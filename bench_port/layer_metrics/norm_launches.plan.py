"""Fused InstanceNorm launches a planning call (the program's
`norm_launches` counter: the norm kernel wrapper's launches inside
`graspnerf.plan` while it records, a graph replay's captured ones
included), profiled segment: 62 where the encode's norms run fused; none
where the program has no such counter."""
from bench_port import program_spans


def read(rec):
    t = program_spans.tracing()
    if t is None or "norm_launches" not in t.counters():
        return None
    return program_spans.counter_per_call("norm_launches")
