"""Host ms a planning call in `graspnerf.encode`, `graspnerf.volume` and
`graspnerf.head`: the host issuing the card's work, the program's spans,
profiled segment."""
from bench_port import program_spans


def read(rec):
    return program_spans.span_ms_per_call(["encode", "volume", "head"])
