"""Host ms a planning call in `graspnerf.wait` (`core()`'s synchronize):
the card's backlog when the host finished issuing, the program's span,
profiled segment."""
from bench_port import program_spans


def read(rec):
    return program_spans.span_ms_per_call(["wait"])
