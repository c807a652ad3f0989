"""Host ms a planning call in `graspnerf.upload` (the five host arrays
to the card, `GraspNeRFPlanner.scene`), the program's span, profiled
segment."""
from bench_port import program_spans


def read(rec):
    return program_spans.span_ms_per_call(["upload"])
