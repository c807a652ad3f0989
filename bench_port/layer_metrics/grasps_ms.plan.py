"""Host ms a planning call in `graspnerf.grasps` (`candidates_to_grasps`:
four readbacks and the host's conversion, the card idle), the program's
span, profiled segment."""
from bench_port import program_spans


def read(rec):
    return program_spans.span_ms_per_call(["grasps"])
