"""Mean device-ordered time of the six views' encoding (`planner.encode`) a planning call: CUDA
events around the call, traced run."""


def read(rec):
    return rec.span_ms("encode")
