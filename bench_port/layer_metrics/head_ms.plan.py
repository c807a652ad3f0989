"""Mean device-ordered time of the grasp head and post-processing (`planner.detect`) a planning call: CUDA
events around the call, traced run."""


def read(rec):
    return rec.span_ms("head")
