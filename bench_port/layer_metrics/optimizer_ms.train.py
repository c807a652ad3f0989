"""Mean device-ordered time a step of Adam and its finite guard
(`trainer.apply_gradients`): CUDA events, traced run."""


def read(rec):
    return rec.span_ms("optimizer")
