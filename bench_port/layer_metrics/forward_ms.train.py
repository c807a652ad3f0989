"""Mean device-ordered time a step of the training forward and losses (step start to
`trainer.gradients`): CUDA events, traced run."""


def read(rec):
    return rec.span_ms("forward")
