"""Mean device-ordered time a step of every parameter's gradient (`trainer.gradients`:
autograd through B' and the double backward of the SDF's gradient): CUDA events, traced run."""


def read(rec):
    return rec.span_ms("backward")
