"""Mean device-ordered time of the SDF volume (`NeuralRayRenderer.sample_volume`) a planning call: CUDA
events around the call, traced run."""


def read(rec):
    return rec.span_ms("volume")
