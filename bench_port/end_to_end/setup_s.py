"""Set-up: process start to the first timed call (kernel build or load,
weights, inputs, the program's set-up, warm-up), host clock."""


def read(rec):
    return rec.setup_s
