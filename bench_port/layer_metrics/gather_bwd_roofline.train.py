"""The gather's backward (B' or B'-bf16, its memset and three kernels a
call) share of its roofline (`work/epipolar_gather_backward.py`),
profiled segment."""


def read(rec):
    return rec.roofline("epipolar_gather_backward")
