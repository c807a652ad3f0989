"""The epipolar gather's (B or B-bf16) share of its roofline
(`work/epipolar_gather.py`), profiled segment."""


def read(rec):
    return rec.roofline("epipolar_gather")
