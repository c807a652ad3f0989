"""The view fuse's (A or A-bf16) share of its roofline: its least time at
the rows a call needs (`work/view_fuse.py`) over its launches' device
time, profiled segment."""


def read(rec):
    return rec.roofline("view_fuse")
