"""Kernels, memsets and copies on the card a call or step, profiled
segment."""


def read(rec):
    seg = rec.sound_segment()
    return None if seg is None else seg.launches_per_call
