"""% of the profiled segment in which no kernel, memset or copy ran on
the card."""


def read(rec):
    seg = rec.sound_segment()
    return None if seg is None else 100.0 * seg.idle_share
