"""Mean planning latency: the window's host-clock time over the calls
completed in it (one robot, so every call waited on)."""


def read(rec):
    return rec.mean_ms()
