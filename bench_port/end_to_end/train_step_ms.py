"""Train step time: the window's host-clock time over the steps completed
in it, each batch's move to the card included."""


def read(rec):
    return rec.mean_ms()
