"""The whole call's or step's share of the card's peak: the FLOPs the
plain reference counts for it (`torch.utils.flop_counter`) over its mean
time in the traced run's window times the peak of the configuration's
dtype (`peaks.py`)."""


def read(rec):
    return rec.mfu()
