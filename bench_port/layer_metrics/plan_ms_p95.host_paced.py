"""The 95th percentile of the planning calls' host-clock latency in a
traced run's window (spans on): the tail, kept beside `plan_ms` without a
bound, since its run-to-run spread is the host's (PERF.md §2)."""


def read(rec):
    return rec.percentile_ms(95)
