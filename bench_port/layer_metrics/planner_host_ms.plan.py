"""The planner's own time a call: the call's host-clock time less the
encode, volume and head spans (the views' upload, the host's grasp
conversion, and what the card waits for between stages), traced run."""


def read(rec):
    parts = [rec.span_ms(s) for s in ("encode", "volume", "head")]
    total = rec.mean_ms()
    if total is None or None in parts:
        return None
    return total - sum(parts)
