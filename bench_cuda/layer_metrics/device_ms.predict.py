"""Device milliseconds per million rows of one traced Booster.predict call
on a batch: the seconds in which a kernel, copy or fill of the call ran
on the card (the union of their intervals), over the batch's rows.
Source: the profiler's CUDA activity."""


def read(rec):
    tr = rec.get("trace") or {}
    if not tr.get("busy_s") or not rec.get("trace_rows"):
        return None
    return tr["busy_s"] * 1e3 / (rec["trace_rows"] / 1e6)
