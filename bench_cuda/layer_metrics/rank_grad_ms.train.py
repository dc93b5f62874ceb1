"""Device milliseconds of the lambdarank objective's gradient function
(objectives.py LambdarankNDCG.make_grad_fn) on the cell's state after
the window, captured alone as a CUDA graph as it runs inside the
captured step: the mean of the timed replays.  Source: CUDA events."""


def read(rec):
    ms = (rec.get("rank") or {}).get("grad_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)
