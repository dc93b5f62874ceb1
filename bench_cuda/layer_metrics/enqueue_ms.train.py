"""The host's milliseconds inside GBDT.train_segment per iteration, over
the window's segments that did not flush the pending trees (a flush
waits for the device, so those segments time the device, not the
enqueue).  Source: host clock around each call."""


def read(rec):
    segs = [s for s in rec["window"]["segments"] if not s[2]]
    iters = sum(s[1] for s in segs)
    if not iters:
        return None
    return sum(s[0] for s in segs) * 1e3 / iters
