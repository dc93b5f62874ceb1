"""Device kernels per iteration in the traced iterations (copies and
fills not counted).  Source: the profiler's CUDA activity."""

from bench_cuda.trace import seconds_matching


def read(rec):
    tr = rec.get("trace") or {}
    if not tr.get("iters") or not tr.get("ops"):
        return None
    n, _ = seconds_matching(tr, lambda name: not name.startswith(("Memcpy", "Memset")))
    return n / tr["iters"]
