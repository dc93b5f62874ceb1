"""The histogram kernels' share of the HBM roofline in the traced
iterations: the least bytes of their trees' sweeps (bench_cuda/
roofline.py, rows from the trees' own counts) over 3.35 TB/s, divided
by the device time of csrc/hist.cu's kernels (sweep_kernel,
reduce_kernel, fused_reduce_kernel; PyTorch's own at::native
reduce_kernel excluded).  Source: the profiler's CUDA activity."""

from bench_cuda import roofline
from bench_cuda.peaks import hbm_ms
from bench_cuda.trace import seconds_matching

KERNELS = ("sweep_kernel", "reduce_kernel", "fused_reduce_kernel")


def is_hist_kernel(name: str) -> bool:
    return "at::native" not in name and any(k + "<" in name for k in KERNELS)


def read(rec):
    tr = rec.get("trace") or {}
    if not tr.get("ops") or not tr.get("trees"):
        return None
    _, secs = seconds_matching(tr, is_hist_kernel)
    if secs <= 0:
        return None
    sh = rec["shape"]
    nbytes = roofline.sweep_bytes(tr["trees"], sh["rows"], sh["features"],
                                  sh["max_bin"])
    return hbm_ms(nbytes) / (secs * 1e3) * 100.0
