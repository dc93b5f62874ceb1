"""The whole iteration's share of the card's peak: the least bytes of an
iteration (its tree's sweeps as in hist_roofline_pct.train, plus the
scores and labels read and the gradients and scores written once) over
3.35 TB/s, divided by the window's milliseconds per iteration.  The
work is bandwidth-bound, so the peak is HBM's.  Source: host clock (the
window) and the trees' counts."""

from bench_cuda import roofline
from bench_cuda.peaks import hbm_ms


def read(rec):
    w = rec["window"]
    if not w["iters"] or not w.get("trees"):
        return None
    sh = rec["shape"]
    per_iter = (roofline.sweep_bytes(w["trees"], sh["rows"], sh["features"],
                                     sh["max_bin"]) / len(w["trees"])
                + roofline.iteration_row_bytes(sh["rows"]))
    return hbm_ms(per_iter) / (w["seconds"] * 1e3 / w["iters"]) * 100.0
