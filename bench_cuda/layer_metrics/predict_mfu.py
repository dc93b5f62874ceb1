"""Scoring's share of the card's peak: the least bytes of one batch (its
rows' f32 features read once, the forest read once, its f64 scores
written once; bench_cuda/roofline.py) over 3.35 TB/s, divided by the
window's time per batch.  Source: host clock (the window) and the
shapes."""

from bench_cuda import roofline
from bench_cuda.peaks import hbm_ms


def read(rec):
    w, sh = rec["window"], rec["shape"]
    if not w["calls"]:
        return None
    nbytes = roofline.predict_bytes(sh["rows"], sh["features"],
                                    sh["trees"] * (sh["leaves"] - 1),
                                    sh["trees"] * sh["leaves"])
    return hbm_ms(nbytes) / (w["seconds"] * 1e3 / w["calls"]) * 100.0
