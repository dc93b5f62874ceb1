"""Scoring raw rows with a finished forest, as a user of
lightgbm_tpu_torch.api scores a test set.

Set-up: the forest (bench_cuda/forest.py, the configuration's `forest`
size) is made from the seed as model text and loaded by
api.Booster(model_file=...); the traffic's `batches` batches of the
configuration's `test_rows` raw f32 rows are made on the device from the
seed and copied to the host; one call of Booster.predict on each warms
the prediction packs up.  The window calls Booster.predict back to back,
the batches in turn, probabilities out; predict_rows_per_s is every row
scored over the window's whole time.  With trace on, one more call of
Booster.predict on a batch runs under the profiler.

The check: the reference parses the model text itself and scores every
batch in f64 (reference/score.py); every output of the window is held to
its batch's reference: prob_gap, the widest gap of a probability.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time

import numpy as np

from .. import forest, spec, trace as tracemod
from ..reference import score as rscore


def _now() -> float:
    return time.perf_counter()


def make_batches(ctx) -> list:
    """The traffic's batches: f32 device tensors of the configuration's
    test rows, batch i from part 1 + i of the seed's data."""
    cfg = ctx.cfg
    gen = spec.data_module(cfg["data"])
    return [gen.rows(cfg["test_rows"], cfg["features"], ctx.seed, 1 + i,
                     ctx.device)[0]
            for i in range(int(ctx.traffic["batches"]))]


def window(predict, batches: list, seconds: float, sync) -> tuple:
    """The measured window: predict on the batches in turn, back to back,
    until `seconds` have passed (one call at least).  Returns (wall
    seconds, rows scored, [(batch index, output)]): the rate is every
    row over the whole window."""
    outs = []
    rows = 0
    w0 = _now()
    while not outs or _now() - w0 < seconds:
        i = len(outs) % len(batches)
        outs.append((i, predict(batches[i])))
        rows += batches[i].shape[0]
    sync()
    return _now() - w0, rows, outs


def run(ctx) -> dict:
    import torch
    from lightgbm_tpu_torch import api

    cfg, dev = ctx.cfg, ctx.device
    fcfg = cfg["forest"]
    text = forest.model_text(fcfg["trees"], fcfg["leaves"], cfg["features"],
                             ctx.seed)
    fd, path = tempfile.mkstemp(suffix=".txt")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        booster = api.Booster(dict(device_type=dev, verbose=-1),
                              model_file=path)
    finally:
        os.unlink(path)
    if ctx.tamper is not None:
        ctx.tamper(booster)
    batches = [b.cpu().numpy() for b in make_batches(ctx)]
    for b in batches:
        booster.predict(b)
    ctx.sync()
    setup_s = _now() - ctx.t0

    window_s, rows, outs = window(booster.predict, batches, ctx.seconds,
                                  ctx.sync)
    phases = {"setup": setup_s, "window": window_s}
    t_phase = _now()
    memory_peak = (torch.cuda.max_memory_allocated() if ctx.on_card else 0)
    record = {"cell": ctx.cell.name,
              "window": {"seconds": window_s, "rows": rows,
                         "calls": len(outs)},
              "shape": {"rows": batches[0].shape[0],
                        "features": batches[0].shape[1],
                        "trees": fcfg["trees"], "leaves": fcfg["leaves"]}}
    if ctx.trace:
        record["trace_rows"] = batches[0].shape[0]
        if ctx.on_card:
            _, summary = tracemod.traced(lambda: booster.predict(batches[0]))
        else:       # the harness's CPU tests: no device trace
            a = _now()
            booster.predict(batches[0])
            summary = tracemod.summarize([], _now() - a)
            summary["busy_s"] = None
        record["trace"] = summary
    device_kind = (torch.cuda.get_device_name(0) if ctx.on_card else "cpu")
    del booster
    gc.collect()
    if ctx.on_card:
        torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------
    phases["trace"] = _now() - t_phase
    t_phase = _now()
    refs = [rscore.probabilities(text, x).cpu().numpy()
            for x in make_batches(ctx)]
    gap, bad = 0.0, 0
    limit = ctx.limits.get("prob_gap", -1.0)
    for i, out in outs:
        out = np.asarray(out, dtype=np.float64).reshape(-1)
        if out.shape != refs[i].shape or not np.isfinite(out).all():
            g = float("inf")
        else:
            g = float(np.abs(out - refs[i]).max())
        gap = max(gap, g)
        bad += not (g <= limit)
    phases["check"] = _now() - t_phase
    return {"end_to_end": {"predict_rows_per_s": rows / window_s},
            "setup_s": setup_s, "record": record,
            "numbers": {"prob_gap": gap}, "attempted": len(outs),
            "failed": bad, "memory_peak_bytes": int(memory_peak),
            "device_kind": device_kind, "phases": phases}


def control(ctx) -> None:
    """The lower-precision control: the reference, scoring in float32,
    in the program's place (the configuration states f64 sums)."""
    import torch
    f = ctx.cfg["forest"]
    text = forest.model_text(f["trees"], f["leaves"], ctx.cfg["features"],
                             ctx.seed)

    def in_f32(booster):
        dev = "cuda" if ctx.on_card else "cpu"
        booster.predict = lambda x: rscore.probabilities(
            text, torch.from_numpy(np.asarray(x)).to(dev),
            torch.float32).cpu().numpy()
    ctx.tamper = in_f32
