"""Training from scratch, as lightgbm_tpu_torch.api.train drives it:
GBDT.train_segment over iter_batch=auto segments, no per-iteration
metric.

Set-up: the configuration's rows are made on the device from the seed,
copied to the host and binned by the port (api.Dataset), the Booster is
built, and training runs until every step kind has been captured as a
CUDA graph (the traffic's `warmup_iters`: the plain step and the
re-sort step that comes every 16 trees).  The window trains a fixed
number of iterations, the configuration's `window_iters` at
`window_seconds` (scaled to a run's `--seconds`), and ends at a
synchronize: every run times the same trees, and iter_ms is the
window's wall time over them.  With trace on, the configuration's
`trace_iters` more iterations run under the profiler, and a lambdarank
objective's gradient function is timed alone.

The check: the program's trees are read back; the reference regenerates
the rows, works out the bin bounds from them by LightGBM's rule
(reference/binning.py), counts the splits whose threshold is not one of
them, and, tree by tree in boosting order, routes every row through each
tree by its raw thresholds and adds the leaf values to f64 scores.  At
the first tree and at `check_trees` trees drawn from the seed among the
window's, it works out the gradients from those scores and holds the
tree to them (reference/trees.check_tree).
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from .. import spec, trace as tracemod
from ..datagen import torch_seed
from ..reference import binning as rbinning, trees as rtrees


def _now() -> float:
    return time.perf_counter()


def tree_dict(t) -> dict:
    """A program tree's arrays in the reference's layout (host copies)."""
    nl = int(t.num_leaves)
    return {"num_leaves": nl,
            "split_feature": np.asarray(t.split_feature_real[:nl - 1]),
            "threshold": np.asarray(t.threshold[:nl - 1], dtype=np.float64),
            "left_child": np.asarray(t.left_child[:nl - 1]),
            "right_child": np.asarray(t.right_child[:nl - 1]),
            "leaf_value": np.asarray(t.leaf_value[:nl], dtype=np.float64),
            "leaf_count": np.asarray(t.leaf_count[:nl]),
            "split_gain": np.asarray(t.split_gain[:nl - 1], dtype=np.float64)}


class Trainer:
    """The booster and its host-clock record of train_segment calls."""

    def __init__(self, gbdt):
        self.gbdt = gbdt
        self.flush_every = int(getattr(gbdt, "_flush_every", 16))
        self.done = 0
        self.stopped = False

    def segment(self, max_iters: int) -> tuple:
        """One train_segment call: (host seconds, iterations, whether it
        crossed a flush of the pending trees)."""
        it = int(self.gbdt.iter)
        a = _now()
        self.stopped, k = self.gbdt.train_segment(max_iters, is_eval=False)
        s = _now() - a
        self.done += int(k)
        return (s, int(k),
                it // self.flush_every != (it + k) // self.flush_every)

    def train(self, n: int) -> list:
        """n more iterations (fewer if training stops)."""
        goal = self.done + n
        segs = []
        while self.done < goal and not self.stopped:
            segs.append(self.segment(goal - self.done))
        return segs


def window_iters(cfg: dict, seconds: float) -> int:
    """The iterations a window of `seconds` trains: the configuration's
    `window_iters` at its `window_seconds`, in proportion, at least
    one."""
    n = int(round(cfg["window_iters"] * seconds / cfg["window_seconds"]))
    return max(1, n)


def window(run_: Trainer, iters: int, sync) -> tuple:
    """The measured window: `iters` iterations as api.train runs them
    (segments enqueue ahead of the device; the host waits only at a
    flush of the pending trees), then a synchronize.  Returns (wall
    seconds, iterations, segments): the rate is taken over all of the
    window's work and time."""
    it0 = run_.done
    w0 = _now()
    segs = run_.train(iters)
    sync()
    return _now() - w0, run_.done - it0, segs


def check_set(seed: int, first: int, iters: int, count: int) -> list:
    """Tree 0 (the eager warm-up step) and `count` trees drawn from the
    seed among the window's `iters`, which start at tree `first`."""
    rng = np.random.default_rng(torch_seed(seed, 4))
    pool = np.arange(first, first + max(0, iters))
    picked = rng.choice(pool, size=min(count, len(pool)), replace=False)
    return sorted({0, *map(int, picked)})


def reference_numbers(ctx, trees: list, check: list) -> tuple:
    """(numbers, trees failing) of the checked trees: the widest of each
    number over them."""
    import torch
    cfg = ctx.cfg
    params = dict(cfg["params"])
    data = spec.data_module(cfg["data"]).generate(cfg, ctx.seed, ctx.device)
    x, y, group = data["x"], data["y"], data["group"]
    ref = spec.reference_module(cfg["reference"])
    bounds = rbinning.bin_bounds(x, int(params["max_bin"]),
                                 int(params["bin_construct_sample_cnt"]),
                                 int(params["data_random_seed"]))
    bins = rtrees.bin_rows(x, bounds)
    nbins = [len(b) for b in bounds]
    worst = {"thresholds_off_bins": float(rtrees.thresholds_off_bins(trees, bounds))}
    score = torch.zeros(x.shape[0], dtype=torch.float64, device=x.device)
    per_tree = []
    for t in range(max(check) + 1):
        tree = trees[t]
        leaf = rtrees.route(x, tree)
        if t in check:
            g, h = ref.gradients(score, y, group, params)
            nums = rtrees.check_tree(tree, leaf, g, h, bins, nbins, params)
            per_tree.append(nums)
            for k, v in nums.items():
                worst[k] = max(worst.get(k, v), v)
        lv = torch.as_tensor(tree["leaf_value"], device=x.device)
        score += lv[leaf]
    bad = sum(1 for nums in per_tree
              if any(not (nums[k] <= lim)
                     for k, lim in ctx.limits.items() if k in nums))
    bad += not (worst["thresholds_off_bins"] <= ctx.limits.get(
        "thresholds_off_bins", 0))
    return worst, bad


def run(ctx) -> dict:
    import torch
    from lightgbm_tpu_torch import api

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    data = spec.data_module(cfg["data"]).generate(cfg, ctx.seed, dev)
    x_host = data["x"].cpu().numpy()
    y_host = data["y"].cpu().numpy()
    group = data["group"]
    del data
    params = dict(cfg["params"], device_type=dev, verbose=-1)
    params.update(ctx.params_extra)
    ds = api.Dataset(x_host, label=y_host, params=params, group=group)
    del x_host
    num_trees = int(cfg["num_trees"])
    booster = api.Booster(dict(params, num_iterations=num_trees),
                          train_set=ds)
    gbdt = booster._gbdt
    # api.train with verbose_eval=False: no metric line in the loop
    gbdt.config.metric_freq = 1 << 30
    if ctx.tamper is not None:
        ctx.tamper(gbdt)
    run_ = Trainer(gbdt)
    run_.train(int(tr["warmup_iters"]))
    ctx.sync()
    setup_s = _now() - ctx.t0
    captures0 = dict(getattr(gbdt, "_captures", {}))

    it0 = run_.done
    window_s, iters, segs = window(
        run_, min(window_iters(cfg, ctx.seconds), num_trees - it0), ctx.sync)
    phases = {"setup": setup_s, "window": window_s}
    t_phase = _now()
    captures_in_window = (dict(getattr(gbdt, "_captures", {})) != captures0)
    if captures_in_window:
        print("bench_cuda: a step was captured inside the window",
              file=sys.stderr, flush=True)

    memory_peak = (torch.cuda.max_memory_allocated() if ctx.on_card else 0)
    record = {"cell": ctx.cell.name, "window": {
        "seconds": window_s, "iters": iters, "segments": segs,
        "captures_in_window": captures_in_window}}
    if ctx.trace:
        t_iters = int(cfg["trace_iters"])
        if ctx.on_card:
            segs_t, summary = tracemod.traced(lambda: run_.train(t_iters))
        else:       # the harness's CPU tests: no device trace
            a = _now()
            segs_t = run_.train(t_iters)
            summary = tracemod.summarize([], _now() - a)
            summary["busy_s"] = None
        record["trace"] = dict(summary, segments=segs_t,
                               iters=sum(s[1] for s in segs_t))
        if getattr(gbdt.objective, "name", "") == "lambdarank":
            record["rank"] = rank_probe(ctx, gbdt, group)
    device_kind = (torch.cuda.get_device_name(0) if ctx.on_card else "cpu")
    phases["trace"] = _now() - t_phase
    t_phase = _now()

    host_trees = gbdt.models        # flushes the pending trees
    check = check_set(ctx.seed, it0, min(iters, len(host_trees) - it0),
                      int(tr["check_trees"]))
    trees = [tree_dict(t) for t in host_trees]
    record["window"]["trees"] = trees[it0:it0 + iters]
    if ctx.trace:
        record["trace"]["trees"] = trees[it0 + iters:]
    record["shape"] = {"rows": int(ds.num_data()),
                       "features": int(ds.num_feature()),
                       "max_bin": int(gbdt.max_bin)}
    del booster, gbdt, ds, run_
    gc.collect()
    if ctx.on_card:
        torch.cuda.empty_cache()
    phases["flush"] = _now() - t_phase
    t_phase = _now()
    numbers, bad = reference_numbers(ctx, trees, check)
    phases["check"] = _now() - t_phase
    if iters < 1:
        bad += 1
    return {"end_to_end": {"iter_ms": window_s * 1e3 / max(iters, 1)},
            "setup_s": setup_s, "record": record, "numbers": numbers,
            "attempted": iters, "failed": bad,
            "memory_peak_bytes": int(memory_peak), "device_kind": device_kind,
            "phases": phases}


def rank_probe(ctx, gbdt, group) -> dict:
    """The rank objective's gradient function alone on the cell's state:
    captured by itself as a CUDA graph (as it runs inside the captured
    step) and replayed, CUDA events around each replay; and its pair
    cells, the useful ones (sum of query length squared) and those of
    the padded blocks (nb * QB * Lmax^2, from the state's shapes)."""
    import torch
    doc_idx = gbdt.gstate[0]
    nb, qb, lmax = (int(s) for s in doc_idx.shape)
    out = {"pair_cells": nb * qb * lmax * lmax,
           "useful_cells": int((np.asarray(group, dtype=np.int64) ** 2).sum())}
    if not ctx.on_card:
        return out
    score = gbdt.scores[0]
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    # no collection while capturing: one that frees another graph's
    # owner would end the capture (the port's _StepGraph does the same)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(stream):
            gbdt.grad_fn(score, gbdt.gstate)
            with torch.cuda.graph(graph, stream=stream):
                gbdt.grad_fn(score, gbdt.gstate)
    finally:
        if collecting:
            gc.enable()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    ms = []
    for _ in range(int(ctx.traffic.get("rank_grad_calls", 3))):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    out["grad_ms"] = ms
    del graph
    return out


def control(ctx) -> None:
    """The lower-precision control: the program's own bf16 histogram
    operands (hist_acc=bf16) in place of the f32 the configuration
    states."""
    ctx.params_extra = dict(ctx.params_extra, hist_acc="bf16")
