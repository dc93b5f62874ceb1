#!/usr/bin/env python3
"""On-card smoke test of lightgbm_tpu_torch: builds the CUDA kernels,
holds them against their plain PyTorch versions at the full-width shapes
of the training path, trains through the CLI's Application, and times
every kernel.

    python3 chip_smoke.py          # from the root of a checkout, one card

Workload: bench.py's headline shape — binary classification on
1,000,000 x 28 synthetic rows (bench.py:63-75), num_leaves=63,
max_bin=MAX_BIN, min_data_in_leaf=100, learning_rate=0.1, a 100,000-row
valid set, 10 trees (so the leaf re-sort after tree 1 runs and the fused
kernel sweeps clustered block lists).  The bagged path adds bench.py's
run_ours_bagged settings (bench.py:418-432): bagging_fraction=0.8,
bagging_freq=5, feature_fraction=0.8, on the same Dataset.

Phases (any failure exits non-zero and prints no result):
  1. build the kernels from lightgbm_tpu_torch/csrc;
  2. kernels vs plain versions on the card (counts exact, each bin's sums
     within the f32 summation bound below, fused rows vs per_feature_split_rows of
     the kernel's own histogram, block list == full sweep bit for bit,
     two launches bit for bit); the accumulator modes (i32 equal to the
     plain versions bit for bit, bf16 within the per-bin bound of the same
     bf16 values), n_active = 0 (clamped to 1: i32 equal to the plain
     versions bit for bit), the ranged kernels (equal to the block-list
     kernels given the matching arange list, bit for bit), K4 on a
     scattered leaf, a one-block leaf and planted gain ties in every mode
     (leaf_cases; on the ties, i32 rows equal the plain scan bit for
     bit), and the root on skewed bins (skew_bins: 90 % of the rows in
     bin 0 in half the features) in every mode, held to the uniform
     root's checks;
  3. the main path: `task=train` through cli.Application with every
     tree's device work under torch.cuda.set_sync_debug_mode("error");
     launch counts of the main path; the model file parses back; the same
     training with hist_impl=torch grows the same first tree and a valid
     AUC within AUC_TOL;
  3b. the bagged path on the Dataset of phase 3, with hist_acc=i32 under
     the sync guard: the compacted window engaged, its launch counts, the
     model parses back, valid AUC within AUC_TOL of hist_acc=f32 and
     within BF16_AUC_TOL of hist_acc=bf16; in each mode, K3 and K4 on the
     trained booster's own window (a strided view of its bins) against
     their plain versions and against a contiguous copy; unbagged i32
     writes the same model bytes with hist_ordered=auto and off;
  4. profiles of one tree (main path, bagged i32), then times for every
     kernel, mode and leaf (the skewed root included): the kernel's
     (median, min and max of 5 means
     of 20 back-to-back calls between CUDA events, which read the host's
     work a call where it exceeds the kernel's; and its device time
     alone, from 5 replays of a CUDA graph of 20 calls), its plain
     version's and the torch.bincount yardstick's (the same clock as the
     kernel's first), and its byte bound;
  5. the kernels JSON line and, last, the device JSON line.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

N_ROWS = 1_000_000
N_VALID = 100_000
N_FEAT = 28
NUM_TREES = 10
NUM_LEAVES = 63
MAX_BIN = 255
SEED = 42
TIE_BIN = 100                  # leaf_inputs' "ties": feature 0's upper bin
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak rate
# The f32 bound on a bin's grad or hess sum.  In the sweep a term meets
# at most: ceil(log2 32) = 5 roundings in its sub-step's group (the rows
# of a bin among a warp's 32 lanes, summed by a pairwise tree in lane
# order); 31 as its group's sum is added to the tile's bin over the
# tile's at most 32 sub-steps (the first addition, into +0.0, is exact);
# 7 in the merge of a block's 8 tiles in rank order; and n_active - 1 in
# the reduce over the listed blocks in list order (from 0).  So at most
# d = 42 + n_active roundings, and at most count - 1: each rounding adds
# two disjoint non-empty sets of the bin's rows (adding an exact zero, an
# empty tile or block, does not round).  The kernel's sum is within
# gamma_d * sum|terms| of the exact sum (recursive summation, gamma_d =
# d u / (1 - d u), u = 2^-24), and the plain version, summed in f64 and
# rounded once, within u * sum|terms|; so each bin is held to (d + 2) *
# 2^-24 * its own sum|terms| (f32_depth).  A control histogram of
# bf16-rounded grad and hess must break that bound, or the check could
# not tell f32 from bf16 operands.
F32_UNIT = 2.0 ** -24
SWEEP_ROUNDINGS = 5 + 31 + 7 - 1   # the bound's d, less n_active
SKEW_SHARE = 0.9               # skew_bins: bin 0's share in half the features
GAIN_TOL = 1e-6                # fused rows: relative gain agreement
AUC_TOL = 1e-3                 # hist_impl=cuda vs hist_impl=torch, i32
#                                vs f32 (bagged)
BF16_AUC_TOL = 5e-3            # bagged bf16 vs f32: gh2 rounded to 8 bits
BAGGED = ["bagging_fraction=0.8", "bagging_freq=5", "feature_fraction=0.8"]
# the kernels JSON line: (entry, wrapper, accumulator mode, TPU kernel,
# the phase-4 case that times it)
ROOT, MID = "full sweep, root", "block list, fused, mid-tree leaf"
SKEW = "full sweep, skewed bins, root"
ENTRIES = [
    ("hist_blocklist", "hist_blocklist", "f32",
     "lightgbm_tpu/ops/hist_pallas.py:366", "K1 " + ROOT),
    ("hist_blocklist_fused", "hist_blocklist_fused", "f32",
     "lightgbm_tpu/ops/hist_pallas.py:659", "K4 " + MID),
    ("hist_ranged", "hist_ranged", "f32",
     "lightgbm_tpu/ops/hist_pallas.py:306", "K5a range, root"),
    ("hist_ranged_fused", "hist_ranged_fused", "f32",
     "lightgbm_tpu/ops/hist_pallas.py:729",
     "K5b range, fused, mid-tree leaf"),
    ("hist_blocklist[i32]", "hist_blocklist", "i32",
     "lightgbm_tpu/ops/hist_pallas.py:120", "K6-i32 K1 " + ROOT),
    ("hist_blocklist_fused[i32]", "hist_blocklist_fused", "i32",
     "lightgbm_tpu/ops/hist_pallas.py:472", "K6-i32 K4 " + MID),
    ("hist_blocklist[bf16]", "hist_blocklist", "bf16",
     "lightgbm_tpu/ops/hist_pallas.py:101", "K6-bf16 K1 " + ROOT),
    ("hist_blocklist_fused[bf16]", "hist_blocklist_fused", "bf16",
     "lightgbm_tpu/ops/hist_pallas.py:120", "K6-bf16 K4 " + MID),
]


def make_data(n, seed):
    """bench.py:63-75's formula."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, N_FEAT).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] * x[:, 2]
         + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return x, y


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % out.stderr)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def sync_error_guard():
    """Any host sync inside raises (torch's sync debug mode)."""
    import torch
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def timed(fn, reps=20, warmup=3):
    """Mean milliseconds per call on the card: CUDA events around `reps`
    back-to-back calls, so a call shorter on the card than its host work
    reads the host work."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_spread(fn, repeats=5, reps=20):
    """(min, median, max) of `repeats` readings of timed(fn, reps)."""
    runs = sorted(timed(fn, reps, warmup=3 if i == 0 else 0)
                  for i in range(repeats))
    return runs[0], runs[len(runs) // 2], runs[-1]


def graph_spread(fn, repeats=5, reps=20, warmup=3):
    """(min, median, max) milliseconds of device time per call of `fn`:
    `reps` calls captured in one CUDA graph, which is replayed `repeats`
    times between CUDA events.  The graph takes the host's launch cost
    (the wrapper's checks and allocations) out of the reading, which
    timed() reads wherever it exceeds the kernels' time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(stop) / reps)
    del graph
    runs.sort()
    return runs[0], runs[len(runs) // 2], runs[-1]


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    print("ok  %s" % what)


def f32_depth(count, n_active):
    """d + 2 of the f32 bound per bin (F32_UNIT above): d = min(count - 1,
    SWEEP_ROUNDINGS + n_active), n_active clamped to at least 1 as the
    kernels clamp it."""
    import torch
    cap = SWEEP_ROUNDINGS + max(int(n_active), 1)
    return torch.clamp(count.double() - 1, min=0, max=cap) + 2


def skew_bins(bins):
    """bins with SKEW_SHARE of the rows in bin 0 in every odd feature,
    as a sparse feature or a few-valued one gives them: a row keeps its
    bin there only where the feature before it has a bin divisible by 10
    (so the skew comes from the bins themselves); even features stay."""
    import torch
    out = bins.clone()
    odd = out[1::2]
    keep = bins[0:2 * odd.shape[0]:2] % 10 == 0
    out[1::2] = torch.where(keep, odd, torch.zeros_like(odd))
    return out


def sums_close(kernel, args, plan, what, acc="f32", control=True):
    """counts exact; each bin's grad and hess sums within (d + 2) * 2^-24
    of its sum of |terms| (F32_UNIT above), against the plain version of
    the same gh2 values (f32, or bf16 widened); in f32 (and unless
    control is off) a bf16-operand control breaks that bound.  Returns
    the max abs error over the sums."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    bins, gh2, eff, target = args
    plain = hc.hist_blocklist_plain(*args, *plan, max_bin=MAX_BIN,
                                    hist_acc=acc)
    absum = hc.hist_blocklist_plain(bins, gh2.abs(), eff, target, *plan,
                                    max_bin=MAX_BIN, hist_acc=acc)
    ctrl = (hc.hist_blocklist_plain(bins, gh2.bfloat16().float(), eff,
                                    target, *plan, max_bin=MAX_BIN)
            if acc == "f32" and control else None)
    check(torch.equal(kernel[..., 2], plain[..., 2]), "%s: counts exact" % what)
    depth = f32_depth(plain[..., 2], int(plan[1]))
    err = 0.0
    for c, name in ((0, "grad"), (1, "hess")):
        bound = depth * F32_UNIT * absum[..., c].double()
        d = (kernel[..., c].double() - plain[..., c].double()).abs()
        live = bound > 0
        ratio = float((d[live] / bound[live]).max())
        check(bool((d <= bound).all()),
              "%s: %s sums within the f32 bound per bin (max err/bound %.3g, "
              "max abs err %.3g)" % (what, name, ratio, float(d.max())))
        if ctrl is not None:
            dc = (ctrl[..., c].double() - plain[..., c].double()).abs()
            ratio_c = float((dc[live] / bound[live]).max())
            check(ratio_c > 1.0,
                  "%s: %s bf16-operand control breaks that bound (max "
                  "err/bound %.3g)" % (what, name, ratio_c))
        err = max(err, float(d.max()))
    return err


def bits_equal(a, b, what):
    """Bit-for-bit equality of two results (tensors or tuples of them);
    returns the max abs difference, 0."""
    import torch
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    check(all(torch.equal(x, y) for x, y in zip(a, b)), what)
    return float((a[0] - b[0]).abs().max())


def pf_close(pf, hist, cnt, sg, sh, fmask, params, what):
    """Fused rows vs plain per_feature_split_rows on the kernel's own
    histogram: gains within GAIN_TOL relative; thresholds (and counts)
    equal where the feature's top two gains are further apart.  The plain
    scan runs on the CPU: the GPU's torch.cumsum associates its sums in
    another order, which cancellation in left = total - right magnifies
    past GAIN_TOL."""
    import torch
    from lightgbm_tpu_torch.ops.split import (PF_GAIN, PF_LCNT, PF_RCNT,
                                              PF_T, _split_scan,
                                              per_feature_split_rows)
    # on the CPU, whose torch.cumsum sums in the kernel's order
    hist, cnt, sg, sh, fmask = (t.cpu() for t in (hist, cnt, sg, sh, fmask))
    pf = pf.cpu()
    want = per_feature_split_rows(hist, cnt, sg, sh, fmask, params)
    g_k, g_p = pf[:, PF_GAIN], want[:, PF_GAIN]
    fin = torch.isfinite(g_p)
    check(torch.equal(torch.isfinite(g_k), fin),
          "%s: same features have a valid split" % what)
    rel = ((g_k - g_p).abs() / g_p.abs().clamp_min(1e-30))[fin]
    check(bool((rel <= GAIN_TOL).all()),
          "%s: gains within %.0e relative (max %.3g)"
          % (what, GAIN_TOL, float(rel.max()) if rel.numel() else 0.0))
    masked = _split_scan(hist, cnt, sg, sh, fmask, params)[0]
    top2 = torch.topk(masked, 2, dim=1).values
    clear = fin & ((top2[:, 0] - top2[:, 1]) > GAIN_TOL * top2[:, 0].abs())
    for col, name in ((PF_T, "thresholds"), (PF_LCNT, "left counts"),
                      (PF_RCNT, "right counts")):
        check(torch.equal(pf[clear, col], want[clear, col]),
              "%s: %s equal on %d clear features" % (what, name,
                                                     int(clear.sum())))


def kernel_inputs(bins, dev, params):
    """Every input that phase 2 checks the kernels on and phase 4 times
    them on, at the main path's shapes, built without any check (so that
    scripts/torch_hist_times.py can time another checkout's kernels on
    them): the root (every in-bag row, every block), also on skew_bins of
    the bins; a mid-tree split of rows sorted by a 4-leaf partition, as
    the re-sort leaves them (parent = leaves {2, 3}, small child = leaf
    2); the accumulator modes' gh2 of
    both; the ranged kernels' ranges; and leaf_inputs' leaves."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    f, n_pad = bins.shape
    nblk = n_pad // hc.ROW_BLOCK
    rng = np.random.RandomState(SEED + 2)
    grad = torch.from_numpy(rng.randn(n_pad).astype(np.float32)).to(dev)
    hess = torch.from_numpy(rng.uniform(0.05, 0.25, n_pad)
                            .astype(np.float32)).to(dev)
    gh2 = hc.make_gh2(grad, hess)
    bag = torch.arange(n_pad, device=dev) < N_ROWS
    root_eff = hc.fold_leaf_mask(torch.zeros(n_pad, dtype=torch.int32,
                                             device=dev), bag)
    zero = _i32(0, dev)
    ident = hc.identity_plan(n_pad, dev)
    plan = hc.block_plan(root_eff, zero)

    b0 = bins[0].to(torch.int32)
    b1 = bins[1].to(torch.int32)
    leaf = ((b0 > 150).to(torch.int32) * 2 + (b1 > 60).to(torch.int32))
    rel = torch.sort(leaf, stable=True).indices
    bins_s = bins.index_select(1, rel).contiguous()
    gh2_s = gh2.index_select(1, rel).contiguous()
    bag_s = bag.index_select(0, rel)
    leaf_s = leaf.index_select(0, rel)
    eff = hc.fold_leaf_mask(leaf_s, bag_s)
    parent_eff = hc.fold_leaf_mask(torch.zeros_like(leaf_s),
                                   bag_s & (leaf_s >= 2))
    two = _i32(2, dev)
    plan_s = hc.block_plan(eff, two)
    args = (bins_s, gh2_s, eff, two)
    st = dict(bins=bins, skew=skew_bins(bins), grad=grad, hess=hess,
              gh2=gh2, bag=bag,
              root_eff=root_eff, zero=zero, ident=ident, plan=plan,
              mid=(args, plan_s, ident,
                   _fused_args(*args[:3], parent_eff, two, max_bin=MAX_BIN)),
              mid_raw=(bins_s, gh2_s, eff, parent_eff, two, plan_s, ident))
    st["modes"] = {acc: _mode_inputs(st, acc) for acc in ("i32", "bf16")}
    # the mid-tree leaf's blocks are one contiguous range after the sort
    st["ranges"] = dict(full=(zero, _i32(nblk, dev)),
                        mid=(plan_s[0][0].clone(), plan_s[1].clone()))
    st["leaves"] = leaf_inputs(st, params)
    return st


def phase2(st, params):
    """Kernels vs plain versions at full width, f32: the root and the
    mid-tree split.  Returns the max abs errors by entry."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    bins, gh2, root_eff, zero = (st[k] for k in ("bins", "gh2", "root_eff",
                                                 "zero"))
    ident, plan = st["ident"], st["plan"]
    n_pad = bins.shape[1]
    err = {}
    # K3 / K1: the root
    k1 = hc.hist_blocklist(bins, gh2, root_eff, zero, *ident, max_bin=MAX_BIN)
    k3 = hc.hist_blocklist(bins, gh2, root_eff, zero, *plan, max_bin=MAX_BIN)
    err["hist_blocklist"] = sums_close(k1, (bins, gh2, root_eff, zero),
                                       ident, "K1 root")
    check(torch.equal(k1, k3), "K3 root block list == K1 full sweep, bits")
    check(torch.equal(k1, hc.hist_blocklist(bins, gh2, root_eff, zero,
                                            *ident, max_bin=MAX_BIN)),
          "K1 twice, same bits")
    st["root"] = k1

    # K4 / K2: the mid-tree split
    args, plan_s, ident_s, fused_args = st["mid"]
    parent, fmask, small, large = fused_args
    check(int(plan_s[1]) < n_pad // hc.ROW_BLOCK,
          "mid-tree leaf sweeps %d of %d blocks"
          % (int(plan_s[1]), n_pad // hc.ROW_BLOCK))
    k4 = hc.hist_blocklist_fused(*args, *plan_s, *fused_args, max_bin=MAX_BIN,
                                 params=params)
    k2 = hc.hist_blocklist_fused(*args, *ident_s, *fused_args, max_bin=MAX_BIN,
                                 params=params)
    err["hist_blocklist_fused"] = sums_close(k4[0], args, plan_s,
                                             "K4 mid-tree leaf")
    for a, b, name in zip(k4, k2, ("hist", "pf_small", "pf_large")):
        check(torch.equal(a, b), "K4 block list == K2 full sweep, %s bits"
              % name)
    k4b = hc.hist_blocklist_fused(*args, *plan_s, *fused_args, max_bin=MAX_BIN,
                                  params=params)
    check(all(torch.equal(a, b) for a, b in zip(k4, k4b)),
          "K4 twice, same bits")
    k3m = hc.hist_blocklist(*args, *plan_s, max_bin=MAX_BIN)
    check(torch.equal(k3m, k4[0]), "K3 and K4 histograms, same bits")
    pf_close(k4[1], k4[0], small[0], small[1].float(), small[2].float(),
             fmask, params, "K4 pf_small")
    pf_close(k4[2], parent - k4[0], large[0], large[1].float(),
             large[2].float(), fmask, params, "K4 pf_large")
    return err


def phase2_skew(st):
    """The root on skew_bins' bins in every mode, held to the uniform
    root's checks: counts exact, each bin within the f32 bound (f32 with
    its bf16 control, and bf16 against the same bf16 values), i32 equal
    to the plain version bit for bit, K3's block list == K1's full sweep
    bit for bit.  Returns the max abs error by mode."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    skew, root_eff, zero = st["skew"], st["root_eff"], st["zero"]
    odd = skew[1::2]
    share = float((odd == 0).double().mean())
    check(abs(share - SKEW_SHARE) < 0.02 and torch.equal(skew[0::2],
                                                         st["bins"][0::2]),
          "skewed bins: %.4f of the rows in bin 0 in %d of %d features, "
          "the others unchanged" % (share, odd.shape[0], skew.shape[0]))
    err = {}
    for acc in ("f32", "bf16", "i32"):
        gh2, inv = ((st["gh2"], None) if acc == "f32"
                    else st["modes"][acc][0])
        kw = dict(max_bin=MAX_BIN, hist_acc=acc, inv_scale=inv)
        args = (skew, gh2, root_eff, zero)
        what = "%s K1 skewed bins, root" % acc
        k1 = hc.hist_blocklist(*args, *st["ident"], **kw)
        if acc == "i32":
            err[acc] = bits_equal(k1, hc.hist_blocklist_plain(
                *args, *st["ident"], **kw), "%s == plain, bits" % what)
        else:
            err[acc] = sums_close(k1, args, st["ident"], what, acc=acc)
        bits_equal(hc.hist_blocklist(*args, *st["plan"], **kw), k1,
                   "%s: K3 block list == K1 full sweep, bits" % what)
    return err


def _i32(v, dev):
    import torch
    return torch.full((), v, dtype=torch.int32, device=dev)


def _fused_args(bins, gh2, eff, parent_eff, target, fmask=None, **kw):
    """The fused arguments of a split whose small child is leaf `target`:
    (parent histogram by the kernel, feature mask (all features unless
    given), small and large child stats from the plain histogram of the
    child)."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    zero = torch.zeros_like(target)
    parent = hc.hist_blocklist(bins, gh2, parent_eff, zero,
                               *hc.block_plan(parent_eff, zero), **kw)
    small_h = hc.hist_blocklist_plain(
        bins, gh2, eff, target, *hc.identity_plan(bins.shape[1], bins.device),
        **kw)
    stats = [(torch.round(h[0, :, 2].sum()).to(torch.int32), h[0, :, 0].sum(),
              h[0, :, 1].sum()) for h in (small_h, parent - small_h)]
    if fmask is None:
        fmask = torch.ones(bins.shape[0], dtype=torch.bool,
                           device=bins.device)
    return parent, fmask, stats[0], stats[1]


def _mode_inputs(st, acc):
    """(gh2, inv_scale) of the root rows and the mid-tree rows in an
    accumulator mode, and the mid-tree fused arguments (parent histogram
    and child stats) in that mode."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    bins_s, gh2_s, eff, parent_eff, two, _, _ = st["mid_raw"]
    root = hc.make_gh2_acc(st["grad"], st["hess"], acc)
    mid = hc.make_gh2_acc(gh2_s[0], gh2_s[1], acc)
    return root, mid, _fused_args(bins_s, mid[0], eff, parent_eff, two,
                                  max_bin=MAX_BIN, hist_acc=acc,
                                  inv_scale=mid[1])


def phase2_modes(st, params):
    """The accumulator modes and the ranged kernels on the card at the
    phase-2 shapes; returns their max abs errors."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    bins, root_eff, zero = st["bins"], st["root_eff"], st["zero"]
    bins_s, _, eff, _, two, plan_s, ident_s = st["mid_raw"]
    dev = bins.device
    nblk = bins.shape[1] // hc.ROW_BLOCK
    full, mid_range = st["ranges"]["full"], st["ranges"]["mid"]
    err = {}

    # i32: integer sums have no order, so every route equals the plain
    # version bit for bit, and the fused rows are the plain scan of the
    # kernel's own (dequantised) histogram
    (q, inv), (q_s, inv_s), fused_i = st["modes"]["i32"]
    kw = dict(max_bin=MAX_BIN, hist_acc="i32", inv_scale=inv)
    want = hc.hist_blocklist_plain(bins, q, root_eff, zero, *st["ident"], **kw)
    e = [bits_equal(hc.hist_blocklist(bins, q, root_eff, zero, *pl, **kw),
                    want, "i32 %s root == plain, bits" % name)
         for pl, name in ((st["ident"], "K1"), (st["plan"], "K3"))]
    e.append(bits_equal(hc.hist_ranged(bins, q, root_eff, zero, *full, **kw),
                        want, "i32 K5a root == plain, bits"))
    kw_s = dict(kw, inv_scale=inv_s)
    args_i = (bins_s, q_s, eff, two)
    want_s = hc.hist_blocklist_plain(*args_i, *plan_s, **kw_s)
    for pl, name in ((plan_s, "K3"), (mid_range, "K5a")):
        fn = hc.hist_ranged if name == "K5a" else hc.hist_blocklist
        e.append(bits_equal(fn(*args_i, *pl, **kw_s), want_s,
                            "i32 %s mid-tree leaf == plain, bits" % name))
    err_i = max(e)
    fkw = dict(kw_s, params=params)
    want_f = hc.hist_blocklist_fused_plain(*args_i, *plan_s, *fused_i, **fkw)
    k4 = hc.hist_blocklist_fused(*args_i, *plan_s, *fused_i, **fkw)
    err_fi = bits_equal(k4[0], want_f[0], "i32 K4 hist == plain, bits")
    bits_equal(hc.hist_blocklist_fused(*args_i, *ident_s, *fused_i, **fkw),
               k4, "i32 K2 == K4 (hist, pf_small, pf_large), bits")
    bits_equal(hc.hist_ranged_fused(*args_i, *mid_range, *fused_i, **fkw),
               k4, "i32 K5b == K4 (hist, pf_small, pf_large), bits")
    # n_active = 0 sweeps the first listed block, as the JAX package's
    # clamp to [1, nblocks] does
    zplan = (plan_s[0], _i32(0, dev))
    want0 = hc.hist_blocklist_fused_plain(*args_i, *zplan, *fused_i, **fkw)
    check(float(want0[0][..., 2].sum()) > 0,
          "n_active = 0: the first listed block holds rows of the leaf")
    bits_equal(hc.hist_blocklist(*args_i, *zplan, **kw_s), want0[0],
               "i32 K3 at n_active = 0 == plain, bits")
    bits_equal(hc.hist_blocklist_fused(*args_i, *zplan, *fused_i, **fkw)[0],
               want0[0], "i32 K4 hist at n_active = 0 == plain, bits")
    parent_i, fmask, small_i, large_i = fused_i
    pf_close(k4[1], k4[0], small_i[0], small_i[1], small_i[2], fmask, params,
             "i32 K4 pf_small")
    pf_close(k4[2], parent_i - k4[0], large_i[0], large_i[1], large_i[2],
             fmask, params, "i32 K4 pf_large")
    err["i32"] = (err_i, err_fi)

    # bf16: gh2 streamed in 16 bits and widened; the f32 path after that,
    # so each bin keeps the f32 bound against the same bf16 values
    (b, _), (b_s, _), fused_b = st["modes"]["bf16"]
    kw = dict(max_bin=MAX_BIN, hist_acc="bf16")
    k1b = hc.hist_blocklist(bins, b, root_eff, zero, *st["ident"], **kw)
    err_b = sums_close(k1b, (bins, b, root_eff, zero), st["ident"],
                       "bf16 K1 root", acc="bf16")
    bits_equal(hc.hist_blocklist(bins, b, root_eff, zero, *st["plan"], **kw),
               k1b, "bf16 K3 root == K1, bits")
    args_b = (bins_s, b_s, eff, two)
    fkw = dict(kw, params=params)
    k4b = hc.hist_blocklist_fused(*args_b, *plan_s, *fused_b, **fkw)
    err_fb = sums_close(k4b[0], args_b, plan_s, "bf16 K4 mid-tree leaf",
                        acc="bf16")
    bits_equal(hc.hist_ranged_fused(*args_b, *mid_range, *fused_b, **fkw),
               k4b, "bf16 K5b == K4, bits")
    parent_b, fmask, small_b, large_b = fused_b
    pf_close(k4b[1], k4b[0], small_b[0], small_b[1], small_b[2], fmask,
             params, "bf16 K4 pf_small")
    err["bf16"] = (err_b, err_fb)

    # f32 ranged kernels: ranges at the start, middle and end (and one
    # past the end, whose missing blocks add nothing) equal the block-list
    # kernels given the matching arange list, bit for bit
    gh2 = st["gh2"]
    args = (bins, gh2, root_eff, zero)
    root_stats = (torch.round(st["root"][0, :, 2].sum()).to(torch.int32),
                  st["root"][0, :, 0].sum(), st["root"][0, :, 1].sum())
    fused_r = (st["root"], torch.ones(bins.shape[0], dtype=torch.bool,
                                      device=dev), root_stats, root_stats)
    k = max(1, min(13, nblk // 3))   # a mid-tree leaf's span
    for s0, n, n_list in ((0, k, k), (nblk // 2 - k // 2, k, k),
                          (nblk - k, k, k), (nblk - 3, 5, 3)):
        blist = torch.cat([torch.arange(s0, s0 + n_list),
                           torch.arange(0, s0),
                           torch.arange(s0 + n_list, nblk)]).to(
                               device=dev, dtype=torch.int32)
        rng = (_i32(s0, dev), _i32(n, dev))
        lst = (blist, _i32(n_list, dev))
        what = "blocks [%d, %d)" % (s0, s0 + n)
        bits_equal(hc.hist_ranged(*args, *rng, max_bin=MAX_BIN),
                   hc.hist_blocklist(*args, *lst, max_bin=MAX_BIN),
                   "K5a == K3 with the arange list, %s, bits" % what)
        bits_equal(hc.hist_ranged_fused(*args, *rng, *fused_r,
                                        max_bin=MAX_BIN, params=params),
                   hc.hist_blocklist_fused(*args, *lst, *fused_r,
                                           max_bin=MAX_BIN, params=params),
                   "K5b == K4 with the arange list, %s, bits" % what)
    k5a = hc.hist_ranged(*args, *full, max_bin=MAX_BIN)
    bits_equal(k5a, st["root"], "K5a over every block == K1, bits")
    err_r = sums_close(k5a, args, st["ident"], "K5a root")
    m_args, _, _, m_fused = st["mid"]
    k5b = hc.hist_ranged_fused(*m_args, *mid_range, *m_fused,
                               max_bin=MAX_BIN, params=params)
    err_rf = sums_close(k5b[0], m_args, plan_s, "K5b mid-tree leaf")
    err["f32_ranged"] = (err_r, err_rf)
    return err


# the leaves of leaf_inputs that phase 4 times; "ties" is a check only
TIMED_LEAVES = ("scattered leaf", "one-block leaf")


def leaf_inputs(st, params):
    """K4's inputs on other leaf shapes, in every mode: a scattered leaf
    (rows in every block at about 10 % occupancy, as trees between
    re-sorts see them), a one-block leaf, and "ties": the scattered leaf
    on bins where feature 0 takes bins 0 and TIE_BIN only (so thresholds
    1..TIE_BIN give equal gains), feature 1 a single bin (no valid
    threshold) and feature 2 masked off.  Returns {label: {acc: (args,
    plan, fused, kw)}}."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    bins, dev = st["bins"], st["bins"].device
    n_pad = bins.shape[1]
    nblk = n_pad // hc.ROW_BLOCK
    b0 = bins[0].to(torch.int32)
    blk = torch.arange(n_pad, device=dev) // hc.ROW_BLOCK
    k = nblk // 3
    # parent: feature 0's upper half; small child its top tenth
    scattered = torch.where(b0 >= 128, 3 - (b0 >= 230).to(torch.int32), 0)
    ties = bins.clone()
    ties[0] = torch.where(bins[0] % 2 == 0, 0, TIE_BIN).to(torch.uint8)
    ties[1] = 7
    fmask = torch.ones(bins.shape[0], dtype=torch.bool, device=dev)
    fmask[2] = False
    shapes = {
        "scattered leaf": (bins, scattered, None),
        # parent: blocks k and k + 1; small child: block k's rows with
        # feature 1's bin at most 60
        "one-block leaf": (bins, torch.where(
            (blk == k) & (bins[1] <= 60), 2,
            torch.where((blk == k) | (blk == k + 1), 3, 0)).to(torch.int32),
            None),
        "ties": (ties, scattered, fmask),
    }
    two = _i32(2, dev)
    out = {}
    for label, (b, leaf, fm) in shapes.items():
        eff = hc.fold_leaf_mask(leaf, st["bag"])
        parent_eff = hc.fold_leaf_mask(torch.zeros_like(leaf),
                                       st["bag"] & (leaf >= 2))
        plan = hc.block_plan(eff, two)
        print("%s: %d rows in %d of %d blocks"
              % (label, int((eff == two).sum()), int(plan[1]), nblk))
        out[label] = {}
        for acc in ("f32", "bf16", "i32"):
            gh2, inv = hc.make_gh2_acc(st["grad"], st["hess"], acc)
            kw = dict(max_bin=MAX_BIN, hist_acc=acc, inv_scale=inv)
            fused = _fused_args(b, gh2, eff, parent_eff, two, fm, **kw)
            out[label][acc] = ((b, gh2, eff, two), plan, fused,
                               dict(kw, params=params))
    return out



def pf_bits(pf, hist, cnt, sg, sh, fmask, params, what):
    """Fused rows equal to per_feature_split_rows of the kernel's own
    histogram bit for bit, every column of every feature (on the CPU,
    whose torch.cumsum sums in the kernel's order)."""
    import torch
    from lightgbm_tpu_torch.ops.split import per_feature_split_rows
    want = per_feature_split_rows(*(t.cpu() for t in (hist, cnt, sg, sh,
                                                      fmask)), params)
    check(torch.equal(pf.cpu(), want), what)


def leaf_cases(st, params):
    """K4 on leaf_inputs' leaves in every mode, with the mid-tree leaf's
    checks: counts exact, sums within the per-bin f32 bound (with the
    bf16 control in f32; i32 equal to the plain version bit for bit), the
    fused rows, block list == full sweep and two launches bit for bit.
    On "ties", in i32, both fused rows equal the plain scan bit for bit,
    thresholds included, and hold the tie rules: the larger threshold
    wins a tie, B - 1 with gain -inf where no threshold is valid.
    Returns {label: {acc: max abs err}}."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops.split import PF_GAIN, PF_T
    out = {}
    for label, per_mode in st["leaves"].items():
        out[label] = {}
        for acc, (args, plan, fused, fkw) in per_mode.items():
            ident = hc.identity_plan(args[0].shape[1], args[0].device)
            what = "%s K4 %s" % (acc, label)
            k4 = hc.hist_blocklist_fused(*args, *plan, *fused, **fkw)
            if acc == "i32":
                err = bits_equal(k4[0], hc.hist_blocklist_fused_plain(
                    *args, *plan, *fused, **fkw)[0],
                    "%s: hist == plain, bits" % what)
            else:
                err = sums_close(k4[0], args, plan, what, acc=acc)
            bits_equal(hc.hist_blocklist_fused(*args, *ident, *fused, **fkw),
                       k4, "%s: block list == full sweep, bits" % what)
            bits_equal(hc.hist_blocklist_fused(*args, *plan, *fused, **fkw),
                       k4, "%s: twice, same bits" % what)
            parent, fmask, small, large = fused
            rows = ((k4[1], k4[0], small), (k4[2], parent - k4[0], large))
            for (pf, hist, stats), side in zip(rows, ("small", "large")):
                pf_close(pf, hist, *stats, fmask, params,
                         "%s pf_%s" % (what, side))
                if label == "ties" and acc == "i32":
                    pf_bits(pf, hist, *stats, fmask, params,
                            "%s: pf_%s == plain scan, bits" % (what, side))
                    pf = pf.cpu()
                    check(float(pf[0, PF_T]) == TIE_BIN
                          and all(float(pf[j, PF_GAIN]) == float("-inf")
                                  and float(pf[j, PF_T]) == MAX_BIN - 1
                                  for j in (1, 2)),
                          "%s pf_%s: tied thresholds give %d, a single-bin "
                          "and a masked feature B - 1 at -inf"
                          % (what, side, TIE_BIN))
            out[label][acc] = err
    return out


def phase3(app, argv):
    """The slice through the CLI's Application, counted."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.models.tree import parse_model_text
    from lightgbm_tpu_torch.models.gbdt import GBDT
    from lightgbm_tpu_torch.config import Config, load_parameters
    from lightgbm_tpu_torch.objectives import create_objective
    from lightgbm_tpu_torch.metrics import create_metrics

    # the guard is live: a host pull inside it raises
    try:
        with sync_error_guard():
            torch.ones(1, device=app.boosting.device).item()
    except RuntimeError:
        print("ok  the sync guard raises on a host pull")
    else:
        raise AssertionError("set_sync_debug_mode('error') did not raise")
    hc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    app.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    print("main path launches: %s" % json.dumps(launches))
    check(app.boosting.hist_impl == "cuda" and app.boosting.hist_ranged
          and app.boosting.hist_fused, "main path is cuda, ordered, fused")
    ntrees = len(app.boosting.models)
    check(ntrees == NUM_TREES, "%d trees trained" % ntrees)
    check(launches["hist_blocklist"]["f32"] == ntrees,
          "K3 launched once per tree (%d)" % launches["hist_blocklist"]["f32"])
    check(launches["hist_blocklist_fused"]["f32"] == ntrees * (NUM_LEAVES - 1),
          "K4 launched %d times per tree" % (NUM_LEAVES - 1))
    with open(app.config.output_model) as fh:
        _, trees = parse_model_text(fh.read())
    check(len(trees) == ntrees and all(t.num_leaves > 1 for t in trees),
          "model file parses back through models/tree.py")
    auc = app.boosting.get_eval_at(1)[0]
    print("valid AUC (hist_impl=cuda): %.6f" % auc)
    check(0.5 < auc <= 1.0, "valid AUC is a real AUC")

    # the same training through the plain torch histogram on the card
    cfg = Config.from_params(load_parameters(argv + ["hist_impl=torch"]))
    obj = create_objective(cfg, app.boosting.device)
    obj.init(app.train_data.metadata, app.train_data.num_data)
    plain = GBDT(cfg, app.train_data, obj)
    ms = create_metrics(cfg)
    for m in ms:
        m.init("valid", app.valid_datas[0].metadata,
               app.valid_datas[0].num_data)
    plain.add_valid_data(app.valid_datas[0], ms)
    t0 = time.perf_counter()
    for _ in range(NUM_TREES):
        if plain.train_one_iter(is_eval=False):
            break
    plain_trees = plain.models
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    a, b = app.boosting.models[0], plain_trees[0]
    check(a.num_leaves == b.num_leaves
          and all(np.array_equal(getattr(a, k), getattr(b, k))
                  for k in ("split_feature", "threshold_bin", "left_child",
                            "right_child", "leaf_count")),
          "first tree of hist_impl=torch is structurally identical")
    auc_plain = plain.get_eval_at(1)[0]
    print("valid AUC (hist_impl=torch): %.6f" % auc_plain)
    check(abs(auc - auc_plain) <= AUC_TOL,
          "valid AUCs within %.0e (%.3g)" % (AUC_TOL, abs(auc - auc_plain)))
    return launches, train_s, plain_s


def read_launches():
    """{wrapper: {mode: launches}} of every kernel wrapper."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    return {w.__name__: dict(w.launches_by_mode) for w in hc.WRAPPERS}


def train_booster(app, argv, guarded=True):
    """A booster of `argv` on phase 3's Datasets (no second load), trained
    for NUM_TREES trees with every tree's device work under the sync guard
    and the launch counts reset just before.  Returns (booster, launches,
    seconds, tree steps run)."""
    import torch
    from lightgbm_tpu_torch.config import Config, load_parameters
    from lightgbm_tpu_torch.metrics import create_metrics
    from lightgbm_tpu_torch.models.gbdt import GBDT
    from lightgbm_tpu_torch.objectives import create_objective
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    cfg = Config.from_params(load_parameters(argv))
    obj = create_objective(cfg, app.boosting.device)
    obj.init(app.train_data.metadata, app.train_data.num_data)
    b = GBDT(cfg, app.train_data, obj)
    ms = create_metrics(cfg)
    for m in ms:
        m.init("valid", app.valid_datas[0].metadata,
               app.valid_datas[0].num_data)
    b.add_valid_data(app.valid_datas[0], ms)
    if guarded:
        b.sync_guard = sync_error_guard
    hc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while steps < NUM_TREES:
        steps += 1
        if b.train_one_iter(is_eval=False):
            break
    b.models   # the flush
    torch.cuda.synchronize()
    return b, read_launches(), time.perf_counter() - t0, steps


def window_kernels(b, acc, params):
    """K3 and K4 on a trained bagged booster's own window, as its path
    gives it to them: bins_dev[:, :W], a view whose rows lie n_pad apart,
    with gh2 and inv_scale from make_gh2_acc of the booster's gradients
    over the window and its in-bag mask.  Each is held against its plain
    version (i32 bit for bit, f32 and bf16 within the per-bin f32 bound)
    and against itself on a contiguous copy of the window, bit for bit.
    A root over every block, and a mid-tree split whose blocks start past
    the first one."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    w, dev = b._bag_window, b.device
    bins = b.bins_dev[:, :w]
    check(bins.stride(0) == b.n_pad != w
          and bins.data_ptr() == b.bins_dev.data_ptr(),
          "bagged %s window: a view of %d rows, rows %d apart"
          % (acc, w, b.n_pad))
    copy = bins.contiguous()
    grad, hess = b.grad_fn(b.scores[0], b.gstate)
    gh2, inv = hc.make_gh2_acc(grad[:w], hess[:w], acc)
    bag = b.bag_dev[:w]
    kw = dict(max_bin=MAX_BIN, hist_acc=acc, inv_scale=inv)
    zero = _i32(0, dev)
    two = _i32(2, dev)
    ident = hc.identity_plan(w, dev)
    root_eff = hc.fold_leaf_mask(torch.zeros(w, dtype=torch.int32,
                                             device=dev), bag)
    # the split: parent = the rows of blocks [nb/4, nb/2), leaf 2 those
    # of them with feature 1's bin above 60, leaf 3 the rest
    nb = w // hc.ROW_BLOCK
    blk = torch.arange(w, device=dev) // hc.ROW_BLOCK
    inside = (blk >= nb // 4) & (blk < nb // 2)
    leaf = torch.where(inside, 3 - (bins[1] > 60).to(torch.int32), 0)
    eff = hc.fold_leaf_mask(leaf, bag)
    parent_eff = hc.fold_leaf_mask(torch.zeros_like(leaf), bag & inside)
    plan = hc.block_plan(eff, two)
    fused = _fused_args(bins, gh2, eff, parent_eff, two, **kw)
    what = "bagged %s window" % acc
    k3 = hc.hist_blocklist(bins, gh2, root_eff, zero, *ident, **kw)
    k4 = hc.hist_blocklist_fused(bins, gh2, eff, two, *plan, *fused,
                                 params=params, **kw)
    if acc == "i32":
        bits_equal(k3, hc.hist_blocklist_plain(bins, gh2, root_eff, zero,
                                               *ident, **kw),
                   "%s: K3 root == plain, bits" % what)
        bits_equal(k4[0], hc.hist_blocklist_fused_plain(
            bins, gh2, eff, two, *plan, *fused, params=params, **kw)[0],
            "%s: K4 mid-tree hist == plain, bits" % what)
    else:
        # the bound's power (the bf16 control) is shown in phase 2
        sums_close(k3, (bins, gh2, root_eff, zero), ident,
                   "%s: K3 root" % what, acc=acc, control=False)
        sums_close(k4[0], (bins, gh2, eff, two), plan,
                   "%s: K4 mid-tree leaf" % what, acc=acc, control=False)
    parent, fmask, small, large = fused
    pf_close(k4[1], k4[0], small[0], small[1], small[2], fmask, params,
             "%s: K4 pf_small" % what)
    pf_close(k4[2], parent - k4[0], large[0], large[1], large[2], fmask,
             params, "%s: K4 pf_large" % what)
    bits_equal(k3, hc.hist_blocklist(copy, gh2, root_eff, zero, *ident,
                                     **kw),
               "%s: K3 on the view == on a contiguous copy, bits" % what)
    bits_equal(k4, hc.hist_blocklist_fused(copy, gh2, eff, two, *plan,
                                           *fused, params=params, **kw),
               "%s: K4 on the view == on a contiguous copy, bits" % what)


def phase3b(app, argv, work, params):
    """The bagged path with hist_acc=i32, and its comparisons."""
    from lightgbm_tpu_torch.models.gbdt import NO_LIMIT
    from lightgbm_tpu_torch.models.tree import parse_model_text
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.utils.mt19937 import Mt19937Random
    window = -(-int(0.8 * N_ROWS) // hc.ROW_BLOCK) * hc.ROW_BLOCK
    out = {}
    for acc in ("i32", "f32", "bf16"):
        b, launches, secs, steps = train_booster(app, argv + BAGGED
                                                 + ["hist_acc=" + acc])
        ntrees = len(b.models)
        auc = b.get_eval_at(1)[0]
        print("bagged %s: %d trees, %.1f ms per tree, valid AUC %.6f, "
              "launches %s" % (acc, ntrees, secs * 1e3 / NUM_TREES, auc,
                               json.dumps(launches)))
        check(b.hist_acc == acc and b.hist_ranged and b.hist_fused,
              "bagged %s: cuda, ordered, fused route" % acc)
        check(b._bag_window == window and b._bag_arranged,
              "bagged %s: the compacted window is engaged at %d rows of %d"
              % (acc, window, b.n_pad))
        check(launches["hist_blocklist"][acc] == steps
              and launches["hist_blocklist_fused"][acc]
              == steps * (NUM_LEAVES - 1),
              "bagged %s: K3 %d and K4 %d launches over %d tree steps"
              % (acc, launches["hist_blocklist"][acc],
                 launches["hist_blocklist_fused"][acc], steps))
        check(sum(sum(m.values()) for m in launches.values())
              == launches["hist_blocklist"][acc]
              + launches["hist_blocklist_fused"][acc],
              "bagged %s: no launch in another mode or kernel" % acc)
        window_kernels(b, acc, params)
        out[acc] = dict(booster=b, launches=launches, auc=auc, secs=secs,
                        ntrees=ntrees)
    path = os.path.join(work, "bagged_i32.txt")
    out["i32"]["booster"].save_model_to_file(NO_LIMIT, True, path)
    with open(path) as fh:
        _, trees = parse_model_text(fh.read())
    check(len(trees) == out["i32"]["ntrees"] == NUM_TREES
          and all(t.num_leaves > 1 for t in trees),
          "bagged i32 model file parses back (%d trees)" % len(trees))
    d_i = abs(out["i32"]["auc"] - out["f32"]["auc"])
    d_b = abs(out["bf16"]["auc"] - out["f32"]["auc"])
    check(d_i <= AUC_TOL, "bagged valid AUC, i32 vs f32, within %.0e (%.3g)"
          % (AUC_TOL, d_i))
    check(d_b <= BF16_AUC_TOL, "bagged valid AUC, bf16 vs f32, within %.0e "
          "(%.3g)" % (BF16_AUC_TOL, d_b))
    # the host's share of a re-bag: the mt19937 selection walk over every
    # row, a sequential Python loop (bit-exact with the reference)
    t0 = time.perf_counter()
    Mt19937Random(SEED).split_mask(N_ROWS, int(0.8 * N_ROWS))
    print("host: one re-bag draw over %d rows in %.1f ms"
          % (N_ROWS, (time.perf_counter() - t0) * 1e3))

    # integer sums have no order: the re-sort cannot move an i32 model
    texts = []
    for ordered in ("auto", "off"):
        b = train_booster(app, argv + ["hist_acc=i32",
                                       "hist_ordered=" + ordered])[0]
        path = os.path.join(work, "i32_%s.txt" % ordered)
        b.save_model_to_file(NO_LIMIT, True, path)
        with open(path, "rb") as fh:
            texts.append(fh.read())
        check(b.hist_ranged == (ordered == "auto"),
              "unbagged i32, hist_ordered=%s" % ordered)
    check(texts[0] == texts[1], "unbagged i32 model files, hist_ordered=auto "
          "and off, byte-identical (%d bytes)" % len(texts[0]))
    return out


def tree_profile(boosting, label):
    """One more tree of the trained booster under torch.profiler: wall
    time, device time summed over its kernels, launches, top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        boosting.train_one_iter(is_eval=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (the CPU ops that launched them carry the
    # same time again)
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    launches = sum(e.count for e in kern)
    print("profile of one tree (%s, no flush): wall %.1f ms, "
          "device %s, %d device launches"
          % (label, wall_ms, "%.2f ms busy (%.1f%%)" % (dev_us / 1e3,
                                                        dev_us / 10 / wall_ms)
             if dev_us else "time not measured", launches))
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        print("  %-60s %6d x  %9.1f us" % (e.key[:60], e.count,
                                          e.self_device_time_total))


def phase4(st, params):
    """Times of each kernel at the phase-2 shapes and leaf_inputs' timed
    leaves, in every accumulator mode: the median, min and max of 5
    readings of timed() over 20 calls (the clock of the kernels line's
    ms, and of its plain and library times), and the device time alone
    (graph_spread, median, min and max); returns them by case."""
    times = {}
    for label, name, kern, plain, lib, bnd in phase4_cases(st, params):
        lo, ms, hi = host_spread(kern)
        dlo, dms, dhi = graph_spread(kern)
        pms = host_spread(plain)[1]
        lms = host_spread(lib)[1]
        times[label] = dict(kernel=name, ms=ms, device_ms=dms, plain_ms=pms,
                            library_ms=lms, bound_ms=bnd)
        print("time  %-46s kernel %.4f ms (min %.4f, max %.4f; 5 x 20 "
              "calls)  device %.4f ms (min %.4f, max %.4f; 5 replays of a "
              "graph of 20)  plain %.4f ms  bincount x3 %.4f ms  bound "
              "%.2f us (bytes)" % (label, ms, lo, hi, dms, dlo, dhi, pms, lms,
                                   bnd * 1e3))
    return times


def phase4_cases(st, params):
    """[(label, wrapper name, kernel call, plain call, bincount call,
    bound ms)] of every kernel, mode and timed leaf at the phase-2
    shapes."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    bins, gh2 = st["bins"], st["gh2"]
    f, n_pad = bins.shape
    nblk = n_pad // hc.ROW_BLOCK
    args, plan_s, ident_s, fused_args = st["mid"]
    bins_s, _, eff, _, two, _, _ = st["mid_raw"]
    root_args = (bins, gh2, st["root_eff"], st["zero"])
    mid_range = st["ranges"]["mid"]

    def bincount3(b, g2, eff, target):
        """torch.bincount over f*256 + bin, weighted, x3 (grad, hess,
        count): the library yardstick, which the port never calls."""
        idx = (torch.arange(f, device=b.device)[:, None] * 256
               + b.long()).reshape(-1)
        m = (eff == target).float()
        w = [(c * m).expand(f, -1).reshape(-1) for c in (g2[0], g2[1], m)]
        return lambda: [torch.bincount(idx, weights=wi, minlength=f * 256)
                        for wi in w]

    hist_bytes = f * MAX_BIN * 3 * 4

    def bound(eff, target, listed_blocks, gh_bytes=4, fused=False):
        """The least bytes the call must move, over the HBM rate: leaf_eff
        of every row of the listed blocks, and every 32-byte sector of
        bins (F rows), grad and hess that holds a row of the leaf (each
        such row lies in a listed block here), read once; the histogram
        written once; fused, the parent histogram read once and two
        [F, 8] rows written."""
        inleaf = eff == target
        nbytes = (4 * hc.ROW_BLOCK * int(listed_blocks)
                  + f * 32 * int(inleaf.view(-1, 32).any(1).sum())
                  + 2 * 32 * int(inleaf.view(-1, 32 // gh_bytes)
                                 .any(1).sum())
                  + hist_bytes * (2 if fused else 1)
                  + (2 * f * 32 if fused else 0))
        return nbytes / HBM_BYTES_PER_S * 1e3

    cases = [
        ("K1 full sweep, root", "hist_blocklist",
         lambda: hc.hist_blocklist(bins, gh2, st["root_eff"], st["zero"],
                                   *st["ident"], max_bin=MAX_BIN),
         lambda: hc.hist_blocklist_plain(bins, gh2, st["root_eff"],
                                         st["zero"], *st["ident"],
                                         max_bin=MAX_BIN),
         bincount3(bins, gh2, st["root_eff"], st["zero"]),
         bound(st["root_eff"], st["zero"], nblk)),
        ("K3 block list, mid-tree leaf", "hist_blocklist",
         lambda: hc.hist_blocklist(*args, *plan_s, max_bin=MAX_BIN),
         lambda: hc.hist_blocklist_plain(*args, *plan_s, max_bin=MAX_BIN),
         bincount3(*args),
         bound(eff, two, plan_s[1])),
        ("K2 full sweep, fused, mid-tree leaf", "hist_blocklist_fused",
         lambda: hc.hist_blocklist_fused(*args, *ident_s, *fused_args,
                                         max_bin=MAX_BIN, params=params),
         lambda: hc.hist_blocklist_fused_plain(*args, *ident_s, *fused_args,
                                               max_bin=MAX_BIN, params=params),
         bincount3(*args),
         bound(eff, two, nblk, fused=True)),
        ("K4 block list, fused, mid-tree leaf", "hist_blocklist_fused",
         lambda: hc.hist_blocklist_fused(*args, *plan_s, *fused_args,
                                         max_bin=MAX_BIN, params=params),
         lambda: hc.hist_blocklist_fused_plain(*args, *plan_s, *fused_args,
                                               max_bin=MAX_BIN, params=params),
         bincount3(*args),
         bound(eff, two, plan_s[1], fused=True)),
        ("K5a range, root", "hist_ranged",
         lambda: hc.hist_ranged(*root_args, *st["ranges"]["full"],
                                max_bin=MAX_BIN),
         lambda: hc.hist_ranged_plain(*root_args, *st["ranges"]["full"],
                                      max_bin=MAX_BIN),
         bincount3(*root_args),
         bound(st["root_eff"], st["zero"], nblk)),
        ("K5b range, fused, mid-tree leaf", "hist_ranged_fused",
         lambda: hc.hist_ranged_fused(*args, *mid_range, *fused_args,
                                      max_bin=MAX_BIN, params=params),
         lambda: hc.hist_ranged_fused_plain(*args, *mid_range, *fused_args,
                                            max_bin=MAX_BIN, params=params),
         bincount3(*args),
         bound(eff, two, mid_range[1], fused=True)),
    ]
    for acc, gh_bytes in (("i32", 4), ("bf16", 2)):
        (g_r, inv_r), (g_m, inv_m), fused_m = st["modes"][acc]
        kw_r = dict(max_bin=MAX_BIN, hist_acc=acc, inv_scale=inv_r)
        kw_m = dict(max_bin=MAX_BIN, hist_acc=acc, inv_scale=inv_m,
                    params=params)
        r_args = (bins, g_r, st["root_eff"], st["zero"])
        m_args = (bins_s, g_m, eff, two)
        cases += [
            ("K6-%s K1 %s" % (acc, ROOT), "hist_blocklist",
             lambda a=r_args, k=kw_r: hc.hist_blocklist(*a, *st["ident"],
                                                        **k),
             lambda a=r_args, k=kw_r: hc.hist_blocklist_plain(
                 *a, *st["ident"], **k),
             bincount3(bins, g_r.float(), st["root_eff"], st["zero"]),
             bound(st["root_eff"], st["zero"], nblk, gh_bytes)),
            ("K6-%s K4 %s" % (acc, MID), "hist_blocklist_fused",
             lambda a=m_args, k=kw_m, u=fused_m: hc.hist_blocklist_fused(
                 *a, *plan_s, *u, **k),
             lambda a=m_args, k=kw_m, u=fused_m:
                 hc.hist_blocklist_fused_plain(*a, *plan_s, *u, **k),
             bincount3(bins_s, g_m.float(), eff, two),
             bound(eff, two, plan_s[1], gh_bytes, fused=True)),
        ]
    for acc in ("f32", "i32", "bf16"):
        g_r, inv_r = ((gh2, None) if acc == "f32" else st["modes"][acc][0])
        kw_r = dict(max_bin=MAX_BIN, hist_acc=acc, inv_scale=inv_r)
        s_args = (st["skew"], g_r, st["root_eff"], st["zero"])
        cases.append((
            ("K1 " if acc == "f32" else "K6-%s K1 " % acc) + SKEW,
            "hist_blocklist",
            lambda a=s_args, k=kw_r: hc.hist_blocklist(*a, *st["ident"], **k),
            lambda a=s_args, k=kw_r: hc.hist_blocklist_plain(
                *a, *st["ident"], **k),
            bincount3(st["skew"], g_r.float(), st["root_eff"], st["zero"]),
            bound(st["root_eff"], st["zero"], nblk,
                  2 if acc == "bf16" else 4)))
    for label in TIMED_LEAVES:
        for acc, (a, pl, u, k) in st["leaves"][label].items():
            name = ("K4 " if acc == "f32" else "K6-%s K4 " % acc) + label
            cases.append((
                name, "hist_blocklist_fused",
                lambda a=a, pl=pl, u=u, k=k: hc.hist_blocklist_fused(
                    *a, *pl, *u, **k),
                lambda a=a, pl=pl, u=u, k=k: hc.hist_blocklist_fused_plain(
                    *a, *pl, *u, **k),
                bincount3(a[0], a[1].float(), a[2], a[3]),
                bound(a[2], a[3], pl[1], 2 if acc == "bf16" else 4,
                      fused=True)))
    return cases


def main():
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "lightgbm_tpu_torch", "csrc")):
        sys.stderr.write("chip_smoke: run from a checkout of the repo\n")
        return 2
    sys.path.insert(0, repo)
    from lightgbm_tpu_torch.cli import Application
    from lightgbm_tpu_torch.ops import hist_cuda as hc

    card = card_line()
    print("card: %s" % card)
    print("torch %s, CUDA %s, device %s" % (torch.__version__,
                                          torch.version.cuda,
                                          torch.cuda.get_device_name(0)))
    # phase 1
    t0 = time.perf_counter()
    hc.load_library()
    print("phase 1: kernels built and loaded in %.2f s"
          % (time.perf_counter() - t0))

    work = tempfile.mkdtemp(prefix=".smoke_", dir=repo)
    try:
        t0 = time.perf_counter()
        x, y = make_data(N_ROWS, SEED)
        xv, yv = make_data(N_VALID, SEED + 1)
        train = os.path.join(work, "train.tsv")
        valid = os.path.join(work, "valid.tsv")
        np.savetxt(train, np.column_stack([y, x]), fmt="%.6g",
                   delimiter="\t")
        np.savetxt(valid, np.column_stack([yv, xv]), fmt="%.6g",
                   delimiter="\t")
        print("data written in %.1f s" % (time.perf_counter() - t0))
        argv = ["task=train", "objective=binary", "data=" + train,
                "valid_data=" + valid, "num_trees=%d" % NUM_TREES,
                "num_leaves=%d" % NUM_LEAVES, "max_bin=%d" % MAX_BIN,
                "min_data_in_leaf=100", "learning_rate=0.1",
                "metric=auc,binary_logloss", "verbose=0",
                "output_model=" + os.path.join(work, "model.txt")]
        t0 = time.perf_counter()
        app = Application(argv)
        app.init_train()
        app.boosting.sync_guard = sync_error_guard
        print("data loaded and binned through the CLI in %.1f s"
              % (time.perf_counter() - t0))
        params = app.boosting.params
        check(app.boosting.max_bin == MAX_BIN, "%d bins per feature" % MAX_BIN)

        # phase 2 on the very bins the main path sweeps
        st = kernel_inputs(app.boosting.bins_dev, app.boosting.device,
                           params)
        err = phase2(st, params)
        md_err = phase2_modes(st, params)
        sk_err = phase2_skew(st)
        lc_err = leaf_cases(st, params)
        print("phase 2: kernels agree with their plain versions")

        # phase 3
        launches, train_s, plain_s = phase3(app, argv)
        print("phase 3: %.1f ms per tree (hist_impl=cuda, CLI loop with "
              "flush and metrics), %.1f ms per tree (hist_impl=torch)"
              % (train_s * 1e3 / NUM_TREES, plain_s * 1e3 / NUM_TREES))

        # phase 3b
        t0 = time.perf_counter()
        bagged = phase3b(app, argv, work, params)
        print("phase 3b: bagged path in %.1f s" % (time.perf_counter() - t0))

        # phase 4
        tree_profile(app.boosting, "main path, hist_impl=cuda")
        tree_profile(bagged["i32"]["booster"], "bagged, hist_acc=i32")
        times = phase4(st, params)
        print("card: %s" % card)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # each kernel's launches on its own path: f32 on the main path, each
    # mode on the bagged path of that mode (counts reset just before each)
    for acc in ("i32", "bf16"):
        err["hist_blocklist[%s]" % acc], err["hist_blocklist_fused[%s]"
                                             % acc] = md_err[acc]
    err["hist_ranged"], err["hist_ranged_fused"] = md_err["f32_ranged"]
    for acc, e in sk_err.items():      # the skewed root, every mode
        name = "hist_blocklist" + ("" if acc == "f32" else "[%s]" % acc)
        err[name] = max(err[name], e)
    for per_mode in lc_err.values():   # K4's other leaves, every mode
        for acc, e in per_mode.items():
            name = "hist_blocklist_fused" + ("" if acc == "f32"
                                             else "[%s]" % acc)
            err[name] = max(err[name], e)
    kernels = []
    for name, wrapper, acc, replaces, label in ENTRIES:
        t = times[label]
        path = launches if acc == "f32" else bagged[acc]["launches"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/hist.cu",
            "replaces": replaces, "launches": path[wrapper][acc],
            "max_abs_err": err[name], "ms": t["ms"],
            "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
