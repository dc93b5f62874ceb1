"""The hand-written CUDA histogram kernels (csrc/hist.cu), their wrappers,
their plain PyTorch versions and their launch counters.

    wrapper                 replaces (lightgbm_tpu/ops/hist_pallas.py)
    hist_blocklist          leaf_histogram_blocklist (K3); with
                            identity_plan, leaf_histogram_masked (K1)
    hist_blocklist_fused    leaf_histogram_blocklist_fused (K4); with
                            identity_plan, leaf_histogram_masked_fused (K2)
    hist_ranged             leaf_histogram_ranged (K5a)
    hist_ranged_fused       leaf_histogram_ranged_fused (K5b)

and, through `hist_acc` (f32 | bf16 | i32), the accumulator modes of all
of them (K6: make_gh2_acc, dequant_hist).

Shared inputs: bins_t [F, N] uint8 (a window of a wider matrix is fine:
its rows need only be contiguous; it must start at a 16-byte boundary,
with rows a multiple of 16 bytes apart), gh2 [2, N] (grad, hess) in the
mode's streaming dtype (make_gh2_acc; 16-byte aligned), leaf_eff [N] i32
(leaf id, -1 out of bag; 16-byte aligned), and either a block list
[N / 8192] i32 whose first n_active entries name the row blocks to
sweep, or a range start: blocks start .. start + n_active - 1.
n_active is clamped to [1, nblocks] and the entries to [0, nblocks), as
the JAX package clamps them.  target, n_active, start and the i32 mode's inv_scale are tensors
on the device, so the training loop never waits on the host.

The sweep (csrc/hist.cu) cuts each listed 8192-row block into 8 tiles of
1024 rows, one thread block each, the 8 joined as a thread-block cluster;
a tile compacts its in-leaf rows before it sums them, one warp a feature:
in the float modes the warp groups its 32 rows of a step by bin and adds
each group's pairwise-tree sum to its bin once; in i32 each row adds
itself with three integer atomics.  The cluster merges
its 8 tile histograms in rank order through distributed shared memory
into one partial per (listed block, feature).  The reduce sums the
partials in list order; the fused variant then scans both children in a
parallel epilogue.  Every sum has a fixed order, so every run gives the
same bits and an ascending block list gives the full sweep's.

A wrapper given CPU tensors runs the plain version beside it (the CPU
path and the tests); given CUDA tensors it launches its kernel or raises.
Each wrapper counts its kernel launches per accumulator mode in
`.launches_by_mode`.

Bound on the card: each sweep reads F + 4 bytes per listed row (bins,
leaf_eff), 8 per in-leaf row (grad, hess; 4 with bf16 gh2), and writes a
partial [F, 256, 3] per listed block; the kernel notes in csrc/hist.cu
say what the design does about it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .histogram import leaf_histogram, make_gvals
from .split import PF_COLS, SplitParams, per_feature_split_rows

ROW_BLOCK = 8192        # rows per block; N must be a multiple
MAX_BIN = 256           # the kernels' bin capacity per feature
HIST_ACC_MODES = ("f32", "bf16", "i32")
# gh2's streaming dtype and the kernels' mode number per accumulator mode
GH2_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16, "i32": torch.int32}
_MODE = {"f32": 0, "bf16": 1, "i32": 2}

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "hist.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# (ranged, mode, bins, ldb, gh2, leaf_eff, target, blocks, n_active,
#  inv_scale, partial, F, N) of both entry points
_SWEEP_ARGS = [_I, _I, _P, _LL] + [_P] * 7 + [_I, _LL]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "lightgbm_tpu_torch build at first use on a machine "
                       "with the CUDA toolkit")


def build_kernels() -> Path:
    """Compile csrc/hist.cu into BUILD_DIR (keyed by the hash of the
    source and flags) unless that library exists; returns its path."""
    digest = hashlib.sha256(_SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / ("libhist_%s.so" % digest)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".so.%d.tmp" % os.getpid())
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed (%d):\n%s\n%s"
                           % (res.returncode, " ".join(cmd), res.stderr))
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use, loaded once per process."""
    lib = ctypes.CDLL(str(build_kernels()))
    lib.lgbt_hist_blocklist.argtypes = _SWEEP_ARGS + [_P, _I, _P]
    lib.lgbt_hist_blocklist_fused.argtypes = (
        _SWEEP_ARGS + [_P] * 7 + [_I, _I, _F, _F, _F, _F, _P])
    lib.lgbt_hist_blocklist.restype = _I
    lib.lgbt_hist_blocklist_fused.restype = _I
    return lib


# -- inputs shared by every variant -----------------------------------------

def make_gh2(grad: torch.Tensor, hess: torch.Tensor) -> torch.Tensor:
    """[2, N] (grad, hess), one per tree."""
    return torch.stack([grad, hess])


def make_gh2_acc(grad: torch.Tensor, hess: torch.Tensor,
                 hist_acc: str = "f32"):
    """(gh2 [2, N], inv_scale) in the accumulator mode's streaming dtype,
    op for op the JAX package's make_gh2_acc (hist_pallas.py:120-141).

    f32: gh2 as is, inv_scale None.  bf16: rounded to bfloat16 (half the
    gh2 stream).  i32: fixed point with a per-tree scale chosen so that
    |q| <= 2^30 / N, so that no sum of the N rows can overflow int32;
    inv_scale, a 0-d f32 tensor on gh2's device (never a host value: it
    depends on max |gh2|), dequantises the grad/hess sums."""
    gh2 = make_gh2(grad.to(torch.float32), hess.to(torch.float32))
    if hist_acc == "bf16":
        return gh2.to(torch.bfloat16), None
    if hist_acc == "i32":
        n = max(int(grad.shape[0]), 1)
        # a fill, not a host-to-device copy: no sync
        cap = torch.full((), 2.0 ** 30 / n, dtype=torch.float32,
                         device=gh2.device)
        m = torch.clamp_min(gh2.abs().amax(), 1e-30)
        scale = cap / m
        q = torch.round(gh2 * scale).to(torch.int32)
        return q, torch.ones_like(scale) / scale
    return gh2, None


def dequant_hist(hist: torch.Tensor, hist_acc: str, inv_scale):
    """[..., 3] histogram -> f32, scaling grad/hess by inv_scale in i32
    mode (counts carry scale 1 and stay exact); hist_pallas.py:144-150."""
    if hist_acc != "i32":
        return hist
    vec = torch.stack([inv_scale, inv_scale, torch.ones_like(inv_scale)])
    return hist.to(torch.float32) * vec


def fold_leaf_mask(leaf_id: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """leaf_eff [N] i32: leaf_id where mask, else -1 (never a target)."""
    return torch.where(mask, leaf_id.to(torch.int32), -1)


def block_plan(leaf_eff: torch.Tensor, target: torch.Tensor):
    """(block_list [nblocks] i32, n_active i32): the blocks holding rows
    of `target`, ascending, then the others; n_active counts the former
    (at least 1).  Ascending order keeps the sum order of a full sweep."""
    nblocks = leaf_eff.shape[0] // ROW_BLOCK
    occ = (leaf_eff == target).view(nblocks, ROW_BLOCK).any(dim=1)
    blist = torch.argsort((~occ).to(torch.int32), stable=True)
    n_active = torch.clamp(occ.sum(), min=1).to(torch.int32)
    return blist.to(torch.int32), n_active


def identity_plan(n: int, device) -> tuple:
    """Every block in order: the full sweep of K1/K2."""
    nblocks = n // ROW_BLOCK
    return (torch.arange(nblocks, dtype=torch.int32, device=device),
            torch.full((), nblocks, dtype=torch.int32, device=device))


# -- plain versions ----------------------------------------------------------

def _listed_rows(block_list, n_active, n: int) -> torch.Tensor:
    """[N] bool: rows of the blocks at list positions < n_active, with the
    kernels' clamps (n_active to [1, nblocks], entries to [0, nblocks))."""
    nblocks = n // ROW_BLOCK
    pos = torch.arange(nblocks, device=block_list.device)
    k = torch.clamp(n_active, 1, nblocks)
    blk = torch.clamp(block_list.long(), 0, nblocks - 1)
    listed = torch.zeros(nblocks, dtype=torch.int32,
                         device=block_list.device).scatter_reduce_(
        0, blk, (pos < k).to(torch.int32), "amax").bool()
    return listed[:, None].expand(nblocks, ROW_BLOCK).reshape(n)


def _ranged_rows(start, n_active, n: int) -> torch.Tensor:
    """[N] bool: rows of blocks start .. start + n_active - 1, with the
    kernels' clamps (start to [0, nblocks), n_active to [1, nblocks]);
    blocks past the last one add nothing."""
    nblocks = n // ROW_BLOCK
    s = torch.clamp(start, 0, nblocks - 1)
    k = torch.clamp(n_active, 1, nblocks)
    blk = torch.arange(nblocks, device=start.device)
    listed = (blk >= s) & (blk < s + k)
    return listed[:, None].expand(nblocks, ROW_BLOCK).reshape(n)


def _hist_rows_plain(bins_t, gh2, leaf_eff, target, rows, max_bin,
                     hist_acc, inv_scale):
    """The masked histogram of the plain versions: sums in f64, rounded
    once to f32 (f32 and the bf16 values widened), or exact integer sums
    dequantised like the kernels (i32)."""
    m = (leaf_eff == target) & rows
    if hist_acc == "i32":
        raw = leaf_histogram(bins_t, make_gvals(gh2[0], gh2[1], m,
                                                torch.float64),
                             max_bin=max_bin)
        return dequant_hist(raw.to(torch.int32), "i32", inv_scale)
    return leaf_histogram(bins_t, make_gvals(gh2[0], gh2[1], m,
                                             torch.float32),
                          max_bin=max_bin)


def _fused_rows_plain(hist, parent_hist, feature_mask, small_stats,
                      large_stats, params):
    cnt_s, sg_s, sh_s = small_stats
    cnt_l, sg_l, sh_l = large_stats
    pfs = per_feature_split_rows(hist, cnt_s, sg_s, sh_s, feature_mask,
                                 params)
    pfl = per_feature_split_rows(parent_hist - hist, cnt_l, sg_l, sh_l,
                                 feature_mask, params)
    return hist, pfs, pfl


def hist_blocklist_plain(bins_t, gh2, leaf_eff, target, block_list, n_active,
                         *, max_bin: int, hist_acc: str = "f32",
                         inv_scale=None) -> torch.Tensor:
    """The plain version of hist_blocklist: [F, max_bin, 3] f32."""
    rows = _listed_rows(block_list, n_active, bins_t.shape[1])
    return _hist_rows_plain(bins_t, gh2, leaf_eff, target, rows, max_bin,
                            hist_acc, inv_scale)


def hist_ranged_plain(bins_t, gh2, leaf_eff, target, start, n_active, *,
                      max_bin: int, hist_acc: str = "f32",
                      inv_scale=None) -> torch.Tensor:
    """The plain version of hist_ranged: [F, max_bin, 3] f32."""
    rows = _ranged_rows(start, n_active, bins_t.shape[1])
    return _hist_rows_plain(bins_t, gh2, leaf_eff, target, rows, max_bin,
                            hist_acc, inv_scale)


def hist_blocklist_fused_plain(bins_t, gh2, leaf_eff, target, block_list,
                               n_active, parent_hist, feature_mask,
                               small_stats, large_stats, *, max_bin: int,
                               params: SplitParams, hist_acc: str = "f32",
                               inv_scale=None):
    """The plain version of hist_blocklist_fused: the histogram, then
    per_feature_split_rows of it and of parent - it."""
    hist = hist_blocklist_plain(bins_t, gh2, leaf_eff, target, block_list,
                                n_active, max_bin=max_bin,
                                hist_acc=hist_acc, inv_scale=inv_scale)
    return _fused_rows_plain(hist, parent_hist, feature_mask, small_stats,
                             large_stats, params)


def hist_ranged_fused_plain(bins_t, gh2, leaf_eff, target, start, n_active,
                            parent_hist, feature_mask, small_stats,
                            large_stats, *, max_bin: int,
                            params: SplitParams, hist_acc: str = "f32",
                            inv_scale=None):
    """The plain version of hist_ranged_fused."""
    hist = hist_ranged_plain(bins_t, gh2, leaf_eff, target, start, n_active,
                             max_bin=max_bin, hist_acc=hist_acc,
                             inv_scale=inv_scale)
    return _fused_rows_plain(hist, parent_hist, feature_mask, small_stats,
                             large_stats, params)


# -- the kernels' wrappers ---------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype:
        raise TypeError("%s has dtype %s, expected %s" % (name, t.dtype, dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def check_alignment(bins_t: torch.Tensor, leaf_eff: torch.Tensor,
                    gh2=None) -> None:
    """The sweep stages bins_t in 16-byte loads, and leaf_eff and gh2 four
    rows a load: raises ValueError unless bins_t starts at a 16-byte
    boundary with its rows a multiple of 16 bytes apart, and leaf_eff (and
    gh2, if given) start at one.  Fresh allocations and their row windows
    [:, :W] qualify; no copy is made."""
    if bins_t.data_ptr() % 16 or bins_t.stride(0) % 16:
        raise ValueError("bins_t must start at a 16-byte boundary with rows "
                         "a multiple of 16 bytes apart (offset %d, row "
                         "stride %d)" % (bins_t.data_ptr() % 16,
                                         bins_t.stride(0)))
    if leaf_eff.data_ptr() % 16:
        raise ValueError("leaf_eff must start at a 16-byte boundary")
    if gh2 is not None and gh2.data_ptr() % 16:
        raise ValueError("gh2 must start at a 16-byte boundary")


def _check_sweep(bins_t, gh2, leaf_eff, target, blocks, n_active, max_bin,
                 hist_acc, inv_scale, ranged):
    """Validates the sweep inputs for the kernel; returns (F, N, device,
    ldb), ldb being the stride between bins_t's rows."""
    dev = bins_t.device
    if dev.type != "cuda":
        raise ValueError("the CUDA histogram kernels take CUDA tensors "
                         "(got %s)" % dev)
    if hist_acc not in HIST_ACC_MODES:
        raise ValueError("hist_acc %r not in %s" % (hist_acc, HIST_ACC_MODES))
    f, n = bins_t.shape
    if n % ROW_BLOCK or n // ROW_BLOCK > 65535:
        raise ValueError("row count %d must be a multiple of %d below 2^29"
                         % (n, ROW_BLOCK))
    if not 1 <= max_bin <= MAX_BIN:
        raise ValueError("max_bin %d outside [1, %d]" % (max_bin, MAX_BIN))
    # bins_t may be a row window [:, :W] of the padded matrix: the kernel
    # takes its row stride, so no copy is made
    if bins_t.dtype != torch.uint8:
        raise TypeError("bins_t has dtype %s, expected torch.uint8"
                        % bins_t.dtype)
    if bins_t.stride(1) != 1 or bins_t.stride(0) < n:
        raise ValueError("bins_t rows must be contiguous")
    _check(gh2, "gh2", GH2_DTYPE[hist_acc], (2, n), dev)
    _check(leaf_eff, "leaf_eff", torch.int32, (n,), dev)
    check_alignment(bins_t, leaf_eff, gh2)
    _check(target.reshape(1), "target", torch.int32, (1,), dev)
    if ranged:
        _check(blocks.reshape(1), "start", torch.int32, (1,), dev)
    else:
        _check(blocks, "block_list", torch.int32, (n // ROW_BLOCK,), dev)
    _check(n_active.reshape(1), "n_active", torch.int32, (1,), dev)
    if hist_acc == "i32":
        if inv_scale is None:
            raise ValueError("hist_acc=i32 needs inv_scale")
        _check(inv_scale.reshape(1), "inv_scale", torch.float32, (1,), dev)
    return f, n, dev, bins_t.stride(0)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError("%s: CUDA launch failed with error %d" % (what, rc))


def _sweep_call_args(bins_t, gh2, leaf_eff, target, blocks, n_active,
                     max_bin, hist_acc, inv_scale, ranged):
    """Checks the inputs and allocates the partials; returns the leading
    ctypes arguments of both entry points and (F, device)."""
    f, n, dev, ldb = _check_sweep(bins_t, gh2, leaf_eff, target, blocks,
                                  n_active, max_bin, hist_acc, inv_scale,
                                  ranged)
    partial = torch.empty((n // ROW_BLOCK, f, MAX_BIN, 3),
                          dtype=(torch.int32 if hist_acc == "i32"
                                 else torch.float32), device=dev)
    args = (int(ranged), _MODE[hist_acc], bins_t.data_ptr(), ldb,
            gh2.data_ptr(), leaf_eff.data_ptr(), target.data_ptr(),
            blocks.data_ptr(), n_active.data_ptr(),
            inv_scale.data_ptr() if inv_scale is not None else None,
            partial.data_ptr(), f, n)
    return args, partial, f, dev


def _sweep(wrapper, bins_t, gh2, leaf_eff, target, blocks, n_active,
           max_bin, hist_acc, inv_scale, ranged):
    args, partial, f, dev = _sweep_call_args(
        bins_t, gh2, leaf_eff, target, blocks, n_active, max_bin, hist_acc,
        inv_scale, ranged)
    hist = torch.empty((f, max_bin, 3), dtype=torch.float32, device=dev)
    rc = load_library().lgbt_hist_blocklist(
        *args, hist.data_ptr(), max_bin,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, wrapper.__name__)
    wrapper.launches_by_mode[hist_acc] += 1
    return hist


def _sweep_fused(wrapper, bins_t, gh2, leaf_eff, target, blocks,
                 n_active, parent_hist, feature_mask, small_stats,
                 large_stats, max_bin, params, hist_acc, inv_scale, ranged):
    args, partial, f, dev = _sweep_call_args(
        bins_t, gh2, leaf_eff, target, blocks, n_active, max_bin, hist_acc,
        inv_scale, ranged)
    _check(parent_hist, "parent_hist", torch.float32, (f, max_bin, 3), dev)
    _check(feature_mask, "feature_mask", torch.bool, (f,), dev)
    stats = torch.stack([small_stats[1], small_stats[2], large_stats[1],
                         large_stats[2]]).to(torch.float32)
    cnts = torch.stack([small_stats[0], large_stats[0]]).to(torch.int32)
    hist = torch.empty((f, max_bin, 3), dtype=torch.float32, device=dev)
    pfs = torch.empty((f, PF_COLS), dtype=torch.float32, device=dev)
    pfl = torch.empty((f, PF_COLS), dtype=torch.float32, device=dev)
    rc = load_library().lgbt_hist_blocklist_fused(
        *args, parent_hist.data_ptr(), feature_mask.data_ptr(),
        stats.data_ptr(), cnts.data_ptr(), hist.data_ptr(), pfs.data_ptr(),
        pfl.data_ptr(), max_bin, int(params.min_data_in_leaf),
        float(params.min_sum_hessian_in_leaf), float(params.lambda_l1),
        float(params.lambda_l2), float(params.min_gain_to_split),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, wrapper.__name__)
    wrapper.launches_by_mode[hist_acc] += 1
    return hist, pfs, pfl


def hist_blocklist(bins_t, gh2, leaf_eff, target, block_list, n_active, *,
                   max_bin: int, hist_acc: str = "f32",
                   inv_scale=None) -> torch.Tensor:
    """hist [F, max_bin, 3] f32 over rows with leaf_eff == target in the
    blocks block_list[:n_active].  Ascending lists give the full sweep's
    bits."""
    if bins_t.device.type == "cpu":
        return hist_blocklist_plain(bins_t, gh2, leaf_eff, target,
                                    block_list, n_active, max_bin=max_bin,
                                    hist_acc=hist_acc, inv_scale=inv_scale)
    return _sweep(hist_blocklist, bins_t, gh2, leaf_eff, target, block_list,
                  n_active, max_bin, hist_acc, inv_scale, False)


def hist_ranged(bins_t, gh2, leaf_eff, target, start, n_active, *,
                max_bin: int, hist_acc: str = "f32",
                inv_scale=None) -> torch.Tensor:
    """hist_blocklist over blocks start .. start + n_active - 1 (start
    clamped to [0, nblocks), n_active to [1, nblocks]; blocks past the
    last add nothing).  Equals hist_blocklist with that arange as list,
    bit for bit, whenever the range lies inside the array."""
    if bins_t.device.type == "cpu":
        return hist_ranged_plain(bins_t, gh2, leaf_eff, target, start,
                                 n_active, max_bin=max_bin,
                                 hist_acc=hist_acc, inv_scale=inv_scale)
    return _sweep(hist_ranged, bins_t, gh2, leaf_eff, target, start, n_active,
                  max_bin, hist_acc, inv_scale, True)


def hist_blocklist_fused(bins_t, gh2, leaf_eff, target, block_list,
                         n_active, parent_hist, feature_mask, small_stats,
                         large_stats, *, max_bin: int, params: SplitParams,
                         hist_acc: str = "f32", inv_scale=None):
    """hist_blocklist for the small child of a split, plus the best-split
    rows of both children: (hist [F, max_bin, 3] f32, pf_small [F, 8],
    pf_large [F, 8]).  parent_hist [F, max_bin, 3] f32 is the parent's
    histogram; small_stats / large_stats are (count i32, sum_g, sum_h).
    In i32 mode both scans run on the dequantised histogram."""
    if bins_t.device.type == "cpu":
        return hist_blocklist_fused_plain(
            bins_t, gh2, leaf_eff, target, block_list, n_active,
            parent_hist, feature_mask, small_stats, large_stats,
            max_bin=max_bin, params=params, hist_acc=hist_acc,
            inv_scale=inv_scale)
    return _sweep_fused(hist_blocklist_fused, bins_t, gh2, leaf_eff, target,
                        block_list, n_active, parent_hist, feature_mask,
                        small_stats, large_stats, max_bin, params, hist_acc,
                        inv_scale, False)


def hist_ranged_fused(bins_t, gh2, leaf_eff, target, start, n_active,
                      parent_hist, feature_mask, small_stats, large_stats, *,
                      max_bin: int, params: SplitParams,
                      hist_acc: str = "f32", inv_scale=None):
    """hist_blocklist_fused over the block range of hist_ranged."""
    if bins_t.device.type == "cpu":
        return hist_ranged_fused_plain(
            bins_t, gh2, leaf_eff, target, start, n_active, parent_hist,
            feature_mask, small_stats, large_stats, max_bin=max_bin,
            params=params, hist_acc=hist_acc, inv_scale=inv_scale)
    return _sweep_fused(hist_ranged_fused, bins_t, gh2, leaf_eff, target,
                        start, n_active, parent_hist, feature_mask,
                        small_stats, large_stats, max_bin, params, hist_acc,
                        inv_scale, True)


WRAPPERS = (hist_blocklist, hist_blocklist_fused, hist_ranged,
            hist_ranged_fused)


def reset_launches() -> None:
    """Set every wrapper's launch counts to 0."""
    for w in WRAPPERS:
        w.launches_by_mode = dict.fromkeys(HIST_ACC_MODES, 0)


reset_launches()
