"""Bin bounds by LightGBM's rule, worked out from the raw rows.

LightGBM bins a dense matrix from a sample of its rows: `Random(
data_random_seed).Sample(n, bin_construct_sample_cnt)` (std::mt19937,
each draw a double made of two 32-bit outputs, x1 + x2 * 2^32 over
2^64; row i is taken when its draw is below (k - taken) / (n - i)), then
per feature `BinMapper::FindBin` over the sampled values: values with
|v| <= 1e-15 count as zeros, a zero is placed among the distinct values
(between the negatives and the positives even with no zeros sampled; at
an end only if zeros were sampled), and

- with at most max_bin distinct values, a bound midway between each
  neighbouring pair;
- otherwise greedy equal-population bins: a value whose count reaches
  total / max_bin ("big") gets a bin of its own, and the others fill
  bins of the mean population left over, recomputed as each bin closes;
  a bin also closes just before a big value once it holds half the
  mean.  A bound lies midway between a bin's last value and the next
  bin's first.

The last bound is +inf; a value goes to the first bin whose bound is >=
it.  This module states that rule afresh (the greedy pass jumps from bin
to bin by searches over running counts, not value by value) and takes
nothing from the program.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

ZERO = 1e-15


def sample_rows(n: int, k: int, seed: int) -> np.ndarray:
    """The rows LightGBM's Random(seed).Sample(n, k) takes (all of them
    when k >= n)."""
    if k >= n:
        return np.arange(n, dtype=np.int64)
    gen = np.random.MT19937()
    gen._legacy_seeding(seed)       # std::mt19937's init_genrand
    raw = gen.random_raw(2 * n).astype(np.float64)
    draws = (raw[0::2] + raw[1::2] * 4294967296.0) / 18446744073709551616.0
    taken = 0
    keep = []
    for i, d in enumerate(draws.tolist()):
        if d < (k - taken) / (n - i):
            keep.append(i)
            taken += 1
    return np.asarray(keep, dtype=np.int64)


def _distinct(values: np.ndarray, total: int):
    """Sorted distinct values and their counts, the zero placed as
    LightGBM places it."""
    v = np.asarray(values, dtype=np.float64)
    nz = v[np.abs(v) > ZERO]
    zeros = total - nz.size
    vals, cnts = np.unique(nz, return_counts=True)
    cnts = cnts.astype(np.int64)
    if vals.size == 0:
        return np.zeros(1), np.array([zeros], dtype=np.int64)
    if vals[0] > 0.0 or vals[-1] < 0.0:
        if zeros > 0:
            at = 0 if vals[0] > 0.0 else vals.size
            return np.insert(vals, at, 0.0), np.insert(cnts, at, zeros)
        return vals, cnts
    at = int(np.searchsorted(vals, 0.0))
    return np.insert(vals, at, 0.0), np.insert(cnts, at, zeros)


def _greedy_cuts(cnts: np.ndarray, total: int, max_bin: int) -> List[int]:
    """The indices of the distinct values that end a bin (the last bin's
    end is not listed)."""
    nv = cnts.size
    big = cnts >= total / max_bin
    big_at = np.flatnonzero(big)
    run = np.cumsum(cnts)                       # counts through value i
    small_run = np.cumsum(np.where(big, 0, cnts))
    rest_bins = max_bin - big_at.size
    rest = total - int(cnts[big].sum())
    mean = rest / rest_bins
    cuts: List[int] = []
    start = 0
    while start <= nv - 2:
        before = int(run[start - 1]) if start else 0
        ends = []
        j = int(np.searchsorted(big_at, start))
        if j < big_at.size:
            ends.append(int(big_at[j]))         # a big value closes its bin
        # the running count reaches the mean (an integer count >= a
        # double: >= its ceiling)
        ends.append(int(np.searchsorted(run, before + math.ceil(mean))))
        # the next value is big and the count reaches half the mean
        half = int(np.searchsorted(run, before + math.ceil(max(1.0, mean * 0.5))))
        j = int(np.searchsorted(big_at, half + 1))
        if j < big_at.size:
            ends.append(int(big_at[j]) - 1)
        end = min(ends)
        if end > nv - 2:
            break
        cuts.append(end)
        if len(cuts) >= max_bin - 1:
            break
        if not big[end]:
            rest_bins -= 1
            mean = (total - int(cnts[big].sum()) - int(small_run[end])) / rest_bins
        start = end + 1
    return cuts


def bounds(values: np.ndarray, total: int, max_bin: int) -> np.ndarray:
    """One feature's bin upper bounds [num_bin] f64, the last +inf, from
    its sampled values (`total` of them, zeros included)."""
    vals, cnts = _distinct(values, total)
    if vals.size <= max_bin:
        mids = (vals[:-1] + vals[1:]) / 2.0
    else:
        cut = np.asarray(_greedy_cuts(cnts, total, max_bin), dtype=np.int64)
        mids = (vals[cut] + vals[cut + 1]) / 2.0
    return np.append(mids, np.inf)


def bin_bounds(x, max_bin: int, sample_cnt: int, seed: int) -> List[np.ndarray]:
    """Every feature's bounds for the rows x [N, F] (a tensor or array)."""
    n = int(x.shape[0])
    rows = sample_rows(n, min(sample_cnt, n), seed)
    if hasattr(x, "cpu"):
        import torch
        sample = x[torch.as_tensor(rows, device=x.device)].cpu().numpy()
    else:
        sample = np.asarray(x)[rows]
    sample = sample.astype(np.float64)
    return [bounds(sample[:, f], rows.size, max_bin)
            for f in range(sample.shape[1])]
