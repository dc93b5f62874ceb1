"""LambdaRank with NDCG deltas (LightGBM's LambdarankNDCG), query by
query.  For the pairs (i, j) of a query with label_i > label_j:

    ds = s_i - s_j
    delta = (gain_i - gain_j) |disc(rank_i) - disc(rank_j)| / maxDCG@k
    delta /= 0.01 + |ds|            (unless every score of the query ties)
    p = 2 / (1 + exp(2 sigma ds))
    lambda_i += -p delta, lambda_j -= -p delta
    hess_i, hess_j += p (2 - p) 2 delta

with gain = 2^label - 1, disc(r) = 1 / log2(2 + r), ranks by a
descending sort of the scores in which ties keep their order in the
query (LightGBM's std::sort leaves ties unspecified; the port documents
this stable rule), and maxDCG@k over the query's labels at k =
max_position.  Queries run in groups of similar length, each padded only
to its group's length, in f64.
"""

from __future__ import annotations

import numpy as np
import torch

BUCKET = 32
CELLS = 1 << 23     # pair cells a chunk holds


def label_gain(params: dict) -> np.ndarray:
    lg = params.get("label_gain")
    if lg:
        return np.asarray([float(v) for v in str(lg).split(",")])
    return np.asarray([0.0] + [float((1 << i) - 1) for i in range(1, 31)])


def gradients(score: torch.Tensor, y: torch.Tensor, group, params: dict):
    """(lambda, hess) f64 [N] of f64 scores; `group` the per-query
    document counts, queries laid out one after another."""
    dev = score.device
    n = score.shape[0]
    sigma2 = 2.0 * float(params.get("sigmoid", 1.0))
    k = int(params.get("max_position", 20))
    gain_t = torch.as_tensor(label_gain(params), dtype=torch.float64,
                             device=dev)
    lengths = np.asarray(group, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    disc = 1.0 / torch.log2(2.0 + torch.arange(int(lengths.max()), device=dev,
                                               dtype=torch.float64))
    lam = torch.zeros(n, dtype=torch.float64, device=dev)
    hes = torch.zeros(n, dtype=torch.float64, device=dev)
    lab_all = y.to(torch.int64)
    padded = -(-lengths // BUCKET) * BUCKET
    for width in np.unique(padded):
        qs = np.nonzero(padded == width)[0]
        per = max(1, CELLS // int(width * width))
        ar = torch.arange(int(width), device=dev)
        for a in range(0, len(qs), per):
            q = qs[a:a + per]
            st = torch.as_tensor(starts[q], device=dev)
            ln = torch.as_tensor(lengths[q], device=dev)
            valid = ar[None, :] < ln[:, None]                   # [C, W]
            idx = torch.where(valid, st[:, None] + ar[None, :], 0)
            s = score[idx]
            lab = torch.where(valid, lab_all[idx], -1)
            gain = torch.where(valid, gain_t[lab.clamp_min(0)], 0.0)
            top = torch.sort(gain, dim=1, descending=True).values[:, :k]
            maxdcg = (top * disc[:top.shape[1]]).sum(1)
            inv = torch.where(maxdcg > 0, 1.0 / maxdcg, 0.0)
            s_sort = torch.where(valid, s, -torch.inf)
            order = torch.argsort(s_sort, dim=1, descending=True, stable=True)
            rank = torch.empty_like(order).scatter_(
                1, order, ar.expand_as(order))
            dsc = torch.where(valid, disc[rank.clamp_max(disc.shape[0] - 1)],
                              0.0)
            best = s_sort.amax(1)
            worst = torch.where(valid, s, torch.inf).amin(1)
            tied = (best == worst)[:, None, None]
            ds = s[:, :, None] - s[:, None, :]
            pair = ((lab[:, :, None] > lab[:, None, :])
                    & valid[:, :, None] & valid[:, None, :])
            delta = ((gain[:, :, None] - gain[:, None, :])
                     * (dsc[:, :, None] - dsc[:, None, :]).abs()
                     * inv[:, None, None])
            delta = torch.where(tied, delta, delta / (0.01 + ds.abs()))
            p = 2.0 / (1.0 + torch.exp(sigma2 * ds))
            p_lam = torch.where(pair, -p * delta, 0.0)
            p_hes = torch.where(pair, p * (2.0 - p) * 2.0 * delta, 0.0)
            l_doc = p_lam.sum(2) - p_lam.sum(1)
            h_doc = p_hes.sum(2) + p_hes.sum(1)
            lam.index_put_((idx[valid],), l_doc[valid], accumulate=True)
            hes.index_put_((idx[valid],), h_doc[valid], accumulate=True)
    return lam, hes
