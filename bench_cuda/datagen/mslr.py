"""MSLR-WEB30K-like ranking data.

Query lengths: one heavy-tailed (log-normal) draw from the
configuration's fixed `length_seed`, scaled to the configuration's
document total, clipped to [1, longest] and with one query at the
longest; every run's seed only permutes the queries, so every seed gives
the same set of sizes and the same padded shapes.  Features are standard
normal.  Relevance 0-4 comes from a latent score (features, a per-query
offset and noise), cut at its quantiles so the labels' shares are the
configuration's `label_shares` (MSLR's, about half the documents 0).
"""

from __future__ import annotations

import numpy as np
import torch

from . import torch_seed


def length_set(queries: int, total: int, longest: int, sigma: float,
               length_seed: int) -> np.ndarray:
    """`queries` lengths summing to `total`, in [1, longest], the largest
    exactly `longest`; the same for every run."""
    rng = np.random.default_rng(length_seed)
    z = rng.lognormal(0.0, sigma, queries)
    ln = np.clip(np.round(z / z.mean() * (total / queries)), 1,
                 longest).astype(np.int64)
    top = int(np.argmax(ln))
    ln[top] = longest
    free = np.ones(queries, dtype=bool)
    free[top] = False
    order = rng.permutation(queries)
    while True:
        diff = total - int(ln.sum())
        if diff == 0:
            return ln
        room = (ln < longest) if diff > 0 else (ln > 1)
        cand = order[(room & free)[order]][:abs(diff)]
        if len(cand) == 0:
            raise ValueError("cannot place %d documents in %d queries of "
                             "at most %d" % (total, queries, longest))
        ln[cand] += 1 if diff > 0 else -1


def query_lengths(cfg: dict, seed: int) -> np.ndarray:
    """The configuration's length set in the run's order."""
    ln = length_set(cfg["queries"], cfg["rows"], cfg["longest_query"],
                    cfg["length_sigma"], cfg["length_seed"])
    perm = np.random.default_rng(torch_seed(seed, 2)).permutation(len(ln))
    return ln[perm]


def generate(cfg: dict, seed: int, device) -> dict:
    """{"x" [N, F] f32, "y" [N] f32 relevance, "group" per-query counts}
    on `device` (the group on the host)."""
    lengths = query_lengths(cfg, seed)
    n, f = int(lengths.sum()), cfg["features"]
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, 0))
    x = torch.randn((n, f), generator=g, device=device)
    noise = torch.randn((n,), generator=g, device=device)
    offset = torch.randn((len(lengths),), generator=g, device=device)
    qid = torch.repeat_interleave(
        torch.arange(len(lengths), device=device),
        torch.from_numpy(lengths).to(device))
    latent = (x[:, 0] + 0.5 * x[:, 1] * x[:, 2] + 0.5 * x[:, 3]
              + 0.5 * offset[qid] + 0.5 * noise)
    shares = np.asarray(cfg["label_shares"], dtype=np.float64)
    cuts = np.cumsum(shares)[:-1]
    srt = torch.sort(latent).values
    edges = srt[torch.as_tensor(np.minimum((cuts * n).astype(np.int64),
                                           n - 1), device=device)]
    y = torch.bucketize(latent, edges, right=True).to(torch.float32)
    return {"x": x, "y": y, "group": lengths}
