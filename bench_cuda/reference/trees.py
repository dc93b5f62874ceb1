"""Trees by LightGBM's rules, on raw feature values.

A tree is a dict of host arrays in LightGBM's layout: node i splits
`split_feature[i]` at `threshold[i]` (a row goes left when its value <=
the threshold), children >= 0 are nodes and < 0 are ~leaf; with
`leaf_value`, and, for a tree the program grew, `leaf_count` and
`split_gain`.  A child node is always numbered after its parent.

check_tree holds one grown tree to what its rows and gradients say:
  rows_misplaced   rows whose leaf differs, by the leaves' counts
                   (half the summed count gaps; exact: limit 0);
  leaf_value_gap   the widest gap of a leaf's value from
                   -G / (H + lambda_l2) * learning_rate (lambda_l1 = 0
                   shrinks |G| first), over the larger of that leaf's
                   and the median leaf's |value|; leaf_value_gap_rows
                   the leaves' gaps weighted by their rows, over the
                   same weighting of |value|;
  split_gain_gap   the same of each split's gain, G_L^2/H_L + G_R^2/H_R
                   - G^2/H, from the sums of the rows it routes;
                   root_gain_gap that of the root split alone, whose
                   sums run over every row with no histogram
                   subtraction;
  gain_shortfall   the widest share of the best gain by which a split's
                   gain falls short of it, the best taken over every
                   bin bound of every feature, the bounds worked out
                   from the raw rows by LightGBM's rule
                   (reference/binning.py): about 0 up to rounding,
                   unless the split finder picked a worse split or
                   binned otherwise.

thresholds_off_bins counts the splits of a forest whose threshold is not
one of the reference's bin bounds of its feature (exact: limit 0).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

HESS_ROOM = 1e-5


def depth(tree: dict) -> int:
    nl = int(tree["num_leaves"])
    if nl <= 1:
        return 0
    lc, rc = tree["left_child"], tree["right_child"]
    d = np.zeros(nl - 1, dtype=np.int64)
    deepest = 1
    for i in range(nl - 1):
        for c in (lc[i], rc[i]):
            if c >= 0:
                d[c] = d[i] + 1
                deepest = max(deepest, int(d[c]) + 1)
    return deepest


def route(x: torch.Tensor, tree: dict) -> torch.Tensor:
    """[N] leaf index of every row of x [N, F] (f32 or f64)."""
    n = x.shape[0]
    dev = x.device
    if int(tree["num_leaves"]) <= 1:
        return torch.zeros(n, dtype=torch.int64, device=dev)
    nl = int(tree["num_leaves"])
    sf = torch.as_tensor(np.asarray(tree["split_feature"][:nl - 1],
                                    dtype=np.int64), device=dev)
    thr = torch.as_tensor(np.asarray(tree["threshold"][:nl - 1],
                                     dtype=np.float64), device=dev)
    lc = torch.as_tensor(np.asarray(tree["left_child"][:nl - 1],
                                    dtype=np.int64), device=dev)
    rc = torch.as_tensor(np.asarray(tree["right_child"][:nl - 1],
                                    dtype=np.int64), device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(depth(tree)):
        nd = node.clamp_min(0)
        v = x.gather(1, sf[nd].unsqueeze(1)).squeeze(1).to(torch.float64)
        nxt = torch.where(v <= thr[nd], lc[nd], rc[nd])
        node = torch.where(node >= 0, nxt, node)
    return ~node


def leaf_split_gain(g, h, l1: float, l2: float):
    a = g.abs()
    return torch.where(a > l1, (a - l1).clamp_min(0) ** 2 / (h + l2), 0.0)


def leaf_output(g, h, l1: float, l2: float):
    a = g.abs()
    return torch.where(a > l1, -torch.sign(g) * (a - l1) / (h + l2), 0.0)


def thresholds_off_bins(forest: List[dict], bounds: List[np.ndarray]) -> int:
    """The splits of the forest whose threshold is not one of its
    feature's finite bin bounds."""
    off = 0
    for t in forest:
        nl = int(t["num_leaves"])
        for f, thr in zip(t["split_feature"][:nl - 1], t["threshold"][:nl - 1]):
            b = bounds[int(f)]
            i = int(np.searchsorted(b, float(thr)))
            off += not (i < b.size - 1 and b[i] == float(thr))
    return off


def bin_rows(x: torch.Tensor, bounds: List[np.ndarray]) -> torch.Tensor:
    """[F, N] int64 bin of every value: the index of the first bound >=
    it."""
    return torch.stack([torch.bucketize(
        x[:, f].to(torch.float64),
        torch.as_tensor(b, dtype=torch.float64, device=x.device), right=False)
        for f, b in enumerate(bounds)])


def _rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    if prog.numel() == 0:
        return 0.0
    floor = ref.abs().median().clamp_min(1e-300)
    return float(((prog - ref).abs() / torch.maximum(ref.abs(), floor)).max())


def check_tree(tree: dict, leaf: torch.Tensor, grad: torch.Tensor,
               hess: torch.Tensor, bins: torch.Tensor, nbins: List[int],
               params: dict) -> Dict[str, float]:
    """The numbers of one grown tree (module docstring).  leaf: the rows'
    leaves by route(); grad, hess: f64 gradients of the scores before the
    tree; bins: bin_rows() of the rows, nbins each feature's bin count."""
    dev = leaf.device
    nl = int(tree["num_leaves"])
    l1 = float(params.get("lambda_l1", 0.0))
    l2 = float(params.get("lambda_l2", 0.0))
    lr = float(params["learning_rate"])
    min_data = int(params.get("min_data_in_leaf", 100))
    min_hess = float(params.get("min_sum_hessian_in_leaf", 10.0))
    f64 = dict(dtype=torch.float64, device=dev)
    cnt = torch.bincount(leaf, minlength=nl).to(torch.float64)
    g = torch.bincount(leaf, weights=grad, minlength=nl)
    h = torch.bincount(leaf, weights=hess, minlength=nl)
    prog_cnt = torch.as_tensor(np.asarray(tree["leaf_count"][:nl],
                                          dtype=np.float64), **f64)
    out = {"rows_misplaced": float((cnt - prog_cnt).abs().sum()) / 2.0}
    lv_ref = leaf_output(g, h, l1, l2) * lr
    lv = torch.as_tensor(np.asarray(tree["leaf_value"][:nl],
                                    dtype=np.float64), **f64)
    out["leaf_value_gap"] = _rel_gap(lv, lv_ref)
    out["leaf_value_gap_rows"] = float((cnt * (lv - lv_ref).abs()).sum()
                                       / (cnt * lv_ref.abs()).sum().clamp_min(1e-300))
    if nl <= 1:
        out.update(split_gain_gap=0.0, root_gain_gap=0.0, gain_shortfall=0.0)
        return out
    lc = np.asarray(tree["left_child"][:nl - 1], dtype=np.int64)
    rc = np.asarray(tree["right_child"][:nl - 1], dtype=np.int64)
    # per-leaf histograms over the reference's bins: [nl, F, B, 3]
    nb = max(nbins) + 1
    nf = bins.shape[0]
    hist = torch.zeros((nl, nf, nb, 3), **f64)
    for f in range(nf):
        idx = leaf * nb + bins[f]
        for c, w in enumerate((grad, hess, None)):
            hist[:, f, :, c] = torch.bincount(
                idx, weights=w, minlength=nl * nb).reshape(nl, nb)
    node_hist = [None] * (nl - 1)
    sums = torch.zeros((nl - 1, 2, 3), **f64)       # [node, side, (g,h,c)]
    leaf_sums = torch.stack([g, h, cnt], 1)

    def side(c):
        return (node_hist[c], sums[c].sum(0)) if c >= 0 else \
            (hist[~c], leaf_sums[~c])

    for i in range(nl - 2, -1, -1):
        (hl, sl), (hr, sr) = side(lc[i]), side(rc[i])
        node_hist[i] = hl + hr
        sums[i, 0], sums[i, 1] = sl, sr
    gl, hl_, gr, hr_ = sums[:, 0, 0], sums[:, 0, 1], sums[:, 1, 0], sums[:, 1, 1]
    gain_ref = (leaf_split_gain(gl, hl_, l1, l2) + leaf_split_gain(gr, hr_, l1, l2)
                - leaf_split_gain(gl + gr, hl_ + hr_, l1, l2))
    gain = torch.as_tensor(np.asarray(tree["split_gain"][:nl - 1],
                                      dtype=np.float64), **f64)
    out["split_gain_gap"] = _rel_gap(gain, gain_ref)
    out["root_gain_gap"] = float((gain[0] - gain_ref[0]).abs()
                                 / gain_ref[0].abs().clamp_min(1e-300))
    # the best candidate split of every node over the reference's bins
    nh = torch.stack(node_hist)                      # [nodes, F, B, 3]
    left = nh.cumsum(2)[:, :, :-1]
    tot = nh.sum(2, keepdim=True)
    right = tot - left
    # a candidate counts only where it clears the limits with room: the
    # program tests them in f32
    hess_floor = min_hess * (1.0 + HESS_ROOM) + HESS_ROOM
    valid = ((left[..., 2] >= min_data) & (right[..., 2] >= min_data)
             & (left[..., 1] >= hess_floor) & (right[..., 1] >= hess_floor))
    gains = (leaf_split_gain(left[..., 0], left[..., 1], l1, l2)
             + leaf_split_gain(right[..., 0], right[..., 1], l1, l2)
             - leaf_split_gain(tot[..., 0], tot[..., 1], l1, l2))
    best = torch.where(valid, gains, -torch.inf).flatten(1).amax(1)
    has = torch.isfinite(best) & (best > 0)
    short = torch.where(has, (best - gain_ref) / best.clamp_min(1e-300), 0.0)
    out["gain_shortfall"] = float(short.max()) if has.any() else 0.0
    return out
