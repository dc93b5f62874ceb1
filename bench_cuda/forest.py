"""A forest of the documented model's size in the LightGBM model-text
format, made from the seed without a training run.

Each tree grows leaf-wise to its leaf count: the leaf to split is drawn
in proportion to the share of rows it holds, the feature uniformly, and
the threshold at a quantile of the data inside the leaf's range on that
feature.  The generator's features are independent standard normals, so
a leaf's share of the rows is the product of its quantile widths and a
quantile u sits at the threshold ndtri(u).  Random numbers are drawn in
a few bulk calls; the loop only does the bookkeeping of the tree's
structure.  Node k is the k-th split; splitting leaf l keeps the left
child as leaf l and makes the right child leaf k + 1, LightGBM's layout.
"""

from __future__ import annotations

import numpy as np
import torch

from .datagen import torch_seed


def _tree(nl: int, nfeat: int, u_leaf, u_feat, u_cut, leaf_values):
    lo = np.zeros((nl, nfeat))
    hi = np.ones((nl, nfeat))
    share = np.zeros(nl)
    share[0] = 1.0
    sf = np.zeros(nl - 1, dtype=np.int64)
    q = np.zeros(nl - 1)
    lc = np.zeros(nl - 1, dtype=np.int64)
    rc = np.zeros(nl - 1, dtype=np.int64)
    leaf_parent = np.full(nl, -1, dtype=np.int64)
    for k in range(nl - 1):
        live = k + 1
        cum = np.cumsum(share[:live])
        leaf = min(int(np.searchsorted(cum, u_leaf[k] * cum[-1], side="right")),
                   live - 1)
        f = int(u_feat[k] * nfeat) % nfeat
        a, b = lo[leaf, f], hi[leaf, f]
        u = a + (b - a) * (0.2 + 0.6 * u_cut[k])
        new = k + 1
        lo[new], hi[new] = lo[leaf], hi[leaf]
        hi[leaf, f] = u
        lo[new, f] = u
        share[new] = share[leaf] * (b - u) / (b - a)
        share[leaf] = share[leaf] * (u - a) / (b - a)
        p = leaf_parent[leaf]
        if p >= 0:
            if lc[p] == ~leaf:
                lc[p] = k
            else:
                rc[p] = k
        sf[k], q[k] = f, u
        lc[k], rc[k] = ~leaf, ~new
        leaf_parent[leaf] = k
        leaf_parent[new] = k
    thr = torch.special.ndtri(torch.from_numpy(q)).numpy()
    return [
        "num_leaves=%d" % nl,
        "split_feature=" + " ".join(str(v) for v in sf),
        "split_gain=" + " ".join("1" for _ in sf),
        "threshold=" + " ".join("%g" % v for v in thr),
        "left_child=" + " ".join(str(v) for v in lc),
        "right_child=" + " ".join(str(v) for v in rc),
        "leaf_parent=" + " ".join(str(v) for v in leaf_parent),
        "leaf_value=" + " ".join("%g" % v for v in leaf_values),
        "internal_value=" + " ".join("0" for _ in sf),
        "",
    ]


def model_text(trees: int, leaves: int, features: int, seed: int) -> str:
    """The forest's model text: binary, sigmoid 1."""
    g = torch.Generator()
    g.manual_seed(torch_seed(seed, 3))
    u = torch.rand((3, trees, leaves - 1), generator=g,
                   dtype=torch.float64).numpy()
    lv = (torch.randn((trees, leaves), generator=g, dtype=torch.float64)
          * 0.05).numpy()
    out = ["gbdt", "num_class=1", "label_index=0",
           "max_feature_idx=%d" % (features - 1), "sigmoid=1",
           "objective=binary", ""]
    for t in range(trees):
        out.append("Tree=%d" % t)
        out += _tree(leaves, features, u[0, t], u[1, t], u[2, t], lv[t])
    out += ["feature importance:", ""]
    return "\n".join(out)
