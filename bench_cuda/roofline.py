"""The least bytes the training and scoring steps must move, worked out
from shapes and from the trees' own row counts, so they count the same
work whatever implements it.

A histogram sweep must read, for every row of the leaf it sweeps, the
row's bin of every feature (one byte each: max_bin <= 256) and its
gradient pair (two f32), and write the leaf's histogram once: per
(feature, bin) a gradient sum, a hessian sum and a count, four bytes
each.  A tree sweeps its root over every row and, at every split, the
smaller child (the larger one is the parent's histogram less the
smaller's), as LightGBM's learner does.  So a tree's sweep bytes are

    (N + sum over splits of min(left rows, right rows)) * (F + 8)
    + (1 + splits) * F * max_bin * 12.

An iteration adds one read of the scores and labels and one write of
the gradients and of the scores, 4 bytes each a row.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

GH_BYTES = 8            # a row's (grad, hess) pair in f32
HIST_CELL_BYTES = 12    # grad sum, hess sum, count


def subtree_counts(left: Sequence[int], right: Sequence[int],
                   leaf_count: Sequence[int]) -> np.ndarray:
    """Rows under each internal node of a LightGBM tree (children >= 0
    are nodes, < 0 are ~leaf), from its leaves' counts.  A child node
    is always numbered after its parent, so one pass from the last node
    back fills them."""
    left = np.asarray(left, dtype=np.int64)
    right = np.asarray(right, dtype=np.int64)
    lc = np.asarray(leaf_count, dtype=np.int64)
    cnt = np.zeros(len(left), dtype=np.int64)

    def side(c, i):
        return cnt[c[i]] if c[i] >= 0 else lc[~c[i]]

    for i in range(len(left) - 1, -1, -1):
        cnt[i] = side(left, i) + side(right, i)
    return cnt


def smaller_child_rows(left, right, leaf_count) -> int:
    """The sum over a tree's splits of its smaller child's rows."""
    left = np.asarray(left, dtype=np.int64)
    right = np.asarray(right, dtype=np.int64)
    lc = np.asarray(leaf_count, dtype=np.int64)
    cnt = subtree_counts(left, right, lc)

    def side(c):
        return np.where(c >= 0, cnt[np.maximum(c, 0)], lc[np.where(c < 0, ~c, 0)])

    if len(left) == 0:
        return 0
    return int(np.minimum(side(left), side(right)).sum())


def tree_sweep_bytes(num_rows: int, features: int, max_bin: int,
                     left, right, leaf_count) -> int:
    """A tree's least sweep bytes (module docstring)."""
    splits = len(left)
    rows = num_rows + smaller_child_rows(left, right, leaf_count)
    return (rows * (features + GH_BYTES)
            + (1 + splits) * features * max_bin * HIST_CELL_BYTES)


def sweep_bytes(trees: Iterable, num_rows: int, features: int,
                max_bin: int) -> int:
    """The least sweep bytes of a list of trees (dicts of num_leaves,
    left_child, right_child, leaf_count)."""
    total = 0
    for t in trees:
        nl = int(t["num_leaves"])
        total += tree_sweep_bytes(num_rows, features, max_bin,
                                  t["left_child"][:nl - 1],
                                  t["right_child"][:nl - 1],
                                  t["leaf_count"][:nl])
    return total


def iteration_row_bytes(num_rows: int) -> int:
    """An iteration's per-row state traffic: scores and labels read,
    gradient pairs and scores written."""
    return num_rows * (4 + 4 + GH_BYTES + 4)


def predict_bytes(rows: int, features: int, nodes: int, leaves: int) -> int:
    """Scoring's least bytes: every row's f32 features read once, the
    forest read once (a node's split feature, threshold as f64 and two
    children as i32; a leaf's value as f64) and every row's f64 score
    written once."""
    return rows * features * 4 + nodes * (4 + 8 + 4 + 4) + leaves * 8 + rows * 8
