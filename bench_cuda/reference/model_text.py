"""LightGBM model text, parsed by the reference itself: the header's
sigmoid and each `Tree=` block's arrays (doubles by Python's correctly
rounded float())."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_INT = ("split_feature", "left_child", "right_child", "leaf_parent")
_FLOAT = ("threshold", "leaf_value", "split_gain", "internal_value")


def parse(text: str) -> Tuple[dict, List[dict]]:
    """(header {key: value string}, [tree dict])."""
    header: dict = {}
    trees: List[dict] = []
    cur = None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Tree="):
            cur = {}
            trees.append(cur)
            continue
        if line.startswith("feature importance"):
            cur = None
            continue
        if "=" not in line:
            continue
        key, val = line.split("=", 1)
        if cur is None:
            header[key] = val
        elif key == "num_leaves":
            cur[key] = int(val)
        elif key in _INT:
            cur[key] = np.asarray([int(v) for v in val.split()], dtype=np.int64)
        elif key in _FLOAT:
            cur[key] = np.asarray([float(v) for v in val.split()],
                                  dtype=np.float64)
    return header, trees
