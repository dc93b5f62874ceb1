"""Scoring a forest of model text over raw rows: each row's leaf in
every tree by LightGBM's rule (value <= threshold goes left), leaf values
summed in boosting order, then the binary objective's probability.  The
sums run in f64, as LightGBM's predictor's; dtype=float32 is the
lower-precision control."""

from __future__ import annotations

import torch

from . import binary, model_text, trees as rtrees


def probabilities(text: str, x: torch.Tensor,
                  dtype: torch.dtype = torch.float64) -> torch.Tensor:
    header, forest = model_text.parse(text)
    raw = torch.zeros(x.shape[0], dtype=dtype, device=x.device)
    for t in forest:
        leaf = rtrees.route(x, t)
        lv = torch.as_tensor(t["leaf_value"], device=x.device).to(dtype)
        raw += lv[leaf]
    sig = float(header.get("sigmoid", "1"))
    return binary.probability(raw, sig).to(dtype)
