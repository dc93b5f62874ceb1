"""Binary log-loss (LightGBM's BinaryLogloss with sigmoid s): per row,
with sign = +1 for label 1 and -1 for 0,
    r = -2 sign s / (1 + exp(2 sign s score)),  grad = r,
    hess = |r| (2 s - |r|);
and the score's probability 1 / (1 + exp(-2 s raw))."""

from __future__ import annotations

import torch


def gradients(score: torch.Tensor, y: torch.Tensor, group, params: dict):
    """(grad, hess) f64 of f64 scores."""
    s = float(params.get("sigmoid", 1.0))
    sign = y.to(torch.float64) * 2.0 - 1.0
    r = -2.0 * sign * s / (1.0 + torch.exp(2.0 * sign * s * score))
    a = r.abs()
    return r, a * (2.0 * s - a)


def probability(raw: torch.Tensor, sigmoid: float) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-2.0 * sigmoid * raw))
