"""HIGGS-like rows: 28 standard-normal features and a binary label from
x0 + 0.5 * x1 * x2 + 0.3 * noise > 0 (the formula of the repository's
JAX-era bench.py, make_data, rewritten here on a torch.Generator)."""

from __future__ import annotations

import torch

from . import torch_seed


def rows(n: int, features: int, seed: int, part: int, device) -> tuple:
    """(x [n, features] f32, y [n] f32) on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, part))
    x = torch.randn((n, features), generator=g, device=device)
    noise = torch.randn((n,), generator=g, device=device)
    y = ((x[:, 0] + 0.5 * x[:, 1] * x[:, 2] + 0.3 * noise) > 0)
    return x, y.to(torch.float32)


def generate(cfg: dict, seed: int, device) -> dict:
    """The training rows: {"x", "y", "group": None}."""
    x, y = rows(cfg["rows"], cfg["features"], seed, 0, device)
    return {"x": x, "y": y, "group": None}


def generate_test(cfg: dict, seed: int, device) -> dict:
    """The test rows, drawn apart from the training rows."""
    x, y = rows(cfg["test_rows"], cfg["features"], seed, 1, device)
    return {"x": x, "y": y}
