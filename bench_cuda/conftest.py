"""Fixtures of the benchmark's own tests (bench_cuda/pytest.ini registers
the `card` marker).  Whether a card is present is decided inside the
`card` fixture, never while a module is imported."""

from __future__ import annotations

import copy

import pytest

from bench_cuda import harness, spec


@pytest.fixture
def card():
    """Skips a test marked `card` where torch sees no CUDA device."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); run on the card: "
                    "python -m pytest bench_cuda -m card")
    return torch.device("cuda")


#: cell sizes a CPU test run holds: the configuration's shapes (widths,
#: objective, parameters) with fewer rows, trees and leaves, and a bin
#: sample smaller than the rows, as at full size
SMALL = {
    "higgs": dict(rows=20_000, test_rows=3_000, num_trees=40,
                  forest={"trees": 20, "leaves": 15}, trace_iters=3,
                  params={"num_leaves": 15, "bin_construct_sample_cnt": 5_000}),
    "mslr": dict(rows=6_000, queries=100, longest_query=200, num_trees=40,
                 features=12, trace_iters=2,
                 params={"num_leaves": 15, "bin_construct_sample_cnt": 3_000}),
}


def shrink(ctx: harness.Context, sizes: dict = None) -> harness.Context:
    sizes = copy.deepcopy(sizes or SMALL[ctx.cfg["name"]])
    params = sizes.pop("params", {})
    ctx.cfg.update(sizes)
    ctx.cfg["params"].update(params)
    return ctx


@pytest.fixture(scope="session")
def bench_spec():
    return spec.Spec.load()


@pytest.fixture
def small_ctx(bench_spec):
    """small_ctx(workload, seed, trace=False, **kw): a CPU context of the
    cell at SMALL's sizes, a 0.5 s window."""
    def make(workload, seed=20_260_101, trace=False, **kw):
        ctx = harness.context_for(bench_spec, workload, seed, 0.5, trace,
                                  device="cpu", **kw)
        return shrink(ctx)
    return make
