"""On the card (marker `card`; skips elsewhere): every cell, at sizes a
test run holds, comes out correct, and its lower-precision control does
not.  Run them on the card with

    python -m pytest bench_cuda -m card
"""

from __future__ import annotations

import pytest

from bench_cuda import harness, spec
from bench_cuda.conftest import shrink

#: the cells' shapes at sizes a test run holds on one card
CARD = {
    "higgs": dict(rows=1_000_000, test_rows=100_000, num_trees=60,
                  forest={"trees": 100, "leaves": 255}, trace_iters=2),
    "mslr": dict(rows=240_000, queries=2_000, num_trees=40, trace_iters=1),
}
WORKLOADS = ["higgs.train", "mslr.rank", "higgs.predict"]


def _ctx(bench_spec, workload, seed, trace=False):
    ctx = harness.context_for(bench_spec, workload, seed, 2.0, trace)
    return shrink(ctx, CARD[ctx.cfg["name"]])


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_is_correct_on_card(card, bench_spec, workload):
    out, _ = harness.run_cell(bench_spec, _ctx(bench_spec, workload, 4_000_000_007,
                                            trace=True))
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert set(out["metrics"]) == {m.name for m in bench_spec.metrics_for(
        workload, trace=True)}


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_on_card(card, bench_spec, workload):
    ctx = _ctx(bench_spec, workload, 4_000_000_011)
    spec.job_module(ctx.traffic["kind"]).control(ctx)
    out, _ = harness.run_cell(bench_spec, ctx)
    assert not out["correct"], out["checks"]
