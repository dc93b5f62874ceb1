"""`correct` comes out false when the timed path is broken underneath, and
for the lower-precision control; true for the program as it is.  On the
CPU at sizes a test run holds: the harness's look for a card is skipped
(a CPU context), the rest of a run is driven as on the card."""

from __future__ import annotations

import pytest

from bench_cuda import faults, harness, spec

SEED = 3_000_000_019    # beyond 32 signed bits


TRAIN_FAULTS = faults.BY_KIND["train"]


@pytest.mark.parametrize("workload", ["higgs.train", "mslr.rank"])
def test_training_sound_run_is_correct(small_ctx, bench_spec, workload):
    out, _ = harness.run_cell(bench_spec, small_ctx(workload, SEED))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("workload", ["higgs.train", "mslr.rank"])
@pytest.mark.parametrize("fault", TRAIN_FAULTS, ids=lambda f: f.__name__)
def test_training_fault_is_caught(small_ctx, bench_spec, workload, fault):
    out, _ = harness.run_cell(bench_spec, small_ctx(workload, SEED, tamper=fault))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", ["higgs.train", "mslr.rank"])
@pytest.mark.parametrize("binning", [{"max_bin": 63},
                                     {"bin_construct_sample_cnt": 2_000},
                                     {"data_random_seed": 7}],
                         ids=["coarse", "sample_size", "sample_rows"])
def test_binning_fault_is_caught(small_ctx, bench_spec, workload, binning):
    """The program bins otherwise than the configuration states (fewer
    bins, or bounds from another sample): the reference's own bounds
    catch it."""
    ctx = small_ctx(workload, SEED)
    ctx.params_extra = dict(ctx.params_extra, **binning)
    out, notes = harness.run_cell(bench_spec, ctx)
    assert not out["correct"], out["checks"]
    assert out["checks"]["thresholds_off_bins"]["value"] > 0


@pytest.mark.parametrize("workload", ["higgs.train", "mslr.rank",
                                      "higgs.predict"])
def test_control_fails(small_ctx, bench_spec, workload):
    """The cell's lower-precision control (the job module's control():
    bf16 histogram operands in training, the reference in f32 in
    scoring)."""
    ctx = small_ctx(workload, SEED)
    spec.job_module(ctx.traffic["kind"]).control(ctx)
    if ctx.traffic["kind"] == "train":
        # the plain versions of the kernels carry hist_acc on the CPU
        ctx.params_extra["hist_impl"] = "cuda"
    out, _ = harness.run_cell(bench_spec, ctx)
    assert not out["correct"], out["checks"]


# -- scoring ------------------------------------------------------------------

@pytest.mark.parametrize("fault", faults.BY_KIND["score"],
                         ids=lambda f: f.__name__)
def test_scoring_fault_is_caught(small_ctx, bench_spec, fault):
    out, _ = harness.run_cell(bench_spec, small_ctx("higgs.predict", SEED,
                                                 tamper=fault))
    assert not out["correct"], out["checks"]
