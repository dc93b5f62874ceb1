"""The benchmark's description, discovery by name, generators, byte
arithmetic, window statistics, the result line and the import rules;
on the CPU."""

from __future__ import annotations

import ast
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_cuda import harness, roofline, spec, trace
from bench_cuda.conftest import shrink
from bench_cuda.datagen import higgs, mslr
from bench_cuda.jobs import score as score_job, train as train_job
from bench_cuda.reference import binning as rbinning, trees as rtrees

PKG = spec.PKG
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _doc():
    return json.loads((spec.ROOT / "BENCHMARK.json").read_text())


# -- the description ----------------------------------------------------

def test_benchmark_json_keys_and_names():
    doc = _doc()
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert doc["paths"] == ["bench_cuda"]
    assert 1 <= doc["run_seconds"] <= 51
    names = [c["name"] for c in doc["configs"]] + \
        [w["name"] for w in doc["workloads"]] + \
        [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_cuda/") and (spec.ROOT / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["reduced"] == json.loads((spec.ROOT / c["file"]).read_text())["reduced"]
    used = {w["config"] for w in doc["workloads"]}
    assert used == {c["name"] for c in doc["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in doc["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    assert len(json.dumps(doc)) < 64 * 1024


def test_every_metric_is_reported_where_it_is_listed():
    doc = _doc()
    cells = {w["name"] for w in doc["workloads"]}
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in doc["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in cells:
        reported = [m for m in doc["end_to_end"]
                    if c in m.get("workloads", cells)]
        assert len(reported) >= 2, c
        assert any(c in m.get("workloads", cells) for m in doc["per_layer"])
    for m in doc["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and UNIT.match(m["unit"])
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        moves = e2e[m["moves"]]
        for c in m["workloads"]:
            assert c in moves.get("workloads", cells), (m["name"], c)
        assert (PKG / "layer_metrics" / (m["name"] + ".py")).is_file()
    assert any("mfu" in m["name"] for m in doc["per_layer"]
               if m["moves"] == "iter_ms")
    assert any("mfu" in m["name"] for m in doc["per_layer"]
               if m["moves"] == "predict_rows_per_s")


def test_each_cell_has_its_files(bench_spec):
    for name, cell in bench_spec.cells.items():
        cfg = bench_spec.config(cell.config)
        tr = bench_spec.traffic(cell.traffic)
        spec.job_module(tr["kind"])
        spec.data_module(cfg["data"])
        spec.reference_module(cfg["reference"])
        assert bench_spec.limits(name)


def test_added_files_are_found_by_name(tmp_path, bench_spec):
    """A cell, a configuration, a traffic mix and a per-layer metric that
    exist only as new files and entries are found; no file is edited."""
    pkg = tmp_path / "bench_cuda"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache"))
    cfg = json.loads((pkg / "configs" / "higgs.json").read_text())
    cfg["name"] = "higgs_small"
    (pkg / "configs" / "higgs_small.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "train_short.json").write_text(json.dumps(
        dict(json.loads((pkg / "traffic" / "train.json").read_text()),
             warmup_iters=3)))
    (pkg / "limits" / "higgs_small.train_short.json").write_text(
        (pkg / "limits" / "higgs.train.json").read_text())
    (pkg / "layer_metrics" / "trees_in_window.train.py").write_text(
        "def read(rec):\n    return float(len(rec['window']['trees']))\n")
    doc = _doc()
    doc["configs"].append(dict(doc["configs"][0], name="higgs_small",
                               file="bench_cuda/configs/higgs_small.json"))
    doc["workloads"].append(dict(doc["workloads"][0], name="higgs_small.train_short",
                                 config="higgs_small", traffic="train_short"))
    doc["per_layer"].append(dict(doc["per_layer"][0], name="trees_in_window.train",
                                 unit="trees", workloads=["higgs_small.train_short"]))
    for m in doc["end_to_end"]:
        if "workloads" in m and "higgs.train" in m["workloads"]:
            m["workloads"].append("higgs_small.train_short")
    sp = spec.Spec(doc, pkg=pkg)
    cell = sp.cell("higgs_small.train_short")
    assert sp.config(cell.config)["name"] == "higgs_small"
    assert sp.traffic(cell.traffic)["warmup_iters"] == 3
    assert sp.limits(cell.name) == bench_spec.limits("higgs.train")
    names = [m.name for m in sp.metrics_for(cell.name, trace=True)]
    assert "trees_in_window.train" in names
    assert sp.reader("trees_in_window.train")({"window": {"trees": [1, 2]}}) == 2.0
    # the new cell runs through the unchanged harness and its new reader
    ctx = harness.Context(cell=cell, cfg=sp.config(cell.config),
                          traffic=sp.traffic(cell.traffic),
                          limits=sp.limits(cell.name), seed=7, seconds=0.3,
                          trace=True, device="cpu")
    shrink(ctx, dict(rows=8_000, num_trees=12, trace_iters=1,
                     params={"num_leaves": 7}))
    out, _ = harness.run_cell(sp, ctx)
    assert out["metrics"]["trees_in_window.train"]["value"] >= 1


# -- generators -------------------------------------------------------------

def test_higgs_rows_shapes_and_seed():
    x, y = higgs.rows(1000, 28, 12_345_678_901, 0, "cpu")
    assert x.shape == (1000, 28) and x.dtype == torch.float32
    assert set(torch.unique(y).tolist()) == {0.0, 1.0}
    x2, y2 = higgs.rows(1000, 28, 12_345_678_901, 0, "cpu")
    assert torch.equal(x, x2) and torch.equal(y, y2)
    x3, _ = higgs.rows(1000, 28, 12_345_678_901, 1, "cpu")
    assert not torch.equal(x, x3)
    assert 0.4 < float(y.mean()) < 0.6


def test_mslr_query_lengths_and_labels(bench_spec):
    cfg = bench_spec.config("mslr")
    a = mslr.query_lengths(cfg, 3)
    b = mslr.query_lengths(cfg, 2 ** 31 + 5)
    assert len(a) == cfg["queries"] == 18_919
    assert int(a.sum()) == cfg["rows"] == 2_270_296
    assert int(a.max()) == cfg["longest_query"] == 1251 and int(a.min()) >= 1
    assert abs(a.mean() - 120.0) < 0.01
    # every seed: the same set of sizes in another order
    assert np.array_equal(np.sort(a), np.sort(b)) and not np.array_equal(a, b)
    # heavy-tailed: the mean well above the median, a long upper tail
    assert np.median(a) < 0.85 * a.mean() and np.percentile(a, 99) > 3 * a.mean()
    small = dict(cfg, rows=60_000, queries=500, longest_query=400)
    d = mslr.generate(small, 11, "cpu")
    assert d["x"].shape == (60_000, cfg["features"])
    assert int(d["group"].sum()) == 60_000
    shares = np.bincount(d["y"].numpy().astype(np.int64), minlength=5) / 60_000
    assert np.allclose(shares, cfg["label_shares"], atol=0.005)


# -- byte arithmetic ----------------------------------------------------------

def _tree3():
    # root splits 100 rows into leaf 0 (30) and node 1; node 1 splits into
    # leaf 1 (50) and leaf 2 (20)
    return {"num_leaves": 3, "left_child": np.array([~0, ~1]),
            "right_child": np.array([1, ~2]),
            "leaf_count": np.array([30, 50, 20])}


def test_subtree_and_smaller_child_rows():
    t = _tree3()
    assert roofline.subtree_counts(t["left_child"], t["right_child"],
                                   t["leaf_count"]).tolist() == [100, 70]
    # min(30, 70) + min(50, 20)
    assert roofline.smaller_child_rows(t["left_child"], t["right_child"],
                                       t["leaf_count"]) == 50


def test_sweep_bytes_by_hand():
    t = _tree3()
    # rows (100 + 50) x (F 4 + 8) + 3 sweeps x 4 x 16 bins x 12
    assert roofline.sweep_bytes([t], 100, 4, 16) == 150 * 12 + 3 * 4 * 16 * 12
    stump = {"num_leaves": 1, "left_child": np.array([], dtype=np.int64),
             "right_child": np.array([], dtype=np.int64),
             "leaf_count": np.array([100])}
    assert roofline.sweep_bytes([stump], 100, 4, 16) == 100 * 12 + 4 * 16 * 12
    assert roofline.iteration_row_bytes(10) == 10 * 20
    assert roofline.predict_bytes(10, 4, 3, 4) == 160 + 60 + 32 + 80


def test_roofline_readers_by_hand(bench_spec):
    t = _tree3()
    rec = {"shape": {"rows": 100, "features": 4, "max_bin": 16},
           "trace": {"trees": [t], "iters": 1, "busy_s": 0.5, "window_s": 2.0,
                     "ops": {"void (anonymous namespace)::sweep_kernel<0, true>(...)": [2, 1e-9],
                             "void at::native::reduce_kernel<512, 1>(...)": [5, 1.0],
                             "Memcpy DtoH": [1, 0.1]}},
           "window": {"trees": [t], "iters": 4, "seconds": 2.0,
                      "segments": [(0.5, 2, False), (1.5, 2, True)]}}
    nbytes = roofline.sweep_bytes([t], 100, 4, 16)
    got = bench_spec.reader("hist_roofline_pct.train")(rec)
    assert got == pytest.approx(nbytes / 3.35e12 / 1e-9 * 100)
    per_iter = nbytes + 100 * 20
    assert bench_spec.reader("iter_mfu.train")(rec) == pytest.approx(
        per_iter / 3.35e12 / 0.5 * 100)
    assert bench_spec.reader("kernels_per_iter.train")(rec) == 7
    assert bench_spec.reader("device_idle_pct.train")(rec) == pytest.approx(75.0)
    assert bench_spec.reader("enqueue_ms.train")(rec) == pytest.approx(250.0)
    assert bench_spec.reader("device_ms.predict")(
        {"trace": {"busy_s": 0.5}, "trace_rows": 250_000}) == pytest.approx(2000.0)
    rec["trace"]["ops"] = {}
    assert bench_spec.reader("hist_roofline_pct.train")(rec) is None


def test_busy_is_the_union_of_device_intervals():
    s = trace.summarize([("a", 0, 10), ("b", 5, 20), ("c", 30, 40)], 1e-7)
    assert s["busy_s"] == pytest.approx(30e-9)
    assert s["gaps"][0][1] == pytest.approx(10e-9)
    assert s["ops"]["b"] == [1, pytest.approx(15e-9)]


# -- window statistics: all the work over all the time ---------------------------

class _FakeBooster:
    """train_segment sleeps: 8 iterations a call, one call stalls."""

    def __init__(self, stall_at=2):
        self.iter = 0
        self.calls = 0
        self.stall_at = stall_at

    def train_segment(self, max_iters, is_eval=False):
        import time
        self.calls += 1
        time.sleep(0.2 if self.calls == self.stall_at else 0.01)
        k = min(8, max_iters)
        self.iter += k
        return False, k


def test_train_window_rate_counts_a_stall():
    run_ = train_job.Trainer(_FakeBooster())
    secs, iters, segs = train_job.window(run_, 40, lambda: None)
    per_call = [s[0] for s in segs]
    iter_ms = secs * 1e3 / iters
    # the fixed count of iterations, whatever their speed
    assert iters == 40 and len(segs) == 5
    # the mean over the whole window, stall included, not a median
    assert iter_ms == pytest.approx(sum(per_call) * 1e3 / iters, rel=0.05)
    assert iter_ms > 1.5 * statistics.median(per_call) * 1e3 / 8


@pytest.mark.parametrize("seconds,iters", [(51, 250), (25.5, 125), (0.1, 1)])
def test_train_window_is_a_fixed_count(seconds, iters):
    cfg = {"window_iters": 250, "window_seconds": 51}
    assert train_job.window_iters(cfg, seconds) == iters


def test_checked_trees_span_the_whole_window():
    picked = set()
    for seed in range(40):
        check = train_job.check_set(3_000_000_000 + seed, 17, 250, 6)
        assert check[0] == 0 and len(check) == 7
        assert all(17 <= t < 267 for t in check[1:])
        picked.update(check[1:])
    assert min(picked) < 30 and max(picked) > 250


def test_score_window_rate_counts_a_stall():
    import time
    calls = []

    def predict(x):
        calls.append(1)
        time.sleep(0.2 if len(calls) == 2 else 0.01)
        return np.zeros(len(x))

    secs, rows, outs = score_job.window(predict, [np.zeros((100, 2))] * 2,
                                        0.3, lambda: None)
    assert rows == 100 * len(outs) and secs >= 0.3
    assert rows / secs < 0.5 * 100 / 0.01


# -- the result line ---------------------------------------------------------------

def test_result_line_keys(small_ctx, bench_spec):
    out, _ = harness.run_cell(bench_spec, small_ctx("higgs.predict"))
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"predict_rows_per_s", "setup_s"}
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["checks"]["prob_gap"]["limit"] == bench_spec.limits(
        "higgs.predict")["prob_gap"]
    traced, _ = harness.run_cell(bench_spec, small_ctx("higgs.predict", trace=True))
    assert list(traced)[-1] == "checks" and "breakdown" in traced
    assert {"busy_s", "window_s"} <= set(traced["device"])
    json.dumps(traced)


def test_judge_needs_every_limit():
    assert harness.judge({"a": 1.0}, {"a": 1.0})[0]
    assert not harness.judge({"a": 1.1}, {"a": 1.0})[0]
    assert not harness.judge({"a": 1.0}, {"a": 1.0, "b": 0})[0]
    ok, checks = harness.judge({"a": 1.0, "r": 9.0}, {"a": 1.0})
    assert ok and list(checks) == ["a"]
    assert not harness.judge({"a": float("nan")}, {"a": 1.0})[0]


# -- import rules ------------------------------------------------------------------------

def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_forbidden_names_compare_whole():
    mods = {"lightgbm_tpu_torch": 1, "lightgbm_tpu_torch.api": 1,
            "jaxtyping": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"lightgbm_tpu.x": 1, "jax": 1, "flax.core": 1})
    assert harness.forbidden_modules(mods) == ["flax.core", "jax",
                                               "lightgbm_tpu.x"]


def test_no_module_imports_jax_or_the_jax_package():
    files = list(PKG.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in harness.FORBIDDEN, (f, name)


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "typing", "numpy", "torch", "math"}
    for f in (PKG / "reference").glob("*.py"):
        for name in _imports(f):
            assert name.split(".")[0] in allowed, (f, name)
    code = ("import sys, bench_cuda.reference.trees, bench_cuda.reference.score,"
            " bench_cuda.reference.binary, bench_cuda.reference.lambdarank;"
            " print(sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('lightgbm_tpu_torch', 'lightgbm_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_route_by_raw_thresholds():
    t = {"num_leaves": 3, "split_feature": np.array([0, 1]),
         "threshold": np.array([0.0, 1.5]), "left_child": np.array([~0, ~1]),
         "right_child": np.array([1, ~2])}
    x = torch.tensor([[-1.0, 9.0], [0.0, 0.0], [0.5, 1.5], [0.5, 2.0]])
    assert rtrees.route(x, t).tolist() == [0, 0, 1, 2]


# -- bin bounds by LightGBM's rule ---------------------------------------------

def test_bounds_of_few_values_are_midpoints():
    # the zero goes between the negatives and the positives, sampled or not
    got = rbinning.bounds(np.array([-2.0, -2.0, 1.0, 3.0]), 4, 255)
    assert got.tolist() == [-1.0, 0.5, 2.0, np.inf]
    # at an end only where zeros were sampled
    assert rbinning.bounds(np.array([1.0, 3.0]), 2, 255).tolist() == [2.0, np.inf]
    assert rbinning.bounds(np.array([1.0, 3.0, 0.0]), 3, 255).tolist() == [
        0.5, 2.0, np.inf]


def test_greedy_bounds_by_hand():
    # 12 distinct values, one each, in 4 bins: the mean 3 closes a bin at
    # every third value
    v = np.arange(1.0, 13.0)
    assert rbinning.bounds(v, 12, 4).tolist() == [3.5, 6.5, 9.5, np.inf]
    # 6 holds a third of the rows, over total / max_bin: a bin of its own.
    # The other 8 rows fill 3 bins of mean 8/3: 1-3 closes at 3 rows; then
    # the mean is 5/2, and 4-5 closes at 2 rows, half the mean or more,
    # because the next value is big; 6 is the third bin, and the last
    # takes the rest
    v = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 6.0, 6.0, 6.0, 7.0, 8.0, 9.0])
    assert rbinning.bounds(v, 12, 4).tolist() == [3.5, 5.5, 6.5, np.inf]


def test_sample_rows_is_mt19937_selection_sampling():
    rows = rbinning.sample_rows(1000, 50, 1)
    assert rows.size == 50 and np.all(np.diff(rows) > 0)
    assert rows.tolist() == rbinning.sample_rows(1000, 50, 1).tolist()
    assert rows.tolist() != rbinning.sample_rows(1000, 50, 2).tolist()
    assert rbinning.sample_rows(10, 50, 1).tolist() == list(range(10))


def test_thresholds_off_bins_counts_each_split():
    bounds = [np.array([0.5, 1.5, np.inf]), np.array([2.0, np.inf])]
    t = {"num_leaves": 4, "split_feature": np.array([0, 1, 0]),
         "threshold": np.array([1.5, 2.0, 0.7])}
    assert rtrees.thresholds_off_bins([t], bounds) == 1
    t["threshold"] = np.array([1.5, np.inf, 0.5])
    assert rtrees.thresholds_off_bins([t], bounds) == 1
