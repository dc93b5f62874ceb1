"""The benchmark's description, read from BENCHMARK.json and the data files
under bench_cuda/ that its names point to.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by name:

  configs/<config>.json        sizes, the program's parameters, the data
                               generator and the plain reference it uses
  traffic/<traffic>.json       the job's parameters; its "kind" names the
                               driver module jobs/<kind>.py
  limits/<workload>.json       the limits of the numbers `correct` compares
  layer_metrics/<metric>.py    one reader per per-layer metric

A later change adds a cell, a configuration or a metric by adding such
files and entries to BENCHMARK.json; no file here needs an edit.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    workloads: Optional[List[str]]

    def applies_to(self, workload: str) -> bool:
        return self.workloads is None or workload in self.workloads


@dataclasses.dataclass
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    why: str


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """BENCHMARK.json and the files it names."""

    def __init__(self, doc: dict, pkg: Path = PKG):
        self.doc = doc
        self.pkg = pkg
        self.cells = {w["name"]: Cell(w["name"], w["config"], w["traffic"],
                                      int(w["chips"]), w["why"])
                      for w in doc["workloads"]}
        self.config_files = {c["name"]: c["file"] for c in doc["configs"]}
        self.end_to_end = [self._metric(m) for m in doc["end_to_end"]]
        self.per_layer = [self._metric(m) for m in doc["per_layer"]]

    @staticmethod
    def _metric(m: dict) -> Metric:
        return Metric(m["name"], m["unit"], m.get("workloads"))

    @classmethod
    def load(cls, root: Path = ROOT) -> "Spec":
        return cls(_load_json(root / "BENCHMARK.json"))

    def cell(self, name: str) -> Cell:
        if name not in self.cells:
            raise KeyError("no workload %r in BENCHMARK.json (have %s)"
                           % (name, ", ".join(sorted(self.cells))))
        return self.cells[name]

    def config(self, name: str) -> dict:
        return _load_json(self.pkg.parent / self.config_files[name])

    def traffic(self, name: str) -> dict:
        return _load_json(self.pkg / "traffic" / (name + ".json"))

    def limits(self, workload: str) -> Dict[str, float]:
        return _load_json(self.pkg / "limits" / (workload + ".json"))

    def metrics_for(self, workload: str, trace: bool) -> List[Metric]:
        """The cell's end-to-end metrics (trace off) or its per-layer
        metrics (trace on)."""
        pool = self.per_layer if trace else self.end_to_end
        return [m for m in pool if m.applies_to(workload)]

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        """The per-layer metric's reader, layer_metrics/<metric>.py's
        read(record) -> float | None."""
        return load_file_module(self.pkg / "layer_metrics" / (metric + ".py"),
                                "bench_cuda_metric_" + metric).read


def load_file_module(path: Path, modname: str):
    """A module from a file whose name need not be an identifier (metric
    names hold dots)."""
    spec = importlib.util.spec_from_file_location(
        modname.replace(".", "_").replace("-", "_"), path)
    if spec is None or spec.loader is None:
        raise ImportError("cannot load %s" % path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def job_module(kind: str):
    """jobs/<kind>.py: run(ctx) drives one cell of that traffic kind."""
    return importlib.import_module("bench_cuda.jobs." + kind)


def data_module(name: str):
    """datagen/<name>.py: the generator a configuration names."""
    return importlib.import_module("bench_cuda.datagen." + name)


def reference_module(name: str):
    """reference/<name>.py: the configuration's plain reference."""
    return importlib.import_module("bench_cuda.reference." + name)
