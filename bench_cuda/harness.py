"""One run of one cell: `python -m bench_cuda --workload <name> --seed <n>
--seconds <s> --trace <0|1>`, from the root of a checkout.

The run makes its inputs from the seed, sets up and warms up the
program (lightgbm_tpu_torch) on the card, measures for `seconds`, then
checks what the timed path produced against the plain reference
(bench_cuda/reference/) and prints one JSON line last on standard
output.  With --trace 0 the line holds the cell's end-to-end metrics;
with --trace 1 its per-layer metrics, the traced window's device busy
and window seconds, and a breakdown.  The numbers `correct` compares are
printed beside their limits as the last lines on standard error and
under "checks", the line's last key.

A run exits non-zero and prints no result when there is no card or
fewer cards than the cell asks for, when the program cannot be imported,
or when jax, jaxlib, flax or the JAX package are loaded once the window
has closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
from typing import Callable, Dict, Optional, Tuple

from . import spec as specmod
from .peaks import card_line

#: modules the process may not hold (top-level names compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "lightgbm_tpu")
CACHE = specmod.PKG / ".cache"


def process_start() -> float:
    """perf_counter's reading at this process's start (Linux /proc; the
    harness's import time elsewhere)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        if 0.0 <= age < 600.0:
            return now - age
    except (OSError, ValueError, IndexError):
        pass
    return now


T0 = process_start()


def set_cache_env() -> None:
    """A fixed Triton cache directory inside the checkout (the port's
    kernel library builds into lightgbm_tpu_torch/_build, also inside
    it), and no Flax through libraries that load it on their own."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(modules=None) -> list:
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".")[0] in FORBIDDEN)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Context:
    """What a job needs: the cell, its files, the run's arguments, and,
    for the harness's own tests, a device other than the card, size
    overrides, extra program parameters and a hook that breaks the
    program under the timed path."""
    cell: specmod.Cell
    cfg: dict
    traffic: dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t0: float = T0
    params_extra: dict = dataclasses.field(default_factory=dict)
    tamper: Optional[Callable[[object], None]] = None

    @property
    def on_card(self) -> bool:
        return self.device == "cuda"

    def sync(self) -> None:
        if self.on_card:
            import torch
            torch.cuda.synchronize()


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(every limited number within its limit, {name: {value, limit}} of
    the limited numbers).  A limit without a number fails; a number
    without a limit is a reading, printed but not compared."""
    checks = {}
    ok = True
    for name in sorted(limits):
        v, lim = numbers.get(name), limits[name]
        checks[name] = {"value": v, "limit": lim}
        if v is None or not (v <= lim):
            ok = False
    return ok, checks


def run_cell(sp: specmod.Spec, ctx: Context) -> Tuple[dict, dict]:
    """Runs the cell's job: (the result's fields, notes: the readings not
    compared and the phases' seconds, for standard error)."""
    job = specmod.job_module(ctx.traffic["kind"])
    res = job.run(ctx)
    correct, checks = judge(res["numbers"], ctx.limits)
    metrics = {}
    if ctx.trace:
        rec = res["record"]
        for m in sp.metrics_for(ctx.cell.name, trace=True):
            v = sp.reader(m.name)(rec)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    else:
        vals = dict(res["end_to_end"], setup_s=res["setup_s"])
        for m in sp.metrics_for(ctx.cell.name, trace=False):
            if m.name not in vals:
                raise RuntimeError("the %s job gives no %s" %
                                   (ctx.traffic["kind"], m.name))
            metrics[m.name] = {"value": vals[m.name], "unit": m.unit}
    device = {"platform": "gpu" if ctx.on_card else "cpu",
              "kind": res["device_kind"], "count": ctx.cell.chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": bool(correct and res["failed"] == 0),
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device}
    if ctx.trace:
        tr = res["record"]["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        from .trace import breakdown
        out["breakdown"] = breakdown(tr)
    out["checks"] = checks
    notes = {"readings": {k: v for k, v in res["numbers"].items()
                          if k not in checks},
             "phases": res.get("phases", {})}
    return out, notes


def context_for(sp: specmod.Spec, workload: str, seed: int, seconds: float,
                trace: bool, **kw) -> Context:
    cell = sp.cell(workload)
    return Context(cell=cell, cfg=sp.config(cell.config),
                   traffic=sp.traffic(cell.traffic),
                   limits=sp.limits(workload), seed=seed, seconds=seconds,
                   trace=trace, **kw)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m bench_cuda")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    set_cache_env()
    sp = specmod.Spec.load()
    cell = sp.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        log("bench_cuda: no CUDA device; this benchmark runs on the card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log("bench_cuda: %s needs %d cards, %d present"
            % (cell.name, cell.chips, torch.cuda.device_count()))
        return 2
    log("bench_cuda: %s seed %d, %s s, trace %d on %s"
        % (cell.name, args.seed, args.seconds, args.trace, card_line()))
    ctx = context_for(sp, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    out, notes = run_cell(sp, ctx)
    gc.collect()
    found = forbidden_modules()
    if found:
        log("bench_cuda: the process holds %s once the window has closed"
            % ", ".join(found))
        return 3
    log("phases " + " ".join("%s=%.1fs" % kv
                             for kv in notes["phases"].items()))
    for name, v in sorted(notes["readings"].items()):
        log("reading %s = %r (not compared)" % (name, v))
    for name, c in out["checks"].items():
        log("check %s = %r (limit %r)" % (name, c["value"], c["limit"]))
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
