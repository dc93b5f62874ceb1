"""Readings for the limits of `correct`: the numbers a cell's check
compares, over many seeds, for the program as it is (--mode sound), for
the cell's lower-precision control (--mode control, the job module's
control()) or with a fault planted (--mode fault:<name>,
bench_cuda/faults.py), at the cell's own size on the card.  One JSON line
per seed; the benchmark's own runs never run this.

    python -m bench_cuda.control --workload higgs.train --mode control \
        --seeds 11,12,13 --seconds 51
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from . import faults, harness, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bench_cuda.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True,
                    help="sound, control, or fault:<name> (bench_cuda/faults.py)")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    harness.set_cache_env()
    import torch
    if not torch.cuda.is_available():
        harness.log("bench_cuda.control: no CUDA device")
        return 2
    sp = spec.Spec.load()
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ctx = harness.context_for(sp, args.workload, seed, args.seconds,
                                  False, t0=t)
        if args.mode == "control":
            spec.job_module(ctx.traffic["kind"]).control(ctx)
        elif args.mode.startswith("fault:"):
            ctx.tamper = getattr(faults, args.mode.split(":", 1)[1])
        out, notes = harness.run_cell(sp, ctx)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "correct": out["correct"],
                          "wall_s": time.perf_counter() - t,
                          "metrics": out["metrics"],
                          "checks": out["checks"], **notes}), flush=True)
        del ctx, out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
