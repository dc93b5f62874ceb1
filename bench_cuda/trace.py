"""Reading a torch.profiler trace of a short window on the card.

`traced(fn)` runs fn under the profiler with CUDA activity only and
returns a summary: the window's host-clock length (ending at a
synchronize), the device's busy seconds (the union of the intervals in
which a kernel, copy or fill ran), each device operation's count and
seconds by name, and the longest idle gaps.  The raw kineto events are
read directly: building the profiler's FunctionEvent tree for the
hundreds of thousands of kernels a traced window holds takes longer than
the window.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple


def _raw_events(prof) -> list:
    """(name, start_ns, end_ns) of every device-side event."""
    import torch
    out = []
    res = getattr(prof.profiler, "kineto_results", None)
    if res is not None:
        for e in res.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                s = int(e.start_ns())
                out.append((e.name(), s, s + int(e.duration_ns())))
        return out
    for e in prof.events():     # older profilers: the parsed events
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, int(e.time_range.start * 1000),
                        int(e.time_range.end * 1000)))
    return out


def summarize(events: List[Tuple[str, int, int]], window_s: float,
              top: int = 10) -> dict:
    """busy_s (union of device intervals), ops {name: [count, seconds]},
    the `top` longest idle gaps [[after-op name, seconds]], and the
    window."""
    ops: Dict[str, List[float]] = {}
    for name, s, e in events:
        rec = ops.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (e - s) / 1e9
    busy_ns = 0
    gaps = []
    cur_s = cur_e = None
    last_name = ""
    for name, s, e in sorted(events, key=lambda t: t[1]):
        if cur_e is None:
            cur_s, cur_e, last_name = s, e, name
            continue
        if s > cur_e:
            busy_ns += cur_e - cur_s
            gaps.append(("after " + last_name[:80], (s - cur_e) / 1e9))
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
        if e >= cur_e:
            last_name = name
    if cur_e is not None:
        busy_ns += cur_e - cur_s
    gaps.sort(key=lambda g: -g[1])
    return {"window_s": window_s, "busy_s": busy_ns / 1e9, "ops": ops,
            "gaps": [[n, s] for n, s in gaps[:top]],
            "events": len(events)}


def traced(fn: Callable[[], object]) -> Tuple[object, dict]:
    """fn() under torch.profiler (CUDA activity), timed by the host clock
    from a synchronize before to a synchronize after."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return out, summarize(_raw_events(prof), window_s)


def breakdown(summary: dict, top: int = 10) -> dict:
    """The result line's breakdown: the device operations that took most
    time and the longest idle gaps, by the operation they followed."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1][1])[:top]
    return {"device_ops": [[name[:120], secs] for name, (_, secs) in ops],
            "idle_gaps": summary["gaps"][:top]}


def seconds_matching(summary: dict, pred: Callable[[str], bool]) -> Tuple[int, float]:
    """(count, seconds) of the device operations whose name satisfies
    pred."""
    n, s = 0, 0.0
    for name, (cnt, secs) in summary["ops"].items():
        if pred(name):
            n += cnt
            s += secs
    return n, s


def idle_pct(summary) -> "float | None":
    """The traced window's share with no device operation running, %."""
    if not summary or summary.get("busy_s") is None or not summary.get("window_s"):
        return None
    return (1.0 - summary["busy_s"] / summary["window_s"]) * 100.0
