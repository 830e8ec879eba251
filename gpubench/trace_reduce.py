"""From a torch.profiler trace of the window to what the per-layer metrics
read: the device's busy intervals (the union over streams of kernel, copy
and set intervals, so that overlapping streams count once), the device
time of each kernel name, the window's span, and the host's events.

The profile is saved as a Chrome trace straight from the profiler's
result and read back: that format is the same in every torch version,
and it skips the per-event Python objects that leaving a
torch.profiler.profile builds, which take minutes for a training
window's million kernels. Times are microseconds in the trace and
seconds here.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

WINDOW_SPAN = "gpubench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


def start_profiler(cuda: bool) -> None:
    from torch.autograd import profiler

    profiler.profile(use_device="cuda" if cuda else None,
                     use_kineto=True).__enter__()


def union(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """Merged, sorted, non-overlapping intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Reduced:
    """The window's trace: device events [(name, start, end)], host events
    [(name, start, end)], the window (start, end); seconds."""

    def __init__(self, device: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]],
                 window: Tuple[float, float]):
        self.window = window
        lo, hi = window
        self.device = [(n, max(s, lo), min(e, hi)) for n, s, e in device
                       if e > lo and s < hi]
        self.host = host
        self.busy = union((s, e) for _, s, e in self.device)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def idle_share(self) -> float:
        """Per cent of the window in which no device interval ran."""
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_seconds(self, names: Iterable[str]) -> Tuple[float, int]:
        """(device seconds, launches) of the events whose name contains
        one of `names` (a kernel's name as written in its source)."""
        names = tuple(names)
        t, n = 0.0, 0
        for name, s, e in self.device:
            if any(k in name for k in names):
                t += e - s
                n += 1
        return t, n

    def top_ops(self, k: int) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[short(n), t] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int) -> List[list]:
        """The k longest device-idle gaps in the window, each named by the
        innermost host event that covers its middle."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:k]:
            mid = (s + e) / 2
            cover = [(he - hs, n) for n, hs, he in self.host
                     if hs <= mid <= he and n != WINDOW_SPAN]
            name = min(cover)[1] if cover else "no host event"
            out.append([short(name), e - s])
        return out


def short(name: str, n: int = 160) -> str:
    return name if len(name) <= n else name[:n]


def reduce_events(events: List[dict]) -> Reduced:
    """Chrome-trace events -> Reduced. The window is the harness's own
    WINDOW_SPAN annotation."""
    device, host = [], []
    window: Optional[Tuple[float, float]] = None
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        name = ev.get("name", "")
        if cat in DEVICE_CATS:
            device.append((name, s, e))
        elif cat in HOST_CATS:
            host.append((name, s, e))
            if name == WINDOW_SPAN and cat == "user_annotation":
                window = (s, e)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    return Reduced(device, host, window)


def stop_profiler(cuda: bool, workdir: str) -> Reduced:
    """Stop the profiler that start_profiler started and reduce its
    trace."""
    import torch

    if cuda:
        torch.cuda.synchronize()
    path = os.path.join(workdir, "trace.json")
    torch.autograd._disable_profiler().save(path)
    try:
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return reduce_events(data["traceEvents"])
