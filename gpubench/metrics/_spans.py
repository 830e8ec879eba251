"""What the readers of the program's spans and counters share.

A span of the port (nanosnp_tpu_torch/utils/profiling.py) opened on the
thread that runs the profiler lands in the trace as a `user_annotation`
event under its own name, so host and device times share the trace's
clock. Counters are read from the program's recorder, which the entry
point's session emptied when the traced window opened. A program without
the recorder, or a trace without the spans, reads None."""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from trace_reduce import union


def covered(a: List[Tuple[float, float]],
            b: List[Tuple[float, float]]) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    t, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            t += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return t


def idle_inside(ctx, names: Iterable[str]) -> Optional[float]:
    """Per cent of the traced window in which the device was idle while
    the main thread was inside one of the spans `names`; None where the
    trace holds none of them."""
    names = set(names)
    lo, hi = ctx.trace.window
    spans = union((max(s, lo), min(e, hi)) for n, s, e in ctx.trace.host
                  if n in names and e > lo and s < hi)
    if not spans:
        return None
    inside = sum(e - s for s, e in spans)
    return 100.0 * (inside - covered(spans, ctx.trace.busy)) \
        / ctx.trace.window_s


def counter(name: str) -> Optional[int]:
    """The program's counter `name` since the traced window's session
    opened; None where the program has no recorder or did not count."""
    try:
        from nanosnp_tpu_torch.utils import profiling
    except ImportError:
        return None
    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None:
        return None
    return snapshot()["counters"].get(name)


def per(name: str, ctx, key: str) -> Optional[float]:
    """Counter `name` over the window's `key` (its samples, or the rows
    that reached the model)."""
    n, d = counter(name), ctx.window.get(key)
    if not n or not d:
        return None
    return n / d
