"""Observability helpers (counterpart of nanosnp_tpu/utils/profiling.py):
stage wall/throughput metrics flow through runtime/pipeline.py, and
device-level traces come from torch.profiler, enabled per run with
NSP_PROFILE_DIR=/path (one Chrome trace per stage, viewable in
chrome://tracing or Perfetto)."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

from ..models.convert import flatten_tree


@contextlib.contextmanager
def maybe_profile(name: str) -> Iterator[None]:
    """torch.profiler trace of this block (host, and the card when there
    is one) when NSP_PROFILE_DIR is set: `<dir>/<name>.trace.json`."""
    trace_dir = os.environ.get("NSP_PROFILE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.trace.json"))


class StageTimer:
    """Accumulates named wall-time spans and item counts."""

    def __init__(self):
        self.spans: Dict[str, float] = {}
        self.items: Dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str, items: int = 0):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + time.monotonic() - t0
            if items:
                self.items[name] = self.items.get(name, 0) + items

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, sec in self.spans.items():
            entry = {"seconds": round(sec, 3)}
            if name in self.items and sec > 0:
                entry["items_per_s"] = round(self.items[name] / sec, 1)
            out[name] = entry
        return out


def count_parameters(params) -> int:
    """Total parameter count of a parameter tree (nested dicts and lists of
    tensors or arrays; the reference's utils.count_parameters analog)."""
    total = 0
    for _, leaf in flatten_tree(params):
        n = 1
        for d in leaf.shape:
            n *= int(d)
        total += n
    return total
