"""Tracing of the port (counterpart of nanosnp_tpu/utils/profiling.py): the
program's own spans and counters, and the operator's per-stage trace.

Recorder. `span(name)` records a block's name, start, end, thread and
parent span in memory; `count(name, n)` adds n to a counter; `snapshot()`
returns both. The clock is time.time_ns: a torch.profiler Chrome trace
puts an event at ts (us) + baseTimeNanoseconds on the system clock (its
steady clock mapped onto the system clock's readings at the profile's
start and end), so the recorder's times and the trace's share one clock.
A steady clock anchored once to the system clock would not: while the
system clock is slewed (by up to 500 ppm), the two part by up to 0.5 ms
a second. At most CAP spans are kept; the rest are counted as dropped.

Session gate. Tracing is on for the length of a session, and only when
a torch profiler records: the entry points (`Trainer.fit`, the s2 and s5
stages, each stage of `Pipeline.run`) open a `session`, which turns
tracing on if a profiler is enabled on the thread that opens it. A
session nested in another follows the outer one. A session that turns
tracing on after one that ran with it off (or first in the process)
drops what the recorder held: back-to-back sessions under one profiler
add up, and a traced run's first session starts afresh. Off, a span is one flag check that returns a shared no-op context, and
`count` returns at once.

Thread rule. A profiler records only the thread that started it (its
enabled flag is thread-local too). A span on that thread also enters
torch.profiler.record_function, so it lands in the trace as a
`user_annotation` event; spans on worker threads (the s5 loader, s2's
device worker and decode pool) read the module's flag and live only in
the recorder, with the open session's root as their parent.
`maybe_profile` writes those into the trace it exports.

No span opens inside a step function or anything captured into a CUDA
graph: a replay runs no Python.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

from ..models.convert import flatten_tree

CAP = 100_000                     # spans kept in memory

_on = False
_root: Optional[int] = None       # the open session's root span
_depth = 0                        # sessions open
_last_on = False                  # tracing was on in the last session
_spans: List[tuple] = []          # (id, name, start, end, thread, parent)
_threads: Dict[int, str] = {}     # native thread id -> thread name
_counters: Dict[str, int] = {}
_dropped = 0
_ids = itertools.count()
_lock = threading.Lock()
_local = threading.local()


class _Off:
    """The span of tracing off: enters and leaves, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Span:
    __slots__ = ("name", "id", "parent", "start", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else _root
        self.id = next(_ids)
        stack.append(self.id)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        end = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack().pop()
        tid = threading.get_native_id()
        if len(_spans) < CAP:
            _spans.append((self.id, self.name, self.start, end, tid,
                           self.parent))
            if tid not in _threads:
                _threads[tid] = threading.current_thread().name
        else:
            with _lock:
                _dropped += 1
        return False


def span(name: str):
    """A context manager that records the block as span `name` while
    tracing is on."""
    return _Span(name) if _on else _OFF


def count(name: str, n: int) -> None:
    """Adds n to counter `name` while tracing is on."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def _clear() -> None:
    """Drops every span and counter the recorder holds."""
    global _dropped
    with _lock:
        _spans.clear()
        _threads.clear()
        _counters.clear()
        _dropped = 0


@contextlib.contextmanager
def session(name: str) -> Iterator[None]:
    """An entry point's block, recorded as its root span `name`; the
    outermost session turns tracing on if a profiler records on this
    thread (module docstring)."""
    global _on, _root, _depth, _last_on
    if _depth == 0:
        _on = torch.autograd._profiler_enabled()
        if _on and not _last_on:
            _clear()
    _depth += 1
    outer = _root
    try:
        with span(name) as root:
            _root = None if root is None else root.id
            yield
    finally:
        _root = outer
        _depth -= 1
        if _depth == 0:
            _last_on, _on = _on, False


def snapshot() -> dict:
    """What the recorder holds: `spans` (dicts: id, name, start_ns and
    end_ns (time.time_ns, the trace's clock), thread (native id),
    thread_name, parent id or None, self_ns: the duration less that of
    its children on its own thread), `counters`, `dropped`."""
    with _lock:
        spans = list(_spans)
        threads = dict(_threads)
        counters = dict(_counters)
        dropped = _dropped
    child: Dict[int, int] = {}
    thread_of = {s[0]: s[4] for s in spans}
    for sid, _, start, end, tid, parent in spans:
        if parent is not None and thread_of.get(parent) == tid:
            child[parent] = child.get(parent, 0) + end - start
    return {"spans": [dict(id=sid, name=name, start_ns=start, end_ns=end,
                           thread=tid,
                           thread_name=threads.get(tid, ""), parent=parent,
                           self_ns=end - start - child.get(sid, 0))
                      for sid, name, start, end, tid, parent in spans],
            "counters": counters, "dropped": dropped}


def _add_thread_spans(path: str, lo_ns: int, hi_ns: int, seen: int) -> int:
    """Writes the recorder's spans from threads other than `seen` (the
    profiler's, whose spans the trace holds already) that lie between
    lo_ns and hi_ns (time.time_ns) into the Chrome trace at `path`, on
    its clock, as `user_annotation` events. -> the number written."""
    with open(path) as f:
        data = json.load(f)
    base = int(data.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events, tids = [], {}
    for s in snapshot()["spans"]:
        if s["thread"] == seen or s["end_ns"] < lo_ns or s["start_ns"] > hi_ns:
            continue
        tids[s["thread"]] = s["thread_name"]
        events.append({"ph": "X", "cat": "user_annotation", "name": s["name"],
                       "pid": pid, "tid": s["thread"],
                       "ts": (s["start_ns"] - base) / 1e3,
                       "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                       "args": {"nsp span": s["id"],
                                "nsp parent": s["parent"]}})
    events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": t,
                "args": {"name": n}} for t, n in tids.items()]
    data.setdefault("traceEvents", []).extend(events)
    with open(path, "w") as f:
        json.dump(data, f)
    return len(events) - len(tids)


@contextlib.contextmanager
def maybe_profile(name: str) -> Iterator[None]:
    """torch.profiler trace of this block (host, and the card when there
    is one) when NSP_PROFILE_DIR is set: `<dir>/<name>.trace.json`, with
    the recorder's spans of the threads the profiler did not see."""
    trace_dir = os.environ.get("NSP_PROFILE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    lo = time.time_ns()
    with profile(activities=activities) as prof:
        yield
    hi = time.time_ns()
    path = os.path.join(trace_dir, f"{name}.trace.json")
    prof.export_chrome_trace(path)
    _add_thread_spans(path, lo, hi, threading.get_native_id())


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
