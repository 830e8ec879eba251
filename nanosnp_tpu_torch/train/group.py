"""Grouped training steps: `steps_per_call` same-shape batches run as one
group of sequential optimizer updates.

Counterpart of the JAX package's make_multi_step / _stack_batches
(nanosnp_tpu/train/train_pileup.py), which scan G stacked batches in one
XLA dispatch: G sequential updates, the same as G single steps. A group
here takes one of four routes, chosen from where it runs:

  the card, one process   the first full group of a batch shape runs its
                          steps eagerly (that builds the kernels and warms
                          cuBLAS on the side stream), the second is
                          captured as one torch.cuda.CUDAGraph of G whole
                          steps (forward, the training kernels and their
                          backward, the gradient, the optimizer chain) on
                          that side stream and replayed, and every later
                          full group of the shape is one replay;
  the card, several ranks the steps eagerly: the gradient average is a
                          gloo all_reduce through the host
                          (parallel/mesh.py), which no graph can hold;
  a partial group         (an epoch's or the data's end) its steps
                          eagerly, JAX's multi step at G = its length;
  the CPU                 every group eagerly: the path the tests hold
                          against the JAX package.

Groups of one step (`steps_per_call: 1`) are single eager steps. State
that a step moves in place outside the optimizer (the CatModel's
BatchNorm running statistics) is captured and replayed with the rest of
the step. Every route runs the same step function on the same static
buffers: the
batches stacked [G, ...] and the optimizer's scalar table [G, S]
(optim.Optimizer.scalar_table), filled on the card from pinned staging
buffers by non-blocking copies. A capture raises if it fails; nothing
falls back to eager steps.

A group's metrics come back as a `GroupMetrics` handle at once: on the
card the runner enqueues their copy into pinned host memory behind the
group's steps on the same stream, and the first read of the handle waits
for it. A caller that reads the handle of group k only after launching
group k+1 keeps the card busy while the host prepares group k+2
(`Trainer.run_group`).

A capture records and runs nothing, so the kernel wrappers' launch
counts (ops.bilstm.LAUNCHES, incremented in Python where a wrapper
launches) move while capturing and never on replay: the runner takes
back what a capture added and adds it at every replay of that graph.
"""
from __future__ import annotations

import time
from collections.abc import Mapping
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..ops.bilstm import LAUNCHES
from ..parallel.mesh import world
from ..utils.profiling import count, span
from .optim import Optimizer

# step(batch, row) -> metrics: one optimizer update from `batch` (a dict
# of device tensors) with `row` (a row of the scalar table on the device)
StepFn = Callable[[Dict[str, torch.Tensor], torch.Tensor],
                  Dict[str, torch.Tensor]]


class _Slot:
    """One batch shape's buffers: pinned staging and device buffers for
    G stacked batches and G rows of scalars (the same tensors on the
    CPU), and once captured its graph, the graph's stacked metrics and
    the launches its capture counted."""

    def __init__(self, like: Dict[str, np.ndarray], group: int,
                 n_scalars: int, dev: torch.device):
        cuda = dev.type == "cuda"

        def empty(shape, dtype):
            return torch.empty((group,) + tuple(shape), dtype=dtype,
                               pin_memory=cuda)

        self.host = {k: empty(v.shape, torch.from_numpy(v).dtype)
                     for k, v in like.items()}
        self.host["_table"] = empty((n_scalars,), torch.float32)
        self.dev = ({k: torch.empty_like(v, device=dev)
                     for k, v in self.host.items()} if cuda else self.host)
        self.copied: Optional[torch.cuda.Event] = None
        self.warm = False
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Dict[str, torch.Tensor] = {}
        self.launches: Dict[str, int] = {}


class GroupMetrics(Mapping):
    """The metrics of one group, each stacked [n, ...]: numpy arrays on
    the host, read through a mapping that `GroupRunner.run` returns as
    soon as the group is enqueued. On the card they are copied without
    blocking into pinned host memory of the handle's own behind the
    group's steps on the runner's stream (`done` records the copy's
    end), so no later group overwrites them however late they are read;
    on the CPU they are final when returned. The first read of any key
    waits for the copy (span `nsp.group.fetch`) and counts the group
    once: `nsp.group.deferred` where the runner had launched a later
    group by then, else `nsp.group.drained`."""

    def __init__(self, runner: "GroupRunner", out: Dict[str, torch.Tensor],
                 done: Optional[torch.cuda.Event] = None):
        self._runner, self._out, self._done = runner, out, done
        self._index = runner.launched
        self._arrays: Optional[Dict[str, np.ndarray]] = None

    def _host(self) -> Dict[str, np.ndarray]:
        if self._arrays is None:
            with span("nsp.group.fetch"):
                if self._done is not None:
                    self._done.synchronize()
                self._arrays = {k: v.numpy() for k, v in self._out.items()}
            count("nsp.group.deferred" if self._runner.launched > self._index
                  else "nsp.group.drained", 1)
        return self._arrays

    def __getitem__(self, key: str) -> np.ndarray:
        return self._host()[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._host())

    def __len__(self) -> int:
        return len(self._host())


class GroupRunner:
    """Runs groups of at most `group` same-shape batches through
    `step_fn`, G sequential updates of `state.opt_state` under `tx`, on
    `device`. `generator` (None without dropout) is registered with each
    graph, so that a replay advances it as G eager steps do.

    `steps` counts the steps each route ran: "graph" (replays), "eager"
    (full groups run eagerly), "partial" (partial groups); `graphs` holds
    one record a capture: the batch shape, its seconds, the bytes the
    graph's memory pool took, the launches of one replay; `launched` the
    groups run.

    While tracing is on (utils/profiling.py), a group is span
    `nsp.group.run`, in turn `nsp.group.stage` (staging) and `.launch`
    (the copies in, the replay or eager steps, a capture, the copy of
    the metrics out), and counter `nsp.h2d_bytes` adds the bytes staged;
    span `nsp.group.fetch` and counters `nsp.group.deferred` and
    `.drained` follow where the caller reads the metrics
    (`GroupMetrics`)."""

    def __init__(self, step_fn: StepFn, tx: Optimizer, state,
                 generator: Optional[torch.Generator], device: torch.device,
                 group: int):
        self.step_fn, self.tx, self.state = step_fn, tx, state
        self.generator, self.dev = generator, torch.device(device)
        self.group = max(int(group), 1)
        # the graph route: the card, one process, groups of two or more
        self.use_graphs = (self.dev.type == "cuda" and world() == 1
                           and self.group > 1)
        self.stream = (torch.cuda.Stream(self.dev) if self.use_graphs
                       else None)
        self.slots: Dict[tuple, _Slot] = {}
        self.steps = {"graph": 0, "eager": 0, "partial": 0}
        self.graphs: List[dict] = []
        self.launched = 0

    def run(self, batches: List[Dict[str, np.ndarray]],
            freeze_on: float = 0.0) -> GroupMetrics:
        """One group: the batches (host arrays of one shape) in order, the
        frozen leaves' updates scaled by 1 - freeze_on. -> the metrics of
        each step, stacked [n, ...] on the host, as a handle that returns
        before the card has run the group (`GroupMetrics`)."""
        with span("nsp.group.run"):
            n = len(batches)
            if not 1 <= n <= self.group:
                raise ValueError(f"a group holds 1 to {self.group} batches, "
                                 f"got {n}")
            self.launched += 1
            key = tuple((k, v.shape, v.dtype.str)
                        for k, v in sorted(batches[0].items()))
            slot = self.slots.get(key)
            if slot is None:
                slot = self.slots[key] = _Slot(batches[0], self.group,
                                               self.tx.n_scalars, self.dev)
            with span("nsp.group.stage"):
                self._stage(slot, batches, freeze_on)
            if self.dev.type == "cpu":
                with span("nsp.group.launch"):
                    out = GroupMetrics(self, self._steps(slot, n))
                self.steps["eager" if n == self.group else "partial"] += n
            else:
                out = self._on_card(slot, n)
            self.tx.advance(self.state.opt_state, n)
            return out

    def _stage(self, slot: _Slot, batches, freeze_on: float) -> None:
        """The group's batches and scalar rows into the slot's staging
        buffers, once the last copy out of them is done; counts the bytes
        the copies to the device move (`nsp.h2d_bytes`; on the CPU,
        where staging is the device buffer, the bytes they would)."""
        n = len(batches)
        if slot.copied is not None:
            slot.copied.synchronize()   # the last copy out of staging is done
        for k, t in slot.host.items():
            view = t.numpy()
            if k == "_table":
                view[:n] = self.tx.scalar_table(self.state.opt_state, n,
                                                freeze_on)
            else:
                for i, b in enumerate(batches):
                    view[i] = b[k]
        count("nsp.h2d_bytes", sum(t[:n].nbytes for t in slot.host.values()))

    def _on_card(self, slot: _Slot, n: int) -> GroupMetrics:
        """The copies in, the group's steps and the copy of its metrics
        out, enqueued in that order on the runner's stream: the copy out
        of a graph's static outputs comes before any later replay."""
        caller = torch.cuda.current_stream(self.dev)
        stream = self.stream or caller
        stream.wait_stream(caller)
        with torch.cuda.stream(stream), span("nsp.group.launch"):
            for k, t in slot.dev.items():
                t[:n].copy_(slot.host[k][:n], non_blocking=True)
            slot.copied = torch.cuda.Event()
            slot.copied.record(stream)
            if self.use_graphs and n == self.group and slot.warm:
                if slot.graph is None:
                    self._capture(slot)
                slot.graph.replay()
                for k, v in slot.launches.items():
                    LAUNCHES[k] += v
                out = slot.outputs
                self.steps["graph"] += n
            else:
                out = self._steps(slot, n)
                slot.warm |= n == self.group
                self.steps["eager" if n == self.group else "partial"] += n
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    for k, v in out.items()}
            for k, v in out.items():
                host[k].copy_(v, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        caller.wait_stream(stream)
        return GroupMetrics(self, host, done)

    def _steps(self, slot: _Slot, n: int) -> Dict[str, torch.Tensor]:
        """The group's n steps in order -> their metrics stacked."""
        outs = [self.step_fn({k: v[i] for k, v in slot.dev.items()
                              if k != "_table"}, slot.dev["_table"][i])
                for i in range(n)]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def _capture(self, slot: _Slot) -> None:
        """Capture a full group of the slot's shape as one graph on the
        side stream; the launches the capture counted move from LAUNCHES
        to the slot."""
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = dict(LAUNCHES)
        torch.cuda.synchronize(self.dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.dev)
        t = time.monotonic()
        with torch.cuda.graph(graph, stream=self.stream):
            slot.outputs = self._steps(slot, self.group)
        seconds = time.monotonic() - t
        slot.launches = {k: LAUNCHES[k] - v for k, v in before.items()
                         if LAUNCHES[k] != v}
        LAUNCHES.update(before)
        slot.graph = graph
        self.graphs.append(dict(
            shapes={k: list(v.shape[1:]) for k, v in slot.dev.items()
                    if k != "_table"},
            steps=self.group, capture_seconds=seconds,
            pool_bytes=torch.cuda.memory_reserved(self.dev) - reserved,
            launches_a_replay=dict(slot.launches)))
