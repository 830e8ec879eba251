"""Pileup-model training (counterpart of nanosnp_tpu/train/train_pileup.py;
reference PileupModel/train.py).

Loss = label-smoothed CE on the gt and zy heads only; Lookahead-Adam lr 1e-4
with per-epoch 0.98 decay after epoch 10, grad clip 20
(config/ont_pileup.yaml). On the card the recurrence runs the hand-written
training kernels (forward and backward, bf16 w_hh), as the JAX package runs
its Pallas recurrence on the TPU; on the CPU the default is the f32 step
loop under autograd, as the JAX package runs its f32 scan off the TPU.
`use_kernels` chooses explicitly (on the CPU it runs the kernels' plain
versions).

Per epoch: gt/zy confusion, accuracy and macro-F1 for the train and
validation splits into scalars.jsonl; epoch_{n}.ckpt; best.ckpt on the
validation gt macro-F1; at the end last.ckpt with the optimizer state.
Checkpoints are the JAX trainer's pickle layout ({"params": numpy tree,
"step", "epoch"}), so its load_checkpoint reads them.

Data-parallel when the caller has joined a process group of several ranks
(the CLI does, from NSP_COORDINATOR, NSP_NUM_PROCS, NSP_PROC_ID, through
parallel/launch.initialize_distributed), the counterpart of the JAX
trainer's mesh: one rank a device, every rank iterating the same
global batches and training on its `shard_rows` slice, parameters
broadcast from rank 0 once, gradients averaged over ranks before each
update, epoch meters summed over ranks; every rank validates on the whole
set, and rank 0 alone writes files.

Batches are buffered as the JAX trainer buffers them and each full buffer
of `steps_per_call` runs as one group (train/group.py): one CUDA graph
replay on the card, eager steps under several ranks, on the CPU and for
a partial buffer. `max_steps` is checked after each batch, so a run may
overshoot it to the end of a group, as in JAX.
"""
from __future__ import annotations

import copy
import json
import os
import pickle
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import PileupModelConfig, TrainConfig
from ..device import set_matmul_precision
from ..models.convert import (flatten_tree, load_params_npz, params_from_jax,
                              params_to_numpy, save_params_npz,
                              unflatten_like)
from ..models.pileup_model import PileupModel, init_pileup_params
from ..parallel.launch import barrier, host_plan, local_device
from ..parallel.mesh import (all_reduce_mean, all_reduce_sum,
                             broadcast_params, shard_rows, world)
from ..utils.profiling import count_parameters, session, span
from .losses import label_smoothing_loss
from .group import GroupRunner
from .metrics import ConfusionAccumulator, MetricsLogger
from .optim import Optimizer, build_optimizer

__all__ = ["TrainState", "EpochMeter", "freeze_mask_fn", "init_state",
           "make_pileup_step", "make_pileup_train_step",
           "make_pileup_eval_step", "train_pileup",
           "save_checkpoint", "load_checkpoint", "resume_state",
           "save_params_npz", "load_params_npz"]


@dataclass
class TrainState:
    """The model holds the fast params and any state that is not
    trainable (the CatModel's BatchNorm running statistics: leaves of
    model.tree() that take no gradient, moved by the forward pass alone);
    `slow` the Lookahead slow params (a tree like model.tree(), None
    without Lookahead). The optimizer's per-leaf state follows the
    trainable leaves (`trainable`)."""
    model: nn.Module
    opt_state: dict
    slow: Optional[dict] = None
    step: int = 0
    epoch: int = 0


def trainable(tree) -> list:
    """A flag for each leaf of `tree` in flatten_tree order: whether the
    optimizer updates it (it takes a gradient). The others are state the
    forward pass moves and the optimizer skips."""
    return [p.requires_grad for _, p in flatten_tree(tree)]


def init_state(model: nn.Module, tx: Optimizer) -> TrainState:
    leaves = [p for _, p in flatten_tree(model.tree())]
    slow = None
    if tx.lookahead:
        # distinct buffers, as wrap_params_for_lookahead makes
        slow = unflatten_like(model.tree(),
                              [p.detach().clone() for p in leaves])
    mask = trainable(model.tree())
    return TrainState(model, tx.init([p for p, m in zip(leaves, mask) if m]),
                      slow)


def freeze_mask_fn(freeze_prefixes: Tuple[str, ...]):
    """-> is_frozen(path): a leaf is frozen when a string key on its path
    contains one of the patterns (substring match, so "encoder" freezes
    both pileup_encoder and haplotype_encoder)."""
    def is_frozen(path) -> bool:
        return any(isinstance(k, str) and any(p in k for p in freeze_prefixes)
                   for k in path)

    return is_frozen


def apply_gradients(state: TrainState, tx: Optimizer, loss: torch.Tensor,
                    is_frozen, row: torch.Tensor) -> None:
    """Gradients of `loss` with respect to the fast params (zero for a
    leaf the loss does not reach, such as the unused indel heads, as
    jax.grad gives), averaged over the ranks of a data-parallel run, then
    one optimizer update in place with the scalars of `row` (a row of
    tx.scalar_table on the device; the counts do not move). Leaves that
    are not trainable (`trainable`) take no gradient and no update."""
    tree = state.model.tree()
    mask = trainable(tree)
    flat = [item for item, m in zip(flatten_tree(tree), mask) if m]
    params = [p for _, p in flat]
    grads = all_reduce_mean(torch.autograd.grad(
        loss, params, allow_unused=True, materialize_grads=True))
    slow = None if state.slow is None else [
        p for (_, p), m in zip(flatten_tree(state.slow), mask) if m]
    tx.update(params, grads, state.opt_state, row, slow,
              [is_frozen(path) for path, _ in flat])


def single_step(tx: Optimizer, state: TrainState, step, freeze_on: float,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """step(row) as one update: the one-row scalar table, then the counts
    advance (the group of one step)."""
    metrics = step(tx.first_row(state.opt_state, freeze_on, device))
    tx.advance(state.opt_state, 1)
    return metrics


def _head_metrics(gt, zy, gt_target, zy_target, smoothing):
    gt_loss = label_smoothing_loss(gt, gt_target, smoothing)
    zy_loss = label_smoothing_loss(zy, zy_target, smoothing)
    loss = gt_loss + zy_loss
    gt_pred = gt.argmax(-1)
    acc = (gt_pred == gt_target).float().mean()
    return loss, {"loss": loss.detach(), "gt_loss": gt_loss.detach(),
                  "zy_loss": zy_loss.detach(), "gt_acc": acc,
                  "gt_pred": gt_pred, "zy_pred": zy.argmax(-1)}


def make_pileup_step(mcfg: PileupModelConfig, tcfg: TrainConfig,
                     tx: Optimizer, use_kernels: bool):
    """-> step(state, batch, generator, row) -> metrics: one update of
    `state` in place from `batch` (x, gt, zy device tensors) with the
    optimizer scalars of `row`; the counts do not move (the group runner,
    train/group.py, moves them). `generator` draws the dropout masks
    (None: no dropout)."""
    smoothing = tcfg.optim.label_smoothing
    is_frozen = freeze_mask_fn(tuple(tcfg.freeze_prefixes))

    def step(state: TrainState, batch, generator: Optional[torch.Generator],
             row: torch.Tensor) -> Dict[str, torch.Tensor]:
        gt, zy = state.model.forward_train(batch["x"],
                                           use_kernels=use_kernels,
                                           generator=generator)
        loss, metrics = _head_metrics(gt, zy, batch["gt"], batch["zy"],
                                      smoothing)
        apply_gradients(state, tx, loss, is_frozen, row)
        return metrics

    return step


def make_pileup_train_step(mcfg: PileupModelConfig, tcfg: TrainConfig,
                           tx: Optimizer, use_kernels: bool):
    """-> train_step(state, x, gt_target, zy_target, generator, freeze_on)
    -> metrics: one step (`make_pileup_step` as a group of one), updating
    `state` in place."""
    step = make_pileup_step(mcfg, tcfg, tx, use_kernels)

    def train_step(state: TrainState, x, gt_target, zy_target,
                   generator: Optional[torch.Generator],
                   freeze_on: float = 0.0) -> Dict[str, torch.Tensor]:
        batch = {"x": x, "gt": gt_target, "zy": zy_target}
        return single_step(tx, state,
                           lambda row: step(state, batch, generator, row),
                           freeze_on, x.device)

    return train_step


def make_pileup_eval_step(mcfg: PileupModelConfig, tcfg: TrainConfig):
    """Validation on the f32 path (the JAX eval step runs pileup_forward
    with use_pallas=False): -> (loss, gt_pred, zy_pred)."""
    smoothing = tcfg.optim.label_smoothing

    @torch.no_grad()
    def eval_step(model, x, gt_target, zy_target):
        gt, zy = model.forward_train(x, use_kernels=False)
        loss, m = _head_metrics(gt, zy, gt_target, zy_target, smoothing)
        return loss, m["gt_pred"], m["zy_pred"]

    return eval_step


class EpochMeter:
    """Accumulates loss + gt/zy confusion over one epoch's batches (gt
    alone for a model without a zygosity head: n_zy 0, zy None)."""

    def __init__(self, n_gt: int, n_zy: int):
        self.gt = ConfusionAccumulator(n_gt)
        self.zy = ConfusionAccumulator(n_zy) if n_zy else None
        self.loss_sum = 0.0
        self.batches = 0

    def update(self, loss, gt_pred, gt_true, zy_pred, zy_true) -> None:
        self.loss_sum += float(loss)
        self.batches += 1
        self.gt.update(_host(gt_pred), _host(gt_true))
        if self.zy is not None:
            self.zy.update(_host(zy_pred), _host(zy_true))

    def scalars(self) -> Dict[str, float]:
        out = {"loss": round(self.loss_sum / max(self.batches, 1), 6)}
        out.update(self.gt.summary("gt_"))
        if self.zy is not None:
            out.update(self.zy.summary("zy_"))
        return out

    def all_reduce(self) -> None:
        """Make each rank's meter the global batches' in a data-parallel
        run: the confusion counts summed over ranks, the loss sum averaged
        (each rank's loss is its slice's mean, and the slices are equal)."""
        if world() <= 1:
            return
        meters = [m for m in (self.gt, self.zy) if m is not None]
        loss, *sums = all_reduce_sum(
            [torch.tensor([self.loss_sum], dtype=torch.float64)]
            + [torch.from_numpy(m.matrix).double() for m in meters])
        self.loss_sum = float(loss) / world()
        for m, total in zip(meters, sums):
            m.matrix = total.numpy().astype(np.int64)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class Trainer:
    """What train_pileup and train_haplotype share: device, state,
    dropout generator, the loop that buffers batches into groups of
    steps (`fit`, `GroupRunner`), epoch bookkeeping, validation and
    checkpoints. A subclass supplies the model-specific parts:
    `train_step`, `host_batch`, `buffer_key`, `run_eval` and `labels`.

    In a data-parallel run (a process group of several ranks) the rank
    trains on its slice of each global batch on its own device; rank 0
    alone writes, and the ranks meet at each epoch's end.

    A checkpoint is written on a writer thread from a host copy taken
    when it is asked for, so the card trains on meanwhile; the next
    write, `finish` and `wait_for_writes` wait for it. A subclass may
    give its checkpoints other names and another layout (`_checkpoint`)."""

    def __init__(self, name, model_cls, mcfg, tcfg, init_params, device,
                 use_kernels, steps_per_epoch, lr_steps_per_epoch, out_dir,
                 resume_from, log_every):
        plan = host_plan()                     # the caller's group, if any
        self.rank, self.world = plan.host_id, plan.n_hosts
        self.dev = local_device(plan, device)  # raises before any write
        if tcfg.batch_size % self.world:       # so does this
            raise ValueError(f"batch size {tcfg.batch_size} not divisible "
                             f"by {self.world} data-parallel ranks")
        set_matmul_precision()
        self.name, self.mcfg, self.tcfg = name, mcfg, tcfg
        self.out_dir, self.log_every = out_dir, log_every
        self.use_kernels = (self.dev.type == "cuda" if use_kernels is None
                            else bool(use_kernels))
        self.tx = build_optimizer(tcfg.optim,
                                  steps_per_epoch or lr_steps_per_epoch or 1000)
        model = model_cls(mcfg, init_params).to(self.dev)
        broadcast_params([p for _, p in flatten_tree(model.tree())])
        self.state = init_state(model, self.tx)
        # each rank its own dropout masks: seeded from (seed, rank)
        seed = tcfg.seed if self.world == 1 else int(np.random.SeedSequence(
            [tcfg.seed, self.rank]).generate_state(1)[0])
        self.generator = torch.Generator(device=self.dev).manual_seed(seed)
        if resume_from:
            # the saved generator is one rank's: ranks of a data-parallel
            # run keep their own seeds
            _restore(self.state, resume_state(resume_from),
                     self.generator if self.world == 1 else None)
        self.logger = None
        if self.rank == 0:
            os.makedirs(out_dir, exist_ok=True)
            self.logger = MetricsLogger(out_dir)
            print(f"[{name}] model parameters: "
                  f"{count_parameters(self.state.model.tree()):,}"
                  + (f", {self.world} data-parallel ranks"
                     if self.world > 1 else ""))
        self.meter = EpochMeter(mcfg.gt_num_class, mcfg.zy_num_class)
        self._writer: Optional[ThreadPoolExecutor] = None
        self._write: Optional[Future] = None
        self.best_metric = float("-inf")
        self.freeze = 0.0
        self._pending = None        # (metrics, batches, step): run_group
        # the JAX trainers group steps only when epochs are marked in the
        # data (steps_per_epoch None)
        self.groups = GroupRunner(
            self.train_step, self.tx, self.state, self.generator, self.dev,
            tcfg.steps_per_call if steps_per_epoch is None else 1)
        self.t0 = time.monotonic()

    def train_step(self, batch: Dict[str, torch.Tensor],
                   row: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One update from a batch of device tensors (`host_batch`'s
        arrays) and a row of the optimizer's scalar table -> its
        metrics."""
        raise NotImplementedError

    def host_batch(self, batch) -> Dict[str, np.ndarray]:
        """The arrays of a batch as they ship to the device."""
        raise NotImplementedError

    def buffer_key(self, batch):
        """-> (the buffer a batch joins, the batch as buffered)."""
        raise NotImplementedError

    def run_eval(self, batch):
        """-> (loss, gt_pred, zy_pred, gt_true, zy_true) of a host batch
        (zy None without a zygosity head)."""
        raise NotImplementedError

    def labels(self, batch):
        """(gt, zy) of a host batch (zy None without a zygosity head)."""
        raise NotImplementedError

    def run_group(self, batches) -> None:
        """The buffered host batches as one group of steps (this rank's
        rows of each in a data-parallel run), launched; then the meter
        and the progress line of the group launched before it, whose
        metrics the card gives while it runs this one. The group stays
        pending until the next group or `drain`."""
        with span("nsp.train.convert"):
            if self.world > 1:
                batches = [_rows(b, shard_rows(len(self.labels(b)[0]),
                                               self.rank, self.world))
                           for b in batches]
            host = [self.host_batch(b) for b in batches]
        m = self.groups.run(host, self.freeze)
        self.state.step += len(batches)
        last, self._pending = self._pending, (m, batches, self.state.step)
        if last is not None:
            self._meter(*last)

    def drain(self) -> None:
        """The meter and the progress line of the pending group, if any:
        before an epoch ends and when training stops."""
        last, self._pending = self._pending, None
        if last is not None:
            self._meter(*last)

    def _meter(self, m, batches, step: int) -> None:
        """A group's metrics (its `GroupMetrics`, read here) into the
        epoch meter, and the progress line at the step that ended it."""
        with span("nsp.train.meter"):
            zy_pred = m.get("zy_pred")
            for i, b in enumerate(batches):
                gt_true, zy_true = self.labels(b)
                self.meter.update(m["loss"][i], m["gt_pred"][i], gt_true,
                                  None if zy_pred is None else zy_pred[i],
                                  zy_true)
            if step % self.log_every < self.groups.group and self.rank == 0:
                dt = time.monotonic() - self.t0
                print(f"[{self.name}] step {step} "
                      f"loss {float(m['loss'][-1]):.4f} "
                      f"gt_acc {float(m['gt_acc'][-1]):.4f} "
                      f"({step / dt:.1f} steps/s)")

    @session("nsp.train.fit")
    def fit(self, data_iter: Iterator, steps_per_epoch: Optional[int],
            max_steps: Optional[int], val_iter_factory,
            eval_fn) -> TrainState:
        """The JAX trainers' loop: each batch joins its buffer
        (`buffer_key`), a full buffer runs as one group; at an EPOCH_END
        sentinel every buffer runs, then the epoch ends (with
        steps_per_epoch, after every that many steps); `max_steps` is
        checked after each batch, so the run ends with the group that
        reaches it. A group is metered once the next is launched
        (`run_group`); the pending one is metered (`drain`) before an
        epoch ends and when the loop does.

        A tracing session (utils/profiling.py), `nsp.train.fit`: each
        batch's `nsp.train.feed` (the iterator's next and the buffering),
        and each group's `nsp.train.convert` (`host_batch`),
        `nsp.group.run` and `nsp.train.meter`, the last holding
        `nsp.group.fetch`, the wait for the group's metrics."""
        from .data import EPOCH_END

        bufs: Dict[object, list] = {}
        done = object()
        items = iter(data_iter)

        def flush_all():
            for key in list(bufs):
                self.run_group(bufs.pop(key))
            self.drain()

        while True:
            with span("nsp.train.feed"):
                item = next(items, done)
                if item is not done and item is not EPOCH_END:
                    key, item = self.buffer_key(item)
                    bufs.setdefault(key, []).append(item)
            if item is done:
                break
            if item is EPOCH_END:
                flush_all()
                self.end_epoch(val_iter_factory, eval_fn)
                continue
            if len(bufs[key]) >= self.groups.group:
                self.run_group(bufs.pop(key))
            if steps_per_epoch and self.state.step \
                    and self.state.step % steps_per_epoch == 0:
                self.drain()
                self.end_epoch(val_iter_factory, eval_fn)
            if max_steps and self.state.step >= max_steps:
                break
        flush_all()
        return self.finish()

    def validate(self, val_iter_factory) -> Optional[Dict[str, float]]:
        if val_iter_factory is None:
            return None
        from .data import EPOCH_END

        vm = EpochMeter(self.mcfg.gt_num_class, self.mcfg.zy_num_class)
        for vb in val_iter_factory():
            if vb is EPOCH_END:
                continue
            loss, gtp, zyp, gtt, zyt = self.run_eval(vb)
            vm.update(loss, gtp, gtt, zyp, zyt)
        return vm.scalars() if vm.batches else None

    def _checkpoint(self, name: str, **kw):
        """-> (path, write(path, payload), payload) of checkpoint `name`,
        the payload a host copy of what it holds: here the state as
        save_checkpoint pickles it."""
        return (os.path.join(self.out_dir, name), _write_pickle,
                checkpoint_blob(self.state, **kw))

    def _save(self, name: str, **kw) -> None:
        if self.rank:
            return
        path, write, payload = self._checkpoint(name, **kw)
        self.wait_for_writes()
        if self._writer is None:
            self._writer = ThreadPoolExecutor(1, "nsp-checkpoint")
        self._write = self._writer.submit(write, path, payload)

    def wait_for_writes(self) -> None:
        """Wait for the checkpoint being written, raising what it raised."""
        if self._write is not None:
            write, self._write = self._write, None
            write.result()

    def end_epoch(self, val_iter_factory, eval_fn) -> None:
        st = self.state
        st.epoch += 1
        self.meter.all_reduce()
        train_scalars = self.meter.scalars()
        val_scalars = self.validate(val_iter_factory)
        if self.logger is not None:
            self.logger.log(st.epoch, "train", train_scalars, step=st.step)
            if val_scalars is not None:
                self.logger.log(st.epoch, "val", val_scalars, step=st.step)
            print(f"[{self.name}] epoch {st.epoch}: train {train_scalars}"
                  + (f" val {val_scalars}" if val_scalars else ""))
        self.meter = EpochMeter(self.mcfg.gt_num_class, self.mcfg.zy_num_class)
        self._save(f"epoch_{st.epoch}.ckpt")
        # best-metric retention (reference train_dev.py:258-281); every
        # rank decides the same, having validated on the same set
        metric = None
        if eval_fn is not None:
            metric = float(eval_fn(st))
        elif val_scalars is not None:
            metric = val_scalars["gt_macro_f1"]
        if metric is not None and metric > self.best_metric:
            self.best_metric = metric
            self._save("best.ckpt")
        if self.tcfg.first_stage is not None \
                and st.epoch >= self.tcfg.first_stage:
            self.freeze = 1.0
        barrier("nsp_train_epoch")

    def finish(self) -> TrainState:
        self.drain()
        self._save("last.ckpt", include_optimizer=True,
                   generator=self.generator)
        self.wait_for_writes()
        if self._writer is not None:
            self._writer.shutdown()
            self._writer = None
        # every rank: the steps each route of the group runner ran
        print(json.dumps({"train_groups": dict(
            name=self.name, rank=self.rank, ranks=self.world,
            steps_per_call=self.groups.group, steps=self.groups.steps,
            graphs=self.groups.graphs)}), flush=True)
        barrier("nsp_train_done")
        return self.state


def _rows(batch, rows: slice):
    """Those rows of a host batch: a tuple of arrays or a dict of them."""
    if isinstance(batch, dict):
        return {k: v[rows] for k, v in batch.items()}
    return tuple(a[rows] for a in batch)


class _PileupTrainer(Trainer):
    def __init__(self, mcfg, tcfg, init_params, *args):
        super().__init__("train_pileup", PileupModel, mcfg, tcfg, init_params,
                         *args)
        self._step = make_pileup_step(mcfg, tcfg, self.tx, self.use_kernels)
        self._eval = make_pileup_eval_step(mcfg, tcfg)

    def host_batch(self, batch):
        x, gt, zy = batch
        return {"x": np.asarray(x, np.float32), "gt": np.asarray(gt),
                "zy": np.asarray(zy)}

    def buffer_key(self, batch):
        return (), batch        # one buffer, as the JAX trainer keeps

    def train_step(self, batch, row):
        return self._step(self.state, batch, self.generator, row)

    def run_eval(self, batch):
        b = {k: torch.from_numpy(v).to(self.dev)
             for k, v in self.host_batch(batch).items()}
        return (*self._eval(self.state.model, b["x"], b["gt"], b["zy"]),
                batch[1], batch[2])

    def labels(self, batch):
        return batch[1], batch[2]


def train_pileup(
    data_iter: Iterator,
    mcfg: PileupModelConfig,
    tcfg: TrainConfig,
    steps_per_epoch: Optional[int],
    out_dir: str,
    init_params=None,
    device="cuda",
    use_kernels: Optional[bool] = None,
    log_every: int = 50,
    max_steps: Optional[int] = None,
    resume_from: Optional[str] = None,
    eval_fn=None,
    val_iter_factory: Optional[Callable[[], Iterator]] = None,
    lr_steps_per_epoch: Optional[int] = None,
) -> TrainState:
    """Loop over an iterator of (x [B,33,18], gt [B], zy [B]) numpy batches
    or data.EPOCH_END sentinels (preferred over steps_per_epoch when the
    batch count depends on the data; the lr decay then uses
    `lr_steps_per_epoch`, an estimate is fine). Runs on `device` (the card
    by default; raises without one).

    As the JAX trainer, it buffers batches and runs each full buffer of
    steps_per_call (without steps_per_epoch; else 1) as one group of
    sequential steps (`Trainer.fit`, train/group.py)."""
    if init_params is None:
        init_params = init_pileup_params(
            torch.Generator().manual_seed(tcfg.seed), mcfg)
    tr = _PileupTrainer(mcfg, tcfg, init_params, device, use_kernels,
                        steps_per_epoch, lr_steps_per_epoch, out_dir,
                        resume_from, log_every)
    return tr.fit(data_iter, steps_per_epoch, max_steps, val_iter_factory,
                  eval_fn)


def save_checkpoint(path: str, state: TrainState,
                    include_optimizer: bool = False,
                    generator: Optional[torch.Generator] = None) -> None:
    """Inference checkpoints store the fast params only; with
    include_optimizer the full training state too (fast and slow params,
    optimizer state, and the dropout generator's state, so that a resumed
    run draws the masks an uninterrupted one would)."""
    _write_pickle(path, checkpoint_blob(state, include_optimizer, generator))


def _write_pickle(path: str, blob: dict) -> None:
    with open(path, "wb") as f:
        pickle.dump(blob, f)


def checkpoint_blob(state: TrainState, include_optimizer: bool = False,
                    generator: Optional[torch.Generator] = None) -> dict:
    """What save_checkpoint pickles, as host arrays of their own (copies,
    never views of tensors that training moves on)."""
    tree = state.model.tree()
    blob = {"params": params_to_numpy(tree), "step": state.step,
            "epoch": state.epoch}
    if include_optimizer:
        blob["full_params"] = {
            "fast": blob["params"],
            "slow": None if state.slow is None else params_to_numpy(
                state.slow)}
        # the counts as ints, each per-leaf list of the optimizer's state
        # as a tree like the params (Adam's mu and nu, SGD's trace, ...)
        blob["opt_state"] = {
            k: params_to_numpy(unflatten_like(tree, v))
            if isinstance(v, list) else v
            for k, v in state.opt_state.items()}
        if generator is not None:
            blob["generator_state"] = generator.get_state().numpy()
    return copy.deepcopy(blob)


def load_checkpoint(path: str):
    """-> (parameter tree of f32 tensors, the checkpoint's dict)."""
    if path.endswith(".npz"):
        return load_params_npz(path), {}
    with open(path, "rb") as f:
        blob = pickle.load(f)
    return params_from_jax(blob["params"]), blob


def resume_state(path: str) -> dict:
    """A full training state saved with include_optimizer=True."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    if "opt_state" not in blob:
        raise ValueError(f"{path} was saved without optimizer state")
    return blob


def _restore(state: TrainState, blob: dict,
             generator: Optional[torch.Generator]) -> None:
    tree = state.model.tree()
    with torch.no_grad():
        for (_, p), (_, v) in zip(flatten_tree(tree), flatten_tree(
                blob["full_params"]["fast"])):
            p.copy_(torch.from_numpy(np.asarray(v)))
        if state.slow is not None:
            for (_, p), (_, v) in zip(flatten_tree(state.slow), flatten_tree(
                    blob["full_params"]["slow"])):
                p.copy_(torch.from_numpy(np.asarray(v)))
    dev = flatten_tree(tree)[0][1].device
    saved = blob["opt_state"]
    if set(saved) != set(state.opt_state):
        raise ValueError(
            f"the checkpoint's optimizer state {sorted(saved)} is not the "
            f"configured optimizer's {sorted(state.opt_state)}")
    state.opt_state = {
        k: [torch.from_numpy(np.asarray(v)).to(dev)
            for _, v in flatten_tree(o)]
        if isinstance(o, (dict, list)) else int(o)
        for k, o in saved.items()}
    state.step, state.epoch = int(blob["step"]), int(blob["epoch"])
    if generator is not None and "generator_state" in blob:
        generator.set_state(torch.from_numpy(blob["generator_state"]))
