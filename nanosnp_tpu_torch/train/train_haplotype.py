"""Haplotype-model training (counterpart of
nanosnp_tpu/train/train_haplotype.py; reference HaplotypeModel/train_dev.py).

Loss = label-smoothed CE on gt(10) + zy(3); the optimizer, checkpoints and
per-epoch records are train_pileup's. Features are computed on the device
inside the train step (features/haplotype.haplotype_features), so the
host ships compact int8 read matrices, not 105-float tensors. Epoch
boundaries come from the data.EPOCH_END sentinel. Batches come in depth
buckets: as the JAX trainer, it keeps one buffer a batch shape and runs
each full buffer of steps_per_call as one group (train/group.py; one
graph a shape on the card).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..config import HaplotypeModelConfig, TrainConfig
from ..features.haplotype import haplotype_features
from ..models.haplotype_model import HaplotypeModel, init_haplotype_params
from ..utils.profiling import count
from .optim import Optimizer
from .train_pileup import (Trainer, TrainState, _head_metrics,
                           apply_gradients, freeze_mask_fn, single_step)


def _featurize(batch):
    xp = haplotype_features(batch["p_seq"], batch["p_baseq"],
                            batch["p_mapq"], batch["p_hap"], batch["p_ref"])
    xh = haplotype_features(batch["h_seq"], batch["h_baseq"],
                            batch["h_mapq"], batch["h_hap"], batch["h_ref"])
    return xp, xh


def make_haplotype_step(mcfg: HaplotypeModelConfig, tcfg: TrainConfig,
                        tx: Optimizer, use_kernels: bool):
    """-> step(state, batch, generator, row) -> metrics, with `batch` a
    dict of device tensors (read matrices, reference codes, gt, zy) and
    `row` a row of the optimizer's scalar table: one update of `state` in
    place; the counts do not move (train_pileup.make_pileup_step)."""
    smoothing = tcfg.optim.label_smoothing
    is_frozen = freeze_mask_fn(tuple(tcfg.freeze_prefixes))

    def step(state: TrainState, batch, generator: Optional[torch.Generator],
             row: torch.Tensor) -> Dict[str, torch.Tensor]:
        xp, xh = _featurize(batch)
        gt, zy = state.model.forward_train(xp, xh, use_kernels=use_kernels,
                                           generator=generator)
        loss, metrics = _head_metrics(gt, zy, batch["gt"], batch["zy"],
                                      smoothing)
        apply_gradients(state, tx, loss, is_frozen, row)
        return metrics

    return step


def make_haplotype_train_step(mcfg: HaplotypeModelConfig, tcfg: TrainConfig,
                              tx: Optimizer, use_kernels: bool):
    """-> train_step(state, batch, generator, freeze_on) -> metrics: one
    step (`make_haplotype_step` as a group of one), updating `state` in
    place."""
    step = make_haplotype_step(mcfg, tcfg, tx, use_kernels)

    def train_step(state: TrainState, batch,
                   generator: Optional[torch.Generator],
                   freeze_on: float = 0.0) -> Dict[str, torch.Tensor]:
        return single_step(tx, state,
                           lambda row: step(state, batch, generator, row),
                           freeze_on, batch["gt"].device)

    return train_step


def make_haplotype_eval_step(mcfg: HaplotypeModelConfig, tcfg: TrainConfig):
    """Validation on the f32 path, as the JAX eval step."""
    smoothing = tcfg.optim.label_smoothing

    @torch.no_grad()
    def eval_step(model, batch):
        xp, xh = _featurize(batch)
        gt, zy = model.forward_train(xp, xh, use_kernels=False)
        loss, m = _head_metrics(gt, zy, batch["gt"], batch["zy"], smoothing)
        return loss, m["gt_pred"], m["zy_pred"]

    return eval_step


def _host_batch(batch):
    """Read matrices and reference codes ship as int8 (clipped to
    [-128, 127], as the JAX trainer does); the featurizer casts to f32 on
    the device. 4x less host-to-device traffic. An int8 array ships as it
    comes, with no copy; a wider one (the shards' int16 mapq, the f32
    reference codes, an f32 batch built by hand) is clipped and narrowed.
    While tracing is on, counters `nsp.train.kept_bytes` and
    `nsp.train.narrowed_bytes` add the bytes of each kind."""
    out, kept, narrowed = {}, 0, 0
    for k, v in batch.items():
        v = np.asarray(v)
        if v.dtype.kind in "fiu" and k not in ("gt", "zy"):
            if v.dtype == np.int8:
                kept += v.nbytes
            else:
                v = np.clip(v, -128, 127).astype(np.int8)
                narrowed += v.nbytes
        out[k] = v
    count("nsp.train.kept_bytes", kept)
    count("nsp.train.narrowed_bytes", narrowed)
    return out


def _device_batch(batch, device):
    return {k: torch.from_numpy(v).to(device)
            for k, v in _host_batch(batch).items()}


class _HaplotypeTrainer(Trainer):
    def __init__(self, mcfg, tcfg, init_params, *args):
        super().__init__("train_haplotype", HaplotypeModel, mcfg, tcfg,
                         init_params, *args)
        self._step = make_haplotype_step(mcfg, tcfg, self.tx,
                                         self.use_kernels)
        self._eval = make_haplotype_eval_step(mcfg, tcfg)

    def host_batch(self, batch):
        return _host_batch(batch)

    def buffer_key(self, batch):
        # training on the repeated tail rows of a tiled remainder is
        # intended (static batch shapes); "_n" matters only to validation
        batch = dict(batch)
        batch.pop("_n", None)
        return tuple(sorted((k, v.shape) for k, v in batch.items())), batch

    def train_step(self, batch, row):
        return self._step(self.state, batch, self.generator, row)

    def run_eval(self, batch):
        batch = dict(batch)
        n_valid = batch.pop("_n", None)  # tiled remainder: each row once
        loss, gtp, zyp = self._eval(self.state.model,
                                    _device_batch(batch, self.dev))
        return (loss, gtp[:n_valid], zyp[:n_valid], batch["gt"][:n_valid],
                batch["zy"][:n_valid])

    def labels(self, batch):
        return batch["gt"], batch["zy"]


def train_haplotype(
    data_iter: Iterator,
    mcfg: HaplotypeModelConfig,
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
    """Loop over batches (dicts of p_/h_ read matrices, reference codes and
    gt/zy labels) or data.EPOCH_END sentinels, on `device` (the card by
    default; raises without one).

    Batches come in depth buckets. As the JAX trainer, it buffers them
    per shape and runs each full buffer of steps_per_call batches as one
    group of sequential steps (`Trainer.fit`, train/group.py), so its
    steps run in the JAX order."""
    if init_params is None:
        init_params = init_haplotype_params(
            torch.Generator().manual_seed(tcfg.seed), mcfg)
    tr = _HaplotypeTrainer(mcfg, tcfg, init_params, device, use_kernels,
                           steps_per_epoch, lr_steps_per_epoch, out_dir,
                           resume_from, log_every)
    return tr.fit(data_iter, steps_per_epoch, max_steps, val_iter_factory,
                  eval_fn)
