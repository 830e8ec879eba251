"""Haplotype-model training (counterpart of
nanosnp_tpu/train/train_haplotype.py; reference HaplotypeModel/train_dev.py).

Loss = label-smoothed CE on gt(10) + zy(3); the optimizer, checkpoints and
per-epoch records are train_pileup's. Features are computed on the device
inside the train step (features/haplotype.haplotype_features), so the
host ships compact int8 read matrices, not 105-float tensors. Epoch
boundaries come from the data.EPOCH_END sentinel.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..config import HaplotypeModelConfig, TrainConfig
from ..features.haplotype import haplotype_features
from ..models.haplotype_model import HaplotypeModel, init_haplotype_params
from .optim import Optimizer
from .train_pileup import (Trainer, TrainState, _head_metrics,
                           apply_gradients, freeze_mask_fn)


def _featurize(batch):
    xp = haplotype_features(batch["p_seq"], batch["p_baseq"],
                            batch["p_mapq"], batch["p_hap"], batch["p_ref"])
    xh = haplotype_features(batch["h_seq"], batch["h_baseq"],
                            batch["h_mapq"], batch["h_hap"], batch["h_ref"])
    return xp, xh


def make_haplotype_train_step(mcfg: HaplotypeModelConfig, tcfg: TrainConfig,
                              tx: Optimizer, use_kernels: bool):
    """-> train_step(state, batch, generator, freeze_on) -> metrics, with
    `batch` a dict of device tensors (read matrices, reference codes,
    gt, zy); updates `state` in place."""
    smoothing = tcfg.optim.label_smoothing
    is_frozen = freeze_mask_fn(tuple(tcfg.freeze_prefixes))

    def train_step(state: TrainState, batch,
                   generator: Optional[torch.Generator],
                   freeze_on: float = 0.0) -> Dict[str, torch.Tensor]:
        xp, xh = _featurize(batch)
        gt, zy = state.model.forward_train(xp, xh, use_kernels=use_kernels,
                                           generator=generator)
        loss, metrics = _head_metrics(gt, zy, batch["gt"], batch["zy"],
                                      smoothing)
        apply_gradients(state, tx, loss, is_frozen, freeze_on)
        return metrics

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


def _device_batch(batch, device):
    """Read matrices and reference codes ship as int8 (clipped to
    [-128, 127], as the JAX trainer does); the featurizer casts to f32 on
    the device. 4x less host-to-device traffic."""
    return {
        k: torch.from_numpy(
            np.clip(np.asarray(v), -128, 127).astype(np.int8)
            if v.dtype.kind in "fiu" and k not in ("gt", "zy")
            else np.asarray(v)).to(device)
        for k, v in batch.items()
    }


class _HaplotypeTrainer(Trainer):
    def __init__(self, mcfg, tcfg, init_params, *args):
        super().__init__("train_haplotype", HaplotypeModel, mcfg, tcfg,
                         init_params, *args)
        self._step = make_haplotype_train_step(mcfg, tcfg, self.tx,
                                               self.use_kernels)
        self._eval = make_haplotype_eval_step(mcfg, tcfg)

    def run_step(self, batch, freeze_on):
        return self._step(self.state, _device_batch(batch, self.dev),
                          self.generator, freeze_on)

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

    Batches come in depth buckets. The JAX trainer buffers them per shape
    and runs each full buffer of steps_per_call batches as one dispatch;
    this loop keeps the same buffering, so its steps run in the same
    order, and runs the buffered batches as single steps."""
    from .data import EPOCH_END

    if init_params is None:
        init_params = init_haplotype_params(
            torch.Generator().manual_seed(tcfg.seed), mcfg)
    tr = _HaplotypeTrainer(mcfg, tcfg, init_params, device, use_kernels,
                           steps_per_epoch, lr_steps_per_epoch, out_dir,
                           resume_from, log_every)
    group = tcfg.steps_per_call if steps_per_epoch is None else 1
    bufs: Dict[tuple, list] = {}

    def flush(key):
        for b in bufs.pop(key, []):
            tr.step(b)

    def flush_all():
        for key in list(bufs):
            flush(key)

    for batch in data_iter:
        if batch is EPOCH_END:
            flush_all()
            tr.end_epoch(val_iter_factory, eval_fn)
            continue
        # training on the repeated tail rows of a tiled remainder is
        # intended (static batch shapes); "_n" matters only to validation
        batch = dict(batch)
        batch.pop("_n", None)
        key = tuple(sorted((k, v.shape) for k, v in batch.items()))
        bufs.setdefault(key, []).append(batch)
        if len(bufs[key]) >= max(group, 1):
            flush(key)
        if steps_per_epoch and tr.state.step \
                and tr.state.step % steps_per_epoch == 0:
            tr.end_epoch(val_iter_factory, eval_fn)
        if max_steps and tr.state.step >= max_steps:
            break
    flush_all()
    return tr.finish()
