"""Training for the legacy CatModel (reference train.py:100-326).

Counterpart of nanosnp_tpu/legacy/train.py. Reference semantics kept:
10-class gt targets at group centers filtered by high-confidence region
(variants: zy>=0 and gt in the SNV block; non-variants: unlabeled confident
sites downsampled to the variant count, dataset.py:185-196), cross entropy
against labels smoothed by 0.1, per-epoch checkpoints. The optimizer is
Adam in optax's order of operations (no clipping, no decay), and the
BatchNorm running statistics are state that the forward pass moves and
the optimizer never touches.

Training runs through the port's trainer, as the pileup and haplotype
models do (`CatModelTrainer`, a `train_pileup.Trainer`): each epoch's
sites are selected and shuffled (`nsp.legacy.select`), batches of
stacked-tag images {g0, g1, y} are buffered into groups of
`steps_per_call` and each full group runs as one `GroupRunner` group:
one CUDA graph replay on the card after the eager first group of a
shape, eager steps on the CPU and for an epoch's partial group. Images
ship as int8 through the runner's pinned staging (`int8_images`: a
value outside int8 raises) and are widened to f32 on the device inside
the step. On the card all five BiLSTM layers run the training kernels,
the percentage stack's dropout included; on the CPU the f32 step loop
under autograd, as the JAX package runs off the TPU.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..config import OptimConfig, TrainConfig
from ..models.convert import flatten_tree, save_params_npz, unflatten_like
from ..train.data import EPOCH_END
from ..train.train_pileup import Trainer, apply_gradients
from ..utils.profiling import span
from .catmodel import CatModel


def cal_label(v1: int, v2: int) -> Optional[int]:
    """The 15-class unordered-pair label over {ref,A,C,G,T(,D=4)} used by
    the config_prev experiments (dataset.py:26-57); pairs outside the
    table return None exactly like the reference falls through."""
    table = {(0, 0): 0, (0, 1): 1, (0, 2): 2, (0, 3): 3, (1, 1): 4,
             (1, 2): 5, (1, 3): 6, (2, 2): 7, (2, 3): 8, (3, 3): 9,
             (4, 4): 10, (0, 4): 11, (1, 4): 12, (2, 4): 13, (3, 4): 14}
    return table.get((min(v1, v2), max(v1, v2)))


def select_training_sites(labels: np.ndarray,
                          rng: np.random.Generator,
                          n_classes: int = 10) -> np.ndarray:
    """labels [N, 3] (confident, gt21, zy) -> shuffled row indices per the
    reference filter (dataset.py:185-196): confident variants with an SNV
    gt class, plus confident unlabeled sites downsampled to the variant
    count. One guard beyond the reference: non-variant rows also require
    an in-head gt (the reference leaves non-ACGT-reference sites carrying
    raw ASCII gt codes in the label array, which would index outside the
    head). n_classes=15 selects the config_prev 15-class variant: GT21
    indices 0-14 (AA..TT, DD, AD..TD) are exactly cal_label's unordered
    pair space, so the deletion-pair classes train too."""
    conf, gt, zy = labels[:, 0], labels[:, 1], labels[:, 2]
    variants = np.flatnonzero((conf > 0) & (zy >= 0) & (gt >= 0)
                              & (gt < n_classes))
    nonvar = np.flatnonzero((conf > 0) & (zy == -1) & (gt >= 0)
                            & (gt < n_classes))
    if len(variants) < len(nonvar):
        nonvar = rng.choice(nonvar, size=len(variants), replace=False)
    idx = np.concatenate([variants, nonvar])
    rng.shuffle(idx)
    return idx


def smoothed_cross_entropy(logits: torch.Tensor, y: torch.Tensor,
                           smoothing: float = 0.1) -> torch.Tensor:
    """Batch mean of the cross entropy against one-hot labels smoothed as
    optax.smooth_labels does: (1 - a) one_hot + a / n_classes."""
    n_class = logits.shape[-1]
    one_hot = torch.nn.functional.one_hot(y.long(), n_class).to(logits.dtype)
    target = one_hot * (1.0 - smoothing) + smoothing / n_class
    return -(target * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def adam_config(lr: float) -> OptimConfig:
    """optax.adam(lr): no clipping, no weight decay, a constant rate."""
    return OptimConfig(type="adam", lr=lr, decay_ratio=1.0, weight_decay=0.0,
                       max_grad_norm=float("inf"))


def int8_images(a) -> np.ndarray:
    """Stacked-tag images as int8, the dtype they are staged in. Every
    channel fits (base codes -2..4, base qualities up to 93, mapping
    qualities up to 60, mask 0-1, phase 1-2); a value int8 does not hold
    exactly raises, nothing is clipped."""
    a = np.asarray(a)
    if a.dtype == np.int8:
        return a
    out = a.astype(np.int8)
    if not np.array_equal(out, a):
        bad = a[out != a]
        raise ValueError(f"image values outside int8: {bad[:4].tolist()}")
    return out


@dataclass
class CatModelConfig:
    """What the trainer reads of the model: its gt classes; the CatModel
    has no zygosity head."""
    gt_num_class: int = 10
    zy_num_class: int = 0


class CatModelTrainer(Trainer):
    """The CatModel's `Trainer`: batches {g0, g1, y} (int8 images
    [B, 2 max_depth, 11, 5], gt classes), Adam at `lr`, dropout 0.5 in
    the percentage stack drawn from the trainer's generator (`dropout`
    False trains without it). Each epoch starts Adam afresh and seeds
    the generator with `seed` + the epoch's index, as the JAX package
    runs each epoch's train_catmodel. Writes catmodel_epoch{n}.npz after
    each epoch and catmodel.npz at the end to `out_dir`: the parameters
    with the BatchNorm running statistics, deflated on the trainer's
    writer thread. `history` holds one record an epoch (epoch, mean
    loss, steps, sites)."""

    def __init__(self, params, *, out_dir: str, lr: float = 1e-3,
                 batch_size: int = 64, seed: int = 0,
                 steps_per_call: int = 8, device="cuda",
                 use_kernels: Optional[bool] = None, dropout: bool = True,
                 log_every: int = 20, gt_classes: int = 10):
        tcfg = TrainConfig(batch_size=batch_size, seed=seed,
                           steps_per_call=steps_per_call,
                           optim=adam_config(lr))
        super().__init__("train_catmodel", lambda _cfg, p: CatModel(p),
                         CatModelConfig(gt_classes), tcfg, params, device,
                         use_kernels, None, None, out_dir, None, log_every)
        self.dropout = dropout
        self.history, self.sites = [], []

    def feed(self, g0: np.ndarray, g1: np.ndarray, labels: np.ndarray,
             rng: np.random.Generator, epochs: int) -> Iterator:
        """Each epoch's sites (`select_training_sites` over the model's gt
        classes, under span `nsp.legacy.select`) in full batches of the
        images and their gt classes, the last partial batch dropped, then
        EPOCH_END."""
        bs = self.tcfg.batch_size
        for _ in range(epochs):
            with span("nsp.legacy.select"):
                idx = select_training_sites(labels, rng,
                                            self.mcfg.gt_num_class)
            self.sites.append(len(idx))
            for s in range(0, len(idx) - bs + 1, bs):
                sel = idx[s:s + bs]
                yield {"g0": g0[sel], "g1": g1[sel], "y": labels[sel, 1]}
            yield EPOCH_END

    def host_batch(self, batch) -> Dict[str, np.ndarray]:
        return {"g0": int8_images(batch["g0"]),
                "g1": int8_images(batch["g1"]),
                "y": np.asarray(batch["y"], np.int64)}

    def buffer_key(self, batch):
        return tuple((k, np.shape(v)) for k, v in sorted(batch.items())), \
            batch

    def _logits(self, batch, train: bool, use_kernels: bool):
        return self.state.model(
            batch["g0"].float(), batch["g1"].float(), train=train,
            generator=self.generator if train and self.dropout else None,
            use_kernels=use_kernels)

    def train_step(self, batch, row):
        logits = self._logits(batch, True, self.use_kernels)
        loss = smoothed_cross_entropy(logits, batch["y"],
                                      self.tcfg.optim.label_smoothing)
        apply_gradients(self.state, self.tx, loss, _never_frozen, row)
        pred = logits.argmax(-1)
        return {"loss": loss.detach(), "gt_pred": pred,
                "gt_acc": (pred == batch["y"]).float().mean()}

    @torch.no_grad()
    def run_eval(self, batch):
        b = {k: torch.from_numpy(v).to(self.dev)
             for k, v in self.host_batch(batch).items()}
        logits = self._logits(b, False, False)
        return (smoothed_cross_entropy(logits, b["y"],
                                       self.tcfg.optim.label_smoothing),
                logits.argmax(-1), None, batch["y"], None)

    def labels(self, batch):
        return batch["y"], None

    def end_epoch(self, val_iter_factory, eval_fn) -> None:
        """The epoch's record and archive, then Adam's state zeroed in
        place (the captured graphs keep their buffers) and the dropout
        generator seeded with `seed` + the next epoch's index."""
        n = self.meter.batches
        self.history.append({
            "epoch": self.state.epoch + 1,
            "loss": round(self.meter.loss_sum / n, 4) if n else float("nan"),
            "steps": n, "sites": self.sites[-1] if self.sites else 0})
        super().end_epoch(val_iter_factory, eval_fn)
        opt = self.state.opt_state
        with torch.no_grad():
            for v in opt.values():
                if isinstance(v, list):
                    for t in v:
                        t.zero_()
        opt["count"] = opt["steps_since_sync"] = 0
        self.generator.manual_seed(self.tcfg.seed + self.state.epoch)

    def _checkpoint(self, name: str, **kw):
        """The legacy archives in the trainers' places: epoch_{n}.ckpt ->
        catmodel_epoch{n}.npz, last.ckpt -> catmodel.npz (no optimizer
        state, as legacy-train has always written)."""
        path = os.path.join(self.out_dir, "catmodel.npz"
                            if name == "last.ckpt"
                            else f"catmodel_epoch{self.state.epoch}.npz")
        tree = self.state.model.tree()
        host = unflatten_like(tree, [p.detach().to("cpu", copy=True)
                                     for _, p in flatten_tree(tree)])
        return path, save_params_npz, host


def _never_frozen(path) -> bool:
    return False
