"""Training pass for the legacy CatModel (reference train.py:100-326).

Counterpart of nanosnp_tpu/legacy/train.py. Reference semantics kept:
10-class gt targets at group centers filtered by high-confidence region
(variants: zy>=0 and gt in the SNV block; non-variants: unlabeled confident
sites downsampled to the variant count, dataset.py:185-196), cross entropy
against labels smoothed by 0.1, per-epoch checkpoints. As in the JAX
package, the recurrences of training are the f32 step loop under autograd
(no training kernel), the optimizer is Adam in optax's order of operations,
and the BatchNorm running statistics are buffers that the forward pass
moves and the optimizer never touches.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import OptimConfig
from ..device import resolve_device
from ..models.convert import flatten_tree
from ..train.optim import Optimizer
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


def adam(lr: float) -> Optimizer:
    """optax.adam(lr): no clipping, no weight decay, a constant rate."""
    return Optimizer(OptimConfig(type="adam", lr=lr, decay_ratio=1.0,
                                 weight_decay=0.0,
                                 max_grad_norm=float("inf")))


def trainable_leaves(model: CatModel):
    """The leaves Adam updates, in the tree's order: everything but the
    BatchNorm running statistics."""
    return [leaf for _, leaf in flatten_tree(model.tree())
            if leaf.requires_grad]


def train_catmodel(
    params,
    batches: Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    *,
    lr: float = 1e-3,
    seed: int = 0,
    log_every: int = 20,
    log=print,
    device="cuda",
    dropout: bool = True,
):
    """Run one pass over `batches` of (g0, g1, gt_label); returns
    (parameter tree on the CPU, mean_loss, n_steps). `dropout=False`
    trains without the percentage RNN's dropout (the deterministic step
    the tests compare)."""
    dev = resolve_device(device)
    model = CatModel(params).to(dev)
    tx = adam(lr)
    leaves = trainable_leaves(model)
    opt_state = tx.init(leaves)
    gen = torch.Generator(device=dev).manual_seed(seed) if dropout else None
    losses = []
    for i, (g0, g1, y) in enumerate(batches):
        logits = model(torch.as_tensor(g0, dtype=torch.float32, device=dev),
                       torch.as_tensor(g1, dtype=torch.float32, device=dev),
                       train=True, generator=gen)
        loss = smoothed_cross_entropy(
            logits, torch.as_tensor(y, dtype=torch.int64, device=dev))
        grads = torch.autograd.grad(loss, leaves)
        tx.step(leaves, grads, opt_state)
        losses.append(float(loss.detach()))
        if log_every and (i + 1) % log_every == 0:
            log(f"  step {i + 1}: loss {np.mean(losses[-log_every:]):.4f}")
    tree = model.to("cpu").tree()
    return tree, (float(np.mean(losses)) if losses else float("nan")), \
        len(losses)
