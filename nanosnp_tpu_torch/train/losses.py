"""Training losses (counterpart of nanosnp_tpu/train/losses.py).

label_smoothing_loss mirrors the reference LabelSmoothingLoss
(PileupModel/optim.py:129-144): the target distribution puts
`1 - smoothing` on the true class and `smoothing / (n_class - 1)` on every
other class; the loss is the batch mean of the cross entropy against it.

focal_loss is kept for parity with HaplotypeModel/focal_loss.py (defined
but unused by the production models).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         smoothing: float = 0.1) -> torch.Tensor:
    """logits [N, C], targets [N] int. Returns a scalar."""
    n_class = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    one_hot = F.one_hot(targets.long(), n_class).to(logits.dtype)
    true_dist = one_hot * (1.0 - smoothing) + (1.0 - one_hot) * (
        smoothing / (n_class - 1))
    return torch.mean(torch.sum(-true_dist * logp, dim=-1))


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    n_class = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    one_hot = F.one_hot(targets.long(), n_class).to(logits.dtype)
    pt = torch.sum(logp.exp() * one_hot, dim=-1)
    logpt = torch.sum(logp * one_hot, dim=-1)
    return torch.mean(-alpha * (1.0 - pt) ** gamma * logpt)
