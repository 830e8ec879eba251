"""Optimizers of the port: Lookahead-Adam (the reference's production
optimizer, and the default) and plain Adam, written in torch.

Counterpart of nanosnp_tpu/train/optim.py, which builds them from optax:

    lookahead(chain(clip_by_global_norm(max_grad_norm),
                    adamw(lr_schedule, 0.9, 0.999, 1e-8, weight_decay)),
              sync_period, slow_step_size)

`Optimizer.step` follows optax 0.2.6's order of operations exactly:
  1. clip: g_norm = sqrt(sum of g^2 over every leaf); unless
     g_norm < max_norm, every g becomes (g / g_norm) * max_norm;
  2. Adam moments mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu; count
     += 1; u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps);
  3. weight decay u += weight_decay * fast params;
  4. u *= -lr(step), the schedule read at the step count before this update;
  5. Lookahead: on the step that completes a sync period,
     diff = fast + u - slow, the slow params move by alpha * diff and the
     fast ones by u - (1 - alpha) * diff (so both land on the new slow
     params); otherwise the fast params move by u and the slow ones stay;
  6. the freeze mask scales the frozen leaves' updates (fast and slow),
     while their Adam moments keep moving, as in the JAX train step where
     the mask follows tx.update;
  7. params += updates.

The other optimizer types of the JAX package (ranger, ranger21, radam,
novograd, sgd, adadelta) are not ported yet: asking for one raises.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from ..config import OptimConfig

ADAM_TYPES = ("adam", "lookahead_adam", "lookaheadadam")
NOT_PORTED = ("radam", "lookahead_radam", "novograd", "lookahead_novograd",
              "sgd", "adadelta", "ranger", "ranger21")


def lr_schedule(cfg: OptimConfig, steps_per_epoch: int
                ) -> Callable[[int], float]:
    """Per-epoch exponential decay starting after begin_to_adjust_lr epochs
    (step = the count of updates made before this one, as optax counts)."""
    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return cfg.lr * cfg.decay_ratio ** max(epoch - cfg.begin_to_adjust_lr,
                                               0)

    return schedule


def is_lookahead_type(type_str: str) -> bool:
    t = type_str.lower()
    return t.startswith("lookahead") or t in ("ranger", "ranger21")


class Optimizer:
    """clip -> AdamW -> lr schedule [-> Lookahead], updating tensors in
    place. The state is a plain dict (picklable as numpy by the trainers):
    count, steps_since_sync, and the moments mu, nu per leaf."""

    def __init__(self, cfg: OptimConfig, steps_per_epoch: int = 1000,
                 finetune: bool = False):
        t = cfg.type.lower()
        if t in NOT_PORTED:
            raise NotImplementedError(
                f"optimizer type {cfg.type!r} is not ported to the PyTorch "
                "package yet (ROADMAP A.1); use lookahead_adam or adam")
        if t not in ADAM_TYPES:
            raise NotImplementedError(cfg.type)
        self.lookahead = is_lookahead_type(t)
        base = lr_schedule(cfg, steps_per_epoch)
        self.lr = (lambda step: 0.1 * base(step)) if finetune else base
        self.max_grad_norm = cfg.max_grad_norm
        self.weight_decay = cfg.weight_decay
        self.sync_period = cfg.lookahead_sync_period
        self.slow_step = cfg.lookahead_slow_step
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        return {"count": 0, "steps_since_sync": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: Sequence[torch.Tensor],
             state: dict, slow: Optional[List[torch.Tensor]] = None,
             scales: Optional[Sequence[float]] = None) -> None:
        """One update, in place: `params` (the fast params), `slow` (the
        Lookahead slow params, required with Lookahead), `state`. `scales`
        multiplies each leaf's updates (the freeze mask)."""
        if self.lookahead and slow is None:
            raise ValueError("Lookahead needs the slow params")
        b1, b2 = self.b1, self.b2
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < self.max_grad_norm
        grads = [torch.where(keep, g, (g / g_norm) * self.max_grad_norm)
                 for g in grads]
        count = state["count"] + 1
        f32 = torch.float32
        bc1 = 1.0 - torch.tensor(b1, dtype=f32) ** count
        bc2 = 1.0 - torch.tensor(b2, dtype=f32) ** count
        step_size = -self.lr(state["count"])
        sync = self.lookahead and \
            state["steps_since_sync"] == self.sync_period - 1
        for i, (p, g) in enumerate(zip(params, grads)):
            mu = (1 - b1) * g + b1 * state["mu"][i]
            nu = (1 - b2) * (g * g) + b2 * state["nu"][i]
            state["mu"][i], state["nu"][i] = mu, nu
            u = (mu / bc1.to(p.device)) / (torch.sqrt(nu / bc2.to(p.device))
                                            + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            u = torch.tensor(step_size, dtype=p.dtype, device=p.device) * u
            scale = 1.0 if scales is None else scales[i]
            if sync:
                diff = p + u - slow[i]
                slow_u = self.slow_step * diff
                u = u - (1 - self.slow_step) * diff
                slow[i].add_(slow_u if scale == 1.0 else slow_u * scale)
            p.add_(u if scale == 1.0 else u * scale)
        state["count"] = count
        if self.lookahead:
            state["steps_since_sync"] = (state["steps_since_sync"] + 1) \
                % self.sync_period


def build_optimizer(cfg: OptimConfig, steps_per_epoch: int = 1000,
                    finetune: bool = False) -> Optimizer:
    return Optimizer(cfg, steps_per_epoch, finetune)
