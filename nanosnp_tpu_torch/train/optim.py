"""Optimizers of the port, written in torch: every type of the JAX
package's build_optimizer, Lookahead-Adam (the reference's production
optimizer, and the default) among them.

Counterpart of nanosnp_tpu/train/optim.py, which builds them from optax
0.2.6. An optimizer here is the same chain of transforms, in optax's order
of operations; each transform works on the list of leaves in flatten_tree
order:

  clip_by_global_norm(max_grad_norm)
  [-> adaptive_grad_clip(0.01)]                   ranger21
  [-> gradient centralization]                    ranger, ranger21
  -> the inner transform:
       adam / lookahead_adam   scale_by_adam -> add_decayed_weights
       radam, ranger           scale_by_radam (rectified from the step at
                               which rho reaches 5)
       novograd                scale_by_novograd (weight decay inside)
       sgd                     trace(0.9, nesterov)
       adadelta                scale_by_adadelta(0.9, 1e-6)
       ranger21                scale_by_adam -> norm_loss(6e-4) ->
                               add_decayed_weights
  -> scale by -lr(step), the schedule read at the update count before this
     update (ranger21: the lr21 warmup and warmdown around it)
  [-> Lookahead]          lookahead_*, ranger, ranger21: on the step that
     completes a sync period, diff = fast + u - slow, the slow params move
     by alpha * diff and the fast ones by u - (1 - alpha) * diff; otherwise
     the fast params move by u and the slow ones stay
  -> the freeze mask scales the frozen leaves' updates (fast and slow),
     while the optimizer state keeps moving, as in the JAX train step where
     the mask follows tx.update
  -> params += updates.

Scalars that optax computes in f32 from the step count (RAdam's rho and
rectification, ranger21's lr) are computed here in numpy f32 the same way:
XLA raises a float to an integer power by square-and-multiply
(`pow32`), and RAdam's rectification term is too sensitive to rho for a
one-ulp difference there. The Adam path keeps torch's pow, as it always
has.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import OptimConfig

ADAM_TYPES = ("adam", "lookahead_adam", "lookaheadadam")

Leaves = List[torch.Tensor]
f32 = np.float32


def lr_schedule(cfg: OptimConfig, steps_per_epoch: int
                ) -> Callable[[int], float]:
    """Per-epoch exponential decay starting after begin_to_adjust_lr epochs
    (step = the count of updates made before this one, as optax counts)."""
    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return cfg.lr * cfg.decay_ratio ** max(epoch - cfg.begin_to_adjust_lr,
                                               0)

    return schedule


def ranger21_schedule(cfg: OptimConfig, steps_per_epoch: int,
                      base: Callable[[int], float]) -> Callable[[int], float]:
    """The JAX package's lr21: linear warmup over the first 10% of the
    planned steps, linear warmdown from 90%, around `base`; in f32 as
    there (the planned total is a float: steps_per_epoch may be huge)."""
    total = float(steps_per_epoch) * max(cfg.ranger21_epochs, 1)
    warm = max(0.1 * total, 1.0)
    down = max(0.9 * total, warm)

    def schedule(step: int) -> float:
        s = f32(step)
        ramp = min(f32(s + f32(1.0)) / f32(warm), f32(1.0))
        decay = min(max(f32(f32(total) - s) / f32(max(total - down, 1.0)),
                        f32(0.0)), f32(1.0))
        return float(f32(f32(base(step)) * ramp)
                     * (decay if s > f32(down) else f32(1.0)))

    return schedule


def pow32(base: float, n: int) -> np.float32:
    """f32(base) ** n as XLA computes a float to an integer power:
    square-and-multiply in f32."""
    b, acc = f32(base), f32(1.0)
    while n:
        if n & 1:
            acc = f32(acc * b)
        b = f32(b * b)
        n >>= 1
    return acc


def is_lookahead_type(type_str: str) -> bool:
    t = type_str.lower()
    return t.startswith("lookahead") or t in ("ranger", "ranger21")


# -- transforms: (updates, params, state, count) -> updates ----------------
# `count` is the number of updates made before this one; per-leaf state
# lives in `state` under the names each transform lists in `slots`.

class Transform:
    slots: Dict[str, str] = {}   # state name -> "leaf" or "scalar" per leaf

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        return {k: [torch.zeros_like(p) if kind == "leaf"
                    else torch.zeros((), dtype=p.dtype, device=p.device)
                    for p in params]
                for k, kind in self.slots.items()}

    def __call__(self, u: Leaves, params: Leaves, state: dict,
                 count: int) -> Leaves:
        raise NotImplementedError


class ClipByGlobalNorm(Transform):
    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def __call__(self, u, params, state, count):
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in u))
        keep = g_norm < self.max_norm
        return [torch.where(keep, g, (g / g_norm) * self.max_norm) for g in u]


def unitwise_norm(x: torch.Tensor) -> torch.Tensor:
    """optax's unitwise_norm: a leaf that squeezes to at most one dimension
    over all of it, 2-D and 3-D leaves over axis 0, 4-D over (0, 1, 2);
    broadcast to the leaf's shape."""
    if x.squeeze().dim() <= 1:
        axes = tuple(range(x.dim()))
    elif x.dim() in (2, 3):
        axes = (0,)
    elif x.dim() == 4:
        axes = (0, 1, 2)
    else:
        raise ValueError(f"Expected parameter with shape in {{1, 2, 3, 4}}, "
                         f"got {tuple(x.shape)}")
    sq = torch.sum(x * x, dim=axes, keepdim=True) if axes else x * x
    return torch.sqrt(sq).expand(x.shape)


class AdaptiveGradClip(Transform):
    def __init__(self, clipping: float, eps: float = 1e-3):
        self.clipping, self.eps = clipping, eps

    def __call__(self, u, params, state, count):
        out = []
        for g, p in zip(u, params):
            g_norm = unitwise_norm(g)
            max_norm = self.clipping * torch.clamp(unitwise_norm(p),
                                                   min=self.eps)
            clipped = g * (max_norm / torch.clamp(g_norm, min=1e-6))
            out.append(torch.where(g_norm < max_norm, g, clipped))
        return out


class Centralize(Transform):
    """Gradient centralization: a leaf of more than one dimension loses its
    mean over every axis but the first."""

    def __call__(self, u, params, state, count):
        return [g if g.dim() <= 1 else
                g - g.mean(dim=tuple(range(1, g.dim())), keepdim=True)
                for g in u]


class ScaleByAdam(Transform):
    slots = {"mu": "leaf", "nu": "leaf"}

    def __init__(self, b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def __call__(self, u, params, state, count):
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** (count + 1)
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** (count + 1)
        out = []
        for i, g in enumerate(u):
            mu = (1 - b1) * g + b1 * state["mu"][i]
            nu = (1 - b2) * (g * g) + b2 * state["nu"][i]
            state["mu"][i], state["nu"][i] = mu, nu
            out.append((mu / bc1.to(g.device))
                       / (torch.sqrt(nu / bc2.to(g.device)) + self.eps))
        return out


class ScaleByRAdam(Transform):
    slots = {"mu": "leaf", "nu": "leaf"}

    def __init__(self, b1=0.9, b2=0.999, eps=1e-8, threshold=5.0):
        self.b1, self.b2, self.eps, self.threshold = b1, b2, eps, threshold
        self.ro_inf = 2.0 / (1.0 - b2) - 1.0

    def rectification(self, count_inc: int):
        """(rho, r) of optax's scale_by_radam at this count, in f32."""
        ro_inf = f32(self.ro_inf)
        b2t = pow32(self.b2, count_inc)
        ro = f32(ro_inf - f32(f32(f32(2 * count_inc) * b2t)
                              / f32(f32(1.0) - b2t)))
        num = f32(f32(f32(ro - f32(4.0)) * f32(ro - f32(2.0))) * ro_inf)
        den = f32(f32((self.ro_inf - 4.0) * (self.ro_inf - 2.0)) * ro)
        with np.errstate(invalid="ignore"):
            return ro, np.sqrt(f32(num / den))

    def __call__(self, u, params, state, count):
        b1, b2 = self.b1, self.b2
        n = count + 1
        bc1 = float(f32(f32(1.0) - pow32(b1, n)))
        bc2 = float(f32(f32(1.0) - pow32(b2, n)))
        ro, r = self.rectification(n)
        rectified = bool(ro >= f32(self.threshold))
        out = []
        for i, g in enumerate(u):
            mu = (1 - b1) * g + b1 * state["mu"][i]
            nu = (1 - b2) * (g * g) + b2 * state["nu"][i]
            state["mu"][i], state["nu"][i] = mu, nu
            mu_hat = mu / bc1
            out.append(float(r) * mu_hat / (torch.sqrt(nu / bc2) + self.eps)
                       if rectified else mu_hat)
        return out


class ScaleByNovograd(Transform):
    """optax's scale_by_novograd: the second moment is one scalar a leaf
    (its squared norm), seeded from the first step's gradient."""
    slots = {"mu": "leaf", "nu": "scalar"}

    def __init__(self, b1=0.9, b2=0.25, eps=1e-6, weight_decay=0.0):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay

    def __call__(self, u, params, state, count):
        first = count == 0
        out = []
        for i, (g, p) in enumerate(zip(u, params)):
            sq = torch.sqrt(torch.sum(g * g)) ** 2
            nu = sq if first else (1 - self.b2) * sq + self.b2 * state["nu"][i]
            step = g / (torch.sqrt(nu) + self.eps) + self.wd * p
            mu = step if first else self.b1 * state["mu"][i] + step
            state["mu"][i], state["nu"][i] = mu, nu
            out.append(mu)
        return out


class Trace(Transform):
    """optax's trace (SGD momentum), Nesterov's form."""
    slots = {"trace": "leaf"}

    def __init__(self, decay: float, nesterov: bool):
        self.decay, self.nesterov = decay, nesterov

    def __call__(self, u, params, state, count):
        out = []
        for i, g in enumerate(u):
            t = g + self.decay * state["trace"][i]
            state["trace"][i] = t
            out.append(g + self.decay * t if self.nesterov else t)
        return out


class ScaleByAdadelta(Transform):
    slots = {"e_g": "leaf", "e_x": "leaf"}

    def __init__(self, rho=0.9, eps=1e-6):
        self.rho, self.eps = rho, eps

    def __call__(self, u, params, state, count):
        rho = self.rho
        out = []
        for i, g in enumerate(u):
            e_g = (1 - rho) * (g * g) + rho * state["e_g"][i]
            x = (torch.sqrt(state["e_x"][i] + self.eps)
                 / torch.sqrt(e_g + self.eps)) * g
            state["e_g"][i] = e_g
            state["e_x"][i] = (1 - rho) * (x * x) + rho * state["e_x"][i]
            out.append(x)
        return out


class NormLoss(Transform):
    """Ranger21's norm loss: adds factor * (1 - 1/||p||) * p, the norm over
    every axis but the first for a leaf of more than one dimension."""

    def __init__(self, factor: float):
        self.factor = factor

    def __call__(self, u, params, state, count):
        out = []
        for x, p in zip(u, params):
            sq = (torch.sum(p * p, dim=tuple(range(1, p.dim())), keepdim=True)
                  if p.dim() > 1 else torch.sum(p * p))
            corr = self.factor * (1.0 - 1.0 / torch.clamp(torch.sqrt(sq),
                                                          min=1e-3))
            out.append(x + corr * p)
        return out


class AddDecayedWeights(Transform):
    def __init__(self, weight_decay: float):
        self.wd = weight_decay

    def __call__(self, u, params, state, count):
        if not self.wd:
            return u
        return [x + self.wd * p for x, p in zip(u, params)]


class ScaleByLearningRate(Transform):
    def __init__(self, schedule: Callable[[int], float]):
        self.schedule = schedule

    def __call__(self, u, params, state, count):
        step_size = -self.schedule(count)
        return [torch.tensor(step_size, dtype=x.dtype, device=x.device) * x
                for x in u]


def build_chain(cfg: OptimConfig, lr: Callable[[int], float],
                steps_per_epoch: int) -> List[Transform]:
    """The transforms of JAX build_optimizer for cfg.type, Lookahead
    apart."""
    t = cfg.type.lower()
    chain: List[Transform] = [ClipByGlobalNorm(cfg.max_grad_norm)]
    if t in ADAM_TYPES:
        inner = [ScaleByAdam(), AddDecayedWeights(cfg.weight_decay)]
    elif t in ("radam", "lookahead_radam"):
        inner = [ScaleByRAdam()]
    elif t in ("novograd", "lookahead_novograd"):
        inner = [ScaleByNovograd(weight_decay=cfg.weight_decay)]
    elif t == "sgd":
        inner = [Trace(0.9, nesterov=True)]
    elif t == "adadelta":
        inner = [ScaleByAdadelta()]
    elif t == "ranger":
        # the PileupModel flavor: gradient centralization -> RAdam
        chain.append(Centralize())
        inner = [ScaleByRAdam()]
    elif t == "ranger21":
        # the HaplotypeModel flavor, the global-norm clip kept beside AGC
        chain += [AdaptiveGradClip(0.01), Centralize()]
        inner = [ScaleByAdam(), NormLoss(6e-4),
                 AddDecayedWeights(cfg.weight_decay)]
        lr = ranger21_schedule(cfg, steps_per_epoch, lr)
    else:
        raise NotImplementedError(f"unknown optimizer type {cfg.type!r}")
    return chain + inner + [ScaleByLearningRate(lr)]


class Optimizer:
    """The chain of cfg.type [-> Lookahead] -> freeze mask, updating
    tensors in place. The state is a plain dict (picklable as numpy by
    the trainers): `count` and `steps_since_sync`, and per-leaf lists
    named by the transforms (Adam's and RAdam's `mu`, `nu`; novograd's
    `mu` and one-scalar-a-leaf `nu`; SGD's `trace`; AdaDelta's `e_g`,
    `e_x`)."""

    def __init__(self, cfg: OptimConfig, steps_per_epoch: int = 1000,
                 finetune: bool = False):
        base = lr_schedule(cfg, steps_per_epoch)
        lr = (lambda step: 0.1 * base(step)) if finetune else base
        self.type = cfg.type.lower()
        self.chain = build_chain(cfg, lr, steps_per_epoch)
        self.lookahead = is_lookahead_type(self.type)
        self.sync_period = cfg.lookahead_sync_period
        self.slow_step = cfg.lookahead_slow_step

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        state = {"count": 0, "steps_since_sync": 0}
        for tr in self.chain:
            state.update(tr.init(params))
        return state

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: Sequence[torch.Tensor],
             state: dict, slow: Optional[List[torch.Tensor]] = None,
             scales: Optional[Sequence[float]] = None) -> None:
        """One update, in place: `params` (the fast params), `slow` (the
        Lookahead slow params, required with Lookahead), `state`. `scales`
        multiplies each leaf's updates (the freeze mask)."""
        if self.lookahead and slow is None:
            raise ValueError("Lookahead needs the slow params")
        u = list(grads)
        for tr in self.chain:
            u = tr(u, params, state, state["count"])
        sync = self.lookahead and \
            state["steps_since_sync"] == self.sync_period - 1
        for i, (p, x) in enumerate(zip(params, u)):
            scale = 1.0 if scales is None else scales[i]
            if sync:
                diff = p + x - slow[i]
                slow_u = self.slow_step * diff
                x = x - (1 - self.slow_step) * diff
                slow[i].add_(slow_u if scale == 1.0 else slow_u * scale)
            p.add_(x if scale == 1.0 else x * scale)
        state["count"] += 1
        if self.lookahead:
            state["steps_since_sync"] = (state["steps_since_sync"] + 1) \
                % self.sync_period


def build_optimizer(cfg: OptimConfig, steps_per_epoch: int = 1000,
                    finetune: bool = False) -> Optimizer:
    return Optimizer(cfg, steps_per_epoch, finetune)
