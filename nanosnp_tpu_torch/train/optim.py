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

Every scalar that depends on the update count (Adam's and RAdam's bias
corrections, RAdam's rectification and its switch, novograd's first
step, the lr, Lookahead's sync) and the freeze scale come from a table
that `Optimizer.scalar_table` computes on the host for counts c ... c+G-1,
one f32 row an update; `Optimizer.update` reads one row of it as a device
tensor, and host branches are `torch.where`s. So G updates run with no
host value baked in, as one CUDA graph replays them (train/group.py), and
a single step is the table's one-row case. optax computes those scalars
in f32 from the count, and so does the table: XLA raises a float to an
integer power by square-and-multiply (`pow32`), and RAdam's rectification
term is too sensitive to rho for a one-ulp difference there; the Adam
path keeps torch's f32 pow, as it always has. Per-leaf state keeps its
storage: each update writes its new value into the state tensor
(`copy_`), computed as before, not by fused in-place arithmetic.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


# -- transforms: (updates, params, state, scalars) -> updates --------------
# Per-leaf state lives in `state` under the names each transform lists in
# `slots` and is written in place. `scalars` are the transform's per-update
# scalars, 0-d tensors in the order of `scalar_names`, which
# `scalar_values(count)` computes on the host (`count` is the number of
# updates made before this one).

class Transform:
    slots: Dict[str, str] = {}   # state name -> "leaf" or "scalar" per leaf
    scalar_names: Tuple[str, ...] = ()

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        return {k: [torch.zeros_like(p) if kind == "leaf"
                    else torch.zeros((), dtype=p.dtype, device=p.device)
                    for p in params]
                for k, kind in self.slots.items()}

    def scalar_values(self, count: int) -> Sequence[float]:
        return ()

    def __call__(self, u: Leaves, params: Leaves, state: dict,
                 scalars: Sequence[torch.Tensor]) -> Leaves:
        raise NotImplementedError


class ClipByGlobalNorm(Transform):
    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def __call__(self, u, params, state, scalars):
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

    def __call__(self, u, params, state, scalars):
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

    def __call__(self, u, params, state, scalars):
        return [g if g.dim() <= 1 else
                g - g.mean(dim=tuple(range(1, g.dim())), keepdim=True)
                for g in u]


class ScaleByAdam(Transform):
    slots = {"mu": "leaf", "nu": "leaf"}
    scalar_names = ("bc1", "bc2")

    def __init__(self, b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def scalar_values(self, count):
        # the bias corrections with torch's f32 pow
        return [float(1.0 - torch.tensor(b, dtype=torch.float32)
                      ** (count + 1)) for b in (self.b1, self.b2)]

    def __call__(self, u, params, state, scalars):
        b1, b2 = self.b1, self.b2
        bc1, bc2 = scalars
        out = []
        for i, g in enumerate(u):
            mu = (1 - b1) * g + b1 * state["mu"][i]
            nu = (1 - b2) * (g * g) + b2 * state["nu"][i]
            state["mu"][i].copy_(mu)
            state["nu"][i].copy_(nu)
            out.append((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps))
        return out


class ScaleByRAdam(Transform):
    slots = {"mu": "leaf", "nu": "leaf"}
    scalar_names = ("bc1", "bc2", "r", "rectified")

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

    def scalar_values(self, count):
        n = count + 1
        ro, r = self.rectification(n)
        # r may be NaN before the switch, where it is not read
        return [f32(f32(1.0) - pow32(self.b1, n)),
                f32(f32(1.0) - pow32(self.b2, n)), r,
                float(ro >= f32(self.threshold))]

    def __call__(self, u, params, state, scalars):
        b1, b2 = self.b1, self.b2
        bc1, bc2, r, rectified = scalars
        rectified = rectified > 0
        out = []
        for i, g in enumerate(u):
            mu = (1 - b1) * g + b1 * state["mu"][i]
            nu = (1 - b2) * (g * g) + b2 * state["nu"][i]
            state["mu"][i].copy_(mu)
            state["nu"][i].copy_(nu)
            mu_hat = mu / bc1
            out.append(torch.where(
                rectified, r * mu_hat / (torch.sqrt(nu / bc2) + self.eps),
                mu_hat))
        return out


class ScaleByNovograd(Transform):
    """optax's scale_by_novograd: the second moment is one scalar a leaf
    (its squared norm), seeded from the first step's gradient."""
    slots = {"mu": "leaf", "nu": "scalar"}
    scalar_names = ("first",)

    def __init__(self, b1=0.9, b2=0.25, eps=1e-6, weight_decay=0.0):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay

    def scalar_values(self, count):
        return [float(count == 0)]

    def __call__(self, u, params, state, scalars):
        first = scalars[0] > 0
        out = []
        for i, (g, p) in enumerate(zip(u, params)):
            sq = torch.sqrt(torch.sum(g * g)) ** 2
            nu = torch.where(first, sq, (1 - self.b2) * sq
                             + self.b2 * state["nu"][i])
            step = g / (torch.sqrt(nu) + self.eps) + self.wd * p
            mu = torch.where(first, step, self.b1 * state["mu"][i] + step)
            state["mu"][i].copy_(mu)
            state["nu"][i].copy_(nu)
            out.append(mu)
        return out


class Trace(Transform):
    """optax's trace (SGD momentum), Nesterov's form."""
    slots = {"trace": "leaf"}

    def __init__(self, decay: float, nesterov: bool):
        self.decay, self.nesterov = decay, nesterov

    def __call__(self, u, params, state, scalars):
        out = []
        for i, g in enumerate(u):
            t = g + self.decay * state["trace"][i]
            state["trace"][i].copy_(t)
            out.append(g + self.decay * t if self.nesterov else t)
        return out


class ScaleByAdadelta(Transform):
    slots = {"e_g": "leaf", "e_x": "leaf"}

    def __init__(self, rho=0.9, eps=1e-6):
        self.rho, self.eps = rho, eps

    def __call__(self, u, params, state, scalars):
        rho = self.rho
        out = []
        for i, g in enumerate(u):
            e_g = (1 - rho) * (g * g) + rho * state["e_g"][i]
            x = (torch.sqrt(state["e_x"][i] + self.eps)
                 / torch.sqrt(e_g + self.eps)) * g
            e_x = (1 - rho) * (x * x) + rho * state["e_x"][i]
            state["e_g"][i].copy_(e_g)
            state["e_x"][i].copy_(e_x)
            out.append(x)
        return out


class NormLoss(Transform):
    """Ranger21's norm loss: adds factor * (1 - 1/||p||) * p, the norm over
    every axis but the first for a leaf of more than one dimension."""

    def __init__(self, factor: float):
        self.factor = factor

    def __call__(self, u, params, state, scalars):
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

    def __call__(self, u, params, state, scalars):
        if not self.wd:
            return u
        return [x + self.wd * p for x, p in zip(u, params)]


class ScaleByLearningRate(Transform):
    scalar_names = ("step_size",)

    def __init__(self, schedule: Callable[[int], float]):
        self.schedule = schedule

    def scalar_values(self, count):
        return [-self.schedule(count)]

    def __call__(self, u, params, state, scalars):
        return [scalars[0] * x for x in u]


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

    @property
    def n_scalars(self) -> int:
        """Columns of `scalar_table`: every transform's scalars, then
        Lookahead's sync flag and the freeze scale."""
        return sum(len(tr.scalar_names) for tr in self.chain) + 2

    def scalar_table(self, state: dict, n: int,
                     freeze_on: float = 0.0) -> np.ndarray:
        """[n, n_scalars] f32: row i holds the scalars of the update made
        after state's `count` + i updates (each transform's
        `scalar_values`, in chain order), Lookahead's sync flag (1 where
        the update completes a sync period) and the freeze scale
        1 - freeze_on, which multiplies the frozen leaves' updates."""
        rows = []
        for i in range(n):
            row = [v for tr in self.chain
                   for v in tr.scalar_values(state["count"] + i)]
            sync = self.lookahead and (state["steps_since_sync"] + i) \
                % self.sync_period == self.sync_period - 1
            rows.append(row + [float(sync), 1.0 - freeze_on])
        return np.asarray(rows, np.float32).reshape(n, self.n_scalars)

    @torch.no_grad()
    def update(self, params: List[torch.Tensor],
               grads: Sequence[torch.Tensor], state: dict,
               row: torch.Tensor, slow: Optional[List[torch.Tensor]] = None,
               frozen: Optional[Sequence[bool]] = None) -> None:
        """One update, in place: `params` (the fast params), `slow` (the
        Lookahead slow params, required with Lookahead), the per-leaf
        state. Every count-dependent value comes from `row`, a row of
        `scalar_table` as a tensor on the params' device; the frozen
        leaves' updates (fast and slow) are multiplied by its freeze
        scale. The counts do not move: `advance` moves them."""
        if self.lookahead and slow is None:
            raise ValueError("Lookahead needs the slow params")
        u, at = list(grads), 0
        for tr in self.chain:
            k = len(tr.scalar_names)
            u = tr(u, params, state, [row[at + j] for j in range(k)])
            at += k
        sync, keep = row[at] > 0, row[at + 1]
        for i, (p, x) in enumerate(zip(params, u)):
            scaled = frozen is not None and frozen[i]
            if self.lookahead:
                diff = p + x - slow[i]
                slow_u = self.slow_step * diff
                x = torch.where(sync, x - (1 - self.slow_step) * diff, x)
                slow[i].copy_(torch.where(
                    sync, slow[i] + (slow_u * keep if scaled else slow_u),
                    slow[i]))
            p.add_(x * keep if scaled else x)

    def advance(self, state: dict, n: int) -> None:
        """Move the counts past n updates."""
        state["count"] += n
        if self.lookahead:
            state["steps_since_sync"] = (state["steps_since_sync"] + n) \
                % self.sync_period

    def first_row(self, state: dict, freeze_on: float,
                  device: torch.device) -> torch.Tensor:
        """The scalars of the next update, on `device`: a single step's
        table."""
        return torch.from_numpy(self.scalar_table(state, 1, freeze_on)[0]
                                ).to(device)

    def step(self, params: List[torch.Tensor], grads: Sequence[torch.Tensor],
             state: dict, slow: Optional[List[torch.Tensor]] = None,
             frozen: Optional[Sequence[bool]] = None,
             freeze_on: float = 0.0) -> None:
        """One update from the counts in `state`: `update` with the
        one-row table, then `advance`."""
        self.update(params, grads, state,
                    self.first_row(state, freeze_on, params[0].device), slow,
                    frozen)
        self.advance(state, 1)


def build_optimizer(cfg: OptimConfig, steps_per_epoch: int = 1000,
                    finetune: bool = False) -> Optimizer:
    return Optimizer(cfg, steps_per_epoch, finetune)
