"""The reference's first training steps: label-smoothed cross entropy on
the gt and zy heads, gradients by autograd through models.py (its own
recurrence op), clipping by global norm, Adam (b1 0.9, b2 0.999, eps
1e-8) with the lr of the configuration, and Lookahead: every
`sync_period`-th step the slow weights move by `slow_step` of the way to
the fast ones, and the fast ones are set to them. Dropout masks are drawn from
a generator seeded as the configuration says, in the order of the
forward: the pileup branch's layers, then the haplotype branch's.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from . import features as F
from .models import haplotype_logits, pileup_logits, smoothed_ce
from .precision import Precision


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def _loss(kind, params, batch, p, dropout, gen, smoothing, device):
    def t(k):
        return torch.as_tensor(batch[k]).to(device)

    def reads(k):
        # the training feed ships read matrices and codes as int8
        return t(k).float().clamp(-128, 127)

    if kind == "pileup":
        gt, zy = pileup_logits(params, t("x").float(), p, train=True,
                               dropout=dropout, gen=gen)
    else:
        xp = F.features(*[reads("p_" + k) for k in
                          ("seq", "baseq", "mapq", "hap", "ref")])
        xh = F.features(*[reads("h_" + k) for k in
                          ("seq", "baseq", "mapq", "hap", "ref")])
        gt, zy = haplotype_logits(params, xp, xh, p, train=True,
                                  dropout=dropout, gen=gen)
    return (smoothed_ce(gt, t("gt"), smoothing)
            + smoothed_ce(zy, t("zy"), smoothing))


def first_steps(kind: str, init: dict, batches: List[dict], p: Precision,
                train_cfg: dict, dropout: float, seed: int,
                device) -> Dict[str, object]:
    """Steps from `init` over `batches` -> {"losses": [...], "grad":
    {path: norm of step 1's clipped gradient}, "delta": {path: norm of
    the (fast) parameters' change after the last step}}. The lr is the
    configuration's first: its decay begins epochs later."""
    opt = train_cfg["optim"]
    if opt["weight_decay"]:
        raise ValueError("the reference has no weight decay")
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr, clip = opt["lr"], opt["max_grad_norm"]
    period, alpha = opt["lookahead_sync_period"], opt["lookahead_slow_step"]
    smoothing = opt["label_smoothing"]
    paths = [path for path, _ in _leaves(init)]
    leaves = [t.detach().clone().float().requires_grad_(True)
              for _, t in _leaves(init)]
    mu = [torch.zeros_like(x) for x in leaves]
    nu = [torch.zeros_like(x) for x in leaves]
    slow = [x.detach().clone() for x in leaves]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    losses, grad = [], {}
    for step, batch in enumerate(batches, start=1):
        params = _rebuild(init, iter(leaves))
        loss = _loss(kind, params, batch, p, dropout, gen, smoothing, device)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True,
                                 materialize_grads=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in gs))
            scale = 1.0 if float(norm) < clip else clip / float(norm)
            gs = [g * scale for g in gs]
            if step == 1:
                grad = {path: float(g.double().norm())
                        for path, g in zip(paths, gs)}
            for x, g, m, v in zip(leaves, gs, mu, nu):
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                upd = (m / (1 - b1 ** step)) / (
                    torch.sqrt(v / (1 - b2 ** step)) + eps)
                x.sub_(lr * upd)
            if step % period == 0:
                for x, s in zip(leaves, slow):
                    s.add_(alpha * (x - s))
                    x.copy_(s)
    delta = {path: float((x.detach().double() - t.double()).norm())
             for path, x, (_, t) in zip(paths, leaves, _leaves(init))}
    return {"losses": losses, "grad": grad, "delta": delta}
