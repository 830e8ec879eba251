"""NanoSNP's legacy CatModel in plain PyTorch, f32, for the check of the
CatModel trainer: the forward pass in training mode, the smoothed cross
entropy, the gradients by autograd and Adam's steps.

Written from NanoSNP's HaplotypeModel/model.py:201-360 (CatModel's active
branches: the percentage branch, a 3-layer BiLSTM over the per-tag A, C,
G, T, deletion fractions of both views with dropout between its layers,
then a Linear; the spatial branch, ResCRNN; the head over both branches'
center states) and HaplotypeModel/crnn.py:95-190 (ResCRNN: six 3x3
ResBlocks with BatchNorm and 1x1 shortcut convolutions, max-pools that
collapse the depth of 2 x 20 reads to 1, two BiLSTM + Linear layers over
the 11 positions). Imports nothing of the program. Every product and
convolution goes through a `Precision` (precision.py), in its forward
and in both products of its backward; the recurrences are models.py's
autograd op, so they round where the configuration says.

Departures from NanoSNP's CatModel, each the JAX package's and the
port's:
  - BatchNorm moves its running variance by the *biased* batch variance
    (torch's BatchNorm2d moves it by n / (n - 1) of that);
  - each BiLSTM direction has one folded bias, b_ih + b_hh;
  - label smoothing as optax.smooth_labels, (1 - s) one_hot + s / C,
    where NanoSNP's LabelSmoothingLoss (models.smoothed_ce) puts s / (C -
    1) on every other class;
  - Adam as optax's (eps outside the square root of the bias-corrected
    second moment), no gradient clipping, a constant rate;
  - the max-pools pad with -inf on the width axis only (kw // 2 a side),
    where NanoSNP's MaxPool2d layers state no padding of the depth.
"""
from __future__ import annotations

from statistics import median
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .models import encoder
from .precision import Precision, exact, matmul

BLOCKS = [(10, 32), (32, 64), (64, 128), (128, 128), (128, 256),
          (256, 256)]
# after block i: (kernel, stride) on (depth, width)
POOLS = {0: ((2, 3), (2, 1)), 1: ((2, 3), (2, 1)), 3: ((3, 3), (3, 1)),
         5: ((2, 3), (2, 1))}
BN_EPS, BN_MOMENTUM = 1e-5, 0.1
DROPOUT = 0.5


class _RoundedConv(torch.autograd.Function):
    """conv2d with both operands rounded, in the forward and in the
    backward's two products (input and weight gradients)."""

    @staticmethod
    def forward(ctx, x, w, r, padding):
        ctx.r, ctx.padding = r, padding
        ctx.save_for_backward(x, w)
        return F.conv2d(r(x), r(w), padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        r, pad = ctx.r, ctx.padding
        gx = torch.nn.grad.conv2d_input(x.shape, r(w), r(g), padding=pad)
        gw = torch.nn.grad.conv2d_weight(r(x), w.shape, r(g), padding=pad)
        return gx, gw, None, None


def conv(x: torch.Tensor, w: torch.Tensor, p: Precision) -> torch.Tensor:
    """'Same' convolution of [N, C, H, W] by w [C_out, C_in, kh, kw]."""
    pad = (w.shape[2] // 2, w.shape[3] // 2)
    if p.mm is exact:
        return F.conv2d(x, w, padding=pad)
    return _RoundedConv.apply(x, w, p.mm, pad)


def batch_norm(x: torch.Tensor, bn: dict, moved: dict) -> torch.Tensor:
    """Training mode: the batch's mean and biased variance normalise;
    `moved` gets the running statistics each moves to."""
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    with torch.no_grad():
        moved["mean"] = bn["mean"] * (1 - BN_MOMENTUM) + BN_MOMENTUM * mean
        moved["var"] = bn["var"] * (1 - BN_MOMENTUM) + BN_MOMENTUM * var
    y = (x - mean[None, :, None, None]) \
        * torch.rsqrt(var + BN_EPS)[None, :, None, None]
    return y * bn["scale"][None, :, None, None] \
        + bn["bias"][None, :, None, None]


def percentage(reads: torch.Tensor) -> torch.Tensor:
    """[..., D] base codes -> [..., 5] fractions of A, C, G, T and
    deletions (-1) over the reads present (pad -2), model.py:192-198."""
    denom = (reads != -2).sum(-1) + 1e-9
    return torch.stack([(reads == c).sum(-1) / denom
                        for c in (1, 2, 3, 4, -1)], dim=-1).float()


def _dense(x: torch.Tensor, layer: dict, p: Precision) -> torch.Tensor:
    lead = x.shape[:-1]
    y = matmul(x.reshape(-1, x.shape[-1]), layer["w"], p.mm) + layer["b"]
    return y.view(*lead, -1)


def logits(params: dict, g0: torch.Tensor, g1: torch.Tensor, p: Precision,
           gen: Optional[torch.Generator], moved: List[dict]
           ) -> torch.Tensor:
    """g0, g1 [N, 2 md, 11, 5] stacked-tag images (surrounding and
    adjacent-het views) -> gt logits [N, C], in training mode. Dropout
    masks come from `gen` (None: no dropout); `moved` gets each ResBlock's
    {"bn1": {mean, var}, "bn2": {...}} running statistics after the
    batch."""
    md = g0.shape[1] // 2
    r0 = g0[..., 0].transpose(1, 2)                       # [N, 11, 2md]
    r1 = g1[..., 0].transpose(1, 2)
    pct = torch.cat([percentage(r0[..., :md]), percentage(r0[..., md:]),
                     percentage(r1[..., :md]), percentage(r1[..., md:])],
                    dim=2)                                # [N, 11, 20]
    enc = encoder(params["percentage_rnn"], pct, p, train=True,
                  dropout=DROPOUT if gen is not None else 0.0, gen=gen)
    p_out = _dense(enc, params["percentage_proj"], p)
    p_ctr = p_out[:, p_out.shape[1] // 2]

    x = torch.cat([g0.permute(0, 3, 1, 2), g1.permute(0, 3, 1, 2)],
                  dim=1).float()                          # [N, 10, 2md, 11]
    for i, blk in enumerate(params["res_blocks"]):
        m = {"bn1": {}, "bn2": {}}
        y = torch.relu(batch_norm(conv(x, blk["conv1"], p), blk["bn1"],
                                  m["bn1"]))
        y = batch_norm(conv(y, blk["conv2"], p), blk["bn2"], m["bn2"])
        x = torch.relu(y + conv(x, blk["shortcut"], p))
        moved.append(m)
        if i in POOLS:
            k, s = POOLS[i]
            x = F.max_pool2d(x, k, s, padding=(0, k[1] // 2))
    if x.shape[2] != 1:
        raise ValueError(f"the tower left depth {x.shape[2]}, not 1")
    seq = x[:, :, 0, :].transpose(1, 2)                   # [N, 11, 256]
    for lstm, proj in (("crnn_lstm1", "crnn_proj1"),
                       ("crnn_lstm2", "crnn_proj2")):
        seq = _dense(encoder(params[lstm], seq, p, train=True),
                     params[proj], p)
    s_ctr = seq[:, seq.shape[1] // 2]
    return _dense(torch.cat([p_ctr, s_ctr], dim=1), params["out"], p)


def smoothed_ce(z: torch.Tensor, y: torch.Tensor,
                smoothing: float) -> torch.Tensor:
    """Batch mean of the cross entropy against (1 - s) one_hot + s / C."""
    n_class = z.shape[-1]
    target = F.one_hot(y.long(), n_class).float() * (1.0 - smoothing) \
        + smoothing / n_class
    return -(target * torch.log_softmax(z, dim=-1)).sum(-1).mean()


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


def is_stat(path) -> bool:
    """A BatchNorm running statistic: state, not a trained weight."""
    return path[-1] in ("mean", "var")


def first_steps(init: dict, batches: List[dict], p: Precision, lr: float,
                smoothing: float, seed: int, device,
                dropout: bool = True) -> Dict[str, object]:
    """Adam steps (b1 0.9, b2 0.999, eps 1e-8) from `init` over `batches`
    ({g0, g1, y}) -> {"losses": [...], "grad": {path: norm of step 1's
    gradient}, "delta": {path: norm of the weight's change after the
    last step}, "stats": {path: running statistic after the last step},
    "weights": {path: weight after the last step}}.
    Dropout masks are drawn from a generator seeded with `seed`."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    items = list(_leaves(init))
    state = [t.detach().clone().float() for _, t in items]
    train = [i for i, (path, _) in enumerate(items) if not is_stat(path)]
    for i in train:
        state[i].requires_grad_(True)
    weights = [state[i] for i in train]
    mu = [torch.zeros_like(x) for x in weights]
    nu = [torch.zeros_like(x) for x in weights]
    gen = torch.Generator(device=device).manual_seed(int(seed)) \
        if dropout else None
    losses, grad = [], {}
    for step, batch in enumerate(batches, start=1):
        params = _rebuild(init, iter(state))
        moved: List[dict] = []
        g0, g1, y = (torch.as_tensor(batch[k]).to(device)
                     for k in ("g0", "g1", "y"))
        loss = smoothed_ce(logits(params, g0.float(), g1.float(), p, gen,
                                  moved), y, smoothing)
        gs = torch.autograd.grad(loss, weights)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if step == 1:
                grad = {items[i][0]: float(g.double().norm())
                        for i, g in zip(train, gs)}
            for x, g, m, v in zip(weights, gs, mu, nu):
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                upd = (m / (1 - b1 ** step)) / (
                    torch.sqrt(v / (1 - b2 ** step)) + eps)
                x.sub_(lr * upd)
            for blk, m in zip(params["res_blocks"], moved):
                for bn in ("bn1", "bn2"):
                    blk[bn]["mean"].copy_(m[bn]["mean"])
                    blk[bn]["var"].copy_(m[bn]["var"])
    delta = {items[i][0]: float((state[i].detach().double()
                                 - items[i][1].double()).norm())
             for i in train}
    stats = {path: state[i].detach().clone()
             for i, (path, _) in enumerate(items) if is_stat(path)}
    return {"losses": losses, "grad": grad, "delta": delta, "stats": stats,
            "weights": {items[i][0]: state[i].detach() for i in train}}


def stats_gap(got: Dict[tuple, torch.Tensor],
              want: Dict[tuple, torch.Tensor]) -> float:
    """The widest gap between the running statistics, a leaf's
    norm(got - want) over the larger of norm(want) and the median
    leaf's: a wrong batch, a missed or doubled update, moves every
    BatchNorm's."""
    norms = {k: float(v.double().norm()) for k, v in want.items()}
    floor = median(norms.values())
    return max(float((got[k].double().to(v.device) - v.double()).norm())
               / max(norms[k], floor) for k, v in want.items())
