"""The two NanoSNP models in plain PyTorch: the pileup model (BiLSTM stack
over [N, 33, 18] counts, center state, proj, tanh dense, gt and zy heads)
and the haplotype model (a 3-layer BiLSTM over each of the 33-long
pileup and the 11-long haplotype features, each center projected, tanh
dense over both, gt and zy heads), after NanoSNP's PileupModel and
HaplotypeModel. Gate order i, f, g, o; one folded bias a direction.

Written from the published equations over the parameter tree of
worlds/weights.py; imports nothing of the program. Every product goes
through a `Precision` (precision.py). Training's recurrence is a
hand-written autograd op, so that the backward sweep rounds where the
configuration says it does (dgates before the product with w_hh^T, dW_hh
once at the end) and not where autograd's casts would.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from .precision import Precision, matmul


def _order(seq_len: int, d: int) -> List[int]:
    return list(range(seq_len)) if d == 0 else list(range(seq_len - 1, -1, -1))


def _cell(gates, c, hidden):
    i, f, g, o = gates.split(hidden, dim=1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def inproj(x: torch.Tensor, layer: dict, p: Precision) -> torch.Tensor:
    """xp [N, L, 2, 4H] = x w_ih[d] + b[d] for both directions."""
    n, seq_len, d_in = x.shape
    four_h = layer["w_hh"].shape[2]
    w = layer["w_ih"].permute(1, 0, 2).reshape(d_in, 2 * four_h)
    xp = matmul(x.reshape(-1, d_in), w, p.mm) + layer["b"].reshape(-1)
    return xp.view(n, seq_len, 2, four_h)


@torch.no_grad()
def recurrence(xp: torch.Tensor, w_hh: torch.Tensor, p: Precision):
    """Both directions' step loops -> hs, cs [N, L, 2, H]."""
    n, seq_len, _, four_h = xp.shape
    hidden = four_h // 4
    hs = xp.new_empty(n, seq_len, 2, hidden)
    cs = xp.new_empty(n, seq_len, 2, hidden)
    for d in (0, 1):
        w = p.rec(w_hh[d])
        h = xp.new_zeros(n, hidden)
        c = xp.new_zeros(n, hidden)
        for t in _order(seq_len, d):
            h, c = _cell(xp[:, t, d] + p.rec(h) @ w, c, hidden)
            hs[:, t, d], cs[:, t, d] = h, c
    return hs, cs


class Recurrence(torch.autograd.Function):
    """hs = recurrence(xp, w_hh) with its backward sweep written out:
    gradients for xp (every step's dgates) and w_hh (sum over rows and
    steps of h_{t-1}^T dgates, rounded once by p.dw)."""

    @staticmethod
    def forward(ctx, xp, w_hh, p):
        hs, cs = recurrence(xp, w_hh, p)
        ctx.p = p
        ctx.save_for_backward(xp, w_hh, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, g):
        xp, w_hh, hs, cs = ctx.saved_tensors
        p = ctx.p
        n, seq_len, _, four_h = xp.shape
        hidden = four_h // 4
        dxp = torch.empty_like(xp)
        dw = xp.new_zeros(2, hidden, four_h)
        for d in (0, 1):
            w = p.rec(w_hh[d])
            order = _order(seq_len, d)
            dh = xp.new_zeros(n, hidden)
            dc = xp.new_zeros(n, hidden)
            for s in range(seq_len - 1, -1, -1):
                t = order[s]
                if s > 0:
                    h_prev, c_prev = hs[:, order[s - 1], d], cs[:, order[s - 1], d]
                else:
                    h_prev = c_prev = xp.new_zeros(n, hidden)
                gates = xp[:, t, d] + p.rec(h_prev) @ w
                ig, fg, gg, og = gates.split(hidden, dim=1)
                ig, fg, og = torch.sigmoid(ig), torch.sigmoid(fg), torch.sigmoid(og)
                gg = torch.tanh(gg)
                tc = torch.tanh(cs[:, t, d])
                dh = g[:, t, d] + dh
                do = dh * tc * og * (1 - og)
                dc = dh * og * (1 - tc * tc) + dc
                dgates = torch.cat([dc * gg * ig * (1 - ig),
                                    dc * c_prev * fg * (1 - fg),
                                    dc * ig * (1 - gg * gg), do], dim=1)
                dw[d] += h_prev.T @ dgates
                dh = p.rec(dgates) @ w.T
                dc = dc * fg
                dxp[:, t, d] = dgates
        return dxp, p.dw(dw), None


def _dropout(out, rate, gen):
    if gen is None or rate <= 0:
        return out
    keep = 1.0 - rate
    mask = torch.rand(out.shape, generator=gen, device=out.device) < keep
    return torch.where(mask, out / keep, 0.0)


def encoder(layers: List[dict], x: torch.Tensor, p: Precision, *,
            train: bool = False, dropout: float = 0.0,
            gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """[N, L, D] -> [N, L, 2H]; dropout between layers in training."""
    out = p.act(x.float())
    for i, layer in enumerate(layers):
        xp = inproj(out, layer, p)
        if train:
            hs = Recurrence.apply(xp, layer["w_hh"], p)
        else:
            hs = recurrence(xp, layer["w_hh"], p)[0]
        out = hs.reshape(hs.shape[0], hs.shape[1], -1)
        if i < len(layers) - 1:
            if train:
                out = _dropout(out, dropout, gen)
            out = p.act(out)
    return out


def dense(x, layer, p: Precision):
    return matmul(x, layer["w"], p.mm) + layer["b"]


def pileup_features(params: dict, x: torch.Tensor, p: Precision, *,
                    train: bool = False, dropout: float = 0.0, gen=None):
    """x [N, 33, 18] -> the heads' input [N, inner]."""
    enc = encoder(params["encoder"], x, p, train=train, dropout=dropout,
                  gen=gen)
    ctr = enc[:, enc.shape[1] // 2]
    feat = torch.tanh(dense(dense(p.act(ctr), params["proj"], p),
                            params["dense"], p))
    return p.act(feat)


def pileup_logits(params: dict, x: torch.Tensor, p: Precision, **kw):
    """x [N, 33, 18] -> (gt [N, 21], zy [N, 3]) logits."""
    feat = pileup_features(params, x, p, **kw)
    return dense(feat, params["gt"], p), dense(feat, params["zy"], p)


def haplotype_features(params: dict, xp: torch.Tensor, xh: torch.Tensor,
                       p: Precision, *, train: bool = False,
                       dropout: float = 0.0, gen=None):
    """xp [N, 33, 105], xh [N, 11, 105] -> the heads' input [N, H]."""
    ep = encoder(params["pileup_encoder"], xp, p, train=train,
                 dropout=dropout, gen=gen)
    eh = encoder(params["haplotype_encoder"], xh, p, train=train,
                 dropout=dropout, gen=gen)
    feat = torch.cat([
        dense(p.act(ep[:, ep.shape[1] // 2]), params["pileup_proj"], p),
        dense(p.act(eh[:, eh.shape[1] // 2]), params["haplotype_proj"], p)],
        dim=-1)
    return p.act(torch.tanh(dense(p.act(feat), params["dense"], p)))


def haplotype_logits(params: dict, xp: torch.Tensor, xh: torch.Tensor,
                     p: Precision, **kw):
    """xp [N, 33, 105], xh [N, 11, 105] -> (gt [N, 10], zy [N, 3])."""
    feat = haplotype_features(params, xp, xh, p, **kw)
    return dense(feat, params["gt"], p), dense(feat, params["zy"], p)


def smoothed_ce(logits: torch.Tensor, target: torch.Tensor,
                smoothing: float) -> torch.Tensor:
    """Mean cross entropy against 1 - s on the true class and s / (C - 1)
    on every other (NanoSNP's LabelSmoothingLoss)."""
    n_class = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    true = torch.full_like(logp, smoothing / (n_class - 1))
    true.scatter_(1, target.long()[:, None], 1.0 - smoothing)
    return (-(true * logp).sum(-1)).mean()
