"""Seeded weights, made on the device in one draw.

The parameter tree is the layout both the port and the JAX package use
(per BiLSTM layer `w_ih` [2, D, 4H], `w_hh` [2, H, 4H], folded `b`
[2, 4H]; dense `w` [in, out], `b` [out]). Values are uniform in
(-k, k) with torch.nn.LSTM's and nn.Linear's scales: k = 1/sqrt(H) for a
layer's weights and 2/sqrt(H) for its folded bias, 1/sqrt(in) for a
dense layer. All leaves are views of one f32 tensor drawn with one
torch.Generator on the device: the same seed gives the same weights.

Seeded weights at these scales answer every site alike: raw counts
saturate the first layer, and each random layer after it shrinks what
differs between sites. So `normalise` folds what training would have
learnt into the seeded weights, layer by layer over a sample of the
cell's own inputs (as LSUV initialisation does): each first layer's input
rows of w_ih divided by the RMS of that input, each layer's in-projection
and each dense layer scaled so that its output varies across the sample
with a standard deviation of one, the dense layer's bias centring it, and
the gt and zy heads centred and scaled so that their logits spread with a
standard deviation of HEAD_STD.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Shape = Tuple[int, ...]
HEAD_STD = 2.0


def _bilstm(d_in: int, hidden: int, layers: int) -> List[Dict[str, tuple]]:
    k = hidden ** -0.5
    out = []
    for i in range(layers):
        d = d_in if i == 0 else 2 * hidden
        out.append({"w_ih": ((2, d, 4 * hidden), k),
                    "w_hh": ((2, hidden, 4 * hidden), k),
                    "b": ((2, 4 * hidden), 2 * k)})
    return out


def _dense(d_in: int, d_out: int) -> Dict[str, tuple]:
    k = d_in ** -0.5
    return {"w": ((d_in, d_out), k), "b": ((d_out,), k)}


def layout(model: dict) -> dict:
    """The tree of (shape, scale) for a config's `model` block."""
    if model["kind"] == "pileup":
        h = model["hidden_size"]
        return {"encoder": _bilstm(model["feature_dim"], h,
                                   model["n_layers"]),
                "proj": _dense(2 * h, model["output_size"]),
                "dense": _dense(model["output_size"], model["inner_size"]),
                "gt": _dense(model["inner_size"], model["gt_num_class"]),
                "zy": _dense(model["inner_size"], model["zy_num_class"]),
                "id1": _dense(model["inner_size"],
                              model["indel1_num_class"]),
                "id2": _dense(model["inner_size"],
                              model["indel2_num_class"])}
    h = model["hidden_size"]
    return {"pileup_encoder": _bilstm(model["pileup_dim"], h,
                                      model["lstm_layers"]),
            "pileup_proj": _dense(2 * h, h),
            "haplotype_encoder": _bilstm(model["haplotype_dim"], h,
                                         model["lstm_layers"]),
            "haplotype_proj": _dense(2 * h, h),
            "dense": _dense(2 * h, h),
            "gt": _dense(h, model["gt_num_class"]),
            "zy": _dense(h, model["zy_num_class"])}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def make_params(model: dict, seed: int, device) -> dict:
    """The seeded parameter tree of `model` on `device`, f32."""
    lay = layout(model)
    items = list(_leaves(lay))
    sizes = [int(torch.Size(shape).numel()) for _, (shape, _) in items]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    scale = torch.repeat_interleave(
        torch.tensor([k for _, (_, k) in items], device=device),
        torch.tensor(sizes, device=device))
    flat = (flat * 2 - 1) * scale
    tree = {k: ([dict(layer) for layer in v] if isinstance(v, list)
                else dict(v)) for k, v in lay.items()}
    for (path, (shape, _)), part in zip(items, flat.split(sizes)):
        _set(tree, path, part.view(shape))
    return tree


def _spread(y: torch.Tensor) -> torch.Tensor:
    """Standard deviation across the sample of each column, averaged."""
    y = y.reshape(-1, y.shape[-1])
    return y.std(0).mean().clamp(min=1e-12)


@torch.no_grad()
def _fit_encoder(layers, x):
    from reference.models import inproj, recurrence
    from reference.precision import PRECISIONS

    f32 = PRECISIONS["f32"]
    r = rms(x)
    layers[0]["w_ih"].div_(torch.where(r > 0, r, torch.ones_like(r))
                           [None, :, None])
    out = x.float()
    for layer in layers:
        xp = inproj(out, layer, f32) - layer["b"][None, None]
        layer["w_ih"].div_(_spread(xp))
        hs = recurrence(inproj(out, layer, f32), layer["w_hh"], f32)[0]
        out = hs.reshape(hs.shape[0], hs.shape[1], -1)
    return out[:, out.shape[1] // 2]


@torch.no_grad()
def _fit_dense(layer, x):
    y = x @ layer["w"]
    layer["w"].div_(_spread(y))
    layer["b"].copy_(-(x @ layer["w"]).mean(0))
    return x @ layer["w"] + layer["b"]


@torch.no_grad()
def normalise(tree: dict, kind: str, inputs) -> None:
    """Scale the seeded tree in place on a sample of the cell's inputs:
    x [n, 33, 18] (pileup), or (xp [n, 33, 105], xh [n, 11, 105])."""
    if kind == "pileup":
        ctr = _fit_encoder(tree["encoder"], inputs)
        feat = torch.tanh(_fit_dense(tree["dense"], _fit_dense(tree["proj"], ctr)))
    else:
        cp = _fit_dense(tree["pileup_proj"], _fit_encoder(tree["pileup_encoder"],
                                                  inputs[0]))
        ch = _fit_dense(tree["haplotype_proj"],
                    _fit_encoder(tree["haplotype_encoder"], inputs[1]))
        feat = torch.tanh(_fit_dense(tree["dense"], torch.cat([cp, ch], -1)))
    mu = feat.mean(0)
    for head in ("gt", "zy"):
        w, b = tree[head]["w"], tree[head]["b"]
        w.mul_(HEAD_STD / ((feat - mu) @ w).std().clamp(min=1e-12))
        b.copy_(-(mu @ w))


def rms(x) -> torch.Tensor:
    """[..., D] -> [D] root mean square over all but the last axis."""
    x = torch.as_tensor(x).float()
    return x.reshape(-1, x.shape[-1]).pow(2).mean(0).sqrt()


def leaves(tree) -> List[Tuple[tuple, torch.Tensor]]:
    """[(path, leaf)] in sorted-key order."""
    return list(_leaves(tree))
