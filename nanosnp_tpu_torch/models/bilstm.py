"""Bidirectional LSTM stack and dense layers over the JAX package's
parameter layout.

Layout (kept from nanosnp_tpu/models/bilstm.py so weights carry across as
a copy): per layer `w_ih` [2, D, 4H] and `w_hh` [2, H, 4H] (x @ w, the
direction stacked first), one folded bias `b` [2, 4H] = b_ih + b_hh, gate
order i, f, g, o. Dense layers keep `w` [in, out] and `b` [out].

Five encoders:
  bilstm_encoder        the f32 step loop, equal to the JAX lax.scan path
                        with compute_dtype=float32 (the CPU reference);
  bilstm_encoder_scan   the scan route, the JAX package's bilstm_encoder(
                        ..., compute_dtype, use_pallas=False): per layer one
                        f32 in-projection product of compute-dtype operands,
                        xp kept in f32, then the inference recurrence with
                        w_hh in the compute dtype (the bf16 kernels, or the
                        f32 kernel, on the card);
  bilstm_encoder_fused  the kernel path, mirroring the JAX package's
                        bilstm_encoder_pallas: one fused in-projection +
                        recurrence kernel per layer, bf16 activations
                        between layers, and under center_only a last layer
                        that emits only the window-center state; with a
                        head, that layer can apply it in the kernel, and
                        under NSP_FUSE_LAYERS=1 a two-layer encoder runs
                        as one kernel;
  bilstm_encoder_unfused  the JAX package's bilstm_encoder_pallas(fused=
                        False): per layer one in-projection product outside
                        the kernel, rounded to bf16, then the inference
                        recurrence kernel;
  bilstm_encoder_train  the differentiable encoder of training, mirroring
                        the JAX package's bilstm_encoder with a dropout rng:
                        per layer one f32 in-projection matmul, then the
                        recurrence (the training kernels with bf16 w_hh, or
                        the f32 step loop under autograd), dropout between
                        layers.

The serving stages pick the route from `inference.use_pallas`
(runtime/stages.resolve_use_pallas, the JAX package's
_resolve_use_pallas) and hand it to the models as `route`:

  use_pallas     device  route      encoder
  auto, true     card    "kernels"  bilstm_encoder_fused (NSP_FUSE_HEAD
                                    and NSP_FUSE_LAYERS honored)
  true           CPU     "kernels"  bilstm_encoder_fused's plain versions
                                    (what the card's kernel route computes)
  auto, false    CPU     "scan"     bilstm_encoder_scan in the compute dtype
                                    (the JAX package on the CPU)
  false          card    "scan"     bilstm_encoder_scan in the compute dtype
                                    on the inference recurrence kernels

Under "scan" NSP_FUSE_HEAD and NSP_FUSE_LAYERS do nothing, as the JAX
package reads them only under use_pallas. A model called without a route
(route None) keeps the behaviour it had before routes: the kernels on the
card and, on the CPU, their plain versions in bf16 or the f32 loop in f32.
"""
from __future__ import annotations

import os
from typing import Iterable, List, Mapping, Optional, Sequence

import torch
from torch import nn

from ..ops.bilstm import bilstm_center, bilstm_stream, pack_weights
from ..ops.bilstm_fused import (bilstm2_center, bilstm_center_head,
                                center_head_supported, head_plain,
                                two_layer_supported)
from ..ops.lstm_train import (lstm_recurrence, lstm_recurrence_infer,
                              lstm_recurrence_train_plain)


def _param(a) -> nn.Parameter:
    """A trainable f32 parameter (a copy: training updates it in place).
    The inference forwards run without gradients and record no graph."""
    return nn.Parameter(torch.as_tensor(a, dtype=torch.float32)
                        .detach().clone())


def param_key(params: Iterable[torch.Tensor]) -> tuple:
    """What identifies the values of these parameters: a cache of anything
    made from them is stale once the key changes (a version counter moves
    on an in-place update, as an optimizer step; storage or device on
    `.to()`). A parameter made under torch.inference_mode has no version
    counter and is never trained: its storage identifies it."""
    return tuple((-1 if p.is_inference() else p._version, p.data_ptr(),
                  p.device) for p in params)


class BiLSTMLayer(nn.Module):
    def __init__(self, p: Mapping):
        super().__init__()
        self.w_ih = _param(p["w_ih"])      # [2, D, 4H]
        self.w_hh = _param(p["w_hh"])      # [2, H, 4H]
        self.b = _param(p["b"])            # [2, 4H]
        self._kernel_cache = None

    @property
    def hidden(self) -> int:
        return self.w_hh.shape[1]

    def kernel_weights(self):
        """(w_ih bf16, w_hh bf16, b f32, pack_weights of the two, or None
        where H is not a multiple of 16, which no kernel takes): the
        kernels' operands, made once and rebuilt only when a parameter
        changed (`param_key`)."""
        params = (self.w_ih, self.w_hh, self.b)
        key = param_key(params)
        if self._kernel_cache is None or self._kernel_cache[0] != key:
            w_ih, w_hh = (p.detach().bfloat16().contiguous()
                          for p in params[:2])
            self._kernel_cache = (key, (
                w_ih, w_hh, self.b.detach().float().contiguous(),
                pack_weights(w_ih, w_hh) if self.hidden % 16 == 0
                else None))
        return self._kernel_cache[1]

    def tree(self) -> dict:
        return {"w_ih": self.w_ih, "w_hh": self.w_hh, "b": self.b}


class BiLSTM(nn.Module):
    """A stack of BiLSTM layers (dropout is a training concern: not here)."""

    def __init__(self, layers: Iterable[Mapping]):
        super().__init__()
        self.layers = nn.ModuleList(BiLSTMLayer(p) for p in layers)

    def tree(self) -> list:
        return [layer.tree() for layer in self.layers]


class Dense(nn.Module):
    """y = x @ w + b with the JAX package's `linear()` cast sites."""

    def __init__(self, p: Mapping):
        super().__init__()
        self.w = _param(p["w"])            # [in, out]
        self.b = _param(p["b"])            # [out]

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        if compute_dtype == torch.bfloat16:
            # bf16 operands, f32 accumulation: a bf16 torch matmul would
            # round its output to bf16, which the JAX path does not
            return (x.bfloat16().float() @ self.w.bfloat16().float()
                    + self.b)
        return x.float() @ self.w + self.b

    def tree(self) -> dict:
        return {"w": self.w, "b": self.b}


@torch.no_grad()
def bilstm_encoder(layers: Iterable[BiLSTMLayer],
                   x: torch.Tensor) -> torch.Tensor:
    """f32 reference loop of inference (no gradient). x [N, L, D] ->
    [N, L, 2H] f32."""
    out = x.float()
    for layer in layers:
        n, seq_len, _ = out.shape
        hidden = layer.hidden
        hs: List[torch.Tensor] = []
        for d in (0, 1):
            xp = out @ layer.w_ih[d] + layer.b[d]          # [N, L, 4H]
            h = out.new_zeros(n, hidden)
            c = out.new_zeros(n, hidden)
            steps = [None] * seq_len
            for s in range(seq_len):
                t = s if d == 0 else seq_len - 1 - s
                gates = xp[:, t] + h @ layer.w_hh[d]
                i, f, g, o = gates.split(hidden, dim=1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                steps[t] = h
            hs.append(torch.stack(steps, dim=1))           # [N, L, H]
        out = torch.cat(hs, dim=-1)
    return out


def k_fusable(d_in: int, hidden: int) -> bool:
    """The JAX package's K-fusion test (in-projection and hidden
    contraction within one 128-deep tile). Here it only routes: a K-fusable
    last layer keeps its head outside the kernel, as there."""
    return -(-d_in // 16) * 16 + hidden <= 128 and hidden % 16 == 0


@torch.no_grad()
def bilstm_encoder_fused(layers: Iterable[BiLSTMLayer], x: torch.Tensor,
                         center_only: bool = False,
                         head: Optional[Sequence[torch.Tensor]] = None,
                         head_packed: Optional[Sequence[torch.Tensor]] = None
                         ) -> torch.Tensor:
    """Kernel path. x [N, L, D] -> [N, L, 2H] f32, or [N, 2H] f32 (the
    state at t = L//2) when center_only. With `head` (center_only; the
    tuple of ops.bilstm_fused, `head_packed` its pack_head, which the
    kernel needs on the card) it returns the head's logits [N, R]: from
    inside the last layer's kernel where that layer is not K-fusable and
    the kernel takes the shape, else from the plain head on the center
    state. Under NSP_FUSE_LAYERS=1 (read at call time) a center-only
    two-layer encoder of equal widths runs as one kernel where
    `two_layer_supported` holds. Every kernel gets the layers' weights
    packed once (`BiLSTMLayer.kernel_weights`)."""
    layers = list(layers)
    if head is not None and not center_only:
        raise ValueError("a head needs center_only")
    seq_len, d_in = x.shape[1], x.shape[2]
    h = x.bfloat16().contiguous()
    if (center_only and len(layers) == 2
            and os.environ.get("NSP_FUSE_LAYERS", "0") == "1"):
        l1, l2 = layers
        if (l2.hidden == l1.hidden and l2.w_ih.shape[1] == 2 * l1.hidden
                and two_layer_supported(seq_len, d_in, l1.hidden)):
            w1, w2 = l1.kernel_weights(), l2.kernel_weights()
            ctr = bilstm2_center(h, *w1[:3], *w2[:3], w1[3], w2[3])
            return ctr if head is None else head_plain(ctr, head)
    hs = None
    for idx, layer in enumerate(layers):
        last = idx == len(layers) - 1
        w_ih, w_hh, b, packed = layer.kernel_weights()
        if last and center_only and seq_len % 2 == 1:
            d_l, hidden = h.shape[2], layer.hidden
            if (head is not None and not k_fusable(d_l, hidden)
                    and center_head_supported(seq_len, d_l, hidden,
                                              head[0].shape[0],
                                              head[2].shape[0])):
                return bilstm_center_head(h, w_ih, w_hh, b, head, packed,
                                          head_packed)
            ctr = bilstm_center(h, w_ih, w_hh, b, packed)
            return ctr if head is None else head_plain(ctr, head)
        hs = bilstm_stream(h, w_ih, w_hh, b,
                           torch.float32 if last else torch.bfloat16, packed)
        h = hs.bfloat16()
    if center_only:
        ctr = hs[:, seq_len // 2]
        return ctr if head is None else head_plain(ctr, head)
    return hs


@torch.no_grad()
def bilstm_encoder_unfused(layers: Iterable[BiLSTMLayer], x: torch.Tensor,
                           center_only: bool = False) -> torch.Tensor:
    """The `fused=False` route: per layer the in-projection of every
    timestep as one product outside the kernel (bf16 operands, f32
    accumulation, plus bias, rounded to bf16), then the inference
    recurrence kernel on that bf16 xp; bf16 activations between layers.
    x [N, L, D] -> [N, L, 2H] f32, or [N, 2H] f32 when center_only."""
    n, seq_len, _ = x.shape
    h = x.bfloat16()
    hs = None
    for layer in layers:
        hidden = layer.hidden
        w_ih = layer.w_ih.bfloat16().permute(1, 0, 2).reshape(-1, 8 * hidden)
        # products of bf16 values summed in f32 (a bf16 matmul would round
        # its output before the bias add)
        xp = (h.float() @ w_ih.float()
              + layer.b.float().reshape(8 * hidden)).bfloat16()
        hs = lstm_recurrence_infer(
            xp.view(n, seq_len, 2, 4 * hidden).contiguous(),
            layer.w_hh.bfloat16().contiguous()).reshape(n, seq_len,
                                                        2 * hidden)
        h = hs.bfloat16()
    return hs[:, seq_len // 2] if center_only else hs


@torch.no_grad()
def bilstm_encoder_scan(layers: Iterable[BiLSTMLayer], x: torch.Tensor,
                        compute_dtype: torch.dtype = torch.float32,
                        center_only: bool = False) -> torch.Tensor:
    """The scan route. Per layer: x cast to the compute dtype; xp = x w_ih
    + b, one product over every timestep and both directions (the
    directions' w_ih side by side), compute-dtype operands held in f32
    tensors so that the sum is f32 (TF32 off), and xp left in f32 (the
    JAX package's einsum with preferred_element_type f32: no bf16 rounding
    of xp, unlike bilstm_encoder_unfused); then `lstm_recurrence_infer` on
    xp with w_hh in the compute dtype (bf16: h_{t-1} rounded to bf16 before
    the product, f32 accumulation; f32: nothing rounded). x [N, L, D] ->
    [N, L, 2H] f32, or [N, 2H] f32 (t = L//2) when center_only."""
    n, seq_len, _ = x.shape
    out = x
    for layer in layers:
        hidden = layer.hidden
        w_ih = layer.w_ih.permute(1, 0, 2).reshape(-1, 8 * hidden)
        xp = (out.to(compute_dtype).float() @ w_ih.to(compute_dtype).float()
              + layer.b.float().reshape(8 * hidden))
        hs = lstm_recurrence_infer(
            xp.view(n, seq_len, 2, 4 * hidden),
            layer.w_hh.to(compute_dtype).contiguous())
        out = hs.view(n, seq_len, 2 * hidden)
    return out[:, seq_len // 2] if center_only else out


ROUTES = ("kernels", "scan")


def encoder_center(layers: Iterable[BiLSTMLayer], x: torch.Tensor,
                   compute_dtype: torch.dtype,
                   route: Optional[str] = None) -> torch.Tensor:
    """Window-center state [N, 2H] f32 by `route` (the table of the module
    docstring): "kernels" the bf16 kernel encoder (its plain versions on
    the CPU), "scan" the scan route in the compute dtype. None keeps the
    behaviour from before routes: the kernels on the card and for bf16 on
    the CPU, the f32 reference loop for f32 on the CPU."""
    if route is None:
        route = ("kernels" if x.is_cuda or compute_dtype == torch.bfloat16
                 else "f32 loop")
    elif route not in ROUTES:
        raise ValueError(f"route {route!r}: expected one of {ROUTES}")
    if route == "kernels":
        return bilstm_encoder_fused(layers, x, center_only=True)
    if route == "scan":
        return bilstm_encoder_scan(layers, x, compute_dtype, center_only=True)
    return bilstm_encoder(layers, x)[:, x.shape[1] // 2]


def bilstm_layer_train(layer: BiLSTMLayer, x: torch.Tensor,
                       use_kernels: bool) -> torch.Tensor:
    """One differentiable layer. x [N, L, D] -> [N, L, 2H] f32.

    As the JAX package's _bilstm_layer with compute_dtype=float32: the
    in-projection of every timestep and both directions is one f32 matmul
    (the directions' w_ih side by side), xp [N, L, 2, 4H]. With use_kernels
    the recurrence is the training kernels' autograd op with w_hh cast to
    bf16 (the Pallas path's cast site; its gradient comes back through the
    cast); otherwise the f32 step loop, differentiated by autograd."""
    n, seq_len, d_in = x.shape
    hidden = layer.hidden
    w_ih = layer.w_ih.permute(1, 0, 2).reshape(d_in, 8 * hidden)
    xp = (x @ w_ih + layer.b.reshape(8 * hidden)).view(n, seq_len, 2,
                                                         4 * hidden)
    if use_kernels:
        hs = lstm_recurrence(xp, layer.w_hh.to(torch.bfloat16))
    else:
        hs, _ = lstm_recurrence_train_plain(xp, layer.w_hh)
    return hs.reshape(n, seq_len, 2 * hidden)


def bilstm_encoder_train(layers: Iterable[BiLSTMLayer], x: torch.Tensor, *,
                         use_kernels: bool, dropout: float = 0.0,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """Training encoder. x [N, L, D] -> [N, L, 2H] f32. Dropout (between
    layers, not after the last, as torch.nn.LSTM) is active only when a
    generator is given: keep each value with probability 1 - dropout and
    scale it by 1/keep."""
    layers = list(layers)
    out = x.float()
    for idx, layer in enumerate(layers):
        out = bilstm_layer_train(layer, out, use_kernels)
        if idx < len(layers) - 1:
            out = dropout_between_layers(out, dropout, generator)
    return out


def dropout_between_layers(out: torch.Tensor, dropout: float,
                           generator: Optional[torch.Generator]
                           ) -> torch.Tensor:
    """Inverted dropout with masks from `generator`; identity without one
    (inference) or at dropout 0."""
    if dropout <= 0.0 or generator is None:
        return out
    keep = 1.0 - dropout
    mask = torch.rand(out.shape, generator=generator,
                      device=out.device) < keep
    return torch.where(mask, out / keep, 0.0)


def init_bilstm_params(gen: torch.Generator, input_size: int,
                       hidden_size: int, n_layers: int) -> List[dict]:
    """Uniform(-1/sqrt(H), 1/sqrt(H)) weights in the parameter layout above
    (torch.nn.LSTM's default init; the folded bias spans twice that)."""
    k = 1.0 / hidden_size ** 0.5

    def u(shape, scale):
        return (torch.rand(shape, generator=gen) * 2 - 1) * scale

    layers = []
    for layer in range(n_layers):
        d_in = input_size if layer == 0 else 2 * hidden_size
        layers.append({"w_ih": u((2, d_in, 4 * hidden_size), k),
                       "w_hh": u((2, hidden_size, 4 * hidden_size), k),
                       "b": u((2, 4 * hidden_size), 2 * k)})
    return layers


def init_linear_params(gen: torch.Generator, d_in: int, d_out: int) -> dict:
    k = 1.0 / d_in ** 0.5
    return {"w": (torch.rand(d_in, d_out, generator=gen) * 2 - 1) * k,
            "b": (torch.rand(d_out, generator=gen) * 2 - 1) * k}
