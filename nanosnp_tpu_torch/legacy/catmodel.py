"""CatModel: the legacy cat/edge model family in PyTorch.

Counterpart of nanosnp_tpu/legacy/catmodel.py, which mirrors the *active*
branches of the reference CatModel (HaplotypeModel/model.py:201-360):

  - percentage branch: per-HP-tag {A,C,G,T,D} fractions over depth at the
    11 group sites for both views (g0 surrounding, g1 adjacent-het),
    concatenated to [N, 11, 20], through a 3-layer BiLSTM (h=256,
    inter-layer dropout 0.5) + Linear(512->256), center timestep taken;
  - spatial branch: the 5-channel (base, baseq, mapq, mask, phase)
    stacked-tag images [N, 10, 40, 11] through ResCRNN: six 3x3 ResBlocks
    with BatchNorm and 1x1-conv shortcuts interleaved with max-pools that
    collapse depth 40 -> 1, then two BiLSTM(256 -> 256) + Linear(512->256)
    layers over the 11 positions, center taken;
  - head: Linear(512 -> gt classes) over the concatenated branch outputs;
    predict applies softmax.

The parameter tree keeps the JAX package's layout (conv weights OIHW, as
torch stores them; BatchNorm `scale/bias/mean/var`; the shared BiLSTM and
linear layouts of models/bilstm.py), so weights carry across as a copy.
Convolutions and max-pools are torch's (they are XLA ops outside any
Pallas kernel in the JAX package); BatchNorm is written out, because the
JAX package normalises and updates its running variance with the biased
batch variance, which torch's batch_norm does not. The three BiLSTM
stacks run the f32 recurrence (the reference path, and training on the
CPU) or, with `use_kernels`, an f32 in-projection product and the
recurrence kernels with bf16 w_hh: the inference kernel without a
gradient, as the JAX package's `use_pallas` does, and the training
kernels under autograd, the percentage stack's dropout included (the
JAX package takes its scan path whenever dropout is on).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..device import set_matmul_precision
from ..models.convert import \
    catmodel_params_from_torch as load_catmodel_torch  # noqa: F401
from ..models.bilstm import (BiLSTM, Dense, _param, bilstm_encoder_train,
                             init_bilstm_params, init_linear_params)

Params = Dict[str, Any]

# ResCRNN conv plan: (c_in, c_out) per block, pool after block index ->
# (kernel, stride) on the (depth, width) axes (crnn.py:158-176)
_BLOCKS = [(None, 32), (32, 64), (64, 128), (128, 128), (128, 256),
           (256, 256)]
_POOLS = {0: ((2, 3), (2, 1)), 1: ((2, 3), (2, 1)), 3: ((3, 3), (3, 1)),
          5: ((2, 3), (2, 1))}
_BN_EPS, _BN_MOMENTUM = 1e-5, 0.1


def calculate_percentage(ts: torch.Tensor) -> torch.Tensor:
    """[..., D] base codes -> [..., 5] fractions of A,C,G,T,D over non-pad
    cells (model.py:192-198; pad is -2, deletion -1, absent cells count in
    the denominator exactly as in the reference)."""
    denom = (ts != -2).sum(-1) + 1e-9
    chans = [(ts == c).sum(-1) / denom for c in (1, 2, 3, 4, -1)]
    return torch.stack(chans, dim=-1).float()


class BatchNorm(nn.Module):
    """Per-channel normalisation of [N, C, H, W] with explicit running
    statistics. In training mode the batch's mean and *biased* variance
    normalise, and both move the running statistics (momentum 0.1)."""

    def __init__(self, p: Mapping):
        super().__init__()
        self.scale = _param(p["scale"])
        self.bias = _param(p["bias"])
        self.register_buffer("mean", torch.as_tensor(
            p["mean"], dtype=torch.float32).detach().clone())
        self.register_buffer("var", torch.as_tensor(
            p["var"], dtype=torch.float32).detach().clone())

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            with torch.no_grad():
                self.mean.mul_(1 - _BN_MOMENTUM).add_(_BN_MOMENTUM * mean)
                self.var.mul_(1 - _BN_MOMENTUM).add_(_BN_MOMENTUM * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + _BN_EPS)
        y = (x - mean[None, :, None, None]) * inv[None, :, None, None]
        return (y * self.scale[None, :, None, None]
                + self.bias[None, :, None, None])

    def tree(self) -> dict:
        return {"scale": self.scale, "bias": self.bias, "mean": self.mean,
                "var": self.var}


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return nn.functional.conv2d(x, w, padding=(w.shape[2] // 2,
                                               w.shape[3] // 2))


def _maxpool(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """Max-pool padded with -inf on the width axis only (kw // 2)."""
    return nn.functional.max_pool2d(x, kernel, stride,
                                    padding=(0, kernel[1] // 2))


class ResBlock(nn.Module):
    def __init__(self, p: Mapping):
        super().__init__()
        self.conv1 = _param(p["conv1"])        # [C_out, C_in, 3, 3]
        self.bn1 = BatchNorm(p["bn1"])
        self.conv2 = _param(p["conv2"])
        self.bn2 = BatchNorm(p["bn2"])
        self.shortcut = _param(p["shortcut"])  # [C_out, C_in, 1, 1]

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = torch.relu(self.bn1(_conv(x, self.conv1), train))
        y = self.bn2(_conv(y, self.conv2), train)
        return torch.relu(y + nn.functional.conv2d(x, self.shortcut))

    def tree(self) -> dict:
        return {"conv1": self.conv1, "bn1": self.bn1.tree(),
                "conv2": self.conv2, "bn2": self.bn2.tree(),
                "shortcut": self.shortcut}


class CatModel(nn.Module):
    def __init__(self, params: Mapping):
        super().__init__()
        set_matmul_precision()
        self.percentage_rnn = BiLSTM(params["percentage_rnn"])
        self.percentage_proj = Dense(params["percentage_proj"])
        self.res_blocks = nn.ModuleList(
            ResBlock(p) for p in params["res_blocks"])
        self.crnn_lstm1 = BiLSTM(params["crnn_lstm1"])
        self.crnn_proj1 = Dense(params["crnn_proj1"])
        self.crnn_lstm2 = BiLSTM(params["crnn_lstm2"])
        self.crnn_proj2 = Dense(params["crnn_proj2"])
        self.out = Dense(params["out"])

    def forward(self, g0: torch.Tensor, g1: torch.Tensor, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                use_kernels: bool = False) -> torch.Tensor:
        """g0, g1 [N, 2*md, 11, 5] stacked-tag images (surrounding and
        adjacent-het) -> gt logits [N, classes]. `train` uses batch
        statistics in the BatchNorms and updates their running statistics
        in place; dropout (0.5 between the percentage RNN's layers) is
        active only in training with a generator, its masks drawn from
        it. `use_kernels` runs the three BiLSTM stacks on the recurrence
        kernels (bf16 w_hh), with or without dropout: without a gradient
        the inference kernel, with one the training kernels."""
        md = g0.shape[1] // 2
        # ---- percentage branch (model.py:263-281)
        reads0 = g0[..., 0].transpose(1, 2)              # [N, 11, 2md]
        reads1 = g1[..., 0].transpose(1, 2)
        pct = torch.cat([calculate_percentage(reads0[..., :md]),
                         calculate_percentage(reads0[..., md:]),
                         calculate_percentage(reads1[..., :md]),
                         calculate_percentage(reads1[..., md:])],
                        dim=2)                           # [N, 11, 20]
        p_out = self.percentage_proj(bilstm_encoder_train(
            self.percentage_rnn.layers, pct, use_kernels=use_kernels,
            dropout=0.5 if train else 0.0, generator=generator))
        p_ctr = p_out[:, p_out.shape[1] // 2]            # [N, 256]

        # ---- spatial ResCRNN branch (model.py:300, crnn.py:95-190)
        x = torch.cat([g0.permute(0, 3, 1, 2), g1.permute(0, 3, 1, 2)],
                      dim=1).float()                     # [N, 10, 2md, 11]
        for i, block in enumerate(self.res_blocks):
            x = block(x, train)
            if i in _POOLS:
                x = _maxpool(x, *_POOLS[i])
        if x.shape[2] != 1:
            raise ValueError(f"ResCRNN collapsed depth to {x.shape[2]} != 1 "
                             f"(input depth must be 2*20 rows)")
        seq = x[:, :, 0, :].transpose(1, 2)              # [N, 11, 256]
        for lstm, proj in ((self.crnn_lstm1, self.crnn_proj1),
                           (self.crnn_lstm2, self.crnn_proj2)):
            seq = proj(bilstm_encoder_train(lstm.layers, seq,
                                            use_kernels=use_kernels))
        s_ctr = seq[:, seq.shape[1] // 2]                # [N, 256]
        return self.out(torch.cat([p_ctr, s_ctr], dim=1))

    def tree(self) -> dict:
        """The parameters in the JAX package's tree layout (the same
        tensors, not copies; BatchNorm running statistics included)."""
        return {"percentage_rnn": self.percentage_rnn.tree(),
                "percentage_proj": self.percentage_proj.tree(),
                "res_blocks": [b.tree() for b in self.res_blocks],
                "crnn_lstm1": self.crnn_lstm1.tree(),
                "crnn_proj1": self.crnn_proj1.tree(),
                "crnn_lstm2": self.crnn_lstm2.tree(),
                "crnn_proj2": self.crnn_proj2.tree(),
                "out": self.out.tree()}


def catmodel_forward(model: CatModel, g0, g1, *, train: bool = False,
                     generator: Optional[torch.Generator] = None,
                     use_kernels: bool = False) -> torch.Tensor:
    return model(g0, g1, train=train, generator=generator,
                 use_kernels=use_kernels)


def kernel_path(device, use_kernels: Optional[bool] = None) -> bool:
    """Inference's choice of recurrence: the kernel path on the card, as
    the JAX package chooses its Pallas path on a TPU; the f32 step loop on
    the CPU unless the caller asks for the kernel path's plain version."""
    if use_kernels is None:
        return torch.device(device).type == "cuda"
    return use_kernels


@torch.no_grad()
def catmodel_predict(model: CatModel, g0, g1, g2=None, g3=None,
                     use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Softmax class probabilities; g2/g3 (edge / pair-route tensors) are
    accepted for API parity and unused, exactly like the reference's
    active branch (model.py:239-244 predict ignores them)."""
    logits = model(g0, g1, train=False,
                   use_kernels=kernel_path(g0.device, use_kernels))
    return torch.softmax(logits, dim=-1)


def build_g_images(tag1: Dict[str, np.ndarray], tag2: Dict[str, np.ndarray],
                   max_depth: int = 20) -> np.ndarray:
    """dataset.py:157-177: stack per-tag (read, baseq, mapq, mask, phase)
    channels into the [N, 2*max_depth, P, 5] image; tag rows truncated to
    max_depth each, missing rows already -2-padded."""
    def half(t, phase):
        read = np.asarray(t["read"])[:, :max_depth, :]
        n, d, p = read.shape
        if d < max_depth:
            pad = np.full((n, max_depth - d, p), -2, read.dtype)
            read = np.concatenate([read, pad], axis=1)
            bq = np.concatenate([np.asarray(t["baseq"])[:, :max_depth], pad],
                                axis=1)
            mq = np.concatenate([np.asarray(t["mapq"])[:, :max_depth], pad],
                                axis=1)
        else:
            bq = np.asarray(t["baseq"])[:, :max_depth]
            mq = np.asarray(t["mapq"])[:, :max_depth]
        mask = (read != -2).astype(read.dtype)
        ph = np.full_like(read, phase)
        return np.stack([read, bq, mq, mask, ph], axis=3)
    return np.concatenate([half(tag1, 1), half(tag2, 2)], axis=1)


def _init_conv(gen, c_in, c_out, kh, kw) -> torch.Tensor:
    k = 1.0 / (c_in * kh * kw) ** 0.5
    return (torch.rand(c_out, c_in, kh, kw, generator=gen) * 2 - 1) * k


def _init_bn(c) -> dict:
    return {"scale": torch.ones(c), "bias": torch.zeros(c),
            "mean": torch.zeros(c), "var": torch.ones(c)}


def init_catmodel_params(gen: torch.Generator, gt_classes: int = 10,
                         in_channels: int = 10) -> Params:
    """Seeded weights at the model's full width (the layout of the JAX
    package's init_catmodel_params; other random numbers)."""
    blocks = []
    for c_in, c_out in _BLOCKS:
        c_in = in_channels if c_in is None else c_in
        blocks.append({"conv1": _init_conv(gen, c_in, c_out, 3, 3),
                       "bn1": _init_bn(c_out),
                       "conv2": _init_conv(gen, c_out, c_out, 3, 3),
                       "bn2": _init_bn(c_out),
                       "shortcut": _init_conv(gen, c_in, c_out, 1, 1)})
    return {
        "percentage_rnn": init_bilstm_params(gen, 20, 256, 3),
        "percentage_proj": init_linear_params(gen, 512, 256),
        "res_blocks": blocks,
        "crnn_lstm1": init_bilstm_params(gen, 256, 256, 1),
        "crnn_proj1": init_linear_params(gen, 512, 256),
        "crnn_lstm2": init_bilstm_params(gen, 256, 256, 1),
        "crnn_proj2": init_linear_params(gen, 512, 256),
        "out": init_linear_params(gen, 512, gt_classes),
    }
