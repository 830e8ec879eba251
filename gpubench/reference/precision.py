"""Where the reference rounds: a precision is three rounding functions,
for the operands of the recurrence's products (h_{t-1}, w_hh, and in the
backward sweep dgates), for the operands of every other product
(in-projections, heads), and for the activations handed between layers
and into the model. Products accumulate in f32 (TF32 off) throughout.

  f32        nothing rounded: the plain f32 model;
  infer      the configurations' serving path: every product's operands
             and every activation handed on (the model's input, between
             layers, into the head) in bf16, f32 accumulation;
  train      the configurations' training path: the recurrence's operands
             bf16 (the JAX Pallas training path's cast site), dW_hh
             rounded to bf16, the rest f32;
  tf32       the training control: train, with every other product's
             operands rounded to TF32 (10 mantissa bits), the step below
             f32 with TF32 off;
  fp8        the inference control: every operand and activation in
             float8 e4m3 with one scale a tensor (its largest magnitude
             at 448), the step below the bf16 that inference states.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

Round = Callable[[torch.Tensor], torch.Tensor]


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest, ties away, at 10 mantissa bits (cvt.rna.tf32)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    s = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Precision(NamedTuple):
    name: str
    rec: Round          # recurrence product operands
    mm: Round           # every other product's operands
    act: Round          # activations between layers and into the model
    dw: Round           # dW_hh as the optimizer gets it


PRECISIONS = {
    "f32": Precision("f32", exact, exact, exact, exact),
    "infer": Precision("infer", bf16, bf16, bf16, exact),
    "train": Precision("train", bf16, exact, exact, bf16),
    "tf32": Precision("tf32", bf16, tf32, exact, bf16),
    "fp8": Precision("fp8", fp8, fp8, fp8, fp8),
}


class _RoundedMatmul(torch.autograd.Function):
    """a @ b with both operands rounded, in the forward and in the two
    products of the backward (as a tensor-core GEMM rounds its inputs)."""

    @staticmethod
    def forward(ctx, a, b, r):
        ctx.r = r
        ctx.save_for_backward(a, b)
        return r(a) @ r(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = ctx.r
        ga = r(g) @ r(b).transpose(-1, -2)
        gb = r(a).transpose(-1, -2) @ r(g)
        return ga, gb, None


def matmul(a: torch.Tensor, b: torch.Tensor, r: Round) -> torch.Tensor:
    if r is exact:
        return a @ b
    return _RoundedMatmul.apply(a, b, r)
