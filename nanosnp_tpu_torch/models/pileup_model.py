"""Pileup-stage caller: 2-layer BiLSTM(h=64) -> proj(128) -> dense(256) ->
4 heads (gt 21, zy 3, indel1 33, indel2 33) over input [N, 33, 18].

Counterpart of nanosnp_tpu/models/pileup_model.py. As there, the window
center is sliced before the head: proj and dense are pointwise over time,
so applying them once at the center is the same math with 33x fewer head
FLOPs. The head is plain products outside any kernel, unless
NSP_FUSE_HEAD=1 (the JAX package's variable, read at call time) asks the
last encoder layer's kernel to apply it on the kernel route. The encoder's
route is `route` (models/bilstm.py's table; None: the kernels on the card
and for bf16 on the CPU, else the f32 loop).
"""
from __future__ import annotations

import os
from typing import Mapping, Optional

import torch
from torch import nn

from ..config import PileupModelConfig
from ..device import set_matmul_precision
from ..ops.bilstm_fused import pack_head
from .bilstm import (BiLSTM, Dense, bilstm_encoder_fused,
                     bilstm_encoder_train, encoder_center,
                     init_bilstm_params, init_linear_params, param_key)

HEADS = ("gt", "zy", "id1", "id2")


class PileupModel(nn.Module):
    def __init__(self, cfg: PileupModelConfig, params: Mapping):
        super().__init__()
        set_matmul_precision()
        self.cfg = cfg
        self.encoder = BiLSTM(params["encoder"])
        self.proj = Dense(params["proj"])
        self.dense = Dense(params["dense"])
        self.heads = nn.ModuleDict({k: Dense(params[k]) for k in HEADS})
        self._head_cache = {}

    @torch.no_grad()
    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32,
                all_heads: bool = True, route: Optional[str] = None):
        """x [N, 33, 18] -> (gt, zy, id1, id2) logits (id* None unless
        all_heads). Inference only (no gradient: the serving kernels have
        no backward); training runs forward_train."""
        names = HEADS if all_heads else HEADS[:2]
        kernel_path = route == "kernels" or (route is None and (
            x.is_cuda or compute_dtype == torch.bfloat16))
        if kernel_path and os.environ.get("NSP_FUSE_HEAD", "0") == "1":
            head, head_packed = self.fused_head(names)
            logits = bilstm_encoder_fused(self.encoder.layers, x,
                                          center_only=True, head=head,
                                          head_packed=head_packed)
            sizes = [self.heads[k].w.shape[1] for k in names]
            outs = logits[:, :sum(sizes)].split(sizes, dim=1)
            return tuple(outs) + (None,) * (4 - len(outs))
        ctr = encoder_center(self.encoder.layers, x, compute_dtype, route)
        feat = self.proj(ctr, compute_dtype)                       # [N, 128]
        feat = torch.tanh(self.dense(feat, compute_dtype))         # [N, 256]
        outs = [self.heads[k](feat, compute_dtype) for k in names]
        return tuple(outs) + (None,) * (4 - len(outs))

    def fused_head(self, names):
        """(head, pack_head(head)): proj, dense and the named heads as the
        in-kernel head, bf16 weights in [out, in] layout, the heads stacked
        into one matrix with its rows zero-padded to a multiple of 8, as the
        JAX package pads them. Made once for each `names` and rebuilt only
        when one of its parameters changed (`param_key`)."""
        params = [self.proj.w, self.proj.b, self.dense.w, self.dense.b]
        params += [p for k in names
                   for p in (self.heads[k].w, self.heads[k].b)]
        key = param_key(params)
        hit = self._head_cache.get(tuple(names))
        if hit is None or hit[0] != key:
            wh = torch.cat([self.heads[k].w.T for k in names]).detach()
            bh = torch.cat([self.heads[k].b for k in names]).detach()
            pad = -wh.shape[0] % 8
            wh = nn.functional.pad(wh, (0, 0, 0, pad))
            bh = nn.functional.pad(bh, (0, pad))
            head = (self.proj.w.detach().T.bfloat16().contiguous(),
                    self.proj.b.detach().float().contiguous(),
                    self.dense.w.detach().T.bfloat16().contiguous(),
                    self.dense.b.detach().float().contiguous(),
                    wh.bfloat16().contiguous(), bh.float().contiguous())
            hit = (key, (head, pack_head(head)))
            self._head_cache[tuple(names)] = hit
        return hit[1]

    def forward_train(self, x: torch.Tensor, *, use_kernels: bool,
                      generator: Optional[torch.Generator] = None):
        """The JAX package's training branch of pileup_forward
        (all_heads=False, compute_dtype f32): the full [N, L, 2H] encoder
        with dropout between layers when a generator is given, then the
        center slice and the f32 head. -> (gt, zy) logits."""
        enc = bilstm_encoder_train(self.encoder.layers, x,
                                   use_kernels=use_kernels,
                                   dropout=self.cfg.dropout,
                                   generator=generator)
        feat = self.proj(enc[:, self.cfg.seq_len // 2])
        feat = torch.tanh(self.dense(feat))
        return self.heads["gt"](feat), self.heads["zy"](feat)

    def tree(self) -> dict:
        """The parameters in the JAX package's tree layout (the same
        tensors, not copies)."""
        out = {"encoder": self.encoder.tree(), "proj": self.proj.tree(),
               "dense": self.dense.tree()}
        out.update({k: self.heads[k].tree() for k in HEADS})
        return out


def init_pileup_params(gen: torch.Generator, cfg: PileupModelConfig) -> dict:
    """Seeded weights at the configuration's full width (the layout of
    the JAX package's init_pileup_params; other random numbers)."""
    return {
        "encoder": init_bilstm_params(gen, cfg.feature_dim, cfg.hidden_size,
                                      cfg.n_layers),
        "proj": init_linear_params(gen, 2 * cfg.hidden_size, cfg.output_size),
        "dense": init_linear_params(gen, cfg.output_size, cfg.inner_size),
        "gt": init_linear_params(gen, cfg.inner_size, cfg.gt_num_class),
        "zy": init_linear_params(gen, cfg.inner_size, cfg.zy_num_class),
        "id1": init_linear_params(gen, cfg.inner_size, cfg.indel1_num_class),
        "id2": init_linear_params(gen, cfg.inner_size, cfg.indel2_num_class),
    }


def pileup_forward(model: PileupModel, x: torch.Tensor, *,
                   compute_dtype: torch.dtype = torch.float32,
                   all_heads: bool = True, route: Optional[str] = None):
    return model(x, compute_dtype=compute_dtype, all_heads=all_heads,
                 route=route)


def pileup_predict(model: PileupModel, x: torch.Tensor,
                   compute_dtype: torch.dtype = torch.float32,
                   route: Optional[str] = None):
    """Softmaxed gt/zy probabilities (reference model.predict)."""
    gt, zy, _, _ = model(x, compute_dtype=compute_dtype, all_heads=False,
                         route=route)
    return torch.softmax(gt, dim=-1), torch.softmax(zy, dim=-1)
