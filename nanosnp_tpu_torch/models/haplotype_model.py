"""Haplotype-stage caller: two 3-layer BiLSTM(h=256) branches over the
33-long pileup features and the 11-long haplotype features, center concat,
dense, gt(10)/zy(3) heads.

Counterpart of nanosnp_tpu/models/haplotype_model.py, inputs feature-last
[N, L, 105], center sliced before the head. Both encoders take `route`
(models/bilstm.py's table).
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from ..config import HaplotypeModelConfig
from ..device import set_matmul_precision
from .bilstm import (BiLSTM, Dense, bilstm_encoder_train, encoder_center,
                     init_bilstm_params, init_linear_params)

_TREE = ("pileup_encoder", "pileup_proj", "haplotype_encoder",
         "haplotype_proj", "dense", "gt", "zy")


class HaplotypeModel(nn.Module):
    def __init__(self, cfg: HaplotypeModelConfig, params: Mapping):
        super().__init__()
        set_matmul_precision()
        self.cfg = cfg
        self.pileup_encoder = BiLSTM(params["pileup_encoder"])
        self.pileup_proj = Dense(params["pileup_proj"])
        self.haplotype_encoder = BiLSTM(params["haplotype_encoder"])
        self.haplotype_proj = Dense(params["haplotype_proj"])
        self.dense = Dense(params["dense"])
        self.gt = Dense(params["gt"])
        self.zy = Dense(params["zy"])

    @torch.no_grad()
    def forward(self, pileup_x: torch.Tensor, haplotype_x: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32,
                route: Optional[str] = None):
        """pileup_x [N, 33, 105], haplotype_x [N, 11, 105] -> (gt, zy)
        logits. Inference only (no gradient: the serving kernels have no
        backward); training runs forward_train."""
        ctr_p = encoder_center(self.pileup_encoder.layers, pileup_x,
                               compute_dtype, route)
        ctr_h = encoder_center(self.haplotype_encoder.layers, haplotype_x,
                               compute_dtype, route)
        feat = torch.cat([self.pileup_proj(ctr_p, compute_dtype),
                          self.haplotype_proj(ctr_h, compute_dtype)], dim=-1)
        feat = torch.tanh(self.dense(feat, compute_dtype))         # [N, 256]
        return self.gt(feat, compute_dtype), self.zy(feat, compute_dtype)

    def forward_train(self, pileup_x: torch.Tensor, haplotype_x: torch.Tensor,
                      *, use_kernels: bool,
                      generator: Optional[torch.Generator] = None):
        """The JAX package's training branch of haplotype_forward
        (compute_dtype f32): each branch's full encoder, both drawing
        their dropout masks from `generator` (the pileup branch first; no
        value goes to the host, so a CUDA graph can hold the step), then
        the center slices and the f32 head. -> (gt, zy) logits."""
        cfg = self.cfg
        enc_p = bilstm_encoder_train(self.pileup_encoder.layers, pileup_x,
                                     use_kernels=use_kernels,
                                     dropout=cfg.dropout, generator=generator)
        enc_h = bilstm_encoder_train(self.haplotype_encoder.layers,
                                     haplotype_x, use_kernels=use_kernels,
                                     dropout=cfg.dropout, generator=generator)
        feat = torch.cat([
            self.pileup_proj(enc_p[:, cfg.pileup_length // 2]),
            self.haplotype_proj(enc_h[:, cfg.haplotype_length // 2])], dim=-1)
        feat = torch.tanh(self.dense(feat))
        return self.gt(feat), self.zy(feat)

    def tree(self) -> dict:
        """The parameters in the JAX package's tree layout (the same
        tensors, not copies)."""
        return {k: getattr(self, k).tree() for k in _TREE}


def init_haplotype_params(gen: torch.Generator,
                          cfg: HaplotypeModelConfig) -> dict:
    """Seeded weights at the configuration's full width (the layout of
    the JAX package's init_haplotype_params; other random numbers)."""
    h = cfg.hidden_size
    return {
        "pileup_encoder": init_bilstm_params(gen, cfg.pileup_dim, h,
                                             cfg.lstm_layers),
        "pileup_proj": init_linear_params(gen, 2 * h, h),
        "haplotype_encoder": init_bilstm_params(gen, cfg.haplotype_dim, h,
                                                cfg.lstm_layers),
        "haplotype_proj": init_linear_params(gen, 2 * h, h),
        "dense": init_linear_params(gen, 2 * h, h),
        "gt": init_linear_params(gen, h, cfg.gt_num_class),
        "zy": init_linear_params(gen, h, cfg.zy_num_class),
    }


def haplotype_forward(model: HaplotypeModel, pileup_x, haplotype_x, *,
                      compute_dtype: torch.dtype = torch.float32,
                      route: Optional[str] = None):
    return model(pileup_x, haplotype_x, compute_dtype=compute_dtype,
                 route=route)


def haplotype_predict(model: HaplotypeModel, pileup_x, haplotype_x,
                      compute_dtype: torch.dtype = torch.float32,
                      route: Optional[str] = None):
    gt, zy = model(pileup_x, haplotype_x, compute_dtype=compute_dtype,
                   route=route)
    return torch.softmax(gt, dim=-1), torch.softmax(zy, dim=-1)
