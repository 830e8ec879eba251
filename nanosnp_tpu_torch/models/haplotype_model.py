"""Haplotype-stage caller: two 3-layer BiLSTM(h=256) branches over the
33-long pileup features and the 11-long haplotype features, center concat,
dense, gt(10)/zy(3) heads.

Counterpart of nanosnp_tpu/models/haplotype_model.py, inputs feature-last
[N, L, 105], center sliced before the head.
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from ..config import HaplotypeModelConfig
from ..device import set_matmul_precision
from .bilstm import BiLSTM, Dense, encoder_center


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

    def forward(self, pileup_x: torch.Tensor, haplotype_x: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32):
        """pileup_x [N, 33, 105], haplotype_x [N, 11, 105] -> (gt, zy)
        logits."""
        ctr_p = encoder_center(self.pileup_encoder.layers, pileup_x,
                               compute_dtype)
        ctr_h = encoder_center(self.haplotype_encoder.layers, haplotype_x,
                               compute_dtype)
        feat = torch.cat([self.pileup_proj(ctr_p, compute_dtype),
                          self.haplotype_proj(ctr_h, compute_dtype)], dim=-1)
        feat = torch.tanh(self.dense(feat, compute_dtype))         # [N, 256]
        return self.gt(feat, compute_dtype), self.zy(feat, compute_dtype)


def haplotype_forward(model: HaplotypeModel, pileup_x, haplotype_x, *,
                      compute_dtype: torch.dtype = torch.float32):
    return model(pileup_x, haplotype_x, compute_dtype=compute_dtype)


def haplotype_predict(model: HaplotypeModel, pileup_x, haplotype_x,
                      compute_dtype: torch.dtype = torch.float32):
    gt, zy = model(pileup_x, haplotype_x, compute_dtype=compute_dtype)
    return torch.softmax(gt, dim=-1), torch.softmax(zy, dim=-1)
