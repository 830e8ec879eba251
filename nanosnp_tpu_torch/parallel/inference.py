"""Batched inference on one device.

Counterpart of nanosnp_tpu/parallel/inference.py without the mesh: the
port runs on one card. Host batches are staged in pinned memory and
copied without blocking the host; results are fetched a bounded number of
batches behind the launches, so the host prepares batch k+1 while the
device computes batch k.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import count
from .mesh import pad_to_multiple


class BatchedPredictor:
    """Runs `predict_fn(*device_tensors) -> tensor or tuple of tensors` over
    host arrays in batches of `batch_size` rows, padding the tail."""

    # batches whose outputs stay on the device before the oldest is fetched
    MAX_IN_FLIGHT = 2

    def __init__(self, predict_fn: Callable, batch_size: int = 8192,
                 device="cuda"):
        self.fn = predict_fn
        self.batch_size = batch_size
        self.device = resolve_device(device)

    def _stage(self, arrays: Sequence) -> List[torch.Tensor]:
        """Host arrays -> device tensors (tensors are moved if needed);
        counter `nsp.h2d_bytes` adds the host arrays' bytes."""
        out = []
        for a in arrays:
            if isinstance(a, torch.Tensor):
                out.append(a.to(self.device))
                continue
            t = torch.from_numpy(np.ascontiguousarray(a))
            count("nsp.h2d_bytes", t.nbytes)
            if self.device.type == "cuda":
                # page-locked staging from PyTorch's caching host allocator,
                # which recycles a buffer only once its copy has finished
                t = t.pin_memory()
            out.append(t.to(self.device, non_blocking=True))
        return out

    @torch.inference_mode()
    def apply(self, *arrays):
        """One batch (any row count) -> device outputs, not fetched."""
        res = self.fn(*self._stage(arrays))
        return tuple(res) if isinstance(res, (tuple, list)) else (res,)

    @torch.inference_mode()
    def run(self, *arrays: np.ndarray) -> List[np.ndarray]:
        """Host arrays with a common leading dim N -> host outputs with the
        padding stripped, concatenated over all batches."""
        n = arrays[0].shape[0]
        bs = self.batch_size
        pending: List = []
        outs: List[List[np.ndarray]] = []

        def drain_one():
            m, res = pending.pop(0)
            outs.append([r[:m].cpu().numpy() for r in res])

        for start in range(0, n, bs):
            chunk = [a[start: start + bs] for a in arrays]
            m = chunk[0].shape[0]
            if m < bs:   # tail: pad to the full batch with zero rows
                chunk = [pad_to_multiple(c, bs)[0] for c in chunk]
            pending.append((m, self.apply(*chunk)))
            while len(pending) > self.MAX_IN_FLIGHT:
                drain_one()
        while pending:
            drain_one()
        if not outs:
            return []
        return [np.concatenate([o[i] for o in outs])
                for i in range(len(outs[0]))]
