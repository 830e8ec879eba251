"""Data parallelism over the ranks of the process group.

Counterpart of nanosnp_tpu/parallel/mesh.py. The JAX trainers shard each
batch over a ("data",) mesh axis (`P("data")`), replicate the parameters
(`P()`) and let XLA sum the gradients (psum). In the port each rank is one
process on one device (parallel/launch.py): it takes its contiguous slice
of the global batch (`shard_rows`), starts from rank 0's parameters
(`broadcast_params`) and averages its gradients with the other ranks'
(`all_reduce_mean`). Without a process group of more than one rank every
function here leaves its input as it is.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist


def world() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the process group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad the leading dim to a multiple (static shapes for jit); returns
    (padded, original_length)."""
    n = x.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x, n
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(x, pad_width), n


def shard_rows(n: int, rank: int, world: int) -> slice:
    """The rows of an n-row global batch that P("data") gives device
    `rank` of `world`: a contiguous n / world of them."""
    if n % world:
        raise ValueError(f"batch of {n} rows not divisible by {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]
            ) -> List[torch.Tensor]:
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


@torch.no_grad()
def broadcast_params(tensors: Sequence[torch.Tensor]) -> None:
    """Rank 0's values into every rank's tensors, in place (one buffer),
    the counterpart of placing them with `replicated`."""
    if world() <= 1 or not tensors:
        return
    flat = _flat(tensors)
    dist.broadcast(flat, src=0)
    for t, v in zip(tensors, _unflat(flat, tensors)):
        t.copy_(v)


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over ranks of each tensor (one buffer, one all_reduce);
    the tensors themselves are left as they are."""
    if world() <= 1 or not tensors:
        return list(tensors)
    flat = _flat(tensors).clone()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    return _unflat(flat, tensors)


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over ranks of each tensor: all_reduce SUM of one flat
    buffer, then divided by the rank count (psum / devices)."""
    n = world()
    if n <= 1:
        return list(tensors)
    return [t / n for t in all_reduce_sum(tensors)]
