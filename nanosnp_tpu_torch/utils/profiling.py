"""Small observability helpers (counterpart of nanosnp_tpu/utils/profiling.py
for what the port uses)."""
from __future__ import annotations

from ..models.convert import flatten_tree


def count_parameters(params) -> int:
    """Total parameter count of a parameter tree (nested dicts and lists of
    tensors or arrays; the reference's utils.count_parameters analog)."""
    total = 0
    for _, leaf in flatten_tree(params):
        n = 1
        for d in leaf.shape:
            n *= int(d)
        total += n
    return total
