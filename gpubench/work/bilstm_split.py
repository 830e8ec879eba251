"""The H=256 BiLSTM layer of the s5 route: `bilstm_inproj` (the
in-projection GEMM into f32 xp) and `bilstm_cluster` (the recurrence on
4-CTA clusters), counted as one layer call: the work is the layer's, not
the split's, so the f32 xp the split writes and reads back is not in it.
Claims the inference layer calls (`op` "bilstm_layer") at H > 64.

A call (n rows, L steps, D inputs, H units): as bilstm_fused, (D + H) x
4H products a step and direction, bf16 on the tensor cores, (L + 1) / 2
steps a direction for a center call; bytes x in, weights, output out.
"""
from typing import Optional

from _peaks import bound_s, layer_bytes

KERNELS = ("bilstm_inproj_kernel", "bilstm_cluster_kernel")


def bound(call: dict) -> Optional[float]:
    if call["op"] != "bilstm_layer" or call["H"] <= 64:
        return None
    n, L, D, H = call["n"], call["L"], call["D"], call["H"]
    steps = (L + 1) // 2 if call["center"] else L
    flop = 2 * n * steps * 2 * (D + H) * 4 * H
    return bound_s(flop, layer_bytes(call))
