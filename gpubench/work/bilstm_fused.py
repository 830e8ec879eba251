"""The fused H=64 BiLSTM layer kernels of the s2 route (`bilstm_stream`:
every step's state out; `bilstm_center`: the window's center state only),
one device kernel template, in-projection and recurrence in one launch.
Claims the inference layer calls (`op` "bilstm_layer") at H <= 64, where
the port holds a layer's weights in shared memory.

A call (n rows, L steps, D inputs, H units): both directions' products
of (D + H) x 4H a step, 2 FLOP a multiply-add, bf16 on the tensor cores;
a center call needs (L + 1) / 2 steps a direction. Bytes: x in bf16, the
bf16 weights, the output (bf16 [n, L, 2H] from a stream layer that feeds
another, f32 [n, L, 2H] from a last one, f32 [n, 2H] from a center call).
"""
from typing import Optional

from _peaks import bound_s, layer_bytes

KERNELS = ("bilstm_fused_kernel",)


def bound(call: dict) -> Optional[float]:
    if call["op"] != "bilstm_layer" or call["H"] > 64:
        return None
    n, L, D, H = call["n"], call["L"], call["D"], call["H"]
    steps = (L + 1) // 2 if call["center"] else L
    flop = 2 * n * steps * 2 * (D + H) * 4 * H
    return bound_s(flop, layer_bytes(call))
