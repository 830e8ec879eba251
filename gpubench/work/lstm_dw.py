"""dW_hh of the training recurrence (`lstm_dw_reduce` at H=256, and the
small launch that adds the split or tiled partials in order at any H).
Claims every training layer call (`op` "lstm_train"). A call (n, L, H):
the f32 product h_{t-1}^T dgates over 2 n (L - 1) rows as three bf16
products of its split operands (hi hi, hi lo, lo hi) on the tensor
cores; bytes: f32 hs and dxp rows in, bf16 dW out. At H=64 the smem
sweep sums dW itself: only the partials' adding runs here, whose work
is in lstm_bwd's bytes, so the call's bound here is nought.
"""
from typing import Optional

from _peaks import bound_s

KERNELS = ("lstm_dw_tc_kernel", "lstm_dw_sum_kernel")


def bound(call: dict) -> Optional[float]:
    if call["op"] != "lstm_train":
        return None
    n, L, H = call["n"], call["L"], call["H"]
    if H == 64:
        return 0.0
    rows = 2 * n * max(L - 1, 0)
    return bound_s(3 * 2 * rows * H * 4 * H,
                   rows * 5 * H * 4 + 2 * H * 4 * H * 2)
