"""The training backward sweep (`lstm_recurrence_bwd`; at H=64 the smem
sweep also sums dW_hh, whose added work is in lstm_dw's count only where
`lstm_dw_tc_kernel` runs). A call (n, L, H): two products a step and
direction (dgates w_hh^T and the gates' recompute), bf16; bytes: f32 xp,
hs, cs and the incoming gradient in, bf16 w_hh in, f32 dxp out. Claims
every training layer call (`op` "lstm_train").
"""
from typing import Optional

from _peaks import bound_s

KERNELS = ("lstm_bwd_smem_kernel", "lstm_bwd_cluster_kernel",
           "lstm_bwd_kernel")


def bound(call: dict) -> Optional[float]:
    if call["op"] != "lstm_train":
        return None
    n, L, H = call["n"], call["L"], call["H"]
    flop = 2 * 2 * (2 * n * L) * 4 * H * H
    state = n * L * 2 * H * 4
    return bound_s(flop, 4 * state + 3 * state + 2 * H * 4 * H * 2
                   + 4 * state)
