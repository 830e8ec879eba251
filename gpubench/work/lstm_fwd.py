"""The training forward recurrence (`lstm_recurrence_train`: the smem
kernel at H=64, the cluster kernel at H=256, the packed kernel
elsewhere). A call (n rows, L steps, H units): both directions' h_{t-1}
x w_hh products, 4H x H a step, bf16 on the tensor cores; bytes: f32 xp
[n, L, 2, 4H] in, bf16 w_hh in, f32 hs and cs [n, L, 2, H] out. Claims
every training layer call (`op` "lstm_train").
"""
from typing import Optional

from _peaks import bound_s

KERNELS = ("lstm_fwd_smem_kernel", "lstm_fwd_cluster_kernel",
           "lstm_fwd_kernel")


def bound(call: dict) -> Optional[float]:
    if call["op"] != "lstm_train":
        return None
    n, L, H = call["n"], call["L"], call["H"]
    flop = 2 * (2 * n * L) * 4 * H * H
    state = n * L * 2 * H * 4
    return bound_s(flop, 4 * state + 2 * H * 4 * H * 2 + 2 * state)
