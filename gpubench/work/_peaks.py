"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W): what every bound and utilization here divides by; and the
bytes an inference layer call must move, which every layer family shares.

A call is a dict of shapes that a cell's driver reports and the work
files claim: `op` "bilstm_layer" (an inference BiLSTM layer: n rows, L
steps, D inputs, H units, `center` when only the window's center state
is needed, `last` when its output leaves the encoder) or "lstm_train"
(one training layer's recurrence: n, L, H), and `count`, the calls in
the window.
"""
BF16_FLOPS = 989e12        # bf16 / fp16 tensor cores
FP32_FFMA_FLOPS = 67e12    # f32 on the CUDA cores
HBM_BYTES = 3.35e12        # bytes/s


def bound_s(flop: float, nbytes: float, flops: float = BF16_FLOPS) -> float:
    """The least time: the larger of operations over peak and bytes over
    bandwidth, each input read once and each output written once."""
    return max(flop / flops, nbytes / HBM_BYTES)


def layer_bytes(call: dict) -> float:
    """x in bf16, both directions' bf16 weights and f32 biases, and the
    output: f32 [n, 2H] from a center call, f32 [n, L, 2H] from a last
    layer, bf16 [n, L, 2H] from one that feeds another."""
    n, L, D, H = call["n"], call["L"], call["D"], call["H"]
    if call["center"]:
        out = n * 2 * H * 4
    else:
        out = n * L * 2 * H * (4 if call["last"] else 2)
    return n * L * D * 2 + 2 * (D + H) * 4 * H * 2 + 2 * 4 * H * 4 + out
