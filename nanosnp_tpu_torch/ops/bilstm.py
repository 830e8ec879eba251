"""BiLSTM layer kernels: fused in-projection + recurrence.

Two wrappers around the CUDA kernels of `csrc/bilstm.cu`, each with its
plain PyTorch version beside it:

  bilstm_stream  every h_t of both directions, [N, L, 2H], bf16 for inner
                 layers or f32 for the last. Replaces the Pallas kernels
                 `_enc_stream_kernel` (pallas_lstm.py:423) and
                 `_enc_stream_kfused_kernel` (pallas_lstm.py:733), which
                 compute the same function.
  bilstm_center  only h at t = L//2 of both directions, [N, 2H] f32.
                 Replaces `_enc_center_kernel` (pallas_lstm.py:501) and
                 `_enc_center_kfused_kernel` (pallas_lstm.py:770), which
                 compute the same function (the K-fusion only filled the
                 TPU's 128-deep matrix tile).

Shared contract (the Pallas kernels' cast sites): x [N, L, D] bf16,
w_ih [2, D, 4H] bf16, w_hh [2, H, 4H] bf16, b [2, 4H] f32 (b_ih + b_hh);
gate order i, f, g, o; bf16 operands with f32 accumulation; h_{t-1} is
rounded to bf16 before the recurrent product; gate and cell math in f32;
h and c start at zero; direction 1 walks time backwards and its outputs
stand at their true time index.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises. `LAUNCHES` counts kernel
launches (never plain-version calls), so a run can show that its path
went through the kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

# every CUDA kernel of the port (those of lstm_train.py, bilstm_fused.py
# and probe.py counted here too)
LAUNCHES: Dict[str, int] = {"bilstm_stream": 0, "bilstm_center": 0,
                            "lstm_recurrence_train": 0,
                            "lstm_recurrence_bwd": 0, "lstm_dw_reduce": 0,
                            "lstm_recurrence_infer": 0,
                            "bilstm_center_head": 0, "bilstm2_center": 0,
                            "bilstm_probe": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(x, w_ih, w_hh, b) -> None:
    if x.dim() != 3 or w_ih.dim() != 3 or w_hh.dim() != 3 or b.dim() != 2:
        raise ValueError("expected x [N, L, D], w_ih [2, D, 4H], "
                         "w_hh [2, H, 4H], b [2, 4H]")
    n, seq_len, d_in = x.shape
    hidden = w_hh.shape[1]
    if (tuple(w_ih.shape) != (2, d_in, 4 * hidden)
            or tuple(w_hh.shape) != (2, hidden, 4 * hidden)
            or tuple(b.shape) != (2, 4 * hidden)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_ih "
                         f"{tuple(w_ih.shape)}, w_hh {tuple(w_hh.shape)}, "
                         f"b {tuple(b.shape)}")
    if x.dtype != torch.bfloat16 or w_ih.dtype != torch.bfloat16 \
            or w_hh.dtype != torch.bfloat16 or b.dtype != torch.float32:
        raise TypeError("expected bf16 x/w_ih/w_hh and f32 b, got "
                        f"{x.dtype}/{w_ih.dtype}/{w_hh.dtype}/{b.dtype}")
    devs = {t.device for t in (x, w_ih, w_hh, b)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _plain_layer(x, w_ih, w_hh, b, steps_of, on_step) -> None:
    """Step-by-step reference with the kernel's cast sites. `steps_of(d)`
    gives the number of steps direction d runs; `on_step(d, t, h)`
    receives each fresh f32 hidden state at true time index t."""
    n, seq_len, _ = x.shape
    hidden = w_hh.shape[1]
    for d in (0, 1):
        # bf16 operands, f32 accumulation: products of bf16 values in f32
        xp = x.float() @ w_ih[d].float()               # [N, L, 4H]
        wh = w_hh[d].float()
        h = torch.zeros(n, hidden, dtype=torch.float32, device=x.device)
        c = torch.zeros_like(h)
        for s in range(steps_of(d)):
            t = s if d == 0 else seq_len - 1 - s
            gates = xp[:, t] + h.bfloat16().float() @ wh + b[d]
            i, f, g, o = gates.split(hidden, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            on_step(d, t, h)


def bilstm_stream_plain(x, w_ih, w_hh, b,
                        out_dtype: torch.dtype = torch.bfloat16):
    n, seq_len, _ = x.shape
    hidden = w_hh.shape[1]
    out = torch.empty(n, seq_len, 2, hidden, dtype=out_dtype, device=x.device)

    def on_step(d, t, h):
        out[:, t, d] = h.to(out_dtype)

    _plain_layer(x, w_ih, w_hh, b, lambda d: seq_len, on_step)
    return out.reshape(n, seq_len, 2 * hidden)


def bilstm_center_plain(x, w_ih, w_hh, b):
    n, seq_len, _ = x.shape
    hidden = w_hh.shape[1]
    center = seq_len // 2
    out = torch.empty(n, 2, hidden, dtype=torch.float32, device=x.device)

    def on_step(d, t, h):
        if t == center:
            out[:, d] = h

    _plain_layer(x, w_ih, w_hh, b,
                 lambda d: center + 1 if d == 0 else seq_len - center,
                 on_step)
    return out.reshape(n, 2 * hidden)


def pack_weights(w_ih, w_hh) -> torch.Tensor:
    """[w_ih | w_hh] of each direction as the kernel's A operand: the
    matrix [4H, Kp] = [w_ih (D zero-padded to a multiple of 16) ; w_hh]^T,
    cut into 16x16 tiles, each tile in mma.m16n8k16 A-fragment order
    (lane l holds rows l//4 and l//4+8, k pairs 2(l%4) and 2(l%4)+8).
    -> [2, 4H/16, Kp/16, 32, 8] bf16, so that a warp loads one tile as
    32 contiguous 16-byte pieces."""
    d_in = w_ih.shape[1]
    d_pad = -(-d_in // 16) * 16
    return pack_a_fragments(torch.cat(
        [torch.nn.functional.pad(w_ih.transpose(1, 2), (0, d_pad - d_in)),
         w_hh.transpose(1, 2)], dim=2))                   # [2, 4H, Kp]


def pack_a_fragments(a: torch.Tensor) -> torch.Tensor:
    """A [B, M, K] (M and K multiples of 16) -> [B, M/16, K/16, 32, 8]:
    16x16 tiles, each in mma.m16n8k16 A-fragment order."""
    batch, rows_m, k_pad = a.shape
    tiles = a.reshape(batch, rows_m // 16, 16, k_pad // 16,
                      16).transpose(2, 3)
    lane = torch.arange(32, device=a.device)
    rows = (lane // 4)[:, None] + torch.tensor(
        [0, 0, 8, 8, 0, 0, 8, 8], device=a.device)[None, :]
    cols = (2 * (lane % 4))[:, None] + torch.tensor(
        [0, 1, 0, 1, 8, 9, 8, 9], device=a.device)[None, :]
    return tiles[:, :, :, rows, cols].contiguous()


def _launch(fn_name, x, w_ih, w_hh, b, out, *extra):
    from .build import library

    for t in (x, w_ih, w_hh, b):
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    n, seq_len, d_in = x.shape
    hidden = w_hh.shape[1]
    if hidden % 16 or hidden > 256:
        raise ValueError(f"the CUDA kernel takes H a multiple of 16 up to "
                         f"256, got {hidden}")
    wpk = pack_weights(w_ih, w_hh)
    with torch.cuda.device(x.device):
        err = getattr(library("bilstm"), fn_name)(
            x.data_ptr(), wpk.data_ptr(), b.data_ptr(), out.data_ptr(),
            *extra, n, seq_len, d_in, hidden,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err} "
                           f"(N={n}, L={seq_len}, D={d_in}, H={hidden})")


def bilstm_stream(x, w_ih, w_hh, b, out_dtype: torch.dtype = torch.bfloat16):
    """x [N, L, D] -> [N, L, 2H] in `out_dtype` (bf16 or f32)."""
    _check(x, w_ih, w_hh, b)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    if x.device.type == "cpu":
        return bilstm_stream_plain(x, w_ih, w_hh, b, out_dtype)
    n, seq_len, _ = x.shape
    out = torch.empty(n, seq_len, 2 * w_hh.shape[1], dtype=out_dtype,
                      device=x.device)
    if n:
        _launch("nsp_bilstm_stream", x, w_ih, w_hh, b, out,
                int(out_dtype == torch.float32))
        LAUNCHES["bilstm_stream"] += 1
    return out


def bilstm_center(x, w_ih, w_hh, b):
    """x [N, L, D] -> h at t = L//2 of both directions, [N, 2H] f32."""
    _check(x, w_ih, w_hh, b)
    if x.device.type == "cpu":
        return bilstm_center_plain(x, w_ih, w_hh, b)
    out = torch.empty(x.shape[0], 2 * w_hh.shape[1], dtype=torch.float32,
                      device=x.device)
    if x.shape[0]:
        _launch("nsp_bilstm_center", x, w_ih, w_hh, b, out)
        LAUNCHES["bilstm_center"] += 1
    return out


def layer_cost(n: int, seq_len: int, d_in: int, hidden: int, *,
               center: bool, out_bytes: int = 2):
    """(FLOP, bytes) that one layer call must do and move: the steps this
    call runs (the center kernel stops at t = L//2), each input read once
    and each output written once."""
    steps = seq_len // 2 + 1 if center else seq_len
    flop = 2 * n * 2 * steps * 4 * hidden * (d_in + hidden)
    read = (n * seq_len * d_in * 2 + 2 * (d_in + hidden) * 4 * hidden * 2
            + 2 * 4 * hidden * 4)
    written = n * 2 * hidden * 4 if center \
        else n * seq_len * 2 * hidden * out_bytes
    return flop, read + written
