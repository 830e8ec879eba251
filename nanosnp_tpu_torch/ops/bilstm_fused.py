"""The pileup encoder's two opt-in fusions.

Two wrappers around the CUDA kernels of `csrc/bilstm_fused.cu`, each with
its plain PyTorch version beside it:

  bilstm_center_head  the center layer (`ops.bilstm.bilstm_center`) and, on
                      its [N, 2H] state, the head inside the kernel:
                      logits = Wh . bf16(tanh(Wd . bf16(Wp . bf16(ctr) + bp)
                      + bd)) + bh, [N, rows] f32. Replaces
                      `_enc_center_head_kernel` (pallas_lstm.py:556).
  bilstm2_center      both layers of a two-layer encoder in one kernel, the
                      bf16 activations between them kept in shared memory;
                      only layer 2's state at t = L//2, [N, 2H] f32.
                      Replaces `_enc2_center_kernel` (pallas_lstm.py:842).

The layers' contract is that of ops/bilstm.py (x bf16, w_ih/w_hh bf16, b
f32, gate order i, f, g, o, bf16 operands with f32 accumulation, f32 cell).
The head is (wp [P, 2H], bp [P], wd [Q, P], bd [Q], wh [R, Q], bh [R]):
weights bf16 in [out, in] layout, biases f32.

One block of either kernel runs both directions of its batch tile, which
bounds what they take: L odd, H a multiple of 16 up to 128, and shared
memory within the 227 KiB a block may ask for (`center_head_supported`,
`two_layer_supported`). A caller chooses its route by those rules; a shape
outside them raises here.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises. Launches count in
`ops.bilstm.LAUNCHES`.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .bilstm import (LAUNCHES, _check, bilstm_center_plain,
                     bilstm_stream_plain, layer_cost, pack_a_fragments,
                     pack_weights)

SMEM_LIMIT = 232_448        # bytes of shared memory one block may ask for
_ROW_PAD = 8                # as kRowPad in the kernels
_HEAD_ROWS, _TWO_LAYER_ROWS = 32, 16     # batch rows a block


def _pad16(v: int) -> int:
    return -(-v // 16) * 16


def _geometry_ok(seq_len: int, hidden: int) -> bool:
    return seq_len % 2 == 1 and hidden % 16 == 0 and 0 < hidden <= 128


def center_head_supported(seq_len: int, d_in: int, hidden: int, p_dim: int,
                          q_dim: int) -> bool:
    """Whether `bilstm_center_head`'s kernel takes this shape."""
    smem = 2 * _HEAD_ROWS * (
        2 * (_pad16(d_in) + hidden + _ROW_PAD) + (2 * hidden + _ROW_PAD)
        + (p_dim + _ROW_PAD) + (q_dim + _ROW_PAD))
    return (_geometry_ok(seq_len, hidden) and p_dim % 16 == 0
            and q_dim % 16 == 0 and smem <= SMEM_LIMIT)


def two_layer_supported(seq_len: int, d_in: int, hidden: int) -> bool:
    """Whether `bilstm2_center`'s kernel takes this shape: its slab of
    layer-1 states, L x (2H + 8) bf16 a batch row for 16 rows, must fit
    beside the operand tiles."""
    smem = 2 * _TWO_LAYER_ROWS * (
        seq_len * (2 * hidden + _ROW_PAD)
        + 2 * (_pad16(d_in) + hidden + _ROW_PAD) + 2 * (hidden + _ROW_PAD))
    return _geometry_ok(seq_len, hidden) and smem <= SMEM_LIMIT


def _check_head(head: Sequence[torch.Tensor], hidden: int, device) -> None:
    if len(head) != 6:
        raise ValueError("head is (wp, bp, wd, bd, wh, bh)")
    wp, bp, wd, bd, wh, bh = head
    p_dim, q_dim, rows = wp.shape[0], wd.shape[0], wh.shape[0]
    if (tuple(wp.shape) != (p_dim, 2 * hidden) or tuple(bp.shape) != (p_dim,)
            or tuple(wd.shape) != (q_dim, p_dim)
            or tuple(bd.shape) != (q_dim,)
            or tuple(wh.shape) != (rows, q_dim)
            or tuple(bh.shape) != (rows,)):
        raise ValueError("head shapes: wp [P, 2H], bp [P], wd [Q, P], "
                         "bd [Q], wh [R, Q], bh [R]; got "
                         f"{[tuple(t.shape) for t in head]}")
    if any(t.dtype != torch.bfloat16 for t in (wp, wd, wh)) or any(
            t.dtype != torch.float32 for t in (bp, bd, bh)):
        raise TypeError("head weights bf16, biases f32; got "
                        f"{[t.dtype for t in head]}")
    if any(t.device != device for t in head):
        raise ValueError("head tensors on another device than x")


def head_plain(ctr: torch.Tensor, head: Sequence[torch.Tensor]):
    """The head on a center state [N, 2H] f32 -> [N, R] f32: bf16 operands,
    f32 accumulation, f32 bias adds and tanh."""
    wp, bp, wd, bd, wh, bh = head

    def lin(w, b, v):
        return v.bfloat16().float() @ w.float().T + b

    feat = lin(wp, bp, ctr)
    feat = torch.tanh(lin(wd, bd, feat))
    return lin(wh, bh, feat)


def bilstm_center_head_plain(x, w_ih, w_hh, b, head):
    return head_plain(bilstm_center_plain(x, w_ih, w_hh, b), head)


def bilstm2_center_plain(x, w_ih1, w_hh1, b1, w_ih2, w_hh2, b2):
    h1 = bilstm_stream_plain(x, w_ih1, w_hh1, b1, torch.bfloat16)
    return bilstm_center_plain(h1, w_ih2, w_hh2, b2)


def _contiguous(*tensors) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def bilstm_center_head(x, w_ih, w_hh, b, head):
    """x [N, L, D] bf16 -> head logits at the window center, [N, R] f32."""
    _check(x, w_ih, w_hh, b)
    n, seq_len, d_in = x.shape
    hidden = w_hh.shape[1]
    _check_head(head, hidden, x.device)
    if x.device.type == "cpu":
        return bilstm_center_head_plain(x, w_ih, w_hh, b, head)
    from .build import library

    wp, bp, wd, bd, wh, bh = head
    p_dim, q_dim, rows = wp.shape[0], wd.shape[0], wh.shape[0]
    if not center_head_supported(seq_len, d_in, hidden, p_dim, q_dim):
        raise ValueError(
            "the CUDA kernel takes odd L, H a multiple of 16 up to 128, P "
            f"and Q multiples of 16, within {SMEM_LIMIT} bytes of shared "
            f"memory; got L={seq_len}, D={d_in}, H={hidden}, P={p_dim}, "
            f"Q={q_dim}")
    _contiguous(x, w_ih, w_hh, b, *head)
    out = torch.empty(n, rows, dtype=torch.float32, device=x.device)
    if n and rows:
        r_dim = _pad16(rows)
        pad = (0, 0, 0, r_dim - rows)
        packed = [pack_weights(w_ih, w_hh), pack_a_fragments(wp[None]),
                  pack_a_fragments(wd[None]), pack_a_fragments(
                      torch.nn.functional.pad(wh, pad)[None])]
        bh_pad = torch.nn.functional.pad(bh, (0, r_dim - rows))
        with torch.cuda.device(x.device):
            err = library("bilstm_fused").nsp_bilstm_center_head(
                x.data_ptr(), packed[0].data_ptr(), b.data_ptr(),
                packed[1].data_ptr(), bp.data_ptr(), packed[2].data_ptr(),
                bd.data_ptr(), packed[3].data_ptr(), bh_pad.data_ptr(),
                out.data_ptr(), n, seq_len, d_in, hidden, p_dim, q_dim, r_dim,
                rows, torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(
                f"bilstm_center_head launch failed: cudaError {err} (N={n}, "
                f"L={seq_len}, D={d_in}, H={hidden}, P={p_dim}, Q={q_dim}, "
                f"R={rows})")
        LAUNCHES["bilstm_center_head"] += 1
    return out


def bilstm2_center(x, w_ih1, w_hh1, b1, w_ih2, w_hh2, b2):
    """x [N, L, D] bf16 through two layers of equal width -> layer 2's
    state at t = L//2 of both directions, [N, 2H] f32."""
    _check(x, w_ih1, w_hh1, b1)
    n, seq_len, d_in = x.shape
    hidden = w_hh1.shape[1]
    if tuple(w_ih2.shape) != (2, 2 * hidden, 4 * hidden):
        raise ValueError(f"layer 2 takes the [N, L, 2H] output of layer 1: "
                         f"w_ih2 {tuple(w_ih2.shape)}, H={hidden}")
    _check(x.new_empty(0, seq_len, 2 * hidden), w_ih2, w_hh2, b2)
    if x.device.type == "cpu":
        return bilstm2_center_plain(x, w_ih1, w_hh1, b1, w_ih2, w_hh2, b2)
    from .build import library

    if not two_layer_supported(seq_len, d_in, hidden):
        raise ValueError(
            "the CUDA kernel takes odd L and H a multiple of 16 up to 128, "
            f"its slab within {SMEM_LIMIT} bytes of shared memory; got "
            f"L={seq_len}, D={d_in}, H={hidden}")
    _contiguous(x, w_ih1, w_hh1, b1, w_ih2, w_hh2, b2)
    out = torch.empty(n, 2 * hidden, dtype=torch.float32, device=x.device)
    if n:
        wpk1 = pack_weights(w_ih1, w_hh1)
        wpk2 = pack_weights(w_ih2, w_hh2)
        with torch.cuda.device(x.device):
            err = library("bilstm_fused").nsp_bilstm2_center(
                x.data_ptr(), wpk1.data_ptr(), b1.data_ptr(), wpk2.data_ptr(),
                b2.data_ptr(), out.data_ptr(), n, seq_len, d_in, hidden,
                torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(
                f"bilstm2_center launch failed: cudaError {err} (N={n}, "
                f"L={seq_len}, D={d_in}, H={hidden})")
        LAUNCHES["bilstm2_center"] += 1
    return out


def center_head_cost(n: int, seq_len: int, d_in: int, hidden: int,
                     p_dim: int, q_dim: int, rows: int):
    """(FLOP, bytes) of one call: the center layer's steps and the head's
    three products; x, the weights and biases read once, the logits
    written once (no center state leaves the kernel)."""
    flop, nbytes = layer_cost(n, seq_len, d_in, hidden, center=True)
    flop += 2 * n * (2 * hidden * p_dim + p_dim * q_dim + q_dim * rows)
    nbytes += (-n * 2 * hidden * 4 + n * rows * 4
               + 2 * (2 * hidden * p_dim + p_dim * q_dim + q_dim * rows)
               + 4 * (p_dim + q_dim + rows))
    return flop, nbytes


def two_layer_cost(n: int, seq_len: int, d_in: int, hidden: int):
    """(FLOP, bytes) of one call: every step of layer 1, the L//2 + 1
    steps a direction of layer 2 must run; no inter-layer bytes."""
    flop1, bytes1 = layer_cost(n, seq_len, d_in, hidden, center=False)
    flop2, bytes2 = layer_cost(n, seq_len, 2 * hidden, hidden, center=True)
    between = n * seq_len * 2 * hidden * 2     # layer 1 out = layer 2 in
    return flop1 + flop2, bytes1 + bytes2 - 2 * between
