"""The pileup encoder's two opt-in fusions.

Two wrappers around the CUDA kernels of `csrc/bilstm_fused.cu`, each with
its plain PyTorch version beside it:

  bilstm_center_head  the center layer (`ops.bilstm.bilstm_center`) and, on
                      its [N, 2H] state, the head inside the kernel:
                      logits = Wh . bf16(tanh(Wd . bf16(Wp . bf16(ctr) + bp)
                      + bd)) + bh, [N, rows] f32. Replaces
                      `_enc_center_head_kernel` (pallas_lstm.py:556).
  bilstm2_center      both layers of a two-layer encoder in one kernel, bf16
                      activations between them; only layer 2's state at
                      t = L//2, [N, 2H] f32. Replaces `_enc2_center_kernel`
                      (pallas_lstm.py:842).

The layers' contract is that of ops/bilstm.py (x bf16, w_ih/w_hh bf16, b
f32, gate order i, f, g, o, bf16 operands with f32 accumulation, f32 cell).
The head is (wp [P, 2H], bp [P], wd [Q, P], bd [Q], wh [R, Q], bh [R]):
weights bf16 in [out, in] layout, biases f32.

Both kernels run on clusters of two CTAs, one a direction, each cluster a
tile of `bn` batch rows, every CTA holding its direction's packed weights
in shared memory. `plan_two_layer` / `plan_center_head` give the launch
plan, an `ops.bilstm.LayerPlan` whose tile the fused layers' own rule
(`fewest_waves`) picks and whose ints the C launchers check;
`two_layer_supported` /
`center_head_supported` say whether a shape has one, and a caller
chooses its route by them before any launch.

The wrappers take the weights packed beforehand (a layer's
`BiLSTMLayer.kernel_weights()[3]`, the head's `pack_head`) and pack
nothing. A wrapper takes the plain version only for tensors on the CPU. For
CUDA tensors it launches the kernel or raises. Launches count in
`ops.bilstm.LAUNCHES`.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Tuple

import torch

from .bilstm import (_ERRORS, LAUNCHES, SMEM_MAX, LayerPlan, _check,
                     _kernel_x, _packed, bilstm_center_plain,
                     bilstm_stream_plain, fewest_waves, layer_cost,
                     pack_a_fragments)

_ROW_PAD = 8                # as kRowPad in the kernels
_TWO_LAYER_TILES = (32, 64, 128)     # batch rows a cluster
_HEAD_TILES = (64, 128)     # each CTA's half a multiple of 32 rows


def _pad16(v: int) -> int:
    return -(-v // 16) * 16


def two_layer_smem(d_x: int, hidden: int, bn: int) -> int:
    """Shared memory of `bilstm2_center`'s CTA (csrc two_layer_smem):
    layer 1's weights and x tiles or, after them, layer 2's x tiles; layer
    2's weights; the h tiles."""
    d_pad = _pad16(d_x)
    w1 = 4 * hidden * (d_pad + hidden) * 2
    x1 = 2 * bn * (d_pad + _ROW_PAD) * 2
    x2 = 2 * bn * (2 * hidden + _ROW_PAD) * 2
    return (max(w1 + x1, x2) + 4 * hidden * 3 * hidden * 2
            + 2 * bn * (hidden + _ROW_PAD) * 2)


def center_head_smem(d_x: int, hidden: int, p_dim: int, q_dim: int,
                     bn: int) -> int:
    """Shared memory of `bilstm_center_head`'s CTA (csrc
    center_head_smem): the weights; the x tiles, later the head's tiles of
    bn/2 rows; the h tiles; the center of bn/2 rows."""
    d_pad, half = _pad16(d_x), bn // 2
    return (4 * hidden * (d_pad + hidden) * 2
            + max(2 * bn * (d_pad + _ROW_PAD),
                  half * (p_dim + q_dim + 2 * _ROW_PAD)) * 2
            + 2 * bn * (hidden + _ROW_PAD) * 2
            + half * (2 * hidden + _ROW_PAD) * 2)


def _pair_plan(path, n, seq_len, d_in, hidden, tiles, smem_of,
               weight_tiles) -> Optional[LayerPlan]:
    """The 2-CTA cluster plan of `fewest_waves` (as the fused layers'), or
    None where no tile fits a CTA."""
    if (n < 1 or seq_len < 1 or seq_len % 2 == 0 or d_in < 1
            or hidden < 16 or hidden % 16):
        return None
    d_x = d_in + d_in % 2
    tile = fewest_waves(n, hidden, tiles, lambda bn: smem_of(d_x, bn))
    if tile is None:
        return None
    bn, threads, smem = tile
    return LayerPlan(path, n, seq_len, d_in, hidden, True, d_x, bn, 2,
                     threads, smem, (2 * -(-n // bn), 1),
                     weight_tiles(_pad16(d_x)))


@lru_cache(maxsize=256)      # a plan is a pure function of ints
def _two_layer_plan(n, seq_len, d_in, hidden):
    return _pair_plan("two_layer", n, seq_len, d_in, hidden,
                      _TWO_LAYER_TILES,
                      lambda d_x, bn: two_layer_smem(d_x, hidden, bn),
                      lambda d_pad: (d_pad + 4 * hidden) // 16)


@lru_cache(maxsize=256)
def _center_head_plan(n, seq_len, d_in, hidden, p_dim, q_dim):
    if p_dim < 16 or p_dim % 16 or q_dim < 16 or q_dim % 16:
        return None
    return _pair_plan("center_head", n, seq_len, d_in, hidden, _HEAD_TILES,
                      lambda d_x, bn: center_head_smem(d_x, hidden, p_dim,
                                                       q_dim, bn),
                      lambda d_pad: (d_pad + hidden) // 16)


def plan_two_layer(n: int, seq_len: int, d_in: int,
                   hidden: int) -> LayerPlan:
    """`bilstm2_center`'s launch plan; ValueError for a shape it does not
    take."""
    plan = _two_layer_plan(n, seq_len, d_in, hidden)
    if plan is None:
        raise ValueError(
            "no two-layer kernel plan: it takes N >= 1, odd L and H a "
            "multiple of 16 whose two layers' weights and tiles fit "
            f"{SMEM_MAX} bytes of shared memory a CTA; got N={n}, "
            f"L={seq_len}, D={d_in}, H={hidden}")
    return plan


def plan_center_head(n: int, seq_len: int, d_in: int, hidden: int,
                     p_dim: int, q_dim: int) -> LayerPlan:
    """`bilstm_center_head`'s launch plan; ValueError for a shape it does
    not take."""
    plan = _center_head_plan(n, seq_len, d_in, hidden, p_dim, q_dim)
    if plan is None:
        raise ValueError(
            "no center + head kernel plan: it takes N >= 1, odd L, H a "
            "multiple of 16, P and Q multiples of 16, the layer's weights "
            f"and tiles within {SMEM_MAX} bytes of shared memory a CTA; "
            f"got N={n}, L={seq_len}, D={d_in}, H={hidden}, P={p_dim}, "
            f"Q={q_dim}")
    return plan


def center_head_supported(seq_len: int, d_in: int, hidden: int, p_dim: int,
                          q_dim: int) -> bool:
    """Whether `bilstm_center_head`'s kernel takes this shape (at any N)."""
    return _center_head_plan(1, seq_len, d_in, hidden, p_dim,
                             q_dim) is not None


def two_layer_supported(seq_len: int, d_in: int, hidden: int) -> bool:
    """Whether `bilstm2_center`'s kernel takes this shape (at any N): both
    layers' weights of one direction in a CTA beside its tiles. L only
    needs to be odd: layer 1's states pass through device memory."""
    return _two_layer_plan(1, seq_len, d_in, hidden) is not None


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


def pack_head(head: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The head as its kernel reads it: wp, wd and wh (its rows zero-padded
    to a multiple of 16) as packed A fragments [M/16, K/16, 32, 8] bf16,
    and bh padded alike. Made once per set of weights (a model caches it),
    never per call."""
    wp, _, wd, _, wh, bh = head
    pad = _pad16(wh.shape[0]) - wh.shape[0]
    return (pack_a_fragments(wp[None])[0], pack_a_fragments(wd[None])[0],
            pack_a_fragments(torch.nn.functional.pad(wh, (0, 0, 0, pad))
                             [None])[0],
            torch.nn.functional.pad(bh, (0, pad)).contiguous())


def _check_head_packed(head, head_packed) -> Tuple[torch.Tensor, ...]:
    if head_packed is None:
        raise ValueError("pass the head packed beforehand (pack_head): the "
                         "kernel's wrapper packs nothing")
    wp, _, wd, _, wh, _ = head
    p_dim, q_dim, r_dim = wp.shape[0], wd.shape[0], _pad16(wh.shape[0])
    want = [(p_dim // 16, wp.shape[1] // 16, 32, 8),
            (q_dim // 16, p_dim // 16, 32, 8),
            (r_dim // 16, q_dim // 16, 32, 8), (r_dim,)]
    got = [tuple(t.shape) for t in head_packed]
    if (got != want or any(t.device != wp.device or not t.is_contiguous()
                           for t in head_packed)
            or any(t.dtype != torch.bfloat16 for t in head_packed[:3])
            or head_packed[3].dtype != torch.float32):
        raise ValueError(f"head_packed must be pack_head(head): {want}, "
                         f"contiguous on {wp.device}; got {got}")
    return tuple(head_packed)


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


def _launch(fn_name: str, device, *args) -> None:
    from .build import library

    with torch.cuda.device(device):
        err = getattr(library("bilstm_fused"), fn_name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn_name} failed: "
                           f"{_ERRORS.get(err, f'cudaError {err}')}")


def _require_packed(w_ih, w_hh, packed) -> torch.Tensor:
    if packed is None:
        raise ValueError("pass the layer's packed weights "
                         "(BiLSTMLayer.kernel_weights()[3]): the kernel's "
                         "wrapper packs nothing")
    return _packed(w_ih, w_hh, packed)


def bilstm_center_head(x, w_ih, w_hh, b, head,
                       packed: Optional[torch.Tensor] = None,
                       head_packed: Optional[Sequence[torch.Tensor]] = None):
    """x [N, L, D] bf16 -> head logits at the window center, [N, R] f32.
    On the card `packed` (pack_weights(w_ih, w_hh)) and `head_packed`
    (pack_head(head)) are required."""
    _check(x, w_ih, w_hh, b)
    n, seq_len, d_in = x.shape
    hidden = w_hh.shape[1]
    _check_head(head, hidden, x.device)
    if x.device.type == "cpu":
        return bilstm_center_head_plain(x, w_ih, w_hh, b, head)
    wp, bp, wd, bd, wh, bh = head
    p_dim, q_dim, rows = wp.shape[0], wd.shape[0], wh.shape[0]
    _contiguous(x, w_ih, w_hh, b, *head)
    wpk = _require_packed(w_ih, w_hh, packed)
    wp_pk, wd_pk, wh_pk, bh_pad = _check_head_packed(head, head_packed)
    out = torch.empty(n, rows, dtype=torch.float32, device=x.device)
    if n and rows:
        plan = plan_center_head(n, seq_len, d_in, hidden, p_dim, q_dim)
        xk = _kernel_x(x, plan.d_x)
        _launch("nsp_bilstm_center_head", x.device, xk.data_ptr(),
                wpk.data_ptr(), b.data_ptr(), wp_pk.data_ptr(),
                bp.data_ptr(), wd_pk.data_ptr(), bd.data_ptr(),
                wh_pk.data_ptr(), bh_pad.data_ptr(), out.data_ptr(), n,
                seq_len, plan.d_x, hidden, p_dim, q_dim, bh_pad.shape[0],
                rows, plan.bn, plan.smem, plan.grid[0])
        LAUNCHES["bilstm_center_head"] += 1
    return out


def bilstm2_center(x, w_ih1, w_hh1, b1, w_ih2, w_hh2, b2,
                   packed1: Optional[torch.Tensor] = None,
                   packed2: Optional[torch.Tensor] = None):
    """x [N, L, D] bf16 through two layers of equal width -> layer 2's
    state at t = L//2 of both directions, [N, 2H] f32. On the card the
    layers' packed weights (`packed1`, `packed2`) are required."""
    _check(x, w_ih1, w_hh1, b1)
    n, seq_len, d_in = x.shape
    hidden = w_hh1.shape[1]
    if tuple(w_ih2.shape) != (2, 2 * hidden, 4 * hidden):
        raise ValueError(f"layer 2 takes the [N, L, 2H] output of layer 1: "
                         f"w_ih2 {tuple(w_ih2.shape)}, H={hidden}")
    _check(x.new_empty(0, seq_len, 2 * hidden), w_ih2, w_hh2, b2)
    if x.device.type == "cpu":
        return bilstm2_center_plain(x, w_ih1, w_hh1, b1, w_ih2, w_hh2, b2)
    _contiguous(x, w_ih1, w_hh1, b1, w_ih2, w_hh2, b2)
    wpk1 = _require_packed(w_ih1, w_hh1, packed1)
    wpk2 = _require_packed(w_ih2, w_hh2, packed2)
    out = torch.empty(n, 2 * hidden, dtype=torch.float32, device=x.device)
    if n:
        plan = plan_two_layer(n, seq_len, d_in, hidden)
        xk = _kernel_x(x, plan.d_x)
        # layer 1's output, read back by layer 2 inside the same kernel
        mid = torch.empty(n, seq_len, 2 * hidden, dtype=torch.bfloat16,
                          device=x.device)
        _launch("nsp_bilstm2_center", x.device, xk.data_ptr(),
                wpk1.data_ptr(), b1.data_ptr(), wpk2.data_ptr(),
                b2.data_ptr(), mid.data_ptr(), out.data_ptr(), n, seq_len,
                plan.d_x, hidden, plan.bn, plan.smem, plan.grid[0])
        LAUNCHES["bilstm2_center"] += 1
    return out


def fused_occupancy(plan: LayerPlan, head_dims: Optional[Tuple[int, int]]
                    = None) -> int:
    """Clusters of the plan the card holds at once
    (cudaOccupancyMaxActiveClusters on the current device); `head_dims`
    (P, Q) for a center + head plan."""
    from .build import library

    p_dim, q_dim = head_dims or (0, 0)
    got = library("bilstm_fused").nsp_bilstm_fused_occupancy(
        int(head_dims is not None), plan.d_x, plan.hidden, p_dim, q_dim,
        plan.bn, plan.smem)
    if got < 0:
        raise RuntimeError(f"fused occupancy query failed: "
                           f"{_ERRORS.get(got, f'cudaError {-got}')}")
    return got


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
    steps a direction of layer 2 must run; no inter-layer bytes (the
    function needs none: the kernel's scratch is its own choice)."""
    flop1, bytes1 = layer_cost(n, seq_len, d_in, hidden, center=False)
    flop2, bytes2 = layer_cost(n, seq_len, 2 * hidden, hidden, center=True)
    between = n * seq_len * 2 * hidden * 2     # layer 1 out = layer 2 in
    return flop1 + flop2, bytes1 + bytes2 - 2 * between
