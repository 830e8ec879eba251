"""The LSTM recurrence over precomputed input projections: the inference
forward, and training's forward and backward kernels, both directions.

Counterpart of the JAX package's custom-VJP `_recurrence`
(nanosnp_tpu/ops/pallas_lstm.py:389-420), which `bilstm_layer_pallas`
reaches with or without differentiation, and of the `fused=False` branch
of `bilstm_encoder_pallas`. Four wrappers around the CUDA kernels of
`csrc/lstm_train.cu`, each with its plain PyTorch version beside it:

  lstm_recurrence_infer  (xp f32 or bf16, w_hh) -> hs, no cell-state
                         stream. Replaces `_kernel` (pallas_lstm.py:64),
                         the primal of `_recurrence`.
  lstm_recurrence_train  (xp, w_hh) -> (hs, cs). Replaces `_train_kernel`
                         (pallas_lstm.py:178).
  lstm_recurrence_bwd    (xp, w_hh, hs, cs, g) -> (dxp, dW_hh): the
                         reverse-time sweep with its dW. Replaces
                         `_bwd_kernel` (pallas_lstm.py:235).
  lstm_dw_reduce         (dxp, hs) -> dW_hh, the dW accumulation that
                         `_bwd_kernel` runs in its body (per batch tile, in
                         VMEM) and its wrapper sums over tiles: on the
                         tensor cores, each f32 operand split into bf16 hi
                         + lo, three products, over the row splits of
                         `plan_dw(n, L, H)`, added in split order.

`plan_train(n, L, H)` picks the training kernels' path:

  smem     H=64 (the pileup model): one block per (direction, 32 batch
           rows) holds the direction's w_hh in shared memory, as the model
           holds it (nothing is packed), prefetches the next step's
           inputs, and the sweep sums the block's dW as it goes; one small
           launch sums the blocks' partials in tile order.
           `lstm_dw_reduce` is not run.
  cluster  H=256 (the haplotype model), whose w_hh fits no block: a
           cluster of C=4 CTAs per (direction, 64 batch rows), CTA r
           holding the w_hh columns of its 64 units (all four gates) in
           shared memory for the whole call, nothing packed. The forward
           trades h_t through distributed shared memory; the sweep
           reduce-scatters dh_{t-1} there, each CTA adding the four
           partials in rank order (`lstm_recurrence_bwd_plain(...,
           csize=4)` is that order). dW by `lstm_dw_reduce`.
  packed   every other H: w_hh packed in fragment order on every call and
           re-read from L2 every step, dW by `lstm_dw_reduce`.

`plan_infer(n, L, H, xp_bytes)` picks the inference kernel's: `smem` at
H=64 (the smem training forward's kernel without the cell-state stream,
xp staged in its own dtype, nothing packed), `cluster` at H=256 (the
cluster training forward's kernel without the cell-state stream, nothing
packed), `packed` at every other H.

`lstm_recurrence_infer` with an f32 w_hh (the scan route in f32, which no
Pallas kernel computes: the counterpart of the JAX package's lax.scan in
`_bilstm_layer` with use_pallas False) launches the f32 kernel of
`plan_infer_f32(n, L, H)`: FFMA products of f32 h and W, nothing rounded,
one CTA per (direction, 64 batch rows), W_hh streamed from L2 through a
ring of shared-memory tiles (held once where a step's tiles fit it,
H <= 64). Its launches count under `lstm_recurrence_infer_f32`.

`lstm_recurrence(xp, w_hh)` takes the inference kernel when no gradient is
wanted and the autograd op over the training kernels otherwise.

Layout, in true time order (direction 1 walks time backwards inside the
kernels): xp and dxp [N, L, 2, 4H] f32 (x @ w_ih + b of both directions,
so one matmul of x with the directions' w_ih side by side gives it);
hs, cs and g [N, L, 2, H] f32, which reshape to the layer output
[N, L, 2H] with no copy; w_hh and dW_hh [2, H, 4H] (x @ w layout).

The dtype of w_hh is the compute dtype, as the Pallas path's
`compute_dtype`: bf16 (the kernels; training casts w_hh to bf16) rounds
h_{t-1} and, in the backward, dgates to bf16 before the products, with f32
accumulation, and returns dW_hh as its f32 sum rounded to bf16. A wider
w_hh (f32, or f64 for gradcheck) runs the plain versions without rounding,
except that `lstm_recurrence_infer` has its f32 kernel on the card.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel of its plan or raises. `LAUNCHES` (shared
with ops/bilstm.py) counts kernel launches, never plain-version calls.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .bilstm import CLUSTER, LAUNCHES, SM_COUNT, SMEM_MAX, pack_a_fragments

# csrc/lstm_train.cu: the smem path's batch tile and the H it is built for
TRAIN_BN = 32
SMEM_HIDDEN = 64
# the cluster path's H and its (C, BN), the layer recurrence's
# (csrc/lstm_train.cu kClH, kClC, kClBN)
CLUSTER_HIDDEN = 256
# 4-CTA clusters of one CTA an SM resident at once on an H100
# (cudaOccupancyMaxActiveClusters, PERF.md): a plan's clusters beyond
# these run in a second round
CLUSTERS_RESIDENT = 30
# the dW kernel (csrc/lstm_train.cu kDwTH, kDwTK, kDwRows, kDwStages): a
# CTA's dW tile (units, gate columns), rows a chunk, f32 chunks in its ring
DW_TILE = (128, 128)
DW_CHUNK = 32
DW_STAGES = 4


class TrainPlan(NamedTuple):
    """How the training kernels run one call: `path` "smem", "cluster"
    or "packed", `bn` batch rows a block (a cluster's on the cluster path;
    the packed sweep's is half the forward's), `grid` (blocks along N,
    directions), `fwd_smem` / `bwd_smem` bytes of shared memory a block,
    `dw_tiles` partial dW sums added in order (the smem sweep's batch
    tiles, or `plan_dw`'s row splits), `cluster` CTAs a cluster (1 off
    the cluster path)."""
    path: str
    bn: int
    grid: Tuple[int, int]
    fwd_smem: int
    bwd_smem: int
    dw_tiles: int
    cluster: int = 1


def smem_bytes(hidden: int, bn: int = TRAIN_BN) -> Tuple[int, int]:
    """Shared memory of the smem path's (forward, sweep) block: w_hh [H][4H
    + 8] bf16 in both; the forward's xp [2][bn][4H + 4] f32 and bf16 h
    [2][bn][H + 8]; the sweep's two buffers of xp, h_{t-1} [bn][H + 8],
    c_{t-1} and g [bn][H + 4], all f32, and dgates as bf16 hi and lo
    [2][bn][4H + 8] (csrc/lstm_train.cu infer_smem_bytes with f32 xp,
    bwd_smem_bytes)."""
    w = hidden * (4 * hidden + 8) * 2
    return (w + 2 * bn * (4 * hidden + 4) * 4 + 2 * bn * (hidden + 8) * 2,
            w + 2 * bn * ((4 * hidden + 4) + (hidden + 8)
                          + 2 * (hidden + 4)) * 4
            + 2 * bn * (4 * hidden + 8) * 2)


def cluster_smem_bytes(hidden: int = CLUSTER_HIDDEN, csize: int = CLUSTER[0],
                       bn: int = CLUSTER[1]) -> Tuple[int, int]:
    """Shared memory of the cluster path's (forward, sweep) CTA: the w_hh
    slice [H][4H/C + 8] bf16 in both; the forward's bf16 h [2][bn][H + 8]
    by step parity; the sweep's one bf16 [bn][H + 8] tile (h_{t-1}, then
    dgates) and the C-1 peers' partial dh [bn][H/C] f32 (csrc/
    lstm_train.cu fwd_cluster_bytes, bwd_cluster_bytes)."""
    w = hidden * (4 * hidden // csize + 8) * 2
    return (w + 2 * bn * (hidden + 8) * 2,
            w + bn * (hidden + 8) * 2 + (csize - 1) * bn * (hidden // csize)
            * 4)


def cluster_gate_columns(hidden: int, csize: int, rank: int) -> torch.Tensor:
    """The gate columns K_r of w_hh [H, 4H] that CTA `rank` of the cluster
    path holds: gate g's run of the CTA's H/C units, g = i, f, g, o
    (column g H + rank H/C + u at g H/C + u; the kernels keep each group
    of 16 units in another order in shared memory, csrc/lstm_train.cu)."""
    units = hidden // csize
    return torch.cat([torch.arange(g * hidden + rank * units,
                                   g * hidden + (rank + 1) * units)
                      for g in range(4)])


def plan_train(n: int, seq_len: int, hidden: int) -> TrainPlan:
    """The training kernels' plan for N rows, L steps, H units: the smem
    path at the H its kernels are built for (64, the pileup model), where
    a direction's w_hh and the sweep's buffers fit a block; the cluster
    path at 256 (the haplotype model), at the layer recurrence's (C, BN),
    whose 16 clusters at the trainer's batch of 512 run in one round
    (BN 32 would need 32, beyond the 30 resident); else the packed
    kernels. Raises ValueError for a shape no kernel takes."""
    if n < 1 or seq_len < 1 or hidden < 16 or hidden % 16 or hidden > 256:
        raise ValueError(f"no training kernel plan for N={n}, L={seq_len}, "
                         f"H={hidden}: H must be a multiple of 16 up to 256")
    fwd, bwd = smem_bytes(hidden)
    if hidden == SMEM_HIDDEN and max(fwd, bwd) <= SMEM_MAX:
        tiles = -(-n // TRAIN_BN)
        return TrainPlan("smem", TRAIN_BN, (tiles, 2), fwd, bwd, tiles)
    if hidden == CLUSTER_HIDDEN:
        csize, bn = CLUSTER
        fwd, bwd = cluster_smem_bytes(hidden, csize, bn)
        return TrainPlan("cluster", bn, (-(-n // bn) * csize, 2), fwd, bwd,
                         plan_dw(n, seq_len, hidden).splits, csize)
    # the packed kernels (csrc/lstm_train.cu kFwdNT, kBwdNT, launch_fwd)
    return TrainPlan("packed", 32, (-(-n // 32), 2), 32 * (hidden + 8) * 2,
                     16 * (5 * hidden + 16) * 2,
                     plan_dw(n, seq_len, hidden).splits)


class InferPlan(NamedTuple):
    """How the inference kernel runs one call: `path` "smem", "cluster"
    or "packed", `bn` batch rows a block (a cluster's on the cluster path),
    `grid` (blocks along N, directions), `smem` bytes of shared memory a
    block, `cluster` CTAs a cluster (1 on the packed path)."""
    path: str
    bn: int
    grid: Tuple[int, int]
    smem: int
    cluster: int = 1


def infer_smem_bytes(hidden: int, xp_bytes: int) -> int:
    """Shared memory of the smem forward's block with xp of `xp_bytes` (4
    f32, 2 bf16): w_hh [H][4H + 8] bf16, xp [2][32][4H] in its dtype with
    16 bytes of pad a row, bf16 h [2][32][H + 8] (csrc/lstm_train.cu
    infer_smem_bytes; the training forward's is the f32 one)."""
    return (hidden * (4 * hidden + 8) * 2
            + 2 * TRAIN_BN * (4 * hidden * xp_bytes + 16)
            + 2 * TRAIN_BN * (hidden + 8) * 2)


def plan_infer(n: int, seq_len: int, hidden: int,
               xp_bytes: int = 4) -> InferPlan:
    """The inference kernel's plan for xp of `xp_bytes` (4 f32, 2 bf16):
    at H=64 the smem path, the training forward's kernel and plan without
    the cell-state stream, xp staged in its own dtype (N = 8192 is 512
    blocks of 32 rows); at H=256 the cluster path, likewise (N = 8192 is
    256 clusters, nine rounds of the 30 resident); at every other H the
    packed kernel (w_hh packed on every call, 32 rows a block). Raises
    ValueError for a shape no kernel takes."""
    if n < 1 or seq_len < 1 or hidden < 16 or hidden % 16 or hidden > 256:
        raise ValueError(f"no inference kernel plan for N={n}, L={seq_len}, "
                         f"H={hidden}: H must be a multiple of 16 up to 256")
    if xp_bytes not in (2, 4):
        raise ValueError(f"xp is f32 or bf16 (4 or 2 bytes), got {xp_bytes}")
    if hidden == SMEM_HIDDEN:
        return InferPlan("smem", TRAIN_BN, (-(-n // TRAIN_BN), 2),
                         infer_smem_bytes(hidden, xp_bytes))
    if hidden == CLUSTER_HIDDEN:
        csize, bn = CLUSTER
        return InferPlan("cluster", bn, (-(-n // bn) * csize, 2),
                         cluster_smem_bytes(hidden, csize, bn)[0], csize)
    # csrc/lstm_train.cu launch_fwd: kFwdNT n-tiles of 8 rows a block
    return InferPlan("packed", 32, (-(-n // 32), 2), 32 * (hidden + 8) * 2)


# csrc/lstm_train.cu kF32BN, kF32KT, kF32Units, kF32Stages: the f32
# kernel's batch rows a CTA, and its W tiles (k rows x the four gates of 64
# units, f32) and their ring
F32_BN = 64
F32_TILE = (16, 4 * 64)
F32_STAGES = 4


def f32_smem_bytes(hidden: int) -> int:
    """Shared memory of the f32 kernel's CTA: h_{t-1} [2][H][64] f32 by step
    parity and the ring of F32_STAGES W tiles of 16 x 256 f32
    (csrc/lstm_train.cu f32_smem_bytes)."""
    return (2 * hidden * F32_BN + F32_STAGES * F32_TILE[0] * F32_TILE[1]) * 4


def plan_infer_f32(n: int, seq_len: int, hidden: int) -> InferPlan:
    """The f32 inference kernel's plan, path "f32": one CTA per (direction,
    64 batch rows) at every H that the bf16 kernels take (a multiple of 16
    up to 256; N = 8192 is 256 CTAs). Raises ValueError for a shape no
    kernel takes."""
    if n < 1 or seq_len < 1 or hidden < 16 or hidden % 16 or hidden > 256:
        raise ValueError(f"no f32 inference kernel plan for N={n}, "
                         f"L={seq_len}, H={hidden}: H must be a multiple "
                         "of 16 up to 256")
    return InferPlan("f32", F32_BN, (-(-n // F32_BN), 2),
                     f32_smem_bytes(hidden))


class DwPlan(NamedTuple):
    """How `lstm_dw_reduce` runs one call: `rows` of the M = N (L-1) rows
    a split (a multiple of DW_CHUNK; split s sums rows [s rows, (s+1) rows)
    of each direction), `splits` partials added in split order (0 where M
    is 0: nothing to launch), `grid` (DW_TILE tiles of dW, splits,
    directions), `smem` bytes of shared memory a CTA."""
    rows: int
    splits: int
    grid: Tuple[int, int, int]
    smem: int


def dw_smem_bytes() -> int:
    """Shared memory of the dW CTA: DW_STAGES f32 chunks of its A and B
    columns, two buffers of its bf16 hi and lo tiles (A [DW_CHUNK][th + 8],
    B as 8x8 core matrices, each column group's padded by 16 bytes)
    (csrc/lstm_train.cu dw_smem_bytes)."""
    th, tk = DW_TILE
    a_tile = DW_CHUNK * (th + 8) * 2
    b_tile = tk // 8 * (DW_CHUNK // 8 * 128 + 16)
    return DW_STAGES * DW_CHUNK * (th + tk) * 4 + 2 * 2 * (a_tile + b_tile)


def plan_dw(n: int, seq_len: int, hidden: int) -> DwPlan:
    """`lstm_dw_reduce`'s plan for N rows, L steps, H units: one CTA per
    (dW tile, row split, direction), one an SM, with as many splits as
    keep the CTAs within one wave of the card's SMs (4 at H=256: 128 CTAs),
    each split a whole number of chunks and none empty. Raises ValueError
    for a shape no kernel takes."""
    if n < 1 or seq_len < 1 or hidden < 16 or hidden % 16 or hidden > 256:
        raise ValueError(f"no dW kernel plan for N={n}, L={seq_len}, "
                         f"H={hidden}: H must be a multiple of 16 up to 256")
    th, tk = DW_TILE
    tiles = -(-hidden // th) * -(-4 * hidden // tk)
    total = n * (seq_len - 1)
    if total == 0:
        return DwPlan(0, 0, (tiles, 0, 2), dw_smem_bytes())
    chunks = -(-total // DW_CHUNK)
    per = -(-chunks // min(max(1, SM_COUNT // (2 * tiles)), chunks))
    rows = per * DW_CHUNK
    splits = -(-total // rows)
    return DwPlan(rows, splits, (tiles, splits, 2), dw_smem_bytes())


def _check(xp, w_hh, *states) -> None:
    if xp.dim() != 4 or xp.shape[2] != 2 or w_hh.dim() != 3:
        raise ValueError("expected xp [N, L, 2, 4H] and w_hh [2, H, 4H], got "
                         f"{tuple(xp.shape)} and {tuple(w_hh.shape)}")
    n, seq_len, _, four_h = xp.shape
    hidden = w_hh.shape[1]
    if tuple(w_hh.shape) != (2, hidden, 4 * hidden) or four_h != 4 * hidden:
        raise ValueError(f"shape mismatch: xp {tuple(xp.shape)}, w_hh "
                         f"{tuple(w_hh.shape)}")
    for s in states:
        if tuple(s.shape) != (n, seq_len, 2, hidden):
            raise ValueError(f"expected [N, L, 2, H] = {(n, seq_len, 2, hidden)}"
                             f", got {tuple(s.shape)}")
    devs = {t.device for t in (xp, w_hh, *states)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    if xp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xp.device}")


def _check_kernel_inputs(hidden: int, f32, bf16=()) -> None:
    if any(t.dtype != torch.float32 for t in f32) or any(
            t.dtype != torch.bfloat16 for t in bf16):
        raise TypeError("the CUDA kernels take bf16 w_hh and f32 xp, hs, cs, "
                        f"g, dxp; got {[t.dtype for t in (*f32, *bf16)]}")
    if hidden % 16 or hidden > 256:
        raise ValueError(f"the CUDA kernels take H a multiple of 16 up to 256"
                         f", got {hidden}")
    for t in (*f32, *bf16):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel inputs must be contiguous and 16-byte "
                             "aligned")


def _round(h, w_dtype):
    """h_{t-1} (or dgates) as the product's operand: rounded to bf16 when
    the compute dtype is bf16, else unchanged."""
    return h.bfloat16().to(h.dtype) if w_dtype == torch.bfloat16 else h


def _order(seq_len: int, d: int):
    """True time index of each step of direction d."""
    return list(range(seq_len)) if d == 0 else list(range(seq_len - 1, -1, -1))


def lstm_recurrence_train_plain(xp, w_hh):
    """Step loop of `_train_kernel`. Differentiable by autograd (the f32
    reference path trains through it). -> hs, cs [N, L, 2, H]."""
    n, seq_len, _, four_h = xp.shape
    hidden = four_h // 4
    hs, cs = [], []
    for d in (0, 1):
        w = w_hh[d].to(xp.dtype)                  # bf16 values are exact
        h = xp.new_zeros(n, hidden)
        c = xp.new_zeros(n, hidden)
        h_at, c_at = [None] * seq_len, [None] * seq_len
        for t in _order(seq_len, d):
            gates = xp[:, t, d] + _round(h, w_hh.dtype) @ w
            i, f, g, o = gates.split(hidden, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            h_at[t], c_at[t] = h, c
        hs.append(torch.stack(h_at, dim=1))
        cs.append(torch.stack(c_at, dim=1))
    return torch.stack(hs, dim=2), torch.stack(cs, dim=2)


def lstm_recurrence_infer_plain(xp, w_hh):
    """Step loop of `_kernel`: bf16 xp is widened on load, no cell-state
    stream. -> hs [N, L, 2, H] (f32 for f32 or bf16 xp)."""
    if xp.dtype == torch.bfloat16:
        xp = xp.float()
    return lstm_recurrence_train_plain(xp, w_hh)[0]


def lstm_recurrence_bwd_plain(xp, w_hh, hs, cs, g, with_dw: bool = True,
                              csize: int = 1):
    """Step loop of `_bwd_kernel`, line by line, dW included (summed in
    xp's dtype, then cast to w_hh's dtype as `_recurrence_bwd` does).
    csize > 1 forms dh_{t-1} in the cluster sweep's order: the partials
    of each CTA's gate columns (`cluster_gate_columns`) added in rank
    order (tests only). -> (dxp [N, L, 2, 4H], dW_hh [2, H, 4H] or
    None)."""
    n, seq_len, _, four_h = xp.shape
    hidden = four_h // 4
    dxp = torch.empty_like(xp)
    dw = xp.new_zeros(2, hidden, four_h)
    for d in (0, 1):
        w = w_hh[d].to(xp.dtype)
        cols = [cluster_gate_columns(hidden, csize, r) for r in range(csize)
                ] if csize > 1 else [slice(None)]
        order = _order(seq_len, d)
        dh = xp.new_zeros(n, hidden)
        dc = xp.new_zeros(n, hidden)
        for s in range(seq_len - 1, -1, -1):
            t = order[s]
            if s > 0:
                h_prev, c_prev = hs[:, order[s - 1], d], cs[:, order[s - 1], d]
            else:
                h_prev, c_prev = dh.new_zeros(n, hidden), dh.new_zeros(n,
                                                                        hidden)
            c_t = cs[:, t, d]
            gates = xp[:, t, d] + _round(h_prev, w_hh.dtype) @ w
            ig, fg, gg, og = gates.split(hidden, dim=1)
            ig, fg, og = torch.sigmoid(ig), torch.sigmoid(fg), torch.sigmoid(og)
            gg = torch.tanh(gg)
            tanh_ct = torch.tanh(c_t)
            dh = g[:, t, d] + dh
            do_pre = dh * tanh_ct * og * (1.0 - og)
            dc = dh * og * (1.0 - tanh_ct * tanh_ct) + dc
            di_pre = dc * gg * ig * (1.0 - ig)
            df_pre = dc * c_prev * fg * (1.0 - fg)
            dg_pre = dc * ig * (1.0 - gg * gg)
            dgates = torch.cat([di_pre, df_pre, dg_pre, do_pre], dim=1)
            if with_dw:
                dw[d] += h_prev.T @ dgates
            dg = _round(dgates, w_hh.dtype)
            dh = sum(dg[:, k] @ w[:, k].T for k in cols)   # in rank order
            dc = dc * fg
            dxp[:, t, d] = dgates
    return dxp, dw.to(w_hh.dtype) if with_dw else None


def lstm_dw_reduce_plain(dxp, hs):
    """dW[d] = sum over (n, t) of h_{t-1}[d]^T dxp[t, d], where h_{t-1} is
    the state of direction d's previous step (none at its first step),
    rounded to bf16."""
    hidden = hs.shape[-1]
    a = [hs[:, :-1, 0], hs[:, 1:, 1]]             # h_{t-1} of each step
    b = [dxp[:, 1:, 0], dxp[:, :-1, 1]]
    return torch.stack([
        a[d].reshape(-1, hidden).T @ b[d].reshape(-1, 4 * hidden)
        for d in (0, 1)]).bfloat16()


def lstm_dw_tiles_plain(dxp, hs, bn: int = TRAIN_BN):
    """The smem sweep's dW partials: for each tile of `bn` batch rows, the
    f32 sum over its rows and steps of h_{t-1}^T dgates, as
    `lstm_dw_reduce_plain` sums them over all rows -> [tiles, 2, H, 4H]
    (the JAX package's `dw_tiles`, [G, 2, 4H, H], in x @ w layout).
    `sum_dw_tiles` gives the sweep's dW_hh."""
    hidden = hs.shape[-1]
    a = [hs[:, :-1, 0], hs[:, 1:, 1]]             # h_{t-1} of each step
    b = [dxp[:, 1:, 0], dxp[:, :-1, 1]]
    return torch.stack([torch.stack([
        a[d][r0:r0 + bn].reshape(-1, hidden).T
        @ b[d][r0:r0 + bn].reshape(-1, 4 * hidden) for d in (0, 1)])
        for r0 in range(0, hs.shape[0], bn)])


def sum_dw_tiles(tiles):
    """dW_hh: the partials summed in tile order, rounded to bf16 once."""
    total = tiles[0].clone()
    for tile in tiles[1:]:
        total += tile
    return total.bfloat16()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


_REFUSED = {-1: "the launcher refused the plan",
            -2: "no cluster of the plan fits the card"}


def _raise_on(err, name, n, seq_len, hidden):
    if err:
        why = _REFUSED.get(err, f"cudaError {err}")
        raise RuntimeError(f"{name} launch failed: {why} "
                           f"(N={n}, L={seq_len}, H={hidden})")


def lstm_recurrence_infer(xp, w_hh):
    """xp [N, L, 2, 4H] f32 or bf16, w_hh [2, H, 4H] -> hs [N, L, 2, H]
    f32. No gradient flows through it. bf16 w_hh: the kernel of
    `plan_infer`; f32 w_hh (xp f32): the f32 kernel."""
    _check(xp, w_hh)
    if xp.device.type == "cpu":
        with torch.no_grad():
            return lstm_recurrence_infer_plain(xp, w_hh)
    if w_hh.dtype == torch.float32:
        return _infer_f32(xp, w_hh)
    from .build import library

    n, seq_len, _, four_h = xp.shape
    hidden = four_h // 4
    xp_bf16 = xp.dtype == torch.bfloat16
    _check_kernel_inputs(hidden, () if xp_bf16 else (xp,),
                         (xp, w_hh) if xp_bf16 else (w_hh,))
    hs = torch.empty(n, seq_len, 2, hidden, dtype=torch.float32,
                     device=xp.device)
    if n and seq_len:
        plan = plan_infer(n, seq_len, hidden, xp.element_size())
        lib = library("lstm_train")
        with torch.cuda.device(xp.device):
            if plan.path == "smem":
                err = lib.nsp_lstm_infer_smem(
                    xp.data_ptr(), int(xp_bf16), w_hh.data_ptr(),
                    hs.data_ptr(), n, seq_len, hidden, plan.bn, plan.smem,
                    plan.grid[0], _stream(xp))
            elif plan.path == "cluster":
                err = lib.nsp_lstm_infer_cluster(
                    xp.data_ptr(), int(xp_bf16), w_hh.data_ptr(),
                    hs.data_ptr(), n, seq_len, hidden, plan.cluster, plan.bn,
                    plan.smem, plan.grid[0], _stream(xp))
            else:
                wpk = pack_a_fragments(w_hh.detach().transpose(1, 2))
                err = lib.nsp_lstm_infer(
                    xp.data_ptr(), int(xp_bf16), wpk.data_ptr(),
                    hs.data_ptr(), n, seq_len, hidden, _stream(xp))
        _raise_on(err, "lstm_recurrence_infer", n, seq_len, hidden)
        LAUNCHES["lstm_recurrence_infer"] += 1
    return hs


def _infer_f32(xp, w_hh):
    """The f32 kernel of `plan_infer_f32` on CUDA tensors: xp and w_hh f32,
    nothing rounded."""
    from .build import library

    n, seq_len, _, four_h = xp.shape
    hidden = four_h // 4
    _check_kernel_inputs(hidden, ())
    if xp.dtype != torch.float32 or not all(
            t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (xp, w_hh)):
        raise TypeError("the f32 inference kernel takes f32 xp and w_hh, "
                        "contiguous and 16-byte aligned; got "
                        f"{xp.dtype} and {w_hh.dtype}")
    hs = torch.empty(n, seq_len, 2, hidden, dtype=torch.float32,
                     device=xp.device)
    if n and seq_len:
        plan = plan_infer_f32(n, seq_len, hidden)
        with torch.cuda.device(xp.device):
            err = library("lstm_train").nsp_lstm_infer_f32(
                xp.data_ptr(), w_hh.data_ptr(), hs.data_ptr(), n, seq_len,
                hidden, plan.bn, plan.smem, plan.grid[0], _stream(xp))
        _raise_on(err, "lstm_recurrence_infer (f32)", n, seq_len, hidden)
        LAUNCHES["lstm_recurrence_infer_f32"] += 1
    return hs


def lstm_recurrence_train(xp, w_hh):
    """xp [N, L, 2, 4H], w_hh [2, H, 4H] -> (hs, cs), both [N, L, 2, H]."""
    _check(xp, w_hh)
    if xp.device.type == "cpu":
        return lstm_recurrence_train_plain(xp, w_hh)
    from .build import library

    n, seq_len, _, four_h = xp.shape
    hidden = four_h // 4
    _check_kernel_inputs(hidden, (xp,), (w_hh,))
    hs = torch.empty(n, seq_len, 2, hidden, dtype=torch.float32,
                     device=xp.device)
    cs = torch.empty_like(hs)
    if n and seq_len:
        plan = plan_train(n, seq_len, hidden)
        lib = library("lstm_train")
        with torch.cuda.device(xp.device):
            if plan.path == "smem":
                err = lib.nsp_lstm_fwd_smem(
                    xp.data_ptr(), w_hh.data_ptr(), hs.data_ptr(),
                    cs.data_ptr(), n, seq_len, hidden, plan.bn,
                    plan.fwd_smem, plan.grid[0], _stream(xp))
            elif plan.path == "cluster":
                err = lib.nsp_lstm_fwd_cluster(
                    xp.data_ptr(), w_hh.data_ptr(), hs.data_ptr(),
                    cs.data_ptr(), n, seq_len, hidden, plan.cluster, plan.bn,
                    plan.fwd_smem, plan.grid[0], _stream(xp))
            else:
                wpk = pack_a_fragments(w_hh.transpose(1, 2))  # w_hh^T
                err = lib.nsp_lstm_fwd(
                    xp.data_ptr(), wpk.data_ptr(), hs.data_ptr(),
                    cs.data_ptr(), n, seq_len, hidden, _stream(xp))
        _raise_on(err, "lstm_recurrence_train", n, seq_len, hidden)
        LAUNCHES["lstm_recurrence_train"] += 1
    return hs, cs


def lstm_recurrence_bwd(xp, w_hh, hs, cs, g, with_dw: bool = True):
    """-> (dxp [N, L, 2, 4H] f32, dW_hh [2, H, 4H] in w_hh's dtype, or None
    without with_dw). On the smem path dW is summed inside the sweep."""
    _check(xp, w_hh, hs, cs, g)
    if xp.device.type == "cpu":
        return lstm_recurrence_bwd_plain(xp, w_hh, hs, cs, g, with_dw)
    from .build import library

    n, seq_len, _, four_h = xp.shape
    hidden = four_h // 4
    _check_kernel_inputs(hidden, (xp, hs, cs, g), (w_hh,))
    dxp = torch.empty_like(xp)
    if not (n and seq_len):
        return dxp, (torch.zeros_like(w_hh) if with_dw else None)
    plan = plan_train(n, seq_len, hidden)
    lib = library("lstm_train")
    dw = None
    with torch.cuda.device(xp.device):
        if plan.path == "smem":
            part = torch.empty((plan.dw_tiles, 2, hidden, four_h)
                               if with_dw else (0,), dtype=torch.float32,
                               device=xp.device)
            dw = torch.empty(2, hidden, four_h, dtype=torch.bfloat16,
                             device=xp.device) if with_dw else None
            err = lib.nsp_lstm_bwd_smem(
                xp.data_ptr(), w_hh.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                g.data_ptr(), dxp.data_ptr(), part.data_ptr(),
                dw.data_ptr() if with_dw else 0, int(with_dw), n, seq_len,
                hidden, plan.bn, plan.bwd_smem, plan.grid[0], _stream(xp))
        elif plan.path == "cluster":
            err = lib.nsp_lstm_bwd_cluster(
                xp.data_ptr(), w_hh.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                g.data_ptr(), dxp.data_ptr(), n, seq_len, hidden,
                plan.cluster, plan.bn, plan.bwd_smem, plan.grid[0],
                _stream(xp))
        else:
            wpk_t = pack_a_fragments(w_hh.transpose(1, 2))   # [2, 4H, H]
            wpk_h = pack_a_fragments(w_hh)                   # [2, H, 4H]
            err = lib.nsp_lstm_bwd(
                xp.data_ptr(), wpk_t.data_ptr(), wpk_h.data_ptr(),
                hs.data_ptr(), cs.data_ptr(), g.data_ptr(), dxp.data_ptr(),
                n, seq_len, hidden, _stream(xp))
    _raise_on(err, "lstm_recurrence_bwd", n, seq_len, hidden)
    LAUNCHES["lstm_recurrence_bwd"] += 1
    if with_dw and plan.path != "smem":
        dw = lstm_dw_reduce(dxp, hs)
    return dxp, dw


def infer_smem_occupancy(xp_bytes: int) -> int:
    """Blocks of the smem inference forward (xp of `xp_bytes`) an SM holds
    at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current
    device)."""
    from .build import library

    got = library("lstm_train").nsp_lstm_infer_smem_occupancy(
        int(xp_bytes == 2), infer_smem_bytes(SMEM_HIDDEN, xp_bytes))
    if got < 0:
        raise RuntimeError(f"occupancy query failed: {got}")
    return got


def infer_f32_occupancy(hidden: int) -> int:
    """CTAs of the f32 inference kernel at width `hidden` an SM holds at
    once (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current
    device)."""
    from .build import library

    got = library("lstm_train").nsp_lstm_infer_f32_occupancy(
        hidden, f32_smem_bytes(hidden))
    if got < 0:
        raise RuntimeError(f"occupancy query failed: {got}")
    return got


def cluster_occupancy(sweep: bool) -> int:
    """Clusters of the cluster path's forward (or sweep) the card holds at
    once (cudaOccupancyMaxActiveClusters on the current device)."""
    from .build import library

    got = library("lstm_train").nsp_lstm_cluster_occupancy(
        int(sweep), cluster_smem_bytes()[int(sweep)])
    if got < 0:
        raise RuntimeError(f"cluster occupancy query failed: {got}")
    return got


def lstm_dw_reduce(dxp, hs):
    """dxp [N, L, 2, 4H] f32, hs [N, L, 2, H] f32 -> dW_hh [2, H, 4H] bf16:
    the f32 sum over `plan_dw`'s row splits, added in split order, rounded
    to bf16 once."""
    if dxp.dim() != 4 or hs.dim() != 4 or tuple(dxp.shape[:3]) != tuple(
            hs.shape[:3]) or dxp.shape[3] != 4 * hs.shape[3]:
        raise ValueError(f"expected dxp [N, L, 2, 4H] and hs [N, L, 2, H], "
                         f"got {tuple(dxp.shape)} and {tuple(hs.shape)}")
    if dxp.device != hs.device:
        raise ValueError(f"tensors on different devices: {dxp.device}, "
                         f"{hs.device}")
    if dxp.device.type == "cpu":
        return lstm_dw_reduce_plain(dxp, hs)
    from .build import library

    n, seq_len, _, hidden = hs.shape
    _check_kernel_inputs(hidden, (dxp, hs))
    if not n or seq_len < 2:
        return torch.zeros(2, hidden, 4 * hidden, dtype=torch.bfloat16,
                           device=dxp.device)
    plan = plan_dw(n, seq_len, hidden)
    dw = torch.empty(2, hidden, 4 * hidden, dtype=torch.bfloat16,
                     device=dxp.device)
    part = torch.empty(plan.splits, 2, hidden, 4 * hidden,
                       dtype=torch.float32, device=dxp.device)
    with torch.cuda.device(dxp.device):
        err = library("lstm_train").nsp_lstm_dw(
            dxp.data_ptr(), hs.data_ptr(), part.data_ptr(), dw.data_ptr(), n,
            seq_len, hidden, plan.rows, plan.splits, plan.smem, plan.grid[0],
            _stream(dxp))
    _raise_on(err, "lstm_dw_reduce", n, seq_len, hidden)
    LAUNCHES["lstm_dw_reduce"] += 1
    return dw


class _Recurrence(torch.autograd.Function):
    """Autograd op: forward `lstm_recurrence_train`, backward
    `lstm_recurrence_bwd` (the custom VJP of the JAX package's
    `_recurrence`)."""

    @staticmethod
    def forward(ctx, xp, w_hh):
        hs, cs = lstm_recurrence_train(xp, w_hh)
        ctx.save_for_backward(xp, w_hh, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, g):
        xp, w_hh, hs, cs = ctx.saved_tensors
        dxp, dw = lstm_recurrence_bwd(xp, w_hh, hs, cs,
                                      g.to(xp.dtype).contiguous())
        return dxp, dw


def lstm_recurrence(xp, w_hh):
    """The recurrence: xp [N, L, 2, 4H], w_hh [2, H, 4H] (its dtype the
    compute dtype) -> hs [N, L, 2, H]. Where no gradient is wanted
    (gradients off, or neither input requires one) it is the inference
    kernel, as the primal of the JAX package's `_recurrence`; otherwise
    the autograd op over the training kernels."""
    if not torch.is_grad_enabled() or not (xp.requires_grad
                                           or w_hh.requires_grad):
        return lstm_recurrence_infer(xp, w_hh)
    return _Recurrence.apply(xp, w_hh)


# (FLOP, bytes) each call must do and move: each input read once, each
# output written once. Products in bf16 on the tensor cores; dW's f32
# product as the three bf16 products of its split operands.
def infer_cost(n: int, seq_len: int, hidden: int, xp_bytes: int = 4):
    flop = 2 * (2 * n * seq_len) * 4 * hidden * hidden
    return flop, (n * seq_len * 2 * 4 * hidden * xp_bytes
                  + 2 * hidden * 4 * hidden * 2
                  + n * seq_len * 2 * hidden * 4)


def infer_f32_cost(n: int, seq_len: int, hidden: int):
    """The f32 kernel's FMA products (counted as 2 FLOP each, on the CUDA
    cores) and its f32 xp in, w_hh in, hs out."""
    flop = 2 * (2 * n * seq_len) * 4 * hidden * hidden
    return flop, (n * seq_len * 2 * 4 * hidden * 4 + 2 * hidden * 4 * hidden
                  * 4 + n * seq_len * 2 * hidden * 4)


def train_cost(n: int, seq_len: int, hidden: int):
    flop = 2 * (2 * n * seq_len) * 4 * hidden * hidden
    state = n * seq_len * 2 * hidden * 4
    return flop, 4 * state + 2 * hidden * 4 * hidden * 2 + 2 * state


def bwd_cost(n: int, seq_len: int, hidden: int):
    """The sweep alone (dW is `dw_cost`): two products per step."""
    flop = 2 * 2 * (2 * n * seq_len) * 4 * hidden * hidden
    state = n * seq_len * 2 * hidden * 4
    return flop, 4 * state + 3 * state + 2 * hidden * 4 * hidden * 2 \
        + 4 * state


def dw_cost(n: int, seq_len: int, hidden: int):
    """Three bf16 products (hi hi, hi lo, lo hi) of both directions' rows;
    both f32 operands read once, dW written once."""
    rows = 2 * n * max(seq_len - 1, 0)
    return (3 * 2 * rows * hidden * 4 * hidden,
            rows * 5 * hidden * 4 + 2 * hidden * 4 * hidden * 2)
