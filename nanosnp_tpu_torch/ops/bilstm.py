"""BiLSTM layer kernels.

Two public wrappers around the CUDA kernels of `csrc/bilstm.cu`, each with
its plain PyTorch version beside it:

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

`plan_layer` picks, per shape, one of two paths and its launch plan:

  fused    one kernel (`nsp_bilstm_stream` / `nsp_bilstm_center`, counted
           under the wrapper's own name): the in-projection fused into the
           recurrence, the direction's packed weights in shared memory.
           Where they fit: the pileup model's H=64 layers.
  cluster  two kernels: `bilstm_inproj`, xp = x . w_ih + b for every step
           as one tensor-core GEMM, then `bilstm_cluster`, the recurrence on
           a thread-block cluster whose CTAs each hold a slice of w_hh in
           shared memory and trade h through distributed shared memory.
           For H=256, whose weights fit no single SM.

Shared contract (the Pallas kernels' cast sites): x [N, L, D] bf16,
w_ih [2, D, 4H] bf16, w_hh [2, H, 4H] bf16, b [2, 4H] f32 (b_ih + b_hh);
gate order i, f, g, o; bf16 operands with f32 accumulation; h_{t-1} is
rounded to bf16 before the recurrent product; gate and cell math in f32;
h and c start at zero; direction 1 walks time backwards and its outputs
stand at their true time index.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernels or raises. `LAUNCHES` counts kernel
launches (never plain-version calls), so a run can show that its path
went through the kernels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

# every CUDA kernel of the port (those of lstm_train.py, bilstm_fused.py
# and probe.py counted here too)
LAUNCHES: Dict[str, int] = {"bilstm_stream": 0, "bilstm_center": 0,
                            "bilstm_inproj": 0, "bilstm_cluster": 0,
                            "lstm_recurrence_train": 0,
                            "lstm_recurrence_bwd": 0, "lstm_dw_reduce": 0,
                            "lstm_recurrence_infer": 0,
                            "lstm_recurrence_infer_f32": 0,
                            "bilstm_center_head": 0, "bilstm2_center": 0,
                            "bilstm_probe": 0}

# H100 SXM (NVIDIA data sheet, the hopper-kernels guide): what a plan must
# fit and what its wave count is reckoned against
SMEM_MAX = 232_448        # dynamic shared memory a block may use
SMEM_SM = 233_472         # shared memory of an SM, 1 KiB reserved a block
REGS_SM = 65_536
SM_COUNT = 132
REGS_FUSED = 128          # registers a thread of the fused kernel (ptxas)
# the in-projection GEMM's tiles (csrc/bilstm.cu kGemm*)
GEMM_M, GEMM_N, GEMM_K, GEMM_STAGES = 256, 128, 64, 4
GEMM_SMEM = GEMM_STAGES * (GEMM_M + GEMM_N) * GEMM_K * 2
# (C, BN) of the cluster path: C=8 / BN=128 was slower at every H=256 shape
# of the main path on an H100 (PERF.md)
CLUSTER = (4, 64)


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


def _plain_recurrence(n, seq_len, w_hh, steps_of, gates_of, on_step,
                      device) -> None:
    """Step loop with the kernels' cast sites. `gates_of(d, t, hh)` gives
    the gate pre-activations from hh = bf16(h_{t-1}) . w_hh[d] (products of
    bf16 values summed in f32); `on_step(d, t, h)` receives each fresh f32
    hidden state at true time index t."""
    hidden = w_hh.shape[1]
    for d in (0, 1):
        wh = w_hh[d].float()
        h = torch.zeros(n, hidden, dtype=torch.float32, device=device)
        c = torch.zeros_like(h)
        for s in range(steps_of(d)):
            t = s if d == 0 else seq_len - 1 - s
            gates = gates_of(d, t, h.bfloat16().float() @ wh)
            i, f, g, o = gates.split(hidden, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            on_step(d, t, h)


def _plain_layer(x, w_ih, w_hh, b, steps_of, on_step) -> None:
    """The fused layer's reference: xp + hh + b at every step."""
    n, seq_len, _ = x.shape
    # bf16 operands, f32 accumulation: products of bf16 values in f32
    xp = [x.float() @ w_ih[d].float() for d in (0, 1)]   # [N, L, 4H]
    _plain_recurrence(n, seq_len, w_hh, steps_of,
                      lambda d, t, hh: xp[d][:, t] + hh + b[d], on_step,
                      x.device)


def _stream_sink(n, seq_len, hidden, out_dtype, device):
    out = torch.empty(n, seq_len, 2, hidden, dtype=out_dtype, device=device)

    def on_step(d, t, h):
        out[:, t, d] = h.to(out_dtype)

    return out, on_step


def _center_sink(n, seq_len, hidden, device):
    center = seq_len // 2
    out = torch.empty(n, 2, hidden, dtype=torch.float32, device=device)

    def on_step(d, t, h):
        if t == center:
            out[:, d] = h

    return out, on_step


def _steps_of(seq_len: int, center: bool) -> Callable[[int], int]:
    c = seq_len // 2
    if center:
        return lambda d: c + 1 if d == 0 else seq_len - c
    return lambda d: seq_len


def bilstm_stream_plain(x, w_ih, w_hh, b,
                        out_dtype: torch.dtype = torch.bfloat16):
    n, seq_len, _ = x.shape
    hidden = w_hh.shape[1]
    out, on_step = _stream_sink(n, seq_len, hidden, out_dtype, x.device)
    _plain_layer(x, w_ih, w_hh, b, _steps_of(seq_len, False), on_step)
    return out.reshape(n, seq_len, 2 * hidden)


def bilstm_center_plain(x, w_ih, w_hh, b):
    n, seq_len, _ = x.shape
    hidden = w_hh.shape[1]
    out, on_step = _center_sink(n, seq_len, hidden, x.device)
    _plain_layer(x, w_ih, w_hh, b, _steps_of(seq_len, True), on_step)
    return out.reshape(n, 2 * hidden)


def pack_weights(w_ih, w_hh) -> torch.Tensor:
    """[w_ih | w_hh] of each direction as the kernels' A operand: the
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


# --------------------------------------------------------------------------
# launch plan

@dataclass(frozen=True)
class LayerPlan:
    """How one kernel call runs on the card. Every field is an int (or a
    tuple of ints) that the C launchers take and check. `kp_tiles`: the
    k-tiles of packed weights a block multiplies by (a CTA's slice of them
    on the cluster path).

    fused:   one block of `threads` per (tile of `bn` rows, direction),
             grid (ceil(N/bn), 2), `smem` bytes; x read `d_x` wide.
    two_layer, center_head: the opt-in kernels of ops/bilstm_fused.py,
             clusters of two CTAs, CTA d running direction d, grid
             (2 ceil(N/bn), 1); `kp_tiles` counts all the packed weights a
             CTA copies (both layers' for two_layer).
    cluster: the in-projection over `inproj_grid` blocks of 512 threads
             (`inproj_smem` bytes) into xp [2, steps_t, n_pad/8, 4H/16, 32,
             4] f32, direction 1's time index t - t1_lo, direction 0 running
             t < t0_count; then the recurrence, clusters of `cluster` CTAs
             of `threads`, grid (ceil(N/bn) * cluster, 2), `smem` bytes a
             CTA, CTA r owning hidden units [r H/cluster, (r+1) H/cluster);
             its w_hh slice is packed k-tiles [w_kt0, kp_tiles) of its
             units' rows (`cluster_weight_tiles`)."""
    path: str
    n: int
    seq_len: int
    d_in: int
    hidden: int
    center: bool
    d_x: int
    bn: int
    cluster: int
    threads: int
    smem: int
    grid: Tuple[int, int]
    kp_tiles: int
    n_pad: int = 0
    steps_t: int = 0
    t0_count: int = 0
    t1_lo: int = 0
    inproj_smem: int = 0
    inproj_grid: Tuple[int, int, int] = (0, 0, 0)

    @property
    def units(self) -> int:
        return self.hidden // self.cluster

    @property
    def w_kt0(self) -> int:
        return self.kp_tiles - self.hidden // 16

    @property
    def inproj_tiles(self) -> int:
        """Blocks of the in-projection that compute (128 batch rows, 256
        gate rows, a step a direction runs); the others of its grid, steps
        a center layer's direction skips, return at once."""
        return (self.n_pad // GEMM_N * -(-4 * self.hidden // GEMM_M)
                * (self.t0_count + self.seq_len - self.t1_lo))

    @property
    def xp_shape(self) -> Tuple[int, ...]:
        return (2, self.steps_t, self.n_pad // 8, 4 * self.hidden // 16, 32,
                4)


def _pad16(d: int) -> int:
    return -(-d // 16) * 16


def fused_smem(d_x: int, hidden: int, bn: int) -> int:
    d_pad = _pad16(d_x)
    return (4 * hidden * (d_pad + hidden) * 2 + 2 * bn * (d_pad + 8) * 2
            + 2 * bn * (hidden + 8) * 2)


def cluster_smem(hidden: int, csize: int, bn: int) -> int:
    return 4 * (hidden // csize) * hidden * 2 + 2 * bn * (hidden + 8) * 2


def fewest_waves(n: int, hidden: int, tiles: Tuple[int, ...],
                 smem_of: Callable[[int], int]
                 ) -> Optional[Tuple[int, int, int]]:
    """(bn, threads, smem) of the batch tile among `tiles` whose blocks,
    two a tile (one a direction), take the fewest waves of the card, then
    the smallest tile; None where no tile fits a block: (H/16) (bn/32)
    warps, at most 16, and `smem_of(bn)` bytes of shared memory. Plans the
    fused layers and both kernels of ops/bilstm_fused.py."""
    best = None
    for bn in tiles:
        warps = hidden // 16 * (bn // 32)
        smem = smem_of(bn)
        if warps > 16 or smem > SMEM_MAX:
            continue
        threads = 32 * warps
        per_sm = min(SMEM_SM // (smem + 1024),
                     REGS_SM // (threads * REGS_FUSED), 64 // warps)
        waves = -(-2 * -(-n // bn) // (SM_COUNT * per_sm))
        if best is None or waves < best[0]:
            best = (waves, bn, threads, smem)
    return None if best is None else best[1:]


def _fused_plan(n, seq_len, d_in, hidden, center) -> Optional[LayerPlan]:
    """The fused plan of `fewest_waves`, or None where the weights and
    tiles fit no block."""
    d_x = d_in + d_in % 2
    tile = fewest_waves(n, hidden, (32, 64, 128),
                        lambda bn: fused_smem(d_x, hidden, bn))
    if tile is None:
        return None
    bn, threads, smem = tile
    return LayerPlan("fused", n, seq_len, d_in, hidden, center, d_x, bn, 1,
                     threads, smem, (-(-n // bn), 2),
                     (_pad16(d_x) + hidden) // 16)


def plan_layer(n: int, seq_len: int, d_in: int, hidden: int,
               center: bool) -> LayerPlan:
    """The launch plan of one layer call: the fused path where it fits,
    else the cluster path at (C, BN) = CLUSTER. Raises ValueError for a
    shape neither path takes."""
    if n < 1 or seq_len < 1 or d_in < 1 or hidden < 16 or hidden % 16:
        raise ValueError(f"no kernel plan for N={n}, L={seq_len}, D={d_in},"
                         f" H={hidden}: H must be a multiple of 16")
    plan = _fused_plan(n, seq_len, d_in, hidden, center)
    return plan if plan is not None \
        else _cluster_plan(n, seq_len, d_in, hidden, center, *CLUSTER)


def _cluster_plan(n, seq_len, d_in, hidden, center, csize,
                  bn) -> LayerPlan:
    """The cluster path's plan at cluster size `csize` and batch tile `bn`
    (the product runs CLUSTER; tests build others at small H)."""
    units = hidden // csize if csize > 0 else 0
    smem = cluster_smem(hidden, csize, bn) if units else 0
    if (hidden > 256 or csize not in (1, 2, 4, 8)
            or units % 16 or bn not in (32, 64, 128)
            or units // 16 * (bn // 32) > 8 or smem > SMEM_MAX):
        raise ValueError(
            f"no kernel plan for N={n}, L={seq_len}, D={d_in}, H={hidden}"
            f" with cluster {csize} x BN {bn}: the cluster path takes H up "
            "to 256, H/C a multiple of 16, at most 8 "
            f"warps and {SMEM_MAX} bytes of shared memory a CTA")
    d_x = -(-d_in // 8) * 8
    c = seq_len // 2
    t0_count, t1_lo = (c + 1, c) if center else (seq_len, 0)
    steps_t = max(t0_count, seq_len - t1_lo)
    n_pad = -(-n // GEMM_N) * GEMM_N
    return LayerPlan(
        "cluster", n, seq_len, d_in, hidden, center, d_x, bn, csize,
        32 * units // 16 * (bn // 32), smem, (-(-n // bn) * csize, 2),
        (_pad16(d_x) + hidden) // 16, n_pad, steps_t, t0_count, t1_lo,
        GEMM_SMEM, (n_pad // GEMM_N, -(-4 * hidden // GEMM_M), 2 * steps_t))


def cluster_weight_tiles(plan: LayerPlan, rank: int) -> List[Tuple[int, int,
                                                                   int]]:
    """The packed tiles CTA `rank` copies into shared memory, in its shared
    order: (m-tile, first k-tile, k-tiles) of `pack_weights`' [4H/16,
    Kp/16] grid, gate-major then unit group; the kernel computes the same
    offsets (csrc/bilstm.cu, bilstm_cluster_kernel)."""
    h_tiles, u_tiles = plan.hidden // 16, plan.units // 16
    return [(g * h_tiles + rank * u_tiles + u, plan.w_kt0, h_tiles)
            for g in range(4) for u in range(u_tiles)]


def plan_traffic(plan: LayerPlan) -> Dict[str, int]:
    """Bytes one call moves, by what it moves, from the plan alone:
    weights read into the SMs (L2 reads after the first) and xp's round
    trip through device memory."""
    kp = plan.kp_tiles * 16
    hidden = plan.hidden
    if plan.path != "cluster":   # each block its direction's weights once
        return {"weights": plan.grid[0] * plan.grid[1] * 4 * hidden * kp * 2}
    d_pad = kp - hidden
    blocks = plan.inproj_tiles
    out = {"w_hh": plan.grid[0] // plan.cluster * 2 * 4 * hidden * hidden * 2,
           "inproj_tiles": blocks * (GEMM_M + GEMM_N) * d_pad * 2,
           "xp_round_trip": 2 * (plan.t0_count + plan.seq_len - plan.t1_lo)
           * plan.n_pad * 4 * hidden * 4}
    out["weights"] = out["w_hh"] + blocks * GEMM_M * d_pad * 2
    return out


# --------------------------------------------------------------------------
# the cluster path's two kernels and their plain versions

def _fragment_index(device):
    """(n, m) within a 16x8 accumulator tile of lane l, element e."""
    lane = torch.arange(32, device=device)[:, None]
    e = torch.arange(4, device=device)[None, :]
    return 2 * (lane % 4) + e % 2, lane // 4 + 8 * (e // 2)


def xp_to_fragments(dense: torch.Tensor) -> torch.Tensor:
    """[2, T, Np, 4H] -> the kernels' xp layout [2, T, Np/8, 4H/16, 32, 4]:
    per 16x8 tile (16 gate rows, 8 batch rows) the mma accumulator's four
    values of each lane."""
    d, steps_t, n_pad, four_h = dense.shape
    t6 = dense.reshape(d, steps_t, n_pad // 8, 8, four_h // 16,
                       16).permute(0, 1, 2, 4, 3, 5)
    ni, mi = _fragment_index(dense.device)
    return t6[..., ni, mi].contiguous()


def xp_from_fragments(frag: torch.Tensor) -> torch.Tensor:
    d, steps_t, n8, m16 = frag.shape[:4]
    t6 = frag.new_empty(d, steps_t, n8, m16, 8, 16)
    ni, mi = _fragment_index(frag.device)
    t6[..., ni, mi] = frag
    return t6.permute(0, 1, 2, 4, 3, 5).reshape(d, steps_t, n8 * 8, m16 * 16)


def bilstm_inproj_plain(x, w_ih, b, plan: LayerPlan) -> torch.Tensor:
    """xp = x . w_ih + b (bf16 products summed in f32) for the steps each
    direction runs, padded rows (x = 0) holding the bias, in the kernels'
    layout; time indices a direction does not run hold zeros."""
    n, seq_len, _ = x.shape
    four_h = 4 * plan.hidden
    dense = torch.zeros(2, plan.steps_t, plan.n_pad, four_h,
                        dtype=torch.float32, device=x.device)
    for d, t_lo, count in ((0, 0, plan.t0_count),
                           (1, plan.t1_lo, seq_len - plan.t1_lo)):
        xs = x[:, t_lo:t_lo + count].float()
        dense[d, :count, :n] = (xs @ w_ih[d].float()).transpose(0, 1) + b[d]
        dense[d, :count, n:] = b[d]
    return xp_to_fragments(dense)


def bilstm_cluster_plain(xp, w_hh, plan: LayerPlan,
                         out_dtype: torch.dtype = torch.bfloat16):
    """The recurrence from xp (bias included): gates = xp + hh, then the
    cell; [N, L, 2H] out_dtype, or [N, 2H] f32 for a center plan."""
    n, seq_len, hidden = plan.n, plan.seq_len, plan.hidden
    dense = xp_from_fragments(xp)

    def gates_of(d, t, hh):
        return dense[d, t - (plan.t1_lo if d else 0), :n] + hh

    if plan.center:
        out, on_step = _center_sink(n, seq_len, hidden, xp.device)
    else:
        out, on_step = _stream_sink(n, seq_len, hidden, out_dtype, xp.device)
    _plain_recurrence(n, seq_len, w_hh, _steps_of(seq_len, plan.center),
                      gates_of, on_step, xp.device)
    return out.reshape(n, -1) if plan.center \
        else out.reshape(n, seq_len, 2 * hidden)


# --------------------------------------------------------------------------
# launching

_ERRORS = {-1: "the launcher refused the plan",
           -2: "no cluster of this plan fits the card "
               "(cudaOccupancyMaxActiveClusters = 0)"}


def _call(fn_name: str, device, *args) -> None:
    from .build import library

    with torch.cuda.device(device):
        err = getattr(library("bilstm"), fn_name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn_name} failed: "
                           f"{_ERRORS.get(err, f'cudaError {err}')}")


def _packed(w_ih, w_hh, packed: Optional[torch.Tensor]) -> torch.Tensor:
    if packed is None:
        return pack_weights(w_ih, w_hh)
    hidden, d_in = w_hh.shape[1], w_ih.shape[1]
    want = (2, 4 * hidden // 16, (_pad16(d_in) + hidden) // 16, 32, 8)
    if (tuple(packed.shape) != want or packed.dtype != torch.bfloat16
            or packed.device != w_ih.device or not packed.is_contiguous()):
        raise ValueError(f"packed must be pack_weights(w_ih, w_hh), "
                         f"{want} bf16 contiguous on {w_ih.device}")
    return packed


def _kernel_x(x: torch.Tensor, d_x: int) -> torch.Tensor:
    """x as the kernels read it: contiguous, 16-byte aligned, zero-padded
    to d_x columns (one pad where D is odd for the fused path or not a
    multiple of 8 for the in-projection)."""
    if d_x != x.shape[2]:
        x = torch.nn.functional.pad(x, (0, d_x - x.shape[2]))
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _contiguous(*tensors) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def bilstm_inproj(x, w_ih, w_hh, b, plan: LayerPlan,
                  packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The cluster path's in-projection: x [N, L, D] -> xp (plan.xp_shape,
    f32, bias included)."""
    _check(x, w_ih, w_hh, b)
    if x.device.type == "cpu":
        return bilstm_inproj_plain(x, w_ih, b, plan)
    _contiguous(x, w_ih, w_hh, b)
    wpk = _packed(w_ih, w_hh, packed)
    xk = _kernel_x(x, plan.d_x)
    xp = torch.empty(plan.xp_shape, dtype=torch.float32, device=x.device)
    _call("nsp_bilstm_inproj", x.device, xk.data_ptr(), wpk.data_ptr(),
          b.data_ptr(), xp.data_ptr(), plan.n, plan.seq_len, plan.d_x,
          plan.hidden, plan.kp_tiles, plan.n_pad, plan.steps_t,
          plan.t0_count, plan.t1_lo, plan.inproj_smem, *plan.inproj_grid)
    LAUNCHES["bilstm_inproj"] += 1
    return xp


def bilstm_cluster(xp, w_ih, w_hh, plan: LayerPlan,
                   out_dtype: torch.dtype = torch.bfloat16,
                   packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The cluster path's recurrence: xp -> [N, L, 2H] out_dtype, or
    [N, 2H] f32 for a center plan."""
    if tuple(xp.shape) != plan.xp_shape or xp.dtype != torch.float32:
        raise ValueError(f"xp must be {plan.xp_shape} f32")
    if xp.device.type == "cpu":
        return bilstm_cluster_plain(xp, w_hh, plan, out_dtype)
    _contiguous(xp, w_ih, w_hh)
    wpk = _packed(w_ih, w_hh, packed)
    n, seq_len, hidden = plan.n, plan.seq_len, plan.hidden
    if plan.center:
        out = torch.empty(n, 2 * hidden, dtype=torch.float32,
                          device=xp.device)
    else:
        out = torch.empty(n, seq_len, 2 * hidden, dtype=out_dtype,
                          device=xp.device)
    _call("nsp_bilstm_cluster", xp.device, xp.data_ptr(), wpk.data_ptr(),
          out.data_ptr(), int(plan.center), int(out.dtype == torch.float32),
          n, seq_len, hidden, plan.kp_tiles, plan.w_kt0, plan.n_pad,
          plan.steps_t, plan.t1_lo, plan.cluster, plan.bn, plan.smem,
          plan.grid[0])
    LAUNCHES["bilstm_cluster"] += 1
    return out


def cluster_occupancy(plan: LayerPlan) -> int:
    """Clusters of the plan's recurrence the card holds at once
    (cudaOccupancyMaxActiveClusters on the current device)."""
    from .build import library

    got = library("bilstm").nsp_bilstm_cluster_occupancy(
        plan.cluster, plan.bn, plan.hidden, plan.smem)
    if got < 0:
        raise RuntimeError(f"cluster occupancy query failed: "
                           f"{_ERRORS.get(got, f'cudaError {-got}')}")
    return got


def _run_layer(x, w_ih, w_hh, b, plan, packed, out_dtype):
    if plan.path == "cluster":
        xp = bilstm_inproj(x, w_ih, w_hh, b, plan, packed)
        return bilstm_cluster(xp, w_ih, w_hh, plan, out_dtype, packed)
    _contiguous(x, w_ih, w_hh, b)
    wpk = _packed(w_ih, w_hh, packed)
    xk = _kernel_x(x, plan.d_x)
    n, seq_len, hidden = plan.n, plan.seq_len, plan.hidden
    shape = (n, 2 * hidden) if plan.center else (n, seq_len, 2 * hidden)
    out = torch.empty(shape, dtype=out_dtype, device=x.device)
    common = (n, seq_len, plan.d_x, hidden, plan.bn, plan.smem, plan.grid[0])
    if plan.center:
        _call("nsp_bilstm_center", x.device, xk.data_ptr(), wpk.data_ptr(),
              b.data_ptr(), out.data_ptr(), *common)
        LAUNCHES["bilstm_center"] += 1
    else:
        _call("nsp_bilstm_stream", x.device, xk.data_ptr(), wpk.data_ptr(),
              b.data_ptr(), out.data_ptr(),
              int(out_dtype == torch.float32), *common)
        LAUNCHES["bilstm_stream"] += 1
    return out


def bilstm_stream(x, w_ih, w_hh, b, out_dtype: torch.dtype = torch.bfloat16,
                  packed: Optional[torch.Tensor] = None):
    """x [N, L, D] -> [N, L, 2H] in `out_dtype` (bf16 or f32). `packed` is
    `pack_weights(w_ih, w_hh)` made ahead (a model packs once, not every
    call)."""
    _check(x, w_ih, w_hh, b)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    if x.device.type == "cpu":
        return bilstm_stream_plain(x, w_ih, w_hh, b, out_dtype)
    if not x.shape[0]:
        return x.new_empty(0, x.shape[1], 2 * w_hh.shape[1], dtype=out_dtype)
    return _run_layer(x, w_ih, w_hh, b, plan_layer(*x.shape, w_hh.shape[1],
                                                   False), packed, out_dtype)


def bilstm_center(x, w_ih, w_hh, b, packed: Optional[torch.Tensor] = None):
    """x [N, L, D] -> h at t = L//2 of both directions, [N, 2H] f32."""
    _check(x, w_ih, w_hh, b)
    if x.device.type == "cpu":
        return bilstm_center_plain(x, w_ih, w_hh, b)
    if not x.shape[0]:
        return x.new_empty(0, 2 * w_hh.shape[1], dtype=torch.float32)
    return _run_layer(x, w_ih, w_hh, b, plan_layer(*x.shape, w_hh.shape[1],
                                                   True), packed,
                      torch.float32)


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


def _split_rows(plan: LayerPlan) -> int:
    """(batch row, step) pairs the split path projects and recurs over."""
    return plan.n * (plan.t0_count + plan.seq_len - plan.t1_lo)


def inproj_cost(plan: LayerPlan):
    """(FLOP, bytes) of the in-projection: x of the steps it projects read
    once, w_ih and b read once, xp of the batch's rows written once."""
    rows, four_h = _split_rows(plan), 4 * plan.hidden
    return (2 * rows * four_h * plan.d_in,
            rows * plan.d_in * 2 + 2 * plan.d_in * four_h * 2 + 2 * four_h * 4
            + rows * four_h * 4)


def cluster_cost(plan: LayerPlan, out_bytes: int = 2):
    """(FLOP, bytes) of the cluster recurrence: xp read once, w_hh read
    once, the output written once."""
    rows, hidden = _split_rows(plan), plan.hidden
    written = plan.n * 2 * hidden * 4 if plan.center \
        else plan.n * plan.seq_len * 2 * hidden * out_bytes
    return (2 * rows * 4 * hidden * hidden,
            rows * 4 * hidden * 4 + 2 * hidden * 4 * hidden * 2 + written)

