"""The training recurrences' launch plan and the smem path's dW, on the CPU
(ops/lstm_train.py).

The CUDA kernels cannot run here; what surrounds them can. These tests
hold:

- `plan_train` takes the smem path (w_hh in shared memory, dW summed in
  the sweep) at the pileup model's H=64, inside a block's shared memory
  and in one wave of the card at the trainer's batch, and the cluster
  path (w_hh sliced over a 4-CTA cluster) at the haplotype model's H=256,
  in one round of resident clusters at the trainer's batch, at the
  trainers' shapes and at ragged N;
- a cluster CTA's w_hh slice is the gate columns of its own units, and
  the cluster sweep's order of sums (dh as the four CTAs' partials added
  in rank order) agrees with the plain sweep and with the JAX package's
  Pallas `_bwd_kernel` in interpret mode;
- the plain version of the sweep's tiled dW, per-tile partials summed in
  tile order, equals `lstm_dw_reduce_plain` and, tile by tile, the
  `dw_tiles` of the JAX package's Pallas `_bwd_kernel` run in interpret
  mode;
- the gate derivatives the sweep forms from the SFU gate formulas keep
  the bound stated here;
- `plan_dw` (the tensor-core dW of `lstm_dw_reduce`) covers every row of
  M = N (L-1) once in a fixed split order, fits a block's shared memory and
  puts one wave of CTAs on the card at the trainers' shapes, and refuses
  what no kernel takes; an emulation of the kernel's arithmetic (bf16 hi +
  lo split, three products, f32 sums per split, splits in order) lies
  within its stated bound of the exact product and, rounded, agrees with
  `lstm_dw_reduce_plain` and the JAX package's Pallas `_bwd_kernel`;
- the step-stamp tool (ops/step_stamps.py) finds each of its anchors in
  the cluster kernels once, and averages the phases of the steady steps;
  the dW knock-out tool (ops/dw_knockouts.py) finds each of its parts in
  the dW kernel once.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import TRAIN_SHAPES, TRAIN_TOL
from nanosnp_tpu.ops.pallas_lstm import (_run_recurrence_bwd,
                                         _run_recurrence_train)
from nanosnp_tpu_torch.ops import build
from nanosnp_tpu_torch.ops import dw_knockouts as D
from nanosnp_tpu_torch.ops import lstm_train as T
from nanosnp_tpu_torch.ops import step_stamps as S
from nanosnp_tpu_torch.ops.bilstm import SM_COUNT, SMEM_MAX, SMEM_SM
from test_torch_bilstm_plan import _sigmoid4, _tanh2
from test_torch_lstm_train import (DW_ATOL, DW_RTOL, _from_jax_layout,
                                   _inputs, _to_jax_layout)

# f32 sums of the same products in another order (the JAX tile sums step
# by step, the plain version all steps at once)
TILE_TOL = 1e-5
# The sweep's derivatives from the SFU values (sigmoid within 1e-6, tanh
# within 2e-6 of exact, csrc/bilstm.cu): s(1 - s) moves by at most
# |ds| |1 - 2s| + ds^2, 1 - t^2 by at most 2 |t| |dt| + dt^2; plus the f32
# rounding of the products (below 2e-7)
SIGMOID_DERIV_BOUND = 1.2e-6
TANH_DERIV_BOUND = 4.2e-6


@pytest.mark.parametrize("n", [1, 17, 2000, 2001, 8192])
@pytest.mark.parametrize("label,seq_len,hidden",
                         [(s[0], s[2], s[4]) for s in TRAIN_SHAPES])
def test_plan_paths_fit_the_card(n, label, seq_len, hidden):
    plan = T.plan_train(n, seq_len, hidden)
    tiles = -(-n // plan.bn)
    assert plan.grid == (tiles * plan.cluster, 2)
    if hidden == 64:
        assert plan.path == "smem", label
        assert plan.bn == T.TRAIN_BN and plan.dw_tiles == tiles
        assert max(plan.fwd_smem, plan.bwd_smem) <= SMEM_MAX
        assert (plan.fwd_smem, plan.bwd_smem) == T.smem_bytes(hidden)
        # one block of the sweep an SM: the trainer's batch in one wave
        assert SMEM_SM // (plan.bwd_smem + 1024) == 1
        if n <= 2000:
            assert plan.grid[0] * plan.grid[1] <= SM_COUNT
    else:
        assert plan.path == "cluster", label
        assert plan.dw_tiles == T.plan_dw(n, seq_len, hidden).splits


@pytest.mark.parametrize("n", [1, 17, 512, 513, 2000])
@pytest.mark.parametrize("label,seq_len,hidden",
                         [(s[0], s[2], s[4]) for s in TRAIN_SHAPES
                          if s[4] == 256])
def test_cluster_plan_at_the_haplotype_shapes(n, label, seq_len, hidden):
    plan = T.plan_train(n, seq_len, hidden)
    assert plan.path == "cluster", label
    assert (plan.cluster, plan.bn) == (4, 64)
    assert (plan.fwd_smem, plan.bwd_smem) == T.cluster_smem_bytes()
    assert max(plan.fwd_smem, plan.bwd_smem) <= SMEM_MAX
    # one CTA an SM, as the clusters resident were counted
    assert SMEM_SM // (plan.fwd_smem + 1024) == 1
    clusters = plan.grid[0] // plan.cluster * plan.grid[1]
    assert clusters == -(-n // 64) * 2
    if n <= 512:   # the trainer's batch: one round of resident clusters
        assert clusters <= 16 <= T.CLUSTERS_RESIDENT
    # the batch tile of 32 would need a second round at the trainer's batch
    assert -(-512 // 32) * 2 > T.CLUSTERS_RESIDENT


@pytest.mark.parametrize("hidden,csize", [(256, 4), (64, 4), (32, 2)])
def test_cluster_cta_slice_is_its_units_columns(hidden, csize):
    """CTA r's gate columns K_r are {g H + r U + u}: all four gates of its
    own U = H/C units, so its cell runs on its own gate product; the
    CTAs' columns cover w_hh's 4H once."""
    rng = np.random.default_rng(4)
    w_hh = torch.from_numpy(rng.standard_normal((2, hidden, 4 * hidden))
                            .astype(np.float32))
    units = hidden // csize
    seen = []
    for r in range(csize):
        cols = T.cluster_gate_columns(hidden, csize, r)
        want = [g * hidden + r * units + u for g in range(4)
                for u in range(units)]
        assert cols.tolist() == want
        for d in (0, 1):
            torch.testing.assert_close(w_hh[d][:, cols], torch.stack(
                [w_hh[d][:, c] for c in want], dim=1), atol=0, rtol=0)
        seen += want
    assert sorted(seen) == list(range(4 * hidden))


def _to_kernel(a, n_pad):
    """[N, L, 2, F] -> the Pallas layout [L, 2, F, Npad], dir 1 reversed."""
    a = np.transpose(_to_jax_layout(a), (0, 1, 3, 2))
    return jnp.asarray(np.pad(a, ((0, 0), (0, 0), (0, 0),
                                  (0, n_pad - a.shape[-1]))))


def _from_kernel(a, n):
    """Inverse of _to_kernel, padded rows cut."""
    return _from_jax_layout(np.transpose(np.asarray(a), (0, 1, 3, 2)))[:n]


# dxp of the cluster order against the single-product sweep and the Pallas
# kernel: f32 outputs with the same bf16 cast sites (h_{t-1}, dgates, w_hh)
# on every side, so the gap is f32 summation order (the four partials added
# in rank order, against one product), which can flip the bf16 rounding of
# a dgate and carry it through the later steps; relative to the largest
# value, as the card's check (chip_smoke.py TRAIN_TOL)
@pytest.mark.parametrize("n,seq_len,hidden,block_n", [(13, 5, 16, 8),
                                                      (7, 4, 32, 8)])
def test_cluster_dh_order_matches_plain_and_pallas_interpret(
        n, seq_len, hidden, block_n):
    xp, w_hh, g_out = _inputs(5 * n + seq_len, n, seq_len, hidden)
    n_pad = -(-n // block_n) * block_n
    meta = dict(seq_len=seq_len, hidden=hidden, gate_dim=4 * hidden,
                block_n=block_n, interpret=True)
    xp_t = _to_kernel(xp, n_pad)
    w_t = jnp.asarray(np.transpose(w_hh, (0, 2, 1))).astype(jnp.bfloat16)
    hs, cs = _run_recurrence_train(xp_t, w_t, **meta)
    dxp_j, _ = _run_recurrence_bwd(xp_t, w_t, hs, cs,
                                   _to_kernel(g_out, n_pad), **meta)
    args = [torch.from_numpy(a) for a in (xp, w_hh, _from_kernel(hs, n),
                                          _from_kernel(cs, n), g_out)]
    args[1] = args[1].bfloat16()
    got, _ = T.lstm_recurrence_bwd_plain(*args, with_dw=False, csize=4)
    one, _ = T.lstm_recurrence_bwd_plain(*args, with_dw=False)
    want = torch.from_numpy(_from_kernel(dxp_j, n))
    for ref in (one, want):
        scale = max(1.0, ref.abs().max().item())
        assert (got - ref).abs().max().item() <= TRAIN_TOL * scale


@pytest.mark.parametrize("hidden", [16, 32, 48, 128])
def test_other_widths_take_the_packed_path(hidden):
    """The smem kernels are built for H=64 only, the cluster kernels for
    256; other widths, those that would fit included, run the packed
    kernels."""
    assert T.plan_train(5, 3, hidden).path == "packed"


@pytest.mark.parametrize("n,seq_len,hidden",
                         [(5, 3, 72), (5, 3, 8), (5, 3, 0), (0, 3, 64),
                          (5, 0, 64), (5, 3, 272)])
def test_plan_refuses_what_no_kernel_takes(n, seq_len, hidden):
    with pytest.raises(ValueError):
        T.plan_train(n, seq_len, hidden)


@pytest.mark.parametrize("n,seq_len,hidden", [(70, 9, 16), (33, 5, 64),
                                              (17, 7, 8)])
def test_tiled_dw_sums_to_the_whole(n, seq_len, hidden):
    xp, w_hh, g_out = (torch.from_numpy(a) for a in
                       _inputs(n + seq_len, n, seq_len, hidden))
    w = w_hh.bfloat16()
    hs, cs = T.lstm_recurrence_train(xp, w)
    dxp, dw = T.lstm_recurrence_bwd(xp, w, hs, cs, g_out)
    tiles = T.lstm_dw_tiles_plain(dxp, hs)
    assert tuple(tiles.shape) == (-(-n // T.TRAIN_BN), 2, hidden,
                                  4 * hidden)
    got = T.sum_dw_tiles(tiles)
    torch.testing.assert_close(got.float(), T.lstm_dw_reduce_plain(
        dxp, hs).float(), atol=DW_ATOL, rtol=DW_RTOL)
    torch.testing.assert_close(got.float(), dw.float(), atol=DW_ATOL,
                               rtol=DW_RTOL)


@pytest.mark.parametrize("n,seq_len,hidden,block_n", [(13, 5, 8, 8),
                                                      (16, 4, 16, 8)])
def test_dw_tiles_match_pallas_interpret(n, seq_len, hidden, block_n):
    xp, w_hh, g_out = _inputs(3 * n + seq_len, n, seq_len, hidden)
    n_pad = -(-n // block_n) * block_n

    def to_kernel(a):
        return _to_kernel(a, n_pad)

    def from_kernel(a):
        return _from_kernel(a, n)

    meta = dict(seq_len=seq_len, hidden=hidden, gate_dim=4 * hidden,
                block_n=block_n, interpret=True)
    xp_t = to_kernel(xp)
    w_t = jnp.asarray(np.transpose(w_hh, (0, 2, 1)))
    hs, cs = _run_recurrence_train(xp_t, w_t, **meta)
    dxp, dw_tiles = _run_recurrence_bwd(xp_t, w_t, hs, cs, to_kernel(g_out),
                                        **meta)
    got = T.lstm_dw_tiles_plain(torch.from_numpy(from_kernel(dxp)),
                                torch.from_numpy(from_kernel(hs)), block_n)
    want = np.transpose(np.asarray(dw_tiles), (0, 1, 3, 2))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TILE_TOL,
                               rtol=TILE_TOL)


def test_gate_derivatives_hold_the_stated_bound():
    v = torch.cat([torch.linspace(-40.0, 40.0, 400_001),
                   torch.tensor([-1e30, -89.0, 89.0, 1e30])]).float()
    args = [v, v.roll(1), v.roll(7919), v.flip(0)]
    for got, arg in zip(_sigmoid4(args), args):
        s = torch.sigmoid(arg.double())
        deriv = (got * (1.0 - got)).double()
        assert not deriv.isnan().any()
        assert (deriv - s * (1 - s)).abs().max() <= SIGMOID_DERIV_BOUND
    # g from sigmoid(2g) as the kernel forms it, and tanh(c) from tanh2
    two_g = _sigmoid4([v, v, v, 2.0 * v])[3]
    for tanh_v in (2.0 * two_g - 1.0, *_tanh2(v, v.flip(0))[:1]):
        t = torch.tanh(v.double())
        deriv = (1.0 - tanh_v * tanh_v).double()
        assert not deriv.isnan().any()
        assert (deriv - (1 - t * t)).abs().max() <= TANH_DERIV_BOUND


@pytest.mark.parametrize("no_stores", [False, True])
def test_step_stamps_instrument_the_cluster_kernels(no_stores):
    src = (build.CSRC / "lstm_train.cu").read_text()
    out = S.instrument(src, no_stores)
    assert out.count("g_stamps[") == 1 + len(S.FWD_PHASES) + len(
        S.BWD_PHASES)
    assert out.count("== 12345.0f") == (2 if no_stores else 0)
    # the kernels before the cluster path's are left as they are
    cut = src.index("lstm_fwd_cluster_kernel(const XpT*")
    assert out.replace(out[:out.index("namespace {")], "", 1).startswith(
        src[src.index("namespace {"):cut])
    # phases: stamp k to k + 1 over the steady steps, the last phase to the
    # next step's first stamp
    steps, names = 6, [p[0] for p in S.BWD_PHASES]
    stamps = np.zeros(S.MAX_STEPS * 16, np.int64)
    for i in range(steps):
        for k in range(len(names)):
            stamps[i * 16 + k] = 1000 * i + 10 * k * k
    got = S._phases(stamps, names, steps)
    assert got["cycles_a_step"] == 1000.0
    last = len(names) - 1
    for k in range(last):
        assert got[f"{k} {names[k]}"] == 10.0 * (2 * k + 1)
    assert got[f"{last} {names[last]}"] == 1000.0 - 10.0 * last * last


# the shapes `lstm_dw_reduce` runs at: the haplotype trainer's two (the
# cluster path), phase 1b's packed check, and the pileup trainer's (the smem
# path sums dW in its sweep, but the wrapper takes any width)
DW_SHAPES = [(s[2], s[4]) for s in TRAIN_SHAPES] + [(11, 128)]


def _dw_rows(plan, total):
    """The row ranges of the splits, in split order."""
    return [range(k * plan.rows, min((k + 1) * plan.rows, total))
            for k in range(plan.splits)]


@pytest.mark.parametrize("n", [1, 17, 512, 513, 2000, 2001])
@pytest.mark.parametrize("seq_len,hidden", DW_SHAPES)
def test_dw_plan_covers_every_row_once(n, seq_len, hidden):
    plan = T.plan_dw(n, seq_len, hidden)
    total = n * (seq_len - 1)
    assert plan.rows % T.DW_CHUNK == 0 and plan.splits >= 1
    ranges = _dw_rows(plan, total)
    assert all(len(r) > 0 for r in ranges)          # no split is empty
    assert [m for r in ranges for m in r] == list(range(total))
    tiles = -(-hidden // T.DW_TILE[0]) * -(-4 * hidden // T.DW_TILE[1])
    assert plan.grid == (tiles, plan.splits, 2)
    # the cluster and packed training plans sum the same splits
    if hidden != 64:
        assert T.plan_train(n, seq_len, hidden).dw_tiles == plan.splits


@pytest.mark.parametrize("n,seq_len,hidden", [(512, 33, 256),
                                              (512, 11, 256),
                                              (512, 11, 128),
                                              (2000, 33, 64)])
def test_dw_plan_fits_the_card_at_the_trainers_shapes(n, seq_len, hidden):
    plan = T.plan_dw(n, seq_len, hidden)
    assert plan.smem == T.dw_smem_bytes() <= SMEM_MAX
    assert SMEM_SM // (plan.smem + 1024) == 1       # one CTA an SM
    ctas = plan.grid[0] * plan.grid[1] * plan.grid[2]
    # one wave, and no more than a tenth of the SMs idle
    assert 0.9 * SM_COUNT <= ctas <= SM_COUNT
    if hidden == 256:
        assert plan.splits == 4 and plan.grid == (16, 4, 2)


@pytest.mark.parametrize("n,hidden", [(1, 256), (7, 128), (3, 16)])
def test_dw_plan_at_one_step_launches_nothing(n, hidden):
    plan = T.plan_dw(n, 1, hidden)
    assert plan.splits == plan.rows == plan.grid[1] == 0
    hs = torch.zeros(n, 1, 2, hidden)
    dxp = torch.ones(n, 1, 2, 4 * hidden)
    dw = T.lstm_dw_reduce(dxp, hs)
    assert dw.dtype == torch.bfloat16 and not dw.float().any()


@pytest.mark.parametrize("n,seq_len,hidden",
                         [(5, 3, 72), (5, 3, 8), (5, 3, 0), (0, 3, 64),
                          (5, 0, 64), (5, 3, 272)])
def test_dw_plan_refuses_what_no_kernel_takes(n, seq_len, hidden):
    with pytest.raises(ValueError):
        T.plan_dw(n, seq_len, hidden)


def _split_bf16(x):
    """x as bf16 hi (its rounding) and lo (what hi leaves, rounded), in
    f32: csrc/lstm_train.cu split2."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _dw_split_bf16(dxp, hs, plan):
    """The dW kernel's arithmetic, before the bf16 rounding: per direction
    and split of `plan.rows` rows, the three products (hi hi, hi lo, lo hi)
    of the split operands summed in f32, the splits added in split order.
    -> ([2, H, 4H] f32, the operands A [2, M, H] and B [2, M, 4H])."""
    hidden = hs.shape[-1]
    a = torch.stack([hs[:, :-1, 0], hs[:, 1:, 1]]).reshape(2, -1, hidden)
    b = torch.stack([dxp[:, 1:, 0], dxp[:, :-1, 1]]).reshape(2, -1,
                                                              4 * hidden)
    total = None
    for rows in _dw_rows(plan, a.shape[1]):
        ah, al = _split_bf16(a[:, rows.start:rows.stop])
        bh, bl = _split_bf16(b[:, rows.start:rows.stop])
        at, alt = ah.transpose(1, 2), al.transpose(1, 2)
        part = at @ bh + at @ bl + alt @ bh
        total = part if total is None else total + part
    return total, a, b


# |x - (hi + lo)| <= 2^-16 |x| and |lo| <= (2^-8 + 2^-16) |x|, so each
# product hi hi + hi lo + lo hi is within 3.1 * 2^-16 |a b| of a b (each
# bf16 product is exact in f32); f32 sums of k terms add at most k 2^-24 of
# the sum of their magnitudes: 3 terms a row, then the splits
def _dw_bound(a, b, splits):
    mag = a.double().abs().transpose(1, 2) @ b.double().abs()
    return (3.1 * 2.0 ** -16 + (3 * a.shape[1] + splits) * 2.0 ** -24) * mag


@pytest.mark.parametrize("n,seq_len,hidden", [(17, 11, 32), (5, 33, 16),
                                              (9, 4, 64)])
def test_split_bf16_dw_lies_within_its_bound(n, seq_len, hidden):
    xp, w_hh, g_out = (torch.from_numpy(a) for a in
                       _inputs(7 * n + seq_len, n, seq_len, hidden))
    w = w_hh.bfloat16()
    hs, cs = T.lstm_recurrence_train(xp, w)
    dxp, _ = T.lstm_recurrence_bwd(xp, w, hs, cs, g_out, with_dw=False)
    plan = T.plan_dw(n, seq_len, hidden)
    got, a, b = _dw_split_bf16(dxp, hs, plan)
    exact = a.double().transpose(1, 2) @ b.double()
    assert ((got.double() - exact).abs() <= _dw_bound(a, b, plan.splits)
            ).all()
    # the bf16 products alone would miss it: the split is what keeps it
    one = (a.bfloat16().float().transpose(1, 2)
           @ b.bfloat16().float()).double()
    assert ((one - exact).abs() > _dw_bound(a, b, plan.splits)).any()
    torch.testing.assert_close(got.bfloat16().float(), T.lstm_dw_reduce_plain(
        dxp, hs).float(), atol=DW_ATOL, rtol=DW_RTOL)


@pytest.mark.parametrize("n,seq_len,hidden,block_n", [(13, 5, 16, 8),
                                                      (16, 4, 32, 8)])
def test_split_bf16_dw_matches_pallas_interpret(n, seq_len, hidden, block_n):
    """Summed over the Pallas kernel's batch tiles and rounded to bf16 as
    its VJP returns it, `_bwd_kernel`'s dW agrees with the split-bf16 sum
    over `plan_dw`'s splits, rounded once."""
    xp, w_hh, g_out = _inputs(5 * n + seq_len, n, seq_len, hidden)
    n_pad = -(-n // block_n) * block_n
    meta = dict(seq_len=seq_len, hidden=hidden, gate_dim=4 * hidden,
                block_n=block_n, interpret=True)
    xp_t = _to_kernel(xp, n_pad)
    w_t = jnp.asarray(np.transpose(w_hh, (0, 2, 1))).astype(jnp.bfloat16)
    hs, cs = _run_recurrence_train(xp_t, w_t, **meta)
    dxp, dw_tiles = _run_recurrence_bwd(xp_t, w_t, hs, cs,
                                        _to_kernel(g_out, n_pad), **meta)
    want = np.transpose(np.asarray(dw_tiles.sum(axis=0).astype(jnp.bfloat16)
                                   .astype(jnp.float32)), (0, 2, 1))
    dxp_t = torch.from_numpy(_from_kernel(dxp, n))
    hs_t = torch.from_numpy(_from_kernel(hs, n))
    got, _, _ = _dw_split_bf16(dxp_t, hs_t, T.plan_dw(n, seq_len, hidden))
    np.testing.assert_allclose(got.bfloat16().float().numpy(), want,
                               atol=DW_ATOL, rtol=DW_RTOL)


@pytest.mark.parametrize("variant", sorted(D.VARIANTS))
def test_dw_knockouts_find_their_parts_in_the_dw_kernel(variant):
    src = (build.CSRC / "lstm_train.cu").read_text()
    out = D.knock_out(src, D.VARIANTS[variant])
    k0, k1 = src.index(D.KERNEL), src.index(D.END)
    # only the dW kernel changes, and only where a part is knocked out
    assert out[:k0] == src[:k0]
    assert out.endswith(src[k1:])
    assert (out == src) == (variant == "all")
    for old, new in D.VARIANTS[variant]:
        assert old not in out[k0:out.index(D.END)] and new in out
