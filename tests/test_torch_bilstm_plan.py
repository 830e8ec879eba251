"""The launch plan of the BiLSTM layer kernels and the plain versions of
the split H=256 path (ops/bilstm.py), on the CPU.

The CUDA kernels cannot run here; what surrounds them can. These tests
hold:

- the plan `plan_layer` hands the C launchers fits the card (shared memory,
  cluster size, grid) at every layer call of the main path (chip_smoke.py's
  SHAPES) and at ragged batch sizes, and every hidden unit is owned by one
  CTA with all four gates;
- each cluster CTA's w_hh slice, read from `pack_weights` at the offsets
  the plan gives the kernel, is its units' rows of [w_ih ; w_hh]^T;
- the kernels' SFU gate formulas, written in f32 torch, keep the bound
  stated in csrc/bilstm.cu and saturate without NaN;
- the plain in-projection and cluster recurrence, composed, equal the
  fused layer's plain version and the JAX package's Pallas encoder run in
  interpret mode;
- a model layer packs its weights once, and again after an update.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import SHAPES
from nanosnp_tpu.ops.pallas_lstm import bilstm_encoder_pallas
from nanosnp_tpu_torch.models import bilstm as M
from nanosnp_tpu_torch.models.convert import params_from_jax
from nanosnp_tpu_torch.ops import bilstm as K

# bf16 h_{t-1} on both sides; a reordered f32 sum can flip one rounding
# (2^-8 near 1) and carry about 1e-3 into an f32 output (the reasoning of
# test_torch_bilstm.BF16_TOL); typical gaps are 1e-7
BF16_TOL = 2e-3
# the bound stated in csrc/bilstm.cu for the SFU formulas
SIGMOID_BOUND = 1e-6
TANH_BOUND = 2e-6
LOG2E = 1.4426950408889634


def _layer(rng, d_in, hidden):
    k = 1.0 / np.sqrt(hidden)
    return {"w_ih": rng.uniform(-k, k, (2, d_in, 4 * hidden)).astype(
                np.float32),
            "w_hh": rng.uniform(-k, k, (2, hidden, 4 * hidden)).astype(
                np.float32),
            "b": rng.uniform(-2 * k, 2 * k, (2, 4 * hidden)).astype(
                np.float32)}


def _kernel_args(rng, n, seq_len, d_in, hidden, x_scale=2.0):
    p = _layer(rng, d_in, hidden)
    x = (rng.standard_normal((n, seq_len, d_in)) * x_scale).astype(
        np.float32)
    return (torch.from_numpy(x).bfloat16(),
            torch.from_numpy(p["w_ih"]).bfloat16(),
            torch.from_numpy(p["w_hh"]).bfloat16(), torch.from_numpy(p["b"]))


def _units_by_cta(plan):
    return [range(r * plan.units, (r + 1) * plan.units)
            for r in range(plan.cluster)]


@pytest.mark.parametrize("n", [1, 63, 65, 2558, 8192])
@pytest.mark.parametrize("label,name,seq_len,d_in,hidden", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_plan_fits_the_card(label, name, seq_len, d_in, hidden, n):
    plan = K.plan_layer(n, seq_len, d_in, hidden,
                        center=name == "bilstm_center")
    assert plan.path == ("cluster" if hidden == 256 else "fused")
    assert plan.smem <= K.SMEM_MAX
    assert plan.threads % 32 == 0 and plan.threads <= 512
    assert 1 <= plan.cluster <= 8
    assert plan.grid[1] == 2 and plan.grid[0] % plan.cluster == 0
    tiles = plan.grid[0] // plan.cluster
    assert (tiles - 1) * plan.bn < n <= tiles * plan.bn
    if plan.path == "fused":
        assert plan.cluster == 1
        assert plan.smem == K.fused_smem(plan.d_x, hidden, plan.bn)
        assert plan.threads == hidden // 16 * (plan.bn // 32) * 32
    else:
        assert plan.smem == K.cluster_smem(hidden, plan.cluster, plan.bn)
        assert plan.threads == plan.units // 16 * (plan.bn // 32) * 32
        assert plan.inproj_smem <= K.SMEM_MAX
        assert plan.n_pad % K.GEMM_N == 0 and plan.n_pad % plan.bn == 0
        assert n <= plan.n_pad < n + K.GEMM_N
        assert plan.inproj_tiles == (plan.n_pad // K.GEMM_N
                                     * 4 * hidden // K.GEMM_M
                                     * (plan.t0_count + seq_len
                                        - plan.t1_lo))
        assert plan.inproj_grid == (plan.n_pad // K.GEMM_N,
                                    4 * hidden // K.GEMM_M,
                                    2 * plan.steps_t)
        assert plan.d_x % 8 == 0 and plan.d_x - d_in < 8
    # every hidden unit belongs to exactly one CTA, all four gates with it
    owned = [j for units in _units_by_cta(plan) for j in units]
    assert sorted(owned) == list(range(hidden))
    if plan.path == "cluster":
        for r, units in enumerate(_units_by_cta(plan)):
            rows = {mt * 16 + i
                    for mt, _, _ in K.cluster_weight_tiles(plan, r)
                    for i in range(16)}
            assert rows == {g * hidden + j for g in range(4) for j in units}


@pytest.mark.parametrize("seq_len,d_in", [(33, 105), (33, 512), (11, 105),
                                          (11, 512)])
def test_h256_cluster_plans_fit(seq_len, d_in):
    for center in (False, True):
        plan = K.plan_layer(8192, seq_len, d_in, 256, center)
        assert (plan.cluster, plan.bn) == K.CLUSTER
        assert plan.smem <= K.SMEM_MAX and plan.threads <= 256
        assert plan.grid[0] % plan.cluster == 0


def test_unschedulable_plans_are_refused():
    with pytest.raises(ValueError, match="cluster"):
        K._cluster_plan(8192, 33, 512, 256, False, 2, 64)  # smem
    with pytest.raises(ValueError, match="cluster"):
        K._cluster_plan(8192, 33, 512, 256, False, 16, 64)
    with pytest.raises(ValueError, match="cluster"):
        K._cluster_plan(64, 33, 512, 256, False, 4, 48)
    with pytest.raises(ValueError, match="multiple of 16"):
        K.plan_layer(64, 33, 18, 40, False)


def _unpack_tile(frag):
    """[32, 8] A fragment -> the 16x16 tile (the PTX ISA's m16n8k16 map)."""
    tile = torch.zeros(16, 16, dtype=frag.dtype)
    for lane in range(32):
        for i in range(8):
            row = lane // 4 + (8 if i in (2, 3, 6, 7) else 0)
            col = 2 * (lane % 4) + (i & 1) + (8 if i >= 4 else 0)
            tile[row, col] = frag[lane, i]
    return tile


@pytest.mark.parametrize("d_in,hidden,cluster", [(20, 64, (4, 32)),
                                                 (105, 128, (4, 64)),
                                                 (18, 256, (8, 128))])
def test_cta_weight_slice_is_its_units_rows(d_in, hidden, cluster):
    rng = np.random.default_rng(3)
    _, w_ih, w_hh, _ = _kernel_args(rng, 1, 3, d_in, hidden)
    plan = K._cluster_plan(5, 7, d_in, hidden, False, *cluster)
    pk = K.pack_weights(w_ih, w_hh)
    d_pad = plan.w_kt0 * 16
    full = torch.cat([torch.nn.functional.pad(w_ih.transpose(1, 2),
                                              (0, d_pad - d_in)),
                      w_hh.transpose(1, 2)], dim=2)           # [2, 4H, Kp]
    for d in (0, 1):
        # the in-projection's A: k-tiles [0, w_kt0) of every row
        a = torch.cat([torch.cat([_unpack_tile(pk[d, mt, kt])
                                  for kt in range(plan.w_kt0)], dim=1)
                       for mt in range(4 * hidden // 16)], dim=0)
        torch.testing.assert_close(a, full[d, :, :d_pad], atol=0, rtol=0)
        for r, units in enumerate(_units_by_cta(plan)):
            tiles = K.cluster_weight_tiles(plan, r)
            got = torch.cat([torch.cat([_unpack_tile(pk[d, mt, kt0 + k])
                                        for k in range(count)], dim=1)
                             for mt, kt0, count in tiles], dim=0)
            rows = [g * hidden + j for g in range(4) for j in units]
            torch.testing.assert_close(got, full[d, rows, d_pad:], atol=0,
                                       rtol=0)
            torch.testing.assert_close(got, w_hh[d].T[rows], atol=0, rtol=0)


def _sigmoid4(v4):
    """csrc/bilstm_layer.cuh sigmoid4 in f32: four sigmoids, one reciprocal of
    the product of their denominators 1 + ex2(-v log2 e), v >= -20."""
    den = [1.0 + torch.exp2(-LOG2E * torch.clamp(v, min=-20.0)) for v in v4]
    ab, cd = den[0] * den[1], den[2] * den[3]
    r = torch.reciprocal(ab * cd)
    r_ab, r_cd = r * cd, r * ab
    return den[1] * r_ab, den[0] * r_ab, den[3] * r_cd, den[2] * r_cd


def _tanh2(u, v):
    """csrc/bilstm_layer.cuh tanh2 in f32: 2 sigmoid(2x) - 1 for two values, one
    reciprocal, x >= -20."""
    a, b = (1.0 + torch.exp2(-2.0 * LOG2E * torch.clamp(w, min=-20.0))
            for w in (u, v))
    r = torch.reciprocal(a * b)
    return 2.0 * (b * r) - 1.0, 2.0 * (a * r) - 1.0


def test_gate_formulas_hold_the_stated_bound():
    v = torch.cat([torch.linspace(-40.0, 40.0, 400_001),
                   torch.tensor([-1e30, -1e4, -89.0, -88.0, 88.0, 89.0,
                                 1e4, 1e30])]).float()
    # every value meets every kind of partner: its own order, rolled, flipped
    args = [v, v.roll(1), v.roll(7919), v.flip(0)]
    for got, arg in zip(_sigmoid4(args), args):
        assert got.dtype == torch.float32 and not got.isnan().any()
        assert (got - torch.sigmoid(arg.double())).abs().max() \
            <= SIGMOID_BOUND
    for got, arg in zip(_tanh2(v, v.flip(0)), (v, v.flip(0))):
        assert got.dtype == torch.float32 and not got.isnan().any()
        assert (got - torch.tanh(arg.double())).abs().max() <= TANH_BOUND
    # large |v| saturates without NaN: ex2 gives 0 or a clamped finite
    # value, never inf * 0
    big = torch.tensor([-1e30, 1e30, -1e30, 1e30])
    got = torch.stack(_sigmoid4(list(big)))
    assert (got - torch.tensor([0.0, 1.0, 0.0, 1.0])).abs().max() \
        <= SIGMOID_BOUND
    got = torch.stack(_tanh2(big[:2], big[:2].flip(0)))
    assert (got - torch.tensor([[-1.0, 1.0], [1.0, -1.0]])).abs().max() \
        <= TANH_BOUND


def test_xp_fragment_layout_is_the_mma_accumulator():
    """Element e of lane l in tile (n-tile, m-tile) is gate row
    16 m + l/4 + 8 (e >= 2) of batch row 8 n + 2 (l % 4) + e % 2."""
    dense = torch.randn(2, 3, 16, 64)
    frag = K.xp_to_fragments(dense)
    assert tuple(frag.shape) == (2, 3, 2, 4, 32, 4)
    for n8, mt, lane, e in [(0, 0, 0, 0), (1, 3, 31, 3), (1, 2, 5, 1),
                            (0, 1, 18, 2)]:
        row = 8 * n8 + 2 * (lane % 4) + e % 2
        col = 16 * mt + lane // 4 + 8 * (e // 2)
        assert frag[1, 2, n8, mt, lane, e] == dense[1, 2, row, col]
    assert torch.equal(K.xp_from_fragments(frag), dense)


# (N, L, D, H, center, (C, BN)): ragged N, odd and even L, D not a
# multiple of 8 (the in-projection's padded x)
SPLIT_CASES = [(5, 9, 10, 64, False, (4, 32)), (70, 8, 20, 64, True, (2, 64)),
               (130, 5, 33, 128, False, (8, 32)),
               (3, 7, 105, 128, True, (4, 64)),
               (16, 11, 18, 32, False, (2, 32))]


@pytest.mark.parametrize("n,seq_len,d_in,hidden,center,cluster",
                         SPLIT_CASES)
def test_split_plain_versions_compose_to_the_layer(n, seq_len, d_in, hidden,
                                                   center, cluster):
    rng = np.random.default_rng(n + seq_len)
    x, w_ih, w_hh, b = _kernel_args(rng, n, seq_len, d_in, hidden)
    plan = K._cluster_plan(n, seq_len, d_in, hidden, center, *cluster)
    xp = K.bilstm_inproj_plain(x, w_ih, b, plan)
    assert tuple(xp.shape) == plan.xp_shape and xp.dtype == torch.float32
    if center:
        got = K.bilstm_cluster_plain(xp, w_hh, plan)
        want = K.bilstm_center_plain(x, w_ih, w_hh, b)
    else:
        got = K.bilstm_cluster_plain(xp, w_hh, plan, torch.float32)
        want = K.bilstm_stream_plain(x, w_ih, w_hh, b, torch.float32)
        # bf16 output: the f32 output rounded
        assert torch.equal(K.bilstm_cluster_plain(xp, w_hh, plan),
                           got.bfloat16())
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=BF16_TOL, rtol=0)
    assert (got - want).abs().median() < 1e-5
    # the wrappers on CPU tensors take these plain versions
    torch.testing.assert_close(K.bilstm_inproj(x, w_ih, w_hh, b, plan), xp,
                               atol=0, rtol=0)


@pytest.mark.parametrize("d_in,center_only", [(18, False), (105, True)])
def test_split_plain_versions_match_pallas_interpret(d_in, center_only):
    """One layer at H=32 through the JAX package's bilstm_encoder_pallas
    (interpret mode; D 18 takes the K-fused Pallas kernels, D 105 the
    unfused ones) and through the port's in-projection + cluster
    recurrence plain versions, on the same numpy-seeded inputs."""
    rng = np.random.default_rng(40 + d_in)
    n, seq_len, hidden = 16, 11, 32
    p = _layer(rng, d_in, hidden)
    x = rng.standard_normal((n, seq_len, d_in)).astype(np.float32)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(bilstm_encoder_pallas(
        [jax.tree.map(jnp.asarray, p)], jnp.asarray(x), block_n=8,
        interpret=True, center_only=center_only))
    plan = K._cluster_plan(n, seq_len, d_in, hidden, center_only, 2, 32)
    w_ih = torch.from_numpy(p["w_ih"]).bfloat16()
    w_hh = torch.from_numpy(p["w_hh"]).bfloat16()
    xp = K.bilstm_inproj_plain(torch.from_numpy(x).bfloat16(), w_ih,
                               torch.from_numpy(p["b"]), plan)
    got = K.bilstm_cluster_plain(xp, w_hh, plan, torch.float32).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=0)
    assert np.median(np.abs(got - want)) < 1e-4


def test_layer_packs_once_and_again_after_an_update(monkeypatch):
    packs = []
    real = M.pack_weights

    def counting(w_ih, w_hh):
        packs.append(tuple(w_ih.shape))
        return real(w_ih, w_hh)

    monkeypatch.setattr(M, "pack_weights", counting)
    monkeypatch.delenv("NSP_FUSE_LAYERS", raising=False)
    rng = np.random.default_rng(8)
    layers = [_layer(rng, 18, 32), _layer(rng, 64, 32)]
    enc = M.BiLSTM(params_from_jax(layers))
    x = torch.from_numpy(rng.standard_normal((6, 9, 18)).astype(np.float32))
    outs = [M.bilstm_encoder_fused(enc.layers, x, center_only=True)
            for _ in range(3)]
    assert len(packs) == 2                   # one per layer, not per call
    assert all(torch.equal(o, outs[0]) for o in outs)
    with torch.no_grad():
        enc.layers[1].w_hh.mul_(0.5)          # an optimizer step, in place
    updated = M.bilstm_encoder_fused(enc.layers, x, center_only=True)
    assert len(packs) == 3 and packs[-1] == (2, 64, 128)
    w_ih, w_hh, b, packed = enc.layers[1].kernel_weights()
    assert len(packs) == 3                   # still cached
    assert torch.equal(packed, real(w_ih, w_hh))
    fresh = M.BiLSTM(params_from_jax(layers))
    with torch.no_grad():
        fresh.layers[1].w_hh.mul_(0.5)
    assert torch.equal(updated,
                       M.bilstm_encoder_fused(fresh.layers, x,
                                              center_only=True))
    assert not torch.equal(updated, outs[0])


def test_layer_made_in_inference_mode_packs_once(monkeypatch):
    """Parameters made under torch.inference_mode carry no version
    counter; the layer keys their pack on their storage."""
    packs = []
    real = M.pack_weights
    monkeypatch.setattr(M, "pack_weights",
                        lambda w_ih, w_hh: packs.append(1)
                        or real(w_ih, w_hh))
    monkeypatch.delenv("NSP_FUSE_LAYERS", raising=False)
    rng = np.random.default_rng(9)
    with torch.inference_mode():
        enc = M.BiLSTM(params_from_jax([_layer(rng, 18, 32)]))
        x = torch.from_numpy(rng.standard_normal((5, 9, 18)).astype(
            np.float32))
        outs = [M.bilstm_encoder_fused(enc.layers, x, center_only=True)
                for _ in range(3)]
    assert enc.layers[0].w_ih.is_inference()
    assert len(packs) == 1
    assert all(torch.equal(o, outs[0]) for o in outs)
