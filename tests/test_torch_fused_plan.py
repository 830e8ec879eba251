"""The launch plans of the pileup encoder's fused kernels and what
surrounds them (ops/bilstm_fused.py, models/), on the CPU.

The CUDA kernels run only on the card (chip_smoke.py phase 1c holds them
against their plain versions). These tests hold:

- `plan_two_layer` and `plan_center_head` fit the card at the pileup
  model's shapes (shared memory, 2-CTA clusters, one wave at N=8192) and
  refuse a shape no CTA can hold;
- a layer's weights, laid out in shared memory as the kernels copy them
  (`cp_async_layer_weights`), are the packed tiles the product reads;
- the head split as the kernel deals it (each CTA half of a cluster's
  rows, every K sum whole) equals `head_plain` bit for bit;
- the knock-out tool (ops/fused_knockouts.py) finds each of its parts in
  the two-layer kernel once;
- the models hand the kernels weights packed once: `PileupModel` packs its
  head once and again after an update, and the two-layer route reaches
  `bilstm2_center` with no pack on a second forward.
"""
import numpy as np
import pytest
import torch

from nanosnp_tpu_torch.config import PileupModelConfig
from nanosnp_tpu_torch.models import bilstm as M
from nanosnp_tpu_torch.models import pileup_model as PM
from nanosnp_tpu_torch.models.pileup_model import (HEADS, PileupModel,
                                                   init_pileup_params)
from nanosnp_tpu_torch.ops import bilstm as K
from nanosnp_tpu_torch.ops import bilstm_fused as F
from nanosnp_tpu_torch.ops import build
from nanosnp_tpu_torch.ops import fused_knockouts as KO

N_TIME = 8192                       # the main path's batch
P_DIM, Q_DIM = 128, 256             # the pileup head's proj and dense


def _pad16(v):
    return -(-v // 16) * 16


def _fits(plan, n, hidden):
    assert plan.smem <= K.SMEM_MAX
    assert plan.cluster == 2 and plan.grid[1] == 1
    assert plan.grid[0] % 2 == 0                   # whole 2-CTA clusters
    clusters = plan.grid[0] // 2
    assert (clusters - 1) * plan.bn < n <= clusters * plan.bn
    assert plan.threads == hidden // 16 * (plan.bn // 32) * 32 <= 512
    assert plan.threads * K.REGS_FUSED <= K.REGS_SM
    assert K.SMEM_SM // (plan.smem + 1024) >= 1


@pytest.mark.parametrize("n", [1, 65, 3001, N_TIME - 1, N_TIME])
def test_two_layer_plan_fits_the_card(n):
    plan = F.plan_two_layer(n, 33, 18, 64)
    _fits(plan, n, 64)
    assert plan.smem == F.two_layer_smem(plan.d_x, 64, plan.bn)
    assert plan.d_x == 18 and plan.bn in (32, 64, 128)
    if n == N_TIME:
        # 64 clusters = 128 CTAs, one a SM: one wave
        assert (plan.bn, plan.grid, plan.smem) == (128, (128, 1), 204_800)
        assert plan.grid[0] <= K.SM_COUNT


@pytest.mark.parametrize("rows", [24, 96])
@pytest.mark.parametrize("n", [1, 65, 3001, N_TIME - 1, N_TIME])
def test_center_head_plan_fits_the_card(n, rows):
    plan = F.plan_center_head(n, 33, 128, 64, P_DIM, Q_DIM)
    _fits(plan, n, 64)
    assert plan.smem == F.center_head_smem(plan.d_x, 64, P_DIM, Q_DIM,
                                           plan.bn)
    assert plan.bn in (64, 128)            # each CTA's half whole warps
    if n == N_TIME:
        assert (plan.bn, plan.grid, plan.smem) == (128, (128, 1), 222_208)
        assert plan.grid[0] <= K.SM_COUNT
    # the rows the head deals to each CTA cover the batch once
    half = plan.bn // 2
    starts = [c * plan.bn + d * half for c in range(plan.grid[0] // 2)
              for d in (0, 1)]
    covered = np.zeros(n, dtype=int)
    for lo in starts:
        covered[lo:lo + half] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("n,hidden,smem_of,want", [
    (N_TIME, 64, lambda bn: 204_800, (128, 512, 204_800)),  # one wave
    (1, 64, lambda bn: 204_800, (32, 128, 204_800)),  # a tie: the smallest
    # 128 past SMEM_MAX; 32 fits three a SM: two waves, as 64
    (N_TIME, 64, lambda bn: 2_000 * bn, (32, 128, 64_000)),
    # H=128: 128 rows would be 32 warps; 32 and 64 take two waves each
    (N_TIME, 128, lambda bn: 100_000, (32, 256, 100_000)),
    (N_TIME, 64, lambda bn: K.SMEM_MAX + 1, None),    # no tile fits
])
def test_fewest_waves_is_the_tile_rule(n, hidden, smem_of, want):
    assert K.fewest_waves(n, hidden, (32, 64, 128), smem_of) == want


@pytest.mark.parametrize("n", [1, 65, 3001, 4224, 4225, N_TIME])
def test_every_fused_plan_takes_its_tile_by_one_rule(n):
    """The fused layers and both 2-CTA cluster kernels pick their batch
    tile by `fewest_waves`, each over its own shared memory."""
    def bn(tiles, smem_of):
        return K.fewest_waves(n, 64, tiles, smem_of)[0]

    assert K.plan_layer(n, 33, 128, 64, True).bn == bn(
        (32, 64, 128), lambda b: K.fused_smem(128, 64, b))
    assert F.plan_two_layer(n, 33, 18, 64).bn == bn(
        (32, 64, 128), lambda b: F.two_layer_smem(18, 64, b))
    assert F.plan_center_head(n, 33, 128, 64, P_DIM, Q_DIM).bn == bn(
        (64, 128), lambda b: F.center_head_smem(128, 64, P_DIM, Q_DIM, b))


def test_weights_are_read_once_per_cta():
    """Bytes of weights one call pulls into the SMs at N=8192: each CTA its
    direction's two layers once, in place of the one-block design's
    re-read of both directions' weights every step for every 16 rows."""
    weights = K.plan_traffic(F.plan_two_layer(N_TIME, 33, 18, 64))["weights"]
    assert weights == 128 * 4 * 64 * (32 + 64 + 192) * 2
    assert round(weights / 1e6, 1) == 18.9
    one_block = N_TIME // 16 * (33 * 2 * 48 * 1024 + 17 * 2 * 96 * 1024)
    assert weights * 150 < one_block       # 3.4 GB
    head = F.plan_center_head(N_TIME, 33, 128, 64, P_DIM, Q_DIM)
    assert K.plan_traffic(head)["weights"] == 128 * 96 * 1024


@pytest.mark.parametrize("args", [
    (N_TIME, 33, 18, 128),     # layer 2's weights alone are 384 KiB
    (N_TIME, 33, 105, 256),    # the haplotype model's width
    (N_TIME, 32, 18, 64),      # an even window has no center step
    (N_TIME, 33, 18, 72),      # H off the 16-row tiles
    (0, 33, 18, 64),           # nothing to launch
])
def test_two_layer_plans_that_cannot_run_are_refused(args):
    with pytest.raises(ValueError):
        F.plan_two_layer(*args)
    if args[0]:
        assert not F.two_layer_supported(*args[1:])


@pytest.mark.parametrize("args", [
    (N_TIME, 33, 512, 256, P_DIM, Q_DIM),   # 1 MiB of layer weights
    (N_TIME, 33, 128, 64, 120, Q_DIM),      # P off the 16-row tiles
    (N_TIME, 33, 128, 64, P_DIM, 4096),     # the head's tiles past 227 KiB
    (N_TIME, 32, 128, 64, P_DIM, Q_DIM),     # an even window
])
def test_center_head_plans_that_cannot_run_are_refused(args):
    with pytest.raises(ValueError):
        F.plan_center_head(*args)
    assert not F.center_head_supported(*args[1:])


@pytest.mark.parametrize("d_x,hidden", [(18, 64), (128, 64), (10, 16)])
def test_shared_weight_layout_holds_the_tiles_the_product_reads(d_x,
                                                                  hidden):
    """csrc/bilstm_layer.cuh: cp_async_layer_weights copies piece i of the
    shared layout from packed tile (g H/16 + u, kt) with (u, kt, g) from
    i // 32; mma_gates reads gate g of k-tile kt of unit group u at
    ((u Kp/16 + kt) 4 + g) 32. The map is a permutation, and each read
    finds its tile."""
    g_ = torch.Generator().manual_seed(d_x + hidden)
    w_ih = torch.randn(2, d_x, 4 * hidden, generator=g_).bfloat16()
    w_hh = torch.randn(2, hidden, 4 * hidden, generator=g_).bfloat16()
    packed = K.pack_weights(w_ih, w_hh)[1]        # direction 1
    h_tiles, k_tiles = hidden // 16, (_pad16(d_x) + hidden) // 16
    flat = packed.reshape(-1, 8)                  # 16-byte pieces
    src = []
    for i in range(4 * h_tiles * k_tiles * 32):   # the kernel's index map
        tile, lane = i >> 5, i & 31
        g, rest = tile & 3, tile >> 2
        u, kt = rest // k_tiles, rest % k_tiles
        src.append(((g * h_tiles + u) * k_tiles + kt) * 32 + lane)
    assert sorted(src) == list(range(len(src)))
    shared = flat[torch.tensor(src)]
    for u in range(h_tiles):
        for kt in range(k_tiles):
            for g in range(4):
                at = ((u * k_tiles + kt) * 4 + g) * 32
                assert torch.equal(shared[at:at + 32],
                                   packed[g * h_tiles + u, kt])


def _head(seed, hidden, rows):
    g_ = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g_) * 0.1

    return (r(P_DIM, 2 * hidden).bfloat16(), r(P_DIM),
            r(Q_DIM, P_DIM).bfloat16(), r(Q_DIM),
            r(rows, Q_DIM).bfloat16(), r(rows))


@pytest.mark.parametrize("n,rows", [(1, 24), (65, 24), (300, 96),
                                    (3001, 96)])
def test_split_head_is_head_plain_bit_for_bit(n, rows):
    """The kernel deals each cluster's bn rows to its two CTAs, bn/2 each,
    and a CTA runs the whole head on its rows: proj, dense and the heads,
    every output's K sum whole in one warp. Dealing rows reorders no sum,
    so the split head is the head, on the batch as the kernel holds it:
    padded with zero rows to whole cluster tiles (the padding's logits are
    computed and dropped)."""
    plan = F.plan_center_head(n, 33, 128, 64, P_DIM, Q_DIM)
    head = _head(n + rows, 64, rows)
    ctr = torch.zeros(plan.grid[0] // 2 * plan.bn, 128)
    ctr[:n] = torch.randn(n, 128, generator=torch.Generator().manual_seed(n))
    want = F.head_plain(ctr, head)
    got = torch.full_like(want, float("nan"))
    half = plan.bn // 2
    for cluster in range(plan.grid[0] // 2):
        for cta in (0, 1):
            lo = cluster * plan.bn + cta * half
            got[lo:lo + half] = F.head_plain(ctr[lo:lo + half], head)
    assert torch.equal(got, want)


def test_packed_head_is_what_the_kernel_reads():
    head = _head(3, 64, 24)
    wp_pk, wd_pk, wh_pk, bh_pad = F.pack_head(head)
    assert torch.equal(wp_pk, K.pack_a_fragments(head[0][None])[0])
    assert torch.equal(wd_pk, K.pack_a_fragments(head[2][None])[0])
    wh16 = torch.cat([head[4], head[4].new_zeros(8, Q_DIM)])
    assert torch.equal(wh_pk, K.pack_a_fragments(wh16[None])[0])
    assert torch.equal(bh_pad, torch.cat([head[5], torch.zeros(8)]))
    assert all(t.is_contiguous() for t in (wp_pk, wd_pk, wh_pk, bh_pad))
    assert F._check_head_packed(head, (wp_pk, wd_pk, wh_pk, bh_pad))
    with pytest.raises(ValueError):        # the wrapper packs nothing
        F._check_head_packed(head, None)
    with pytest.raises(ValueError):
        F._check_head_packed(head, (wp_pk, wd_pk, wp_pk, bh_pad))
    w_ih = torch.zeros(2, 18, 256, dtype=torch.bfloat16)
    w_hh = torch.zeros(2, 64, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        F._require_packed(w_ih, w_hh, None)


def _counting(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counting(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(module, name, counting)
    return calls, real


def test_pileup_model_packs_its_head_once_and_again_after_an_update(
        monkeypatch):
    monkeypatch.setenv("NSP_FUSE_HEAD", "1")
    monkeypatch.delenv("NSP_FUSE_LAYERS", raising=False)
    packs, real = _counting(monkeypatch, PM, "pack_head")
    # hidden 48: the last layer is not K-fusable, so the head runs in the
    # center kernel's route
    cfg = PileupModelConfig(seq_len=9, hidden_size=48, output_size=32,
                            inner_size=48)
    params = init_pileup_params(torch.Generator().manual_seed(4), cfg)
    model = PileupModel(cfg, params)
    x = torch.randn(7, 9, 18, generator=torch.Generator().manual_seed(5))
    heads = M.bilstm_center_head
    seen = []
    monkeypatch.setattr(M, "bilstm_center_head",
                        lambda *a: seen.append(a) or heads(*a))
    outs = [model(x, compute_dtype=torch.bfloat16) for _ in range(3)]
    assert len(packs) == 1 and len(seen) == 3   # one per head, not per call
    assert all(torch.equal(o[0], outs[0][0]) for o in outs)
    head, head_packed = model.fused_head(HEADS)
    assert len(packs) == 1
    assert seen[-1][4] is head and seen[-1][6] is head_packed
    assert all(torch.equal(a, b) for a, b in zip(head_packed, real(head)))
    model(x, compute_dtype=torch.bfloat16, all_heads=False)
    assert len(packs) == 2                      # gt + zy: another head
    with torch.no_grad():
        model.dense.w.mul_(0.5)                 # an optimizer step, in place
    updated = model(x, compute_dtype=torch.bfloat16)
    assert len(packs) == 3
    assert not torch.equal(updated[0], outs[0][0])
    fresh = PileupModel(cfg, params)
    with torch.no_grad():
        fresh.dense.w.mul_(0.5)
    want = fresh(x, compute_dtype=torch.bfloat16)
    for a, b in zip(updated, want):
        assert torch.equal(a, b)


def test_two_layer_route_packs_nothing_on_a_second_forward(monkeypatch):
    monkeypatch.setenv("NSP_FUSE_LAYERS", "1")
    packs, real = _counting(monkeypatch, M, "pack_weights")
    calls, _ = _counting(monkeypatch, M, "bilstm2_center")
    rng = np.random.default_rng(6)
    layers = []
    for d_in in (18, 32):
        layers.append({
            "w_ih": rng.uniform(-0.25, 0.25, (2, d_in, 64)),
            "w_hh": rng.uniform(-0.25, 0.25, (2, 16, 64)),
            "b": rng.uniform(-0.5, 0.5, (2, 64))})
    enc = M.BiLSTM(layers)
    x = torch.from_numpy(rng.standard_normal((5, 9, 18)).astype(np.float32))
    first = M.bilstm_encoder_fused(enc.layers, x, center_only=True)
    assert len(packs) == 2 and len(calls) == 1  # one pack per layer
    second = M.bilstm_encoder_fused(enc.layers, x, center_only=True)
    assert len(packs) == 2 and len(calls) == 2  # none on the second call
    assert torch.equal(first, second)
    for layer, got in zip(enc.layers, calls[-1][7:9]):
        w_ih, w_hh = layer.kernel_weights()[:2]
        assert torch.equal(got, real(w_ih, w_hh))


@pytest.mark.parametrize("variant", sorted(KO.VARIANTS))
def test_fused_knockouts_find_their_parts_in_the_two_layer_kernel(variant):
    src = (build.CSRC / "bilstm_fused.cu").read_text()
    out = KO.knock_out(src, KO.VARIANTS[variant])
    k0, k1 = src.index(KO.KERNEL), src.index(KO.END)
    # only the two-layer kernel and its unroll change, and only there
    assert out[:k0] == src[:k0]
    assert out.endswith(src[k1:])
    assert (out == src) == (variant == "all")
    body = out[k0:out.index(KO.END)]
    for old, new in KO.VARIANTS[variant]:
        assert old not in body and new in body
    # every variant still copies both layers' weights and meets its peer
    assert body.count("cp_async_layer_weights(") == 2
    assert "cluster_wait();" in body
    assert body.count("fused_layer<") == 2 - sum(
        part in KO.VARIANTS[variant] for part in (KO.LAYER1, KO.LAYER2))
