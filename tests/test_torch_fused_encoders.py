"""The pileup encoder's opt-in routes against the JAX package's.

On the CPU the wrappers run their plain PyTorch versions, which keep the
CUDA kernels' cast sites; they are held against the Pallas kernels in
interpret mode, reached the way a user reaches them: `pileup_forward`
under NSP_FUSE_HEAD=1 (`_enc_center_head_kernel`), `bilstm_encoder_pallas`
under NSP_FUSE_LAYERS=1 (`_enc2_center_kernel`), and a one-layer encoder
(`_enc_center_kfused_kernel`). The CUDA kernels are held against the same
plain versions on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nanosnp_tpu.config import PileupModelConfig as JaxPileupConfig
from nanosnp_tpu.models.pileup_model import pileup_forward as jax_forward
from nanosnp_tpu.ops import pallas_lstm
from nanosnp_tpu_torch.config import PileupModelConfig
from nanosnp_tpu_torch.models import bilstm as M
from nanosnp_tpu_torch.models.convert import params_from_jax
from nanosnp_tpu_torch.models.pileup_model import PileupModel
from nanosnp_tpu_torch.ops import bilstm as K
from nanosnp_tpu_torch.ops import bilstm_fused as F

# Same cast sites on both sides (bf16 operands, f32 accumulation, f32 cell,
# bf16 between layers and between the head's products): what remains is f32
# summation order, which can flip a bf16 rounding (2^-8 relative) and carry
# about 1e-3 into the next layer's f32 output. Typical gaps are ~1e-6.
BF16_TOL = 2e-3


def _lin(rng, d_in, d_out):
    k = 1.0 / np.sqrt(d_in)
    return {"w": rng.uniform(-k, k, (d_in, d_out)).astype(np.float32),
            "b": rng.uniform(-k, k, (d_out,)).astype(np.float32)}


def _layers(rng, d_in, hidden, n_layers):
    k = 1.0 / np.sqrt(hidden)
    return [{"w_ih": rng.uniform(-k, k, (2, d_in if i == 0 else 2 * hidden,
                                         4 * hidden)).astype(np.float32),
             "w_hh": rng.uniform(-k, k, (2, hidden, 4 * hidden)).astype(
                 np.float32),
             "b": rng.uniform(-2 * k, 2 * k, (2, 4 * hidden)).astype(
                 np.float32)} for i in range(n_layers)]


def _pileup_params(rng, cfg):
    return {"encoder": _layers(rng, cfg.feature_dim, cfg.hidden_size,
                               cfg.n_layers),
            "proj": _lin(rng, 2 * cfg.hidden_size, cfg.output_size),
            "dense": _lin(rng, cfg.output_size, cfg.inner_size),
            "gt": _lin(rng, cfg.inner_size, cfg.gt_num_class),
            "zy": _lin(rng, cfg.inner_size, cfg.zy_num_class),
            "id1": _lin(rng, cfg.inner_size, cfg.indel1_num_class),
            "id2": _lin(rng, cfg.inner_size, cfg.indel2_num_class)}


def _bf16_input(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return calls


# hidden 48: layer 2's D = 96, 96 + 48 > 128, so the last layer is not
# K-fusable and both packages apply the head inside the center kernel;
# hidden 16 is K-fusable: center kernel, then the plain head.
@pytest.mark.parametrize("hidden,all_heads,in_kernel",
                         [(48, True, True), (48, False, True),
                          (16, True, False)])
def test_fuse_head_matches_pallas_interpret(monkeypatch, hidden, all_heads,
                                            in_kernel):
    monkeypatch.setenv("NSP_FUSE_HEAD", "1")
    monkeypatch.delenv("NSP_FUSE_LAYERS", raising=False)
    kw = dict(seq_len=9, hidden_size=hidden, output_size=32, inner_size=48)
    rng = np.random.default_rng(hidden + all_heads)
    params = _pileup_params(rng, PileupModelConfig(**kw))
    x = _bf16_input(rng, (10, 9, 18))
    jax_calls = _spy(monkeypatch, pallas_lstm, "_run_enc_center_head")
    want = jax_forward(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                       JaxPileupConfig(**kw), all_heads=all_heads,
                       use_pallas=True, pallas_interpret=True)
    assert bool(jax_calls) == in_kernel
    calls = _spy(monkeypatch, M, "bilstm_center_head")
    model = PileupModel(PileupModelConfig(**kw), params_from_jax(params))
    got = model(torch.from_numpy(x), compute_dtype=torch.bfloat16,
                all_heads=all_heads)
    assert bool(calls) == in_kernel
    assert [g is None for g in got] == [w is None for w in want]
    for g, w in zip(got, want):
        if w is not None:
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=BF16_TOL, rtol=0)
    # the route changes where the head runs, not what it computes
    monkeypatch.setenv("NSP_FUSE_HEAD", "0")
    base = model(torch.from_numpy(x), compute_dtype=torch.bfloat16,
                 all_heads=all_heads)
    for g, b in zip(got, base):
        if b is not None:
            torch.testing.assert_close(g, b, atol=1e-5, rtol=0)


def test_fuse_layers_matches_pallas_interpret(monkeypatch):
    """The gate test of the JAX package's two-layer fusion: D 18, H 16,
    two layers, N 17, L 33, center only."""
    rng = np.random.default_rng(11)
    layers = _layers(rng, 18, 16, 2)
    x = _bf16_input(rng, (17, 33, 18))
    jl = [jax.tree.map(jnp.asarray, p) for p in layers]
    enc = M.BiLSTM(params_from_jax(layers))
    monkeypatch.setenv("NSP_FUSE_LAYERS", "0")
    split = M.bilstm_encoder_fused(enc.layers, torch.from_numpy(x),
                                   center_only=True)
    monkeypatch.setenv("NSP_FUSE_LAYERS", "1")
    jax_calls = _spy(monkeypatch, pallas_lstm, "_run_enc2_center")
    want = np.asarray(pallas_lstm.bilstm_encoder_pallas(
        jl, jnp.asarray(x), block_n=8, interpret=True, center_only=True))
    assert jax_calls
    calls = _spy(monkeypatch, M, "bilstm2_center")
    got = M.bilstm_encoder_fused(enc.layers, torch.from_numpy(x),
                                 center_only=True)
    assert calls and tuple(got.shape) == want.shape == (17, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_TOL, rtol=0)
    assert np.median(np.abs(got.numpy() - want)) < 1e-4
    # same cast sites as the per-layer path: the plain versions agree exactly
    torch.testing.assert_close(got, split, atol=0, rtol=0)


def test_both_variables_run_two_layer_kernel_and_plain_head(monkeypatch):
    monkeypatch.setenv("NSP_FUSE_HEAD", "1")
    monkeypatch.setenv("NSP_FUSE_LAYERS", "1")
    kw = dict(seq_len=9, hidden_size=16, output_size=32, inner_size=48)
    rng = np.random.default_rng(5)
    params = _pileup_params(rng, PileupModelConfig(**kw))
    x = _bf16_input(rng, (9, 9, 18))
    want = jax_forward(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                       JaxPileupConfig(**kw), all_heads=False,
                       use_pallas=True, pallas_interpret=True)
    two = _spy(monkeypatch, M, "bilstm2_center")
    head = _spy(monkeypatch, M, "bilstm_center_head")
    got = PileupModel(PileupModelConfig(**kw), params_from_jax(params))(
        torch.from_numpy(x), compute_dtype=torch.bfloat16, all_heads=False)
    assert two and not head
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BF16_TOL,
                                   rtol=0)


def test_one_layer_route_matches_center_kfused_interpret(monkeypatch):
    """A one-layer pileup encoder (D 18 padded to 32, 32 + H <= 128): the
    JAX package runs `_enc_center_kfused_kernel`, the port `bilstm_center`."""
    monkeypatch.delenv("NSP_FUSE_LAYERS", raising=False)
    rng = np.random.default_rng(8)
    layers = _layers(rng, 18, 32, 1)
    x = _bf16_input(rng, (13, 33, 18))
    jax_calls = _spy(monkeypatch, pallas_lstm, "_run_enc_center_kfused")
    want = np.asarray(pallas_lstm.bilstm_encoder_pallas(
        [jax.tree.map(jnp.asarray, p) for p in layers], jnp.asarray(x),
        block_n=8, interpret=True, center_only=True))
    assert jax_calls
    calls = _spy(monkeypatch, M, "bilstm_center")
    got = M.bilstm_encoder_fused(M.BiLSTM(params_from_jax(layers)).layers,
                                 torch.from_numpy(x), center_only=True)
    assert calls == ["bilstm_center"]
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_TOL, rtol=0)
    assert np.median(np.abs(got.numpy() - want)) < 1e-5


def _kernel_args(seed, n=6, seq_len=9, d_in=10, hidden=16):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, seq_len, d_in, generator=g).bfloat16()
    w_ih = (torch.randn(2, d_in, 4 * hidden, generator=g) * 0.2).bfloat16()
    w_hh = (torch.randn(2, hidden, 4 * hidden, generator=g) * 0.2).bfloat16()
    b = torch.randn(2, 4 * hidden, generator=g) * 0.1
    return x, w_ih, w_hh, b


def _head(seed, hidden, p_dim=16, q_dim=32, rows=24):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.2

    return (r(p_dim, 2 * hidden).bfloat16(), r(p_dim),
            r(q_dim, p_dim).bfloat16(), r(q_dim),
            r(rows, q_dim).bfloat16(), r(rows))


def test_center_head_is_the_head_on_the_center_state():
    x, w_ih, w_hh, b = _kernel_args(1)
    head = _head(2, 16)
    got = F.bilstm_center_head(x, w_ih, w_hh, b, head)
    assert got.dtype == torch.float32 and tuple(got.shape) == (6, 24)
    ctr = K.bilstm_center(x, w_ih, w_hh, b)
    torch.testing.assert_close(got, F.head_plain(ctr, head), atol=0, rtol=0)
    # the head rounds its operands to bf16 at each product
    wp, bp, wd, bd, wh, bh = head
    feat = ctr.bfloat16().float() @ wp.float().T + bp
    feat = torch.tanh(feat.bfloat16().float() @ wd.float().T + bd)
    torch.testing.assert_close(
        got, feat.bfloat16().float() @ wh.float().T + bh, atol=1e-6, rtol=0)


def test_fused_wrappers_reject_bad_inputs_and_count_no_plain_calls():
    K.reset_launch_counts()
    x, w_ih, w_hh, b = _kernel_args(3)
    l2 = _kernel_args(4, d_in=32)[1:]
    F.bilstm2_center(x, w_ih, w_hh, b, *l2)
    F.bilstm_center_head(x, w_ih, w_hh, b, _head(5, 16))
    assert K.LAUNCHES["bilstm2_center"] == 0
    assert K.LAUNCHES["bilstm_center_head"] == 0
    with pytest.raises(ValueError):          # layer 2 must take 2H inputs
        F.bilstm2_center(x, w_ih, w_hh, b, w_ih, w_hh, b)
    with pytest.raises(ValueError):          # head contracts over 2H
        F.bilstm_center_head(x, w_ih, w_hh, b, _head(5, 8))
    with pytest.raises(TypeError):           # head weights are bf16
        F.bilstm_center_head(x, w_ih, w_hh, b,
                             tuple(t.float() for t in _head(5, 16)))
    with pytest.raises(ValueError):
        M.bilstm_encoder_fused([], x, center_only=False, head=_head(5, 16))


def test_kernel_limits_are_stated_rules():
    # the pileup shapes fit; an even window or a layer whose weights fill
    # no CTA do not, and the encoder then takes the per-layer kernels
    assert F.center_head_supported(33, 128, 64, 128, 256)
    assert F.two_layer_supported(33, 18, 64)
    assert not F.center_head_supported(32, 128, 64, 128, 256)
    assert not F.center_head_supported(33, 512, 256, 128, 256)
    assert not F.two_layer_supported(33, 105, 256)
    # layer 1's states pass through device memory: a long window fits
    assert F.two_layer_supported(65, 18, 64)
    # one direction of both layers' weights in a CTA: 48 + 384 KiB at H 128
    assert not F.two_layer_supported(11, 18, 128)
    assert M.k_fusable(18, 64) and not M.k_fusable(128, 64)


def test_unsupported_shapes_take_the_per_layer_kernels(monkeypatch):
    monkeypatch.setenv("NSP_FUSE_LAYERS", "1")
    two = _spy(monkeypatch, M, "bilstm2_center")
    rng = np.random.default_rng(3)
    enc = M.BiLSTM(params_from_jax(_layers(rng, 10, 16, 2)))
    x = torch.from_numpy(_bf16_input(rng, (5, 8, 10)))      # even L
    out = M.bilstm_encoder_fused(enc.layers, x, center_only=True)
    assert not two and tuple(out.shape) == (5, 32)
    monkeypatch.setattr(M, "two_layer_supported", lambda *a: False)
    x = torch.from_numpy(_bf16_input(rng, (5, 9, 10)))
    M.bilstm_encoder_fused(enc.layers, x, center_only=True)
    assert not two


def test_fused_costs_count_what_the_kernels_must_do():
    flop, nbytes = F.two_layer_cost(8192, 33, 18, 64)
    assert flop == 2 * 8192 * 2 * 256 * (33 * (18 + 64) + 17 * (128 + 64))
    # no inter-layer bytes: x in, weights and biases, the center state out
    assert nbytes == (8192 * 33 * 18 * 2 + 2 * (18 + 64) * 256 * 2
                      + 2 * (128 + 64) * 256 * 2 + 2 * 2 * 256 * 4
                      + 8192 * 128 * 4)
    flop_h, bytes_h = F.center_head_cost(8192, 33, 128, 64, 128, 256, 24)
    flop_c, bytes_c = K.layer_cost(8192, 33, 128, 64, center=True)
    assert flop_h - flop_c == 2 * 8192 * (128 * 128 + 128 * 256 + 256 * 24)
    assert bytes_h < bytes_c + 2 * (128 * 128 + 128 * 256 + 256 * 24) + 4096
