"""The port's BiLSTM kernel module against the JAX package.

On the CPU the kernel wrappers run their plain PyTorch versions, which
keep the CUDA kernels' cast sites; they are held against the Pallas
kernels run in interpret mode (`bilstm_encoder_pallas(interpret=True)`),
and the f32 loop against the JAX f32 scan path. The CUDA kernels
themselves are held against the same plain versions on the card by
chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nanosnp_tpu.models.bilstm import bilstm_encoder as jax_bilstm_encoder
from nanosnp_tpu.ops.pallas_lstm import bilstm_encoder_pallas
from nanosnp_tpu_torch.models.bilstm import (BiLSTM, bilstm_encoder,
                                             bilstm_encoder_fused)
from nanosnp_tpu_torch.models.convert import params_from_jax
from nanosnp_tpu_torch.ops import bilstm as K

# Same cast sites on both sides (bf16 operands, f32 accumulation, f32 cell,
# bf16 between layers), so what remains is f32 summation order, which can
# flip the bf16 rounding of an inner-layer activation (one bf16 ulp is
# 2^-8 near 1) and carry up to about 1e-3 into the next layer's f32
# output. Typical gaps are 1e-7 .. 1e-5.
BF16_TOL = 2e-3
# f32 throughout: summation order only
F32_TOL = 2e-5


def _layers(rng, d_in, hidden, n_layers):
    k = 1.0 / np.sqrt(hidden)
    out = []
    for i in range(n_layers):
        d = d_in if i == 0 else 2 * hidden
        out.append({
            "w_ih": rng.uniform(-k, k, (2, d, 4 * hidden)).astype(np.float32),
            "w_hh": rng.uniform(-k, k, (2, hidden, 4 * hidden)).astype(
                np.float32),
            "b": rng.uniform(-2 * k, 2 * k, (2, 4 * hidden)).astype(
                np.float32)})
    return out


def _bf16_input(rng, n, seq_len, d):
    x = rng.standard_normal((n, seq_len, d)).astype(np.float32)
    # round once through bf16 so both sides start from the same values
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


# (d_in, hidden, layers, center_only) at N=16, L=11 (a short window
# keeps interpret mode quick). D=18, H=64 is the pileup model:
# the JAX side runs _enc_stream_kfused_kernel (D padded to 32, 32+64 <=
# 128) then _enc_center_kernel. D=105 is not K-fusable: _enc_stream_kernel
# then _enc_center_kernel. center_only=False streams every layer.
CASES = [(18, 64, 2, True), (105, 64, 2, True), (18, 64, 2, False)]


@pytest.mark.parametrize("d_in,hidden,n_layers,center_only", CASES)
def test_fused_encoder_matches_pallas_interpret(monkeypatch, d_in, hidden,
                                                n_layers, center_only):
    monkeypatch.delenv("NSP_FUSE_LAYERS", raising=False)
    rng = np.random.default_rng(100 + d_in)
    layers = _layers(rng, d_in, hidden, n_layers)
    x = _bf16_input(rng, 16, 11, d_in)
    want = np.asarray(bilstm_encoder_pallas(
        [jax.tree.map(jnp.asarray, p) for p in layers], jnp.asarray(x),
        block_n=8, interpret=True, center_only=center_only))
    enc = BiLSTM(params_from_jax(layers))
    got = bilstm_encoder_fused(enc.layers, torch.from_numpy(x),
                               center_only=center_only)
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_TOL, rtol=0)
    # most entries agree far more closely than the bound
    assert np.median(np.abs(got.numpy() - want)) < 1e-4


def test_f32_loop_matches_jax_scan():
    rng = np.random.default_rng(7)
    layers = _layers(rng, 18, 32, 2)
    x = rng.standard_normal((12, 11, 18)).astype(np.float32)
    want = np.asarray(jax_bilstm_encoder(
        [jax.tree.map(jnp.asarray, p) for p in layers], jnp.asarray(x)))
    got = bilstm_encoder(BiLSTM(params_from_jax(layers)).layers,
                         torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


def _kernel_args(seed, n=6, seq_len=9, d_in=10, hidden=32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, seq_len, d_in, generator=g).bfloat16()
    w_ih = (torch.randn(2, d_in, 4 * hidden, generator=g) * 0.2).bfloat16()
    w_hh = (torch.randn(2, hidden, 4 * hidden, generator=g) * 0.2).bfloat16()
    b = torch.randn(2, 4 * hidden, generator=g) * 0.1
    return x, w_ih, w_hh, b


@pytest.mark.parametrize("seq_len", [9, 8])
def test_center_equals_stream_at_center(seq_len):
    """The center kernel's early stop gives exactly the streamed state at
    t = L//2 (odd and even L)."""
    x, w_ih, w_hh, b = _kernel_args(1, seq_len=seq_len)
    full = K.bilstm_stream(x, w_ih, w_hh, b, torch.float32)
    ctr = K.bilstm_center(x, w_ih, w_hh, b)
    torch.testing.assert_close(ctr, full[:, seq_len // 2], atol=0, rtol=0)


def test_stream_direction_one_runs_backwards():
    """Direction 1 at its first step sees only x[L-1]: its output at
    t = L-1 must not change when every other timestep changes."""
    x, w_ih, w_hh, b = _kernel_args(2)
    x2 = x.clone()
    x2[:, :-1] = torch.randn_like(x2[:, :-1].float()).bfloat16()
    hidden = w_hh.shape[1]
    a = K.bilstm_stream(x, w_ih, w_hh, b, torch.float32)
    c = K.bilstm_stream(x2, w_ih, w_hh, b, torch.float32)
    torch.testing.assert_close(a[:, -1, hidden:], c[:, -1, hidden:],
                               atol=0, rtol=0)
    assert not torch.equal(a[:, -1, :hidden], c[:, -1, :hidden])


def test_stream_bf16_output_is_rounded_f32_output():
    x, w_ih, w_hh, b = _kernel_args(3)
    f32 = K.bilstm_stream(x, w_ih, w_hh, b, torch.float32)
    bf = K.bilstm_stream(x, w_ih, w_hh, b, torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf, f32.bfloat16(), atol=0, rtol=0)


def test_wrappers_reject_bad_inputs():
    x, w_ih, w_hh, b = _kernel_args(4)
    with pytest.raises(TypeError):
        K.bilstm_stream(x.float(), w_ih, w_hh, b)
    with pytest.raises(ValueError):
        K.bilstm_center(x[:, :, :-1], w_ih, w_hh, b)
    with pytest.raises(ValueError):
        K.bilstm_stream(x.to("meta"), w_ih.to("meta"), w_hh.to("meta"),
                        b.to("meta"))


def test_plain_versions_count_no_launches():
    K.reset_launch_counts()
    x, w_ih, w_hh, b = _kernel_args(5)
    K.bilstm_stream(x, w_ih, w_hh, b)
    K.bilstm_center(x, w_ih, w_hh, b)
    assert {"bilstm_stream", "bilstm_center"} <= set(K.LAUNCHES)
    assert set(K.LAUNCHES.values()) == {0}


def test_layer_cost_counts_center_steps():
    flop_s, bytes_s = K.layer_cost(8192, 33, 512, 256, center=False)
    flop_c, bytes_c = K.layer_cost(8192, 33, 512, 256, center=True)
    assert flop_s == 2 * 8192 * 2 * 33 * 1024 * 768
    assert flop_c * 33 == flop_s * 17
    assert bytes_c < bytes_s


def test_pack_weights_is_the_mma_a_fragment_layout():
    """Unpack with the PTX ISA's m16n8k16 A-fragment map (element i of lane
    l: row l/4 + 8 for i in {2,3,6,7}, column 2(l%4) + (i&1) + 8 for
    i >= 4) and recover [w_ih (zero-padded) ; w_hh]^T exactly."""
    _, w_ih, w_hh, _ = _kernel_args(6, d_in=18, hidden=32)
    pk = K.pack_weights(w_ih, w_hh)
    d_pad, four_h = 32, 128
    assert tuple(pk.shape) == (2, four_h // 16, (d_pad + 32) // 16, 32, 8)
    want = torch.zeros(2, four_h, d_pad + 32, dtype=torch.bfloat16)
    want[:, :, :18] = w_ih.transpose(1, 2)
    want[:, :, d_pad:] = w_hh.transpose(1, 2)
    got = torch.zeros_like(want)
    for lane in range(32):
        for i in range(8):
            row = lane // 4 + (8 if i in (2, 3, 6, 7) else 0)
            col = 2 * (lane % 4) + (i & 1) + (8 if i >= 4 else 0)
            for mt in range(pk.shape[1]):
                for kt in range(pk.shape[2]):
                    got[:, mt * 16 + row, kt * 16 + col] = pk[:, mt, kt,
                                                              lane, i]
    torch.testing.assert_close(got, want, atol=0, rtol=0)
