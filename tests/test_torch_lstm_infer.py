"""The port's inference recurrence (`lstm_recurrence_infer`) against the
JAX package's `_kernel`, its plan, and the dispatch of `lstm_recurrence`.

On the CPU the wrapper runs its plain PyTorch version, which keeps the
CUDA kernels' cast sites. It is held against `bilstm_layer_pallas`
(interpret mode, no differentiation: the primal `_kernel`, with f32 xp and,
at the CatModel's width, bf16 xp too) and against
`bilstm_encoder_pallas(fused=False)` (xp rounded to bf16 before the
kernel). `plan_infer` takes the smem forward at H=64 (its shared memory
as the C launcher reckons it, for f32 and bf16 xp), the cluster forward at
H=256 and the packed kernel elsewhere; an emulation of the smem forward's
arithmetic (its SFU gate formulas, bf16 h, f32 cell) stays within the
card's tolerance of the plain version. The CUDA kernels are held against
the same plain version on the card by chip_smoke.py.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import TRAIN_TOL
from nanosnp_tpu.ops.pallas_lstm import (bilstm_encoder_pallas,
                                         bilstm_layer_pallas)
from nanosnp_tpu_torch.models.bilstm import BiLSTM, bilstm_encoder_unfused
from nanosnp_tpu_torch.models.convert import params_from_jax
from nanosnp_tpu_torch.ops import lstm_train as T
from nanosnp_tpu_torch.ops.bilstm import (CLUSTER, LAUNCHES, SMEM_MAX,
                                          SMEM_SM, reset_launch_counts)
from nanosnp_tpu_torch.ops.build import CSRC
from test_torch_bilstm_plan import _sigmoid4, _tanh2

# bf16 cast sites on both sides (w_hh and h_{t-1} rounded to bf16, f32
# accumulation, f32 cell): what remains is f32 summation order, which can
# flip the bf16 rounding of an h_{t-1} (2^-8 relative) and carry a few 1e-4
# into later steps; typical gaps are ~1e-7.
BF16_TOL = 1e-3
# the fused=False encoder rounds xp and the activations between layers to
# bf16 too, so a flipped rounding can carry about 1e-3 into the next layer
ENC_TOL = 2e-3


def _to_jax_layout(a):
    """[N, L, 2, F] true time -> [L, 2, N, F], direction 1 pre-reversed."""
    a = np.transpose(a, (1, 2, 0, 3))
    return np.stack([a[:, 0], a[::-1, 1]], axis=1)


def _from_jax_layout(a):
    a = np.stack([a[:, 0], a[::-1, 1]], axis=1)
    return np.ascontiguousarray(np.transpose(a, (2, 0, 1, 3)))


def _inputs(seed, n, seq_len, hidden):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(hidden)
    xp = rng.standard_normal((n, seq_len, 2, 4 * hidden)).astype(np.float32)
    w_hh = rng.uniform(-k, k, (2, hidden, 4 * hidden)).astype(np.float32)
    return xp, w_hh


# N ragged against the Pallas tile (8) and the CUDA kernel's (32)
@pytest.mark.parametrize("n,seq_len,hidden", [(5, 9, 16), (13, 11, 32)])
def test_infer_f32_xp_matches_pallas_primal(n, seq_len, hidden):
    xp, w_hh = _inputs(n + seq_len, n, seq_len, hidden)
    want = _from_jax_layout(np.asarray(bilstm_layer_pallas(
        jnp.asarray(_to_jax_layout(xp)), jnp.asarray(w_hh), block_n=8,
        interpret=True)))
    got = T.lstm_recurrence_infer(torch.from_numpy(xp),
                                  torch.from_numpy(w_hh).bfloat16())
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_TOL, rtol=0)
    assert np.median(np.abs(got.numpy() - want)) < 1e-5


@pytest.mark.parametrize("xp_dtype", [jnp.float32, jnp.bfloat16])
def test_infer_at_the_catmodel_width_matches_pallas_primal(xp_dtype):
    """H=256, L=11 (the CatModel's recurrences, the cluster path on the
    card), a few rows; bf16 xp is widened on load on both sides."""
    n, seq_len, hidden = 3, 11, 256
    xp, w_hh = _inputs(41, n, seq_len, hidden)
    xp_j = jnp.asarray(_to_jax_layout(xp)).astype(xp_dtype)
    want = _from_jax_layout(np.asarray(bilstm_layer_pallas(
        xp_j, jnp.asarray(w_hh), block_n=8, interpret=True)))
    xp_t = torch.from_numpy(_from_jax_layout(np.asarray(
        xp_j.astype(jnp.float32))))
    if xp_dtype == jnp.bfloat16:
        xp_t = xp_t.bfloat16()        # exact: the values are bf16 already
    assert T.plan_infer(n, seq_len, hidden).path == "cluster"
    got = T.lstm_recurrence_infer(xp_t, torch.from_numpy(w_hh).bfloat16())
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_TOL, rtol=0)
    assert np.median(np.abs(got.numpy() - want)) < 1e-5


@pytest.mark.parametrize("n", [1, 65, 3001, 8192])
def test_plan_infer_takes_the_cluster_path_at_256(n):
    """The training forward's cluster plan, without its cell-state stream:
    C=4, 64 rows a cluster, the same shared memory; N=8192 is 256
    clusters, nine rounds of the 30 resident."""
    plan = T.plan_infer(n, 11, 256)
    train = T.plan_train(n, 11, 256)
    assert plan.path == "cluster" and (plan.cluster, plan.bn) == CLUSTER
    assert plan.grid == train.grid == (-(-n // 64) * 4, 2)
    assert plan.smem == train.fwd_smem == T.cluster_smem_bytes()[0] \
        <= SMEM_MAX
    clusters = plan.grid[0] // plan.cluster * plan.grid[1]
    if n == 8192:
        assert clusters == 256
        assert -(-clusters // T.CLUSTERS_RESIDENT) == 9


@pytest.mark.parametrize("hidden", [16, 128])
def test_plan_infer_takes_the_packed_path_off_256(hidden):
    plan = T.plan_infer(3001, 33, hidden)
    assert plan.path == "packed" and plan.cluster == 1
    assert plan.grid == (-(-3001 // 32), 2)
    assert plan.smem == 32 * (hidden + 8) * 2


@pytest.mark.parametrize("xp_bytes", [4, 2])
@pytest.mark.parametrize("n", [1, 65, 3001, 8192])
def test_plan_infer_takes_the_smem_path_at_64(n, xp_bytes):
    """The training forward's smem plan, without its cell-state stream:
    32 rows a block, w_hh in shared memory, xp staged in its own dtype. With
    f32 xp the block is the training forward's; with bf16 xp three blocks
    fill an SM's shared memory to the byte."""
    plan = T.plan_infer(n, 33, 64, xp_bytes)
    assert plan.path == "smem" and plan.cluster == 1
    assert plan.bn == T.TRAIN_BN == 32
    assert plan.grid == (-(-n // 32), 2)
    assert plan.smem == T.infer_smem_bytes(64, xp_bytes) <= SMEM_MAX
    assert plan.smem == {4: 109_568, 2: 76_800}[xp_bytes]
    if xp_bytes == 4:
        assert plan.smem == T.plan_train(n, 33, 64).fwd_smem \
            == T.smem_bytes(64)[0]
    assert SMEM_SM // (plan.smem + 1024) == {4: 2, 2: 3}[xp_bytes]
    if n == 8192:
        assert plan.grid[0] * plan.grid[1] == 512


def _c_function(name: str) -> str:
    """The return expression of int `name`(...) in csrc/lstm_train.cu."""
    src = (CSRC / "lstm_train.cu").read_text()
    m = re.search(r"\nint " + name + r"\(int hidden, int xp_bytes\) \{\s*"
                  r"return (.*?);\s*\}", src, re.S)
    assert m, name
    return m.group(1)


@pytest.mark.parametrize("xp_bytes", [4, 2])
def test_infer_smem_bytes_is_what_the_launcher_reckons(xp_bytes):
    """csrc/lstm_train.cu infer_smem_bytes, evaluated with the source's own
    constants, is the Python plan's: the launcher refuses any other."""
    src = (CSRC / "lstm_train.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    expr = _c_function("infer_smem_bytes")
    assert set(re.findall(r"k\w+", expr)) <= set(consts)
    got = eval(f"({expr})", {}, dict(consts, hidden=64, xp_bytes=xp_bytes))
    assert got == T.infer_smem_bytes(64, xp_bytes) \
        == T.plan_infer(8192, 33, 64, xp_bytes).smem


@pytest.mark.parametrize("n,seq_len,hidden",
                         [(5, 3, 72), (5, 3, 8), (5, 3, 0), (0, 3, 64),
                          (5, 0, 64), (5, 3, 272)])
def test_plan_infer_refuses_what_no_kernel_takes(n, seq_len, hidden):
    with pytest.raises(ValueError):
        T.plan_infer(n, seq_len, hidden)


def _smem_forward(xp, w_hh):
    """The smem forward's arithmetic in torch: xp widened to f32 as it is
    read, gates = xp + w_hh^T . bf16(h_{t-1}) summed in f32, the SFU gate
    formulas (sigmoid4 of i, f, o and 2g; tanh2 of c), f32 cell, bf16 h
    carried -> hs [N, L, 2, H] f32."""
    n, seq_len, _, four_h = xp.shape
    hidden = four_h // 4
    hs = torch.empty(n, seq_len, 2, hidden)
    for d in (0, 1):
        w = w_hh[d].float()
        h = torch.zeros(n, hidden)
        c = torch.zeros(n, hidden)
        for s in range(seq_len):
            t = s if d == 0 else seq_len - 1 - s
            acc = xp[:, t, d].float() + h.bfloat16().float() @ w
            i, f, g, o = acc.split(hidden, dim=1)
            si, sf, so, s2g = _sigmoid4([i, f, o, 2.0 * g])
            c = sf * c + si * (2.0 * s2g - 1.0)
            h = _tanh2(c, c)[0] * so
            hs[:, t, d] = h
    return hs


@pytest.mark.parametrize("xp_dtype", [torch.float32, torch.bfloat16])
def test_smem_forward_arithmetic_is_within_the_card_tolerance(xp_dtype):
    """At the pileup shape (L=33, H=64), N ragged against the block's 32
    rows: the kernel's own formulas against the plain version (IEEE
    sigmoid and tanh), within TRAIN_TOL of max(1, max|want|), the tolerance
    chip_smoke.py holds the kernel to on the card."""
    n, seq_len, hidden = 40, 33, 64
    xp, w_hh = _inputs(64, n, seq_len, hidden)
    xp_t = (torch.from_numpy(xp) * 3.0).to(xp_dtype)
    w = torch.from_numpy(w_hh).bfloat16()
    want = T.lstm_recurrence_infer_plain(xp_t, w)
    got = _smem_forward(xp_t, w)
    err = (got - want).abs().max().item()
    assert err / max(1.0, want.abs().max().item()) <= TRAIN_TOL
    assert err > 0      # the formulas are not the plain version's


def _layers(rng, d_in, hidden, n_layers):
    k = 1.0 / np.sqrt(hidden)
    return [{"w_ih": rng.uniform(-k, k, (2, d_in if i == 0 else 2 * hidden,
                                         4 * hidden)).astype(np.float32),
             "w_hh": rng.uniform(-k, k, (2, hidden, 4 * hidden)).astype(
                 np.float32),
             "b": rng.uniform(-2 * k, 2 * k, (2, 4 * hidden)).astype(
                 np.float32)} for i in range(n_layers)]


@pytest.mark.parametrize("n,d_in,hidden,n_layers,center_only",
                         [(13, 18, 16, 2, True), (6, 10, 32, 1, False)])
def test_unfused_encoder_matches_pallas_fused_false(n, d_in, hidden, n_layers,
                                                    center_only):
    """bf16 xp: the in-projection outside the kernel, rounded to bf16."""
    rng = np.random.default_rng(n * d_in)
    layers = _layers(rng, d_in, hidden, n_layers)
    x = np.array(jnp.asarray(rng.standard_normal((n, 11, d_in)),
                             jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(bilstm_encoder_pallas(
        [jax.tree.map(jnp.asarray, p) for p in layers], jnp.asarray(x),
        block_n=8, interpret=True, center_only=center_only, fused=False))
    got = bilstm_encoder_unfused(BiLSTM(params_from_jax(layers)).layers,
                                 torch.from_numpy(x), center_only=center_only)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ENC_TOL, rtol=0)
    assert np.median(np.abs(got.numpy() - want)) < 1e-4


def test_infer_bf16_xp_is_the_widened_f32_run():
    xp, w_hh = _inputs(3, 7, 9, 16)
    xp_bf = torch.from_numpy(xp).bfloat16()
    w = torch.from_numpy(w_hh).bfloat16()
    got = T.lstm_recurrence_infer(xp_bf, w)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, T.lstm_recurrence_infer(xp_bf.float(), w),
                               atol=0, rtol=0)
    # and it equals the training forward's hs on the same inputs
    torch.testing.assert_close(
        got, T.lstm_recurrence_train(xp_bf.float(), w)[0], atol=0, rtol=0)


def _spy(monkeypatch):
    calls = []
    for name in ("lstm_recurrence_infer", "lstm_recurrence_train"):
        real = getattr(T, name)

        def wrapped(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(T, name, wrapped)
    return calls


def test_recurrence_dispatch_follows_gradients(monkeypatch):
    """No gradient wanted -> the inference kernel's wrapper; otherwise the
    autograd op over the training kernels."""
    calls = _spy(monkeypatch)
    xp, w_hh = _inputs(4, 5, 7, 16)
    xp_t = torch.tensor(xp, requires_grad=True)
    w_t = torch.tensor(w_hh).bfloat16()

    with torch.no_grad():
        a = T.lstm_recurrence(xp_t, w_t)
    assert calls == ["lstm_recurrence_infer"] and not a.requires_grad
    calls.clear()
    b = T.lstm_recurrence(xp_t.detach(), w_t)       # nothing requires grad
    assert calls == ["lstm_recurrence_infer"] and not b.requires_grad
    calls.clear()
    c = T.lstm_recurrence(xp_t, w_t)
    assert calls == ["lstm_recurrence_train"] and c.requires_grad
    torch.testing.assert_close(a, c.detach(), atol=0, rtol=0)
    calls.clear()
    T.lstm_recurrence(xp_t.detach(), w_t.float().requires_grad_())
    assert calls == ["lstm_recurrence_train"]


def test_infer_rejects_bad_inputs_and_counts_no_plain_calls():
    reset_launch_counts()
    xp, w_hh = _inputs(5, 4, 5, 16)
    T.lstm_recurrence_infer(torch.from_numpy(xp),
                            torch.from_numpy(w_hh).bfloat16())
    assert LAUNCHES["lstm_recurrence_infer"] == 0
    with pytest.raises(ValueError):
        T.lstm_recurrence_infer(torch.from_numpy(xp[:, :, :1]),
                                torch.from_numpy(w_hh).bfloat16())
    with pytest.raises(ValueError):
        T.lstm_recurrence_infer(torch.from_numpy(xp).to("meta"),
                                torch.from_numpy(w_hh).to("meta"))


def test_infer_cost_counts_no_cell_state_stream():
    flop, nbytes = T.infer_cost(8192, 11, 256)
    flop_t, bytes_t = T.train_cost(8192, 11, 256)
    assert flop == flop_t == 2 * 2 * 8192 * 11 * 1024 * 256
    assert bytes_t - nbytes == 8192 * 11 * 2 * 256 * 4      # cs
    assert nbytes - T.infer_cost(8192, 11, 256, xp_bytes=2)[1] \
        == 8192 * 11 * 2 * 1024 * 2
