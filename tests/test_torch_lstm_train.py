"""The port's training recurrence (ops/lstm_train.py) against the JAX
package's differentiable Pallas recurrence.

On the CPU the kernel wrappers run their plain PyTorch versions, which keep
the CUDA kernels' cast sites; the autograd op over them is held against
`bilstm_layer_pallas(interpret=True)` (forward `_train_kernel`, custom-VJP
backward `_bwd_kernel`): forward hs, and dxp, dW_hh from the gradient of
sum(hs * g_out). The CUDA kernels are held against the same plain versions
on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nanosnp_tpu.ops.pallas_lstm import bilstm_layer_pallas
from nanosnp_tpu_torch.ops import lstm_train as T
from nanosnp_tpu_torch.ops.bilstm import LAUNCHES, reset_launch_counts

# bf16 cast sites on both sides (W, h_{t-1}, dgates rounded to bf16; f32
# accumulation), so what remains is f32 summation order. A reordered sum
# can flip the bf16 rounding of an h_{t-1} or a dgate (2^-8 relative), which
# the next steps carry at a few 1e-4 at most; typical gaps are ~1e-7.
BF16_TOL = 1e-3
# dW is returned rounded to bf16 on both sides: the f32 sums differ in
# order only, so the rounded values agree within one bf16 ulp (2^-8
# relative, plus an absolute floor for sums near zero).
DW_RTOL, DW_ATOL = 2 ** -7, 1e-4
# f32 throughout: summation order only (the tolerance of the JAX package's
# own test_pallas_recurrence_vjp_matches_scan_grads)
F32_TOL = 1e-5


def _to_jax_layout(a):
    """[N, L, 2, F] true time -> [L, 2, N, F], direction 1 pre-reversed."""
    a = np.transpose(a, (1, 2, 0, 3))
    return np.stack([a[:, 0], a[::-1, 1]], axis=1)


def _from_jax_layout(a):
    """Inverse of _to_jax_layout."""
    a = np.stack([a[:, 0], a[::-1, 1]], axis=1)
    return np.ascontiguousarray(np.transpose(a, (2, 0, 1, 3)))


def _inputs(seed, n, seq_len, hidden):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(hidden)
    xp = rng.standard_normal((n, seq_len, 2, 4 * hidden)).astype(np.float32)
    w_hh = rng.uniform(-k, k, (2, hidden, 4 * hidden)).astype(np.float32)
    g_out = rng.standard_normal((n, seq_len, 2, hidden)).astype(np.float32)
    return xp, w_hh, g_out


def _jax_grads(xp, w_hh, g_out, compute_dtype):
    g_j = jnp.asarray(_to_jax_layout(g_out))

    def loss(xp_, w_):
        hs = bilstm_layer_pallas(xp_, w_, block_n=8, interpret=True,
                                 compute_dtype=compute_dtype)
        return jnp.sum(hs * g_j), hs

    (_, hs), (dxp, dw) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(
        jnp.asarray(_to_jax_layout(xp)), jnp.asarray(w_hh))
    return (_from_jax_layout(np.asarray(hs)),
            _from_jax_layout(np.asarray(dxp)), np.asarray(dw))


def _torch_grads(xp, w_hh, g_out, compute_dtype):
    xp_t = torch.tensor(xp, requires_grad=True)
    w_t = torch.tensor(w_hh, requires_grad=True)
    hs = T.lstm_recurrence(xp_t, w_t.to(compute_dtype))
    dxp, dw = torch.autograd.grad((hs * torch.tensor(g_out)).sum(),
                                  (xp_t, w_t))
    return hs.detach().numpy(), dxp.numpy(), dw.numpy()


# N ragged against the Pallas tile (8) and the kernels' (16, 32). Interpret
# mode unrolls L, so L=33 (the pileup window) runs once: it is the slow case.
CASES = [(5, 9, 8), (13, 33, 16)]


@pytest.mark.parametrize("n,seq_len,hidden", CASES)
def test_recurrence_bf16_matches_pallas_interpret(n, seq_len, hidden):
    xp, w_hh, g_out = _inputs(n * 100 + seq_len, n, seq_len, hidden)
    want = _jax_grads(xp, w_hh, g_out, jnp.bfloat16)
    got = _torch_grads(xp, w_hh, g_out, torch.bfloat16)
    for name, g, w in zip(("hs", "dxp"), got[:2], want[:2]):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=BF16_TOL, rtol=0, err_msg=name)
        assert np.median(np.abs(g - w)) < 1e-5, name
    np.testing.assert_allclose(got[2], want[2], atol=DW_ATOL, rtol=DW_RTOL,
                               err_msg="dW_hh")


@pytest.mark.parametrize("n,seq_len,hidden", [(11, 9, 16)])
def test_recurrence_f32_matches_pallas_interpret(n, seq_len, hidden):
    xp, w_hh, g_out = _inputs(n * 10 + seq_len, n, seq_len, hidden)
    want = _jax_grads(xp, w_hh, g_out, jnp.float32)
    got = _torch_grads(xp, w_hh, g_out, torch.float32)
    for name, g, w in zip(("hs", "dxp", "dW_hh"), got, want):
        np.testing.assert_allclose(g, w, atol=F32_TOL, rtol=F32_TOL,
                                   err_msg=name)


def test_recurrence_gradcheck_float64():
    """The hand-written backward (plain version of `_bwd_kernel`) is the
    derivative of the forward, checked by finite differences in f64."""
    xp, w_hh, _ = _inputs(3, 3, 5, 4)
    xp_t = torch.tensor(xp, dtype=torch.float64, requires_grad=True)
    w_t = torch.tensor(w_hh, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(T.lstm_recurrence, (xp_t, w_t),
                                    eps=1e-6, atol=1e-7, rtol=1e-5)


def test_backward_matches_autograd_of_forward_f32():
    """Differentiating the plain forward by autograd (the f32 reference
    path of training) gives the hand-written backward's gradients."""
    xp, w_hh, g_out = _inputs(4, 6, 9, 8)
    xp_t = torch.tensor(xp, requires_grad=True)
    w_t = torch.tensor(w_hh, requires_grad=True)
    hs, _ = T.lstm_recurrence_train_plain(xp_t, w_t)
    want = torch.autograd.grad((hs * torch.tensor(g_out)).sum(), (xp_t, w_t))
    got = _torch_grads(xp, w_hh, g_out, torch.float32)[1:]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), atol=F32_TOL, rtol=F32_TOL)


def test_dw_reduce_matches_the_sweeps_own_sum():
    xp, w_hh, g_out = _inputs(5, 7, 9, 16)
    args = [torch.from_numpy(a) for a in (xp, w_hh)]
    hs, cs = T.lstm_recurrence_train(args[0], args[1].bfloat16())
    dxp, dw = T.lstm_recurrence_bwd(args[0], args[1].bfloat16(), hs, cs,
                                    torch.from_numpy(g_out))
    assert dw.dtype == torch.bfloat16
    dw_sep = T.lstm_dw_reduce(dxp, hs)
    torch.testing.assert_close(dw_sep.float(), dw.float(), atol=DW_ATOL,
                               rtol=DW_RTOL)
    dxp_only, none = T.lstm_recurrence_bwd(args[0], args[1].bfloat16(), hs,
                                           cs, torch.from_numpy(g_out),
                                           with_dw=False)
    assert none is None
    torch.testing.assert_close(dxp_only, dxp, atol=0, rtol=0)


def test_direction_one_runs_backwards():
    """Direction 1's first step reads only xp[:, L-1]: its state there is
    unchanged when every other timestep changes."""
    xp, w_hh, _ = _inputs(6, 4, 7, 8)
    w = torch.from_numpy(w_hh).bfloat16()
    a, _ = T.lstm_recurrence_train(torch.from_numpy(xp), w)
    xp2 = xp.copy()
    xp2[:, :-1] += 1.0
    b, _ = T.lstm_recurrence_train(torch.from_numpy(xp2), w)
    torch.testing.assert_close(a[:, -1, 1], b[:, -1, 1], atol=0, rtol=0)
    assert not torch.equal(a[:, -1, 0], b[:, -1, 0])


def test_wrappers_reject_bad_inputs_and_count_no_plain_launches():
    reset_launch_counts()
    xp, w_hh, g_out = _inputs(7, 3, 5, 8)
    xp, w = torch.from_numpy(xp), torch.from_numpy(w_hh).bfloat16()
    with pytest.raises(ValueError):
        T.lstm_recurrence_train(xp[:, :, :, :-1], w)
    with pytest.raises(ValueError):
        T.lstm_recurrence_train(xp.to("meta"), w.to("meta"))
    hs, cs = T.lstm_recurrence_train(xp, w)
    with pytest.raises(ValueError):
        T.lstm_recurrence_bwd(xp, w, hs[:, 1:], cs, torch.from_numpy(g_out))
    T.lstm_recurrence_bwd(xp, w, hs, cs, torch.from_numpy(g_out))
    assert set(LAUNCHES.values()) == {0}


def test_costs_count_each_stream_once():
    flop, nbytes = T.train_cost(2000, 33, 64)
    assert flop == 2 * 2 * 2000 * 33 * 256 * 64
    assert nbytes == 2000 * 33 * 2 * (256 + 2 * 64) * 4 + 2 * 64 * 256 * 2
    flop_b, _ = T.bwd_cost(2000, 33, 64)
    assert flop_b == 2 * flop
    flop_w, bytes_w = T.dw_cost(512, 33, 256)
    # three bf16 products (hi hi, hi lo, lo hi) of the split f32 operands
    assert flop_w == 3 * 2 * (2 * 512 * 32) * 256 * 1024
    assert bytes_w == 2 * 512 * 32 * 5 * 256 * 4 + 2 * 256 * 1024 * 2
    plan = T.plan_dw(2000, 33, 64)
    assert 120 <= plan.grid[0] * plan.grid[1] * plan.grid[2] <= 132
