"""The training recurrences' launch plan and the smem path's dW, on the CPU
(ops/lstm_train.py).

The CUDA kernels cannot run here; what surrounds them can. These tests
hold:

- `plan_train` takes the smem path (w_hh in shared memory, dW summed in
  the sweep) at the pileup model's H=64, inside a block's shared memory
  and in one wave of the card at the trainer's batch, and the packed
  kernels at the haplotype model's H=256, at the trainers' shapes and at
  ragged N;
- the plain version of the sweep's tiled dW, per-tile partials summed in
  tile order, equals `lstm_dw_reduce_plain` and, tile by tile, the
  `dw_tiles` of the JAX package's Pallas `_bwd_kernel` run in interpret
  mode;
- the gate derivatives the sweep forms from the SFU gate formulas keep
  the bound stated here.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import TRAIN_SHAPES
from nanosnp_tpu.ops.pallas_lstm import (_run_recurrence_bwd,
                                         _run_recurrence_train)
from nanosnp_tpu_torch.ops import lstm_train as T
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
    assert plan.grid == (tiles, 2)
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
        assert plan.path == "packed", label
        assert plan.dw_tiles == T.dw_splits(n, seq_len, hidden)


@pytest.mark.parametrize("hidden", [16, 32, 48, 128])
def test_other_widths_take_the_packed_path(hidden):
    """The smem kernels are built for H=64 only; other widths, those that
    would fit included, run the packed kernels."""
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

    def to_kernel(a):   # [N, L, 2, F] -> [L, 2, F, Npad], dir 1 reversed
        a = np.transpose(_to_jax_layout(a), (0, 1, 3, 2))
        return jnp.asarray(np.pad(a, ((0, 0), (0, 0), (0, 0),
                                      (0, n_pad - n))))

    def from_kernel(a):  # inverse, padded rows cut
        return _from_jax_layout(np.transpose(np.asarray(a),
                                             (0, 1, 3, 2)))[:n]

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
