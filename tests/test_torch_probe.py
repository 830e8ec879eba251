"""The kernel probe: the Pallas `_variant_kernel` of scripts/kernel_probe.py
(run in interpret mode on the CPU, the script itself untouched) against
the port's `probe_plain`, the plain version of the CUDA probe kernel, on
the same numpy-seeded x and weights, in all four modes.

Tolerance 2e-2 absolute on the bf16 outputs: both sides round h to bf16
every step and sum their products in another order, and a one-ulp flip of
a bf16 h (4e-3 near 1) is carried on through 33 steps. `nogate` has no
squashing function, so its values grow past 1 and its gap is held relative
to the largest magnitude.

The CUDA kernel is the layer code `bilstm_stream` runs with a knock-out
parameter: its plan is `bilstm_stream`'s, its source keeps no layer loop
of its own, and the production kernels call the layer code with the
knock-out at its default."""
import functools
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from nanosnp_tpu_torch.ops import probe
from nanosnp_tpu_torch.ops.bilstm import (LAUNCHES, bilstm_stream,
                                          bilstm_stream_plain, plan_layer)
from nanosnp_tpu_torch.ops.build import CSRC, SOURCES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, L, D, D_PAD, H = 16, 33, 18, 32, 64
TOL = 2e-2


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "kernel_probe_under_test",
        os.path.join(REPO, "scripts", "kernel_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(10)
    k = 1.0 / np.sqrt(H)
    return dict(
        x=rng.standard_normal((N, L, D)).astype(np.float32),
        w_ih=rng.uniform(-k, k, (2, D, 4 * H)).astype(np.float32),
        w_hh=rng.uniform(-k, k, (2, H, 4 * H)).astype(np.float32),
        b=rng.uniform(-2 * k, 2 * k, (2, 4 * H)).astype(np.float32))


def run_pallas(script, monkeypatch, inp, mode):
    """`_run_variant` as `main` feeds it (batch on the last axis, D padded
    to 32), its pallas_call in interpret mode -> [N, L, 2H] f32."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    x_t = jnp.pad(jnp.transpose(jnp.asarray(inp["x"]), (1, 2, 0))
                  .astype(jnp.bfloat16), ((0, 0), (0, D_PAD - D), (0, 0)))
    wih_t = jnp.pad(jnp.transpose(jnp.asarray(inp["w_ih"]), (0, 2, 1))
                    .astype(jnp.bfloat16), ((0, 0), (0, 0), (0, D_PAD - D)))
    w_t = jnp.transpose(jnp.asarray(inp["w_hh"]), (0, 2, 1)).astype(
        jnp.bfloat16)
    b = jnp.asarray(inp["b"])[:, :, None]
    out = script._run_variant(x_t, wih_t, w_t, b, seq_len=L, hidden=H,
                              gate_dim=4 * H, block_n=8, mode=mode)
    out = np.asarray(out.astype(jnp.float32))           # [L, 2, H, N]
    return out.transpose(3, 0, 1, 2).reshape(N, L, 2 * H)


def torch_inputs(inp):
    return (torch.from_numpy(inp["x"]).bfloat16(),
            torch.from_numpy(inp["w_ih"]).bfloat16(),
            torch.from_numpy(inp["w_hh"]).bfloat16(),
            torch.from_numpy(inp["b"]))


@pytest.mark.parametrize("mode", probe.MODES)
def test_probe_plain_matches_pallas_variant(script, inputs, monkeypatch,
                                            mode):
    want = run_pallas(script, monkeypatch, inputs, mode)
    got = probe.probe_plain(*torch_inputs(inputs), mode).float().numpy()
    assert got.shape == want.shape == (N, L, 2 * H)
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= TOL * scale


def test_modes_differ_and_full_is_the_production_layer(inputs):
    """Each knock-out really changes the function, `full` is exactly
    `bilstm_stream_plain`, and on the CPU the wrapper takes the plain
    version without counting a launch."""
    args = torch_inputs(inputs)
    outs = {m: probe.probe_plain(*args, m).float() for m in probe.MODES}
    assert torch.equal(outs["full"],
                       bilstm_stream_plain(*args, torch.bfloat16).float())
    for m in probe.MODES[1:]:
        assert (outs[m] - outs["full"]).abs().max() > 0.05, m
    # nodma: every step sees the slab of its direction's first step
    x, w_ih, w_hh, b = args
    frozen = x[:, :1].expand(-1, L, -1).contiguous()
    d0 = bilstm_stream_plain(frozen, w_ih, w_hh, b).float()[:, :, :H]
    assert torch.equal(outs["nodma"][:, :, :H], d0)
    before = dict(LAUNCHES)
    via_wrapper = probe.bilstm_probe(*args, "nomm")
    assert torch.equal(via_wrapper.float(), outs["nomm"])
    assert torch.equal(probe.bilstm_probe(*args, "full"),
                       bilstm_stream(*args))
    assert LAUNCHES == before and "bilstm_probe" in LAUNCHES


def test_wrapper_refuses_what_the_kernel_does_not_take(inputs):
    x, w_ih, w_hh, b = torch_inputs(inputs)
    with pytest.raises(ValueError, match="mode"):
        probe.bilstm_probe(x, w_ih, w_hh, b, "nogates")
    with pytest.raises(TypeError):
        probe.bilstm_probe(x.float(), w_ih, w_hh, b, "full")
    with pytest.raises(ValueError):
        probe.bilstm_probe(x[:, :, :5], w_ih, w_hh, b, "full")


def test_shares_and_entry_point_on_the_cpu(capsys):
    s = probe.shares({"full": 2.0, "nogate": 1.0, "nomm": 1.5, "nodma": 2.5})
    assert s == {"gate transcendental": 0.5, "hidden-matmul": 0.25,
                 "input-load": -0.25}
    assert probe.main(["8", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for word in ("full", "nogate", "nomm", "nodma",
                 "gate transcendental share", "hidden-matmul share",
                 "input-load share", "production 2-layer encoder"):
        assert word in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            probe.main(["8", "1"])


@pytest.mark.parametrize("n", [8192, 3001])
def test_probe_plan_is_bilstm_streams(n):
    """The probe runs on the plan `bilstm_stream` takes at the s2 layer-1
    shape: the fused path, the same tile, grid and shared memory."""
    plan = probe.probe_plan(n, L, D, H)
    assert plan == plan_layer(n, L, D, H, center=False)
    assert plan.path == "fused" and plan.grid == (-(-n // plan.bn), 2)


@pytest.mark.parametrize("d_in,hidden", [(18, 256), (2000, 64)])
def test_probe_refuses_shapes_off_the_fused_path(d_in, hidden):
    """The knock-outs exist only in the fused layer: a shape whose plan is
    the cluster path raises, on the CPU as on the card."""
    assert plan_layer(8, L, d_in, hidden, center=False).path == "cluster"
    with pytest.raises(ValueError, match="fused"):
        probe.probe_plan(8, L, d_in, hidden)
    rng = np.random.default_rng(hidden)
    x = torch.from_numpy(rng.standard_normal((2, L, d_in)).astype(
        np.float32)).bfloat16()
    w_ih = torch.zeros(2, d_in, 4 * hidden, dtype=torch.bfloat16)
    w_hh = torch.zeros(2, hidden, 4 * hidden, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="fused"):
        probe.bilstm_probe(x, w_ih, w_hh, torch.zeros(2, 4 * hidden), "full")


def _strip_comments(src):
    return re.sub(r"//[^\n]*", "", src)


def test_probe_source_keeps_no_layer_code_of_its_own():
    """bilstm_probe.cu includes the shared layer code and passes the mode
    through to `fused_layer`; it has no step loop, product or gate math."""
    src = _strip_comments((CSRC / "bilstm_probe.cu").read_text())
    assert '#include "bilstm_layer.cuh"' in src
    assert re.search(r"fused_layer<false, true, __nv_bfloat16, 4, kKnock>",
                     src)
    for own in (r"for \(int s = ", "mma_bf16", "mma.sync", "sigmoid",
                "tanh", "ex2", "__syncthreads", "cp_async16"):
        assert not re.search(own, src), own
    # the C entry point takes the layer's plan, as nsp_bilstm_stream does
    assert len(SOURCES["bilstm_probe"]["nsp_bilstm_probe"]) == 13
    assert "fused_plan_ok(" in src


@pytest.mark.parametrize("name", ["bilstm.cu", "bilstm_fused.cu"])
def test_production_kernels_keep_the_default_knock_out(name):
    """Every call of the shared layer code in the production sources names
    no knock-out: `fused_layer` with its four template arguments and
    `cell_update` with its three."""
    src = _strip_comments((CSRC / name).read_text())
    calls = re.findall(r"(fused_layer|cell_update)<([^>]*)>\(", src)
    assert calls, name
    for fn, args in calls:
        assert "KnockOut" not in args and "Knock" not in args
        assert len(args.split(",")) == {"fused_layer": 4,
                                        "cell_update": 3}[fn], (fn, args)
    assert "KnockOut" not in src
