"""The scan route of the port (`inference.use_pallas: false`, and `auto` on
the CPU) against the JAX package's lax.scan route, on the CPU.

- `bilstm_encoder_scan` against JAX `bilstm_encoder(..., compute_dtype,
  use_pallas=False)` in f32 and bf16, every timestep and the center;
- the f32 inference recurrence: its plain version (what the wrapper runs
  on the CPU with an f32 w_hh), its plan and the C side's constants, and
  a NumPy emulation of the CUDA kernel's tiling (W tiles, ring, chunks of
  64 units) against the plain version;
- `resolve_use_pallas` over the route table of models/bilstm.py;
- `s2-predict` through both CLIs and the s5 stage of both packages under
  `use_pallas: false, use_bf16: true` and under the default config.

The CUDA kernels are held against the same plain versions on the card by
chip_smoke.py (phases 1c and 2d)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nanosnp_tpu.config import HaplotypeModelConfig, PipelineConfig
from nanosnp_tpu.io.fasta import FastaReference as JaxFasta
from nanosnp_tpu.models.bilstm import bilstm_encoder as jax_bilstm_encoder
from nanosnp_tpu.models.haplotype_model import init_haplotype_params
from nanosnp_tpu.models.pileup_model import pileup_predict as jax_pileup
from nanosnp_tpu.runtime import stages as jax_stages
from nanosnp_tpu.runtime.cli import main as jax_main
from nanosnp_tpu_torch import config as tconfig
from nanosnp_tpu_torch.models.bilstm import (BiLSTM,
                                             bilstm_encoder_fused,
                                             bilstm_encoder_scan,
                                             encoder_center)
from nanosnp_tpu_torch.models.convert import (params_from_jax,
                                              pileup_checkpoint_from_params)
from nanosnp_tpu_torch.models.pileup_model import PileupModel, pileup_predict
from nanosnp_tpu_torch.ops import bilstm as K
from nanosnp_tpu_torch.ops import lstm_train as T
from nanosnp_tpu_torch.runtime import cli, stages

from test_torch_bilstm import _layers
from test_torch_stages import _hap_world, _np_tree, assert_same_calls, world

# f32 on both sides: summation order only
F32_TOL = 1e-5
# bf16 operands on both sides (h_{t-1} and the layer inputs rounded to
# bf16, f32 sums): what remains is f32 summation order, which can flip
# the bf16 rounding of an h_{t-1} or an activation (one bf16 ulp is 2^-8
# near 1) and carry it through the later steps and layers
BF16_TOL = 2e-3
# share of the argmax decisions of a small head on the two packages'
# bf16 center states that must agree
BF16_AGREE = 0.99

SRC = Path(T.__file__).resolve().parent / "csrc" / "lstm_train.cu"


# -- the scan encoder against JAX ------------------------------------------

@pytest.mark.parametrize("center_only", [False, True])
@pytest.mark.parametrize("hidden,seq_len", [(16, 33), (64, 11)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_encoder_matches_jax_scan(dtype, hidden, seq_len, center_only):
    rng = np.random.default_rng(hidden + seq_len)
    layers = _layers(rng, 18, hidden, 2)
    x = (rng.standard_normal((200, seq_len, 18)) * 2).astype(np.float32)
    want = np.asarray(jax_bilstm_encoder(
        [jax.tree.map(jnp.asarray, p) for p in layers], jnp.asarray(x),
        compute_dtype=getattr(jnp, dtype), use_pallas=False))
    if center_only:
        want = want[:, seq_len // 2]
    enc = BiLSTM(params_from_jax(layers))
    got = bilstm_encoder_scan(enc.layers, torch.from_numpy(x),
                              getattr(torch, dtype),
                              center_only=center_only).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    if dtype == "bfloat16":
        # most entries agree far more closely than the bound, and a head
        # on the center states takes the same decisions
        assert np.median(np.abs(got - want)) < 1e-5
        ctr_g = got if center_only else got[:, seq_len // 2]
        ctr_w = want if center_only else want[:, seq_len // 2]
        head = rng.standard_normal((2 * hidden, 5)).astype(np.float32)
        agree = ((ctr_g @ head).argmax(1) == (ctr_w @ head).argmax(1)).mean()
        print(f"bf16 H={hidden} L={seq_len}: max |d| "
              f"{np.abs(got - want).max():.2e}, head argmax agreement "
              f"{agree:.4f}")
        assert agree >= BF16_AGREE


def test_encoder_center_routes():
    """"scan" is the scan encoder's center, "kernels" the kernel encoder's
    plain versions whatever the compute dtype, None the behaviour from
    before routes; an unknown route raises."""
    rng = np.random.default_rng(3)
    enc = BiLSTM(params_from_jax(_layers(rng, 18, 16, 2)))
    x = torch.from_numpy(rng.standard_normal((7, 33, 18)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(encoder_center(enc.layers, x, dtype, "scan"),
                           bilstm_encoder_scan(enc.layers, x, dtype, True))
        assert torch.equal(encoder_center(enc.layers, x, dtype, "kernels"),
                           bilstm_encoder_fused(enc.layers, x, True))
    assert torch.equal(encoder_center(enc.layers, x, torch.bfloat16),
                       bilstm_encoder_fused(enc.layers, x, True))
    with pytest.raises(ValueError, match="route"):
        encoder_center(enc.layers, x, torch.float32, "pallas")


def test_pileup_model_scan_route_matches_jax_and_ignores_fuse_head(
        monkeypatch):
    from nanosnp_tpu.models.pileup_model import init_pileup_params
    from nanosnp_tpu.config import PileupModelConfig as JCfg

    mcfg = tconfig.PileupModelConfig(hidden_size=16, output_size=32,
                                     inner_size=32)
    jparams = _np_tree(init_pileup_params(jax.random.key(4), JCfg(
        hidden_size=16, output_size=32, inner_size=32)))
    model = PileupModel(mcfg, params_from_jax(jparams))
    x = np.random.default_rng(5).integers(-20, 20, (64, 33, 18)).astype(
        np.float32)
    want = jax_pileup(jax.tree.map(jnp.asarray, jparams), jnp.asarray(x),
                      JCfg(hidden_size=16, output_size=32, inner_size=32),
                      compute_dtype=jnp.bfloat16, use_pallas=False)
    got = pileup_predict(model, torch.from_numpy(x), torch.bfloat16, "scan")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BF16_TOL,
                                   rtol=0)
    monkeypatch.setenv("NSP_FUSE_HEAD", "1")
    monkeypatch.setenv("NSP_FUSE_LAYERS", "1")
    again = pileup_predict(model, torch.from_numpy(x), torch.bfloat16,
                           "scan")
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# -- the f32 inference recurrence ------------------------------------------

def test_f32_wrapper_on_cpu_is_the_train_loop_bit_for_bit():
    g = torch.Generator().manual_seed(11)
    xp = torch.randn(9, 7, 2, 4 * 32, generator=g) * 2
    w = torch.randn(2, 32, 4 * 32, generator=g) / 32 ** 0.5
    K.reset_launch_counts()
    got = T.lstm_recurrence_infer(xp, w)
    want, _ = T.lstm_recurrence_train_plain(xp, w)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    # no kernel launched: the CPU runs the plain version
    assert sum(K.LAUNCHES.values()) == 0


def _c_constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SRC.read_text())
    return int(m.group(1))


def test_f32_plan_fits_and_matches_the_c_side():
    assert T.F32_BN == _c_constant("kF32BN")
    assert T.F32_TILE == (_c_constant("kF32KT"), 4 * _c_constant("kF32Units"))
    assert T.F32_STAGES == _c_constant("kF32Stages")
    assert _c_constant("kF32Threads") == (T.F32_BN // 4) * (
        T.F32_TILE[1] // 4 // 4)        # 4 rows x 4 units a thread
    for hidden in range(16, 257, 16):
        plan = T.plan_infer_f32(8192, 33, hidden)
        assert plan.path == "f32" and plan.bn == 64
        assert plan.grid == (128, 2) and plan.cluster == 1
        assert plan.smem == T.f32_smem_bytes(hidden) <= K.SMEM_MAX
    assert T.plan_infer_f32(1, 1, 64).grid == (1, 2)
    assert T.plan_infer_f32(65, 33, 64).grid == (2, 2)
    assert T.f32_smem_bytes(256) == 196_608
    assert T.f32_smem_bytes(64) == 98_304
    for n, seq_len, hidden in ((8, 33, 0), (8, 33, 8), (8, 33, 25),
                               (8, 33, 272), (0, 33, 64), (8, 0, 64)):
        with pytest.raises(ValueError):
            T.plan_infer_f32(n, seq_len, hidden)


def test_f32_kernel_takes_f32_only():
    """A CUDA w_hh of f32 goes to the f32 kernel, which takes f32 xp only;
    checked before anything is launched (no card is needed to raise)."""
    xp = torch.zeros(4, 3, 2, 64, dtype=torch.bfloat16)
    w = torch.zeros(2, 16, 64)
    with pytest.raises(TypeError, match="f32"):
        T._infer_f32(xp, w)


def _emulate_f32_kernel(xp, w_hh):
    """The f32 kernel's arithmetic in NumPy, laid out as
    csrc/lstm_train.cu lays it out: per (direction, 64 rows) CTA, W tiles
    of 16 k rows x (4 gates x 64 units) loaded piece by piece as
    f32_load_tile maps them into a ring of F32_STAGES slots (or held,
    where a step's tiles fit the ring), chunks of 64 units with their cell
    states kept over the steps, h_{t-1} transposed in two buffers by step
    parity, xp added after the product."""
    n, seq_len, _, four_h = xp.shape
    hidden = four_h // 4
    bn, (kt_rows, cols), stages = T.F32_BN, T.F32_TILE, T.F32_STAGES
    units = cols // 4
    chunks = -(-hidden // units)
    k_tiles = hidden // kt_rows
    tiles = chunks * k_tiles
    resident = tiles <= stages
    hs = np.zeros((n, seq_len, 2, hidden), np.float32)
    for d in (0, 1):
        w = w_hh[d]

        def load(c, kt):
            out = np.zeros(kt_rows * cols, np.float32)
            for i in range(kt_rows * cols // 4):      # 16-byte pieces
                q, g, kk = i & 15, (i >> 4) & 3, i >> 6
                u = c * units + 4 * q
                if u < hidden:
                    out[4 * i:4 * i + 4] = w[kt * kt_rows + kk,
                                             g * hidden + u:
                                             g * hidden + u + 4]
            return out.reshape(kt_rows, 4, units)

        for n0 in range(0, n, bn):
            rows = np.arange(n0, n0 + bn)
            ok = rows < n
            ring = [None] * stages
            for s in range(tiles if resident else stages - 1):
                ring[s] = load(s // k_tiles, s % k_tiles)
            s_h = np.zeros((2, hidden, bn), np.float32)
            c_state = np.zeros((chunks, bn, units), np.float32)
            gidx = 0
            for step in range(seq_len):
                t = step if d == 0 else seq_len - 1 - step
                h_prev, h_next = s_h[step & 1], s_h[(step + 1) & 1]
                for c in range(chunks):
                    acc = np.zeros((bn, 4, units), np.float32)
                    for kt in range(k_tiles):
                        if resident:
                            slot = c * k_tiles + kt
                        else:
                            slot = gidx % stages
                            nxt = (gidx + stages - 1) % tiles
                            ring[(gidx + stages - 1) % stages] = load(
                                nxt // k_tiles, nxt % k_tiles)
                        for kk in range(kt_rows):
                            acc += (h_prev[kt * kt_rows + kk][:, None, None]
                                    * ring[slot][kk][None])
                        gidx += 1
                    u_ok = np.arange(c * units, (c + 1) * units) < hidden
                    u = np.arange(c * units, (c + 1) * units)[u_ok]
                    x = np.zeros((bn, 4, len(u)), np.float32)
                    x[ok] = xp[rows[ok], t, d].reshape(-1, 4, hidden)[
                        :, :, u]
                    gates = x + acc[:, :, u_ok]
                    sig = 1 / (1 + np.exp(-gates))
                    cn = (sig[:, 1] * c_state[c][:, u_ok]
                          + sig[:, 0] * np.tanh(gates[:, 2]))
                    c_state[c][:, u_ok] = cn
                    h = sig[:, 3] * np.tanh(cn)
                    h_next[u] = h.T
                    hs[rows[ok], t, d, u[0]:u[-1] + 1] = h[ok]
    return hs


@pytest.mark.parametrize("n,seq_len,hidden", [(70, 3, 80), (5, 4, 48),
                                              (64, 2, 64)])
def test_f32_kernel_layout_emulation_matches_plain(n, seq_len, hidden):
    """Two CTAs with a ragged tail, a ragged last chunk and a streamed ring
    (H=80: two chunks, ten tiles a step); one CTA with W held (H=48, three
    tiles; H=64, four, the pileup model's)."""
    g = torch.Generator().manual_seed(hidden)
    xp = torch.randn(n, seq_len, 2, 4 * hidden, generator=g) * 2
    w = torch.randn(2, hidden, 4 * hidden, generator=g) / hidden ** 0.5
    want = T.lstm_recurrence_infer_plain(xp, w).numpy()
    got = _emulate_f32_kernel(xp.numpy(), w.numpy())
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


# -- the route resolver ----------------------------------------------------

@pytest.mark.parametrize("use_pallas,device,want", [
    ("auto", "cuda", True), ("auto", "cpu", False),
    (True, "cuda", True), (True, "cpu", True),
    (False, "cuda", False), (False, "cpu", False)])
def test_resolve_use_pallas_follows_the_route_table(use_pallas, device, want):
    cfg = tconfig.PipelineConfig()
    cfg.inference.use_pallas = use_pallas
    assert stages.resolve_use_pallas(cfg, torch.device(device)) is want
    assert stages.encoder_route(cfg, torch.device(device)) == (
        "kernels" if want else "scan")


def test_configs_default_yaml_resolves_as_the_jax_package_on_the_cpu():
    cfg = tconfig.load_config(str(Path(__file__).resolve().parents[1]
                                  / "configs" / "default.yaml"))
    assert stages.resolve_use_pallas(cfg, "cpu") is False
    assert stages.resolve_use_pallas(cfg, "cuda") is True


# -- the stages against the JAX CLI ----------------------------------------

# (name, the YAML of both packages, the jcfg/tcfg inference fields)
ROUTE_CONFIGS = {
    "scan bf16": ("inference:\n  use_pallas: false\n  use_bf16: true\n",
                  dict(use_pallas=False, use_bf16=True)),
    "default": ("", {}),
}


def _share(got_path, want_path):
    got = Path(got_path).read_text().splitlines()
    want = Path(want_path).read_text().splitlines()
    return sum(g == w for g, w in zip(got, want)) / max(len(want), 1)


@pytest.mark.parametrize("route", sorted(ROUTE_CONFIGS))
def test_s2_cli_matches_the_jax_cli(world, tmp_path, route):
    yaml, _ = ROUTE_CONFIGS[route]
    ck = tmp_path / "pileup.chkpt"
    torch.save(pileup_checkpoint_from_params(
        params_from_jax(world["pparams"])), str(ck))
    args = ["s2-predict", "--shards", str(world["col_dir"]), "--ref",
            world["ref"].fasta_path, "--pileup-model", str(ck)]
    if yaml:
        (tmp_path / "cfg.yaml").write_text(yaml)
        args += ["--config", str(tmp_path / "cfg.yaml")]
    assert jax_main(args + ["-o", str(tmp_path / "jax")]) == 0
    K.reset_launch_counts()
    assert cli.main(args + ["-o", str(tmp_path / "port"), "--device",
                            "cpu"]) == 0
    assert sum(K.LAUNCHES.values()) == 0
    got, want = (tmp_path / d / "pileup.vcf" for d in ("port", "jax"))
    n_rows = sum(1 for r in got.read_text().splitlines() if r[0] != "#")
    assert n_rows > 100
    n_qual = assert_same_calls(got, want, qual_col=5, sample_col=9)
    print(f"s2 {route}: {n_rows} rows, {n_qual} QUAL within 0.01, "
          f"byte-identical share {_share(got, want):.4f}")
    assert n_qual <= n_rows // 100


@pytest.mark.parametrize("route", sorted(ROUTE_CONFIGS))
def test_s5_stage_matches_the_jax_stage(world, tmp_path, route):
    _, fields = ROUTE_CONFIGS[route]
    jcfg, tcfg = PipelineConfig(), tconfig.PipelineConfig()
    for c in (jcfg, tcfg):
        c.inference.batch_size = 1024
        c.threads = 2
        for k, v in fields.items():
            setattr(c.inference, k, v)
    hcfg = HaplotypeModelConfig(hidden_size=16, lstm_layers=2)
    jcfg.haplotype_model = hcfg
    tcfg.haplotype_model = tconfig.HaplotypeModelConfig(hidden_size=16,
                                                        lstm_layers=2)
    hparams = _np_tree(init_haplotype_params(jax.random.key(9), hcfg))
    shard_dir = _hap_world(world, tmp_path)
    mj = jax_stages.stage_haplotype_predict(
        jcfg, JaxFasta(world["ref"].fasta_path), str(shard_dir),
        str(tmp_path / "jax.csv"), hparams)
    mt = stages.stage_haplotype_predict(
        tcfg, world["ref"], str(shard_dir), str(tmp_path / "port.csv"),
        params_from_jax(hparams), device="cpu")
    assert mt["sites"] == mj["sites"] == 820
    assert mt["deferred"] == mj["deferred"] > 0
    rows = (tmp_path / "port.csv").read_text().splitlines()
    assert len(rows) == 820 - mt["deferred"]
    n_qual = assert_same_calls(tmp_path / "port.csv", tmp_path / "jax.csv",
                               qual_col=3)
    print(f"s5 {route}: {len(rows)} rows, {n_qual} QUAL within 0.01, "
          f"byte-identical share "
          f"{_share(tmp_path / 'port.csv', tmp_path / 'jax.csv'):.4f}")
    assert n_qual <= max(len(rows) // 100, 1)
