"""The slice end to end on the CPU: the JAX package's s2, s5 and s6 stages
(f32: use_pallas=False, use_bf16=False) against the port's, on the same
shards and weights. The outputs must be the same files, except that a
QUAL (printed rounded to 2 places from f32 probabilities) may differ by
0.01 where the two f32 computations land on either side of a rounding
boundary; such rows are counted and must stay rare."""
import os

import numpy as np
import pytest
import torch

import jax

from nanosnp_tpu.config import HaplotypeModelConfig, PipelineConfig
from nanosnp_tpu.io import bins as jax_bins
from nanosnp_tpu.io.fasta import write_fasta
from nanosnp_tpu.io.fasta import FastaReference as JaxFasta
from nanosnp_tpu.models.haplotype_model import init_haplotype_params
from nanosnp_tpu.models.pileup_model import init_pileup_params
from nanosnp_tpu.runtime import stages as jax_stages
from nanosnp_tpu_torch import config as tconfig
from nanosnp_tpu_torch.io import bins
from nanosnp_tpu_torch.io.fasta import FastaReference
from nanosnp_tpu_torch.models.convert import (params_from_jax,
                                              pileup_checkpoint_from_params)
from nanosnp_tpu_torch.runtime import cli, stages

from test_s5_deep_buckets import _random_shard

CONTIG = "chr20"
LENGTH = 40_000


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(batch_size):
    jcfg, tcfg = PipelineConfig(), tconfig.PipelineConfig()
    for c in (jcfg, tcfg):
        c.inference.batch_size = batch_size
        c.inference.use_bf16 = False
        c.inference.use_pallas = False
        c.threads = 2
    return jcfg, tcfg


def pileup_columns(rng, seq: np.ndarray) -> np.ndarray:
    """[len(seq), 18] int16 counts in the s1 layout: reads matching the
    reference count negative in the reference base's channels, other
    bases positive, plus small indel channels."""
    n = len(seq)
    cols = np.zeros((n, 18), np.int16)
    base_idx = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), seq)
    depth = rng.integers(8, 40, n)
    alt = rng.binomial(depth, rng.choice([0.02, 0.5, 0.95], n))
    fwd = rng.binomial(depth, 0.5)
    alt_base = (base_idx + rng.integers(1, 4, n)) % 4
    rows = np.arange(n)
    fwd_alt = rng.binomial(alt, 0.5)
    cols[rows, base_idx] -= (fwd - fwd_alt).clip(0)
    cols[rows, base_idx + 9] -= (depth - fwd - (alt - fwd_alt)).clip(0)
    cols[rows, alt_base] += fwd_alt
    cols[rows, alt_base + 9] += alt - fwd_alt
    cols[:, [4, 5, 6, 7, 13, 14, 15, 16]] = rng.integers(
        0, 3, (n, 8)).astype(np.int16)
    return cols


def pileup_shard(rng, seq: np.ndarray, n_cand: int, flank: int = 16):
    """A v2 columnar shard: the column union is the whole contig."""
    pos = np.sort(rng.choice(np.arange(flank + 1, len(seq) - flank),
                             n_cand, replace=False)).astype(np.int64)
    refs = np.array([seq[p - 1 - flank: p + flank].tobytes() for p in pos],
                    dtype=f"S{2 * flank + 1}")
    return bins.PileupShard(
        contig=CONTIG, positions=pos, ref_seqs=refs,
        alt_info=np.array([b"A:1"] * n_cand, dtype="S"),
        columns=pileup_columns(rng, seq), cand_off=pos - 1, flank=flank)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_slice")
    rng = np.random.default_rng(2026)
    genome = {CONTIG: "".join(rng.choice(list("ACGT"), LENGTH))}
    write_fasta(str(tmp / "ref.fa"), genome)
    ref = FastaReference(str(tmp / "ref.fa"))
    seq = ref.contig(CONTIG)
    col_dir = tmp / "shards_v2"
    col_dir.mkdir()
    shard = pileup_shard(rng, seq, 1500)
    # two parts, as s1 writes them for a long contig
    for k, (lo, hi) in enumerate(((0, 1000), (1000, 1500))):
        part = bins.PileupShard(
            contig=CONTIG, positions=shard.positions[lo:hi],
            ref_seqs=shard.ref_seqs[lo:hi], alt_info=shard.alt_info[lo:hi],
            columns=shard.columns, cand_off=shard.cand_off[lo:hi], flank=16)
        bins.save_pileup_shard(str(col_dir / f"{CONTIG}.part{k:04d}.npz"),
                               part)
    dense_dir = tmp / "shards_v1"
    dense_dir.mkdir()
    sub = pileup_shard(rng, seq, 600)
    bins.save_pileup_shard(str(dense_dir / f"{CONTIG}.npz"), bins.PileupShard(
        contig=CONTIG, positions=sub.positions, matrix=sub.matrix,
        ref_seqs=sub.ref_seqs, alt_info=sub.alt_info))
    pparams = _np_tree(init_pileup_params(jax.random.key(21),
                                          PipelineConfig().pileup_model))
    return dict(tmp=tmp, ref=ref, col_dir=col_dir, dense_dir=dense_dir,
                shard=shard, pparams=pparams)


def _rows(path):
    with open(path) as f:
        return [line for line in f]


def assert_same_calls(got_path, want_path, qual_col, sample_col=None):
    """Equal files, but for QUAL within 0.01 (and the GQ derived from it
    within 1). Returns the number of rows whose QUAL differs."""
    got, want = _rows(got_path), _rows(want_path)
    assert len(got) == len(want)
    n_qual = 0
    for g, w in zip(got, want):
        if g == w:
            continue
        gf, wf = g.rstrip("\n").split("\t"), w.rstrip("\n").split("\t")
        assert len(gf) == len(wf)
        assert abs(float(gf[qual_col]) - float(wf[qual_col])) <= 0.0100001, \
            (g, w)
        for i, (a, b) in enumerate(zip(gf, wf)):
            if i in (qual_col, sample_col):
                continue
            assert a == b, (g, w)
        if sample_col is not None:
            gs, ws = gf[sample_col].split(":"), wf[sample_col].split(":")
            assert gs[0] == ws[0] and gs[2:] == ws[2:], (g, w)
            assert abs(int(gs[1]) - int(ws[1])) <= 1, (g, w)
        n_qual += 1
    return n_qual


def _s2_both(world, shard_dir, tmp, monkeypatch):
    jcfg, tcfg = _cfgs(256)
    # several device units per shard in the port's columnar feed
    monkeypatch.setattr(stages, "_UNIT_COLUMNS", 9000)
    jax_stages.stage_pileup_predict(
        jcfg, JaxFasta(world["ref"].fasta_path), str(shard_dir),
        str(tmp / "jax.vcf"), params=world["pparams"])
    m = stages.stage_pileup_predict(
        tcfg, world["ref"], str(shard_dir), str(tmp / "port.vcf"),
        params=params_from_jax(world["pparams"]), device="cpu")
    return m


@pytest.mark.parametrize("layout", ["shards_v2", "shards_v1"])
def test_s2_pileup_vcf_matches_jax(world, tmp_path, monkeypatch, layout):
    shard_dir = world["col_dir"] if layout == "shards_v2" \
        else world["dense_dir"]
    m = _s2_both(world, shard_dir, tmp_path, monkeypatch)
    rows = [r for r in _rows(tmp_path / "port.vcf") if r[0] != "#"]
    assert m["sites"] == (1500 if layout == "shards_v2" else 600)
    assert len(rows) > 100
    n_qual = assert_same_calls(tmp_path / "port.vcf", tmp_path / "jax.vcf",
                               qual_col=5, sample_col=9)
    assert n_qual <= len(rows) // 100


def test_s2_cli_on_cpu_matches_stage(world, tmp_path):
    """`s2-predict --device cpu` with a reference-layout checkpoint gives
    the stage's output byte for byte."""
    ck = tmp_path / "pileup.chkpt"
    torch.save(pileup_checkpoint_from_params(
        params_from_jax(world["pparams"])), str(ck))
    tcfg = tconfig.PipelineConfig()
    tcfg.inference.use_bf16 = False
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text("inference:\n  use_bf16: false\n  use_pallas: auto\n")
    assert cli.main(["s2-predict", "--shards", str(world["col_dir"]),
                     "--ref", world["ref"].fasta_path,
                     "--pileup-model", str(ck), "--config", str(cfg_path),
                     "--device", "cpu", "-o", str(tmp_path / "out")]) == 0
    stages.stage_pileup_predict(
        tcfg, world["ref"], str(world["col_dir"]), str(tmp_path / "st.vcf"),
        params=params_from_jax(world["pparams"]), device="cpu")
    assert _rows(tmp_path / "out" / "pileup.vcf") == _rows(
        tmp_path / "st.vcf")


def _hap_world(world, tmp):
    """Haplotype shards in two depth buckets (32 and 192) on candidates of
    the s2 shard; a quarter of the sites untagged for the deferral gate."""
    rng = np.random.default_rng(77)
    shard_dir = tmp / "hap_shards"
    shard_dir.mkdir()
    pos = world["shard"].positions
    for depth, n, name in ((20, 120, "d32x32"), (150, 700, "d192x192")):
        s = _random_shard(rng, CONTIG, n, depth, 16, 5)
        picked = np.sort(rng.choice(pos[(pos > 60) & (pos < LENGTH - 60)], n,
                                    replace=False))
        s.candidate_positions = picked
        s.group_positions = picked[:, None] + np.arange(-5, 6)[None, :] * 3
        h = s.haplotype["hap"]
        q = n // 4
        h[:q] = np.where(h[:q] == -2, -2, 3)
        bins.save_haplotype_shard(str(shard_dir / f"{CONTIG}_{name}.npz"), s)
    return shard_dir


def test_s5_and_s6_match_jax(world, tmp_path, monkeypatch):
    hcfg = HaplotypeModelConfig(hidden_size=16, lstm_layers=2)
    jcfg, tcfg = _cfgs(1024)   # the deep bucket featurizes in halves
    jcfg.haplotype_model = hcfg
    tcfg.haplotype_model = tconfig.HaplotypeModelConfig(hidden_size=16,
                                                        lstm_layers=2)
    assert stages._featurize_sub_batch(tcfg, 192) == 512
    hparams = _np_tree(init_haplotype_params(jax.random.key(5), hcfg))
    shard_dir = _hap_world(world, tmp_path)
    jref = JaxFasta(world["ref"].fasta_path)
    mj = jax_stages.stage_haplotype_predict(
        jcfg, jref, str(shard_dir), str(tmp_path / "jax.csv"), hparams)
    mt = stages.stage_haplotype_predict(
        tcfg, world["ref"], str(shard_dir), str(tmp_path / "port.csv"),
        params_from_jax(hparams), device="cpu")
    assert mt == {k: v for k, v in mj.items() if k != "sites_per_s"} | {
        "sites_per_s": mt["sites_per_s"]}
    assert mt["deferred"] > 0 and mt["sites"] == 820
    rows = _rows(tmp_path / "port.csv")
    assert len(rows) == 820 - mt["deferred"]
    n_qual = assert_same_calls(tmp_path / "port.csv", tmp_path / "jax.csv",
                               qual_col=3)
    assert n_qual <= max(len(rows) // 100, 1)

    # s6 over each side's own s2 and s5 outputs; random weights are never
    # confident, so accept every haplotype call to exercise the rescue rows
    _s2_both(world, world["col_dir"], tmp_path, monkeypatch)
    jcfg.merge.hap_quality = 0.0
    cfg_path = tmp_path / "merge.yaml"
    cfg_path.write_text("merge:\n  hap_quality: 0.0\n")
    jax_stages.stage_merge(jcfg, str(tmp_path / "jax.vcf"),
                           str(tmp_path / "jax.csv"),
                           str(tmp_path / "jax_merge.vcf"))
    assert cli.main(["s6-merge", "--pileup-vcf", str(tmp_path / "port.vcf"),
                     "--haplotype-csv", str(tmp_path / "port.csv"),
                     "--config", str(cfg_path), "-o", str(tmp_path / "port_merge")]) == 0
    merged = tmp_path / "port_merge" / "merge.vcf"
    assert any("\tH\t" in r for r in _rows(merged))
    assert_same_calls(merged, tmp_path / "jax_merge.vcf", qual_col=5,
                      sample_col=9)


def test_shards_interchange_with_jax_package(world, tmp_path):
    """Shards written by either package load in the other unchanged."""
    sub = world["shard"]
    jax_bins.save_pileup_shard(str(tmp_path / "j.npz"), sub)
    got = bins.load_pileup_shard(str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(got.matrix, sub.matrix)
    np.testing.assert_array_equal(got.positions, sub.positions)
    hs = _random_shard(np.random.default_rng(3), CONTIG, 10, 12, 16, 5)
    bins.save_haplotype_shard(str(tmp_path / "h.npz"), hs)
    back = jax_bins.load_haplotype_shard(str(tmp_path / "h.npz"))
    for k in bins._KEYS:
        np.testing.assert_array_equal(back.pileup[k], hs.pileup[k])
        assert back.haplotype[k].dtype == bins._KEY_DTYPE[k]
    assert os.path.basename(bins.list_shards(str(tmp_path))[0]) == "h.npz"
