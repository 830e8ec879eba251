"""`call` end to end on the CPU: the port's CLI against the JAX package's,
on one diploid world, in f32 (use_bf16 false, use_pallas false), with
narrow models from a `--config` YAML and weights that both packages load
from the same files: the haplotype model seeded, as a pickled parameter
tree; the pileup model as a reference-layout .chkpt. Seeded pileup weights
call no variant at all, s3 then phases nothing and s4/s5 stay empty, so
the fixture first fits a narrow pileup model to the world's truth for a
few hundred steps (a reference-layout `nn.LSTM` module on seeded numpy
batches; the port's own trainers are held to the JAX ones elsewhere).

What must hold: the host artifacts (s1 pileup shards, s3 phased VCF and HP
partition, s4 haplotype shards) are identical; `pileup.vcf`,
`haplotype.csv` and `merge.vcf` have the same rows, positions, alleles and
genotypes, with QUAL within 0.01 (both print it rounded to two places
from f32 probabilities computed by two frameworks, so a value may land on
either side of a rounding boundary; a fitted model's probabilities lie
near 1, where QUAL = -10 log10((1 - p) / p) turns one f32 ulp of p into a
visible step); such rows are counted and must stay under 5%. A run killed after s1 or after s4 and started again gives the clean
run's files byte for byte. `make-train-data` writes the JAX CLI's arrays."""
import json
import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bamgen import write_bam
from diploid import diploid_reads, make_diploid, truth_vcf_lines
from synth import random_genome

from nanosnp_tpu.io.fasta import write_fasta
from nanosnp_tpu.runtime.cli import main as jax_main
from nanosnp_tpu_torch import config as tconfig
from nanosnp_tpu_torch.models.convert import params_to_numpy
from nanosnp_tpu_torch.models.haplotype_model import init_haplotype_params
from nanosnp_tpu_torch.runtime.cli import main as torch_main
from nanosnp_tpu_torch.train import data as D

from test_torch_host_stages import assert_same_npz_dirs
from test_torch_stages import assert_same_calls

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# narrow models; thresholds that let a briefly fitted pileup model feed
# every stage: s3 takes every het call, s4 every site as candidate and
# every het as support
CONFIG = """\
pileup_model:
  hidden_size: 16
  output_size: 32
  inner_size: 32
haplotype_model:
  hidden_size: 16
haplotype_feature:
  phase_het_quality: 0
  hete_support_quality: 0
  low_quality_threshold: 100
inference:
  batch_size: 512
  use_bf16: false
  use_pallas: false
threads: 2
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_call")
    rng = np.random.default_rng(4242)
    genome = random_genome(rng, {"chrA": 30_000, "chrB": 20_000})
    fasta = tmp / "ref.fa"
    write_fasta(str(fasta), genome)
    reads, truth_lines, bed = [], [], []
    for i, (name, seq) in enumerate(genome.items()):
        truth, h1, h2 = make_diploid(rng, seq, n_het=len(seq) // 150,
                                     n_hom=len(seq) // 450, spacing=60)
        reads += diploid_reads(rng, h1, h2, ref_id=i,
                               n_reads=len(seq) * 18 // 220,
                               read_len=220, err=0.05, tag_rate=0.0)
        lines = truth_vcf_lines(name, truth)
        truth_lines += lines if not truth_lines else lines[2:]
        bed.append(f"{name}\t100\t{len(seq) - 100}\n")
    bam = tmp / "sample.bam"
    write_bam(str(bam), [(n, len(s)) for n, s in genome.items()], reads)
    (tmp / "truth.vcf").write_text("".join(truth_lines))
    (tmp / "conf.bed").write_text("".join(bed))
    (tmp / "cfg.yaml").write_text(CONFIG)

    cfg = tconfig.load_config(str(tmp / "cfg.yaml"))
    gen = torch.Generator().manual_seed(7)
    assert torch_main(
        ["make-train-data", "--config", str(tmp / "cfg.yaml"), "--bam",
         str(bam), "--ref", str(fasta), "--truth-vcf", str(tmp / "truth.vcf"),
         "--bed", str(tmp / "conf.bed"), "-o", str(tmp / "mtd_torch")]) == 0
    torch.save(fit_reference_pileup(cfg.pileup_model,
                                    tmp / "mtd_torch" / "train_data"),
               str(tmp / "pileup.chkpt"))
    hparams = init_haplotype_params(gen, cfg.haplotype_model)
    with open(tmp / "hap.ckpt", "wb") as f:
        pickle.dump({"params": params_to_numpy(hparams), "step": 0,
                     "epoch": 0}, f)
    return dict(tmp=tmp, fasta=str(fasta), bam=str(bam),
                contigs=list(genome))


class _RefEncoder(torch.nn.Module):
    def __init__(self, m):
        super().__init__()
        self.lstm = torch.nn.LSTM(m.feature_dim, m.hidden_size,
                                  num_layers=m.n_layers, bidirectional=True,
                                  batch_first=True)
        self.output_proj = torch.nn.Linear(2 * m.hidden_size, m.output_size)


class _RefForward(torch.nn.Module):
    def __init__(self, m):
        super().__init__()
        self.dense = torch.nn.Linear(m.output_size, m.inner_size)
        self.genotype_layer = torch.nn.Linear(m.inner_size, m.gt_num_class)
        self.zygosity_layer = torch.nn.Linear(m.inner_size, m.zy_num_class)
        self.indel1_layer = torch.nn.Linear(m.inner_size, m.indel1_num_class)
        self.indel2_layer = torch.nn.Linear(m.inner_size, m.indel2_num_class)


def fit_reference_pileup(mcfg, data_dir, steps=150, batch=128):
    """A reference-layout checkpoint dict of a pileup model fitted to the
    labeled arrays in `data_dir`: seeded init, seeded batches, Adam."""
    torch.manual_seed(11)
    enc, fwd = _RefEncoder(mcfg), _RefForward(mcfg)
    arrays = [D.load_train_arrays(str(p))
              for p in sorted(data_dir.iterdir())]
    arrays = D.PileupTrainArrays(
        np.concatenate([a.matrix for a in arrays]),
        np.concatenate([a.label for a in arrays]),
        np.concatenate([a.positions for a in arrays]),
        np.concatenate([a.is_variant for a in arrays]))
    opt = torch.optim.Adam(list(enc.parameters()) + list(fwd.parameters()),
                           lr=0.01)
    batches = D.batch_iterator(arrays, batch, np.random.default_rng(3),
                               epochs=10_000)
    for _ in range(steps):
        x, gt, zy = next(batches)
        h, _ = enc.lstm(torch.from_numpy(x))
        feat = torch.tanh(fwd.dense(enc.output_proj(h[:, x.shape[1] // 2])))
        loss = torch.nn.functional.cross_entropy(
            fwd.genotype_layer(feat), torch.from_numpy(gt).long()) \
            + torch.nn.functional.cross_entropy(
                fwd.zygosity_layer(feat), torch.from_numpy(zy).long())
        opt.zero_grad()
        loss.backward()
        opt.step()
    return {"encoder": {k: v.detach() for k, v in enc.state_dict().items()},
            "forward_layer": {k: v.detach()
                              for k, v in fwd.state_dict().items()}}


def call_args(w, out):
    tmp = w["tmp"]
    return ["call", "--config", str(tmp / "cfg.yaml"), "--bam", w["bam"],
            "--ref", w["fasta"], "--pileup-model", str(tmp / "pileup.chkpt"),
            "--haplotype-model", str(tmp / "hap.ckpt"), "--phaser", "native",
            "--contigs"] + w["contigs"] + ["-o", str(out)]


@pytest.fixture(scope="module")
def runs(world):
    """One `call` of each package on the same inputs."""
    tmp = world["tmp"]
    old = os.environ.get("NSP_JAX_CACHE")
    os.environ["NSP_JAX_CACHE"] = "0"
    try:
        assert jax_main(call_args(world, tmp / "run_jax")) == 0
    finally:
        if old is None:
            del os.environ["NSP_JAX_CACHE"]
        else:
            os.environ["NSP_JAX_CACHE"] = old
    assert torch_main(call_args(world, tmp / "run_torch")
                      + ["--device", "cpu"]) == 0
    return tmp / "run_jax", tmp / "run_torch"


def _metrics(run, stage):
    with open(run / ".stages" / f"{stage}.done") as f:
        return json.load(f)["metrics"]


STAGES = ["s1_pileup_features", "s2_pileup_predict", "s3_phasing",
          "s4_haplotype_features", "s5_haplotype_predict", "s6_merge"]


def test_every_stage_ran_and_fed_the_next(runs):
    jrun, trun = runs
    for st in STAGES:
        assert (trun / ".stages" / f"{st}.done").exists(), st
    for st, keys in (("s1_pileup_features", ("rows", "candidates")),
                     ("s2_pileup_predict", ("sites",)),
                     ("s3_phasing", ("sites", "phased_sites", "blocks",
                                     "tagged_reads", "engine")),
                     ("s4_haplotype_features", ("groups", "shards")),
                     ("s5_haplotype_predict", ("sites", "deferred")),
                     ("s6_merge", ("rescued",))):
        jm, tm = _metrics(jrun, st), _metrics(trun, st)
        for k in keys:
            assert tm[k] == jm[k], (st, k)
    assert _metrics(trun, "s1_pileup_features")["candidates"] > 200
    assert _metrics(trun, "s3_phasing")["phased_sites"] > 0
    assert _metrics(trun, "s5_haplotype_predict")["sites"] > 0


def test_host_artifacts_identical(runs):
    jrun, trun = runs
    assert_same_npz_dirs(str(trun / "pileup_shards"),
                         str(jrun / "pileup_shards"))
    assert_same_npz_dirs(str(trun / "haplotype_shards"),
                         str(jrun / "haplotype_shards"))
    got = sorted(os.listdir(trun / "phase_native"))
    assert got == sorted(os.listdir(jrun / "phase_native")) and got
    for name in got:
        if name.endswith(".phased.vcf"):
            assert (trun / "phase_native" / name).read_bytes() == \
                (jrun / "phase_native" / name).read_bytes()
        else:
            a = np.load(trun / "phase_native" / name)
            b = np.load(jrun / "phase_native" / name)
            assert np.array_equal(a["read_ids"], b["read_ids"])
            assert np.array_equal(a["hp"], b["hp"])


@pytest.mark.parametrize("name,qual_col,sample_col",
                         [("pileup.vcf", 5, 9), ("haplotype.csv", 3, None),
                          ("merge.vcf", 5, 9)])
def test_calls_equal_qual_within_a_cent(runs, name, qual_col, sample_col):
    """Same rows and genotypes; QUAL within 0.01. Reports whether the file
    is byte-identical."""
    jrun, trun = runs
    n_rows = sum(1 for line in open(trun / name) if line[0] != "#")
    assert n_rows > 0
    n_qual = assert_same_calls(trun / name, jrun / name, qual_col,
                               sample_col)
    identical = (trun / name).read_bytes() == (jrun / name).read_bytes()
    print(f"{name}: {n_rows} rows, {n_qual} differ in QUAL by 0.01, "
          f"byte-identical: {identical}")
    assert n_qual <= max(0.05 * n_rows, 2)


def test_second_call_resumes_and_runs_no_stage(world, runs):
    _, trun = runs
    before = {st: os.stat(trun / ".stages" / f"{st}.done").st_mtime_ns
              for st in STAGES}
    merge = (trun / "merge.vcf").read_bytes()
    assert torch_main(call_args(world, trun) + ["--device", "cpu"]) == 0
    after = {st: os.stat(trun / ".stages" / f"{st}.done").st_mtime_ns
             for st in STAGES}
    assert after == before
    assert (trun / "merge.vcf").read_bytes() == merge


def _port_cli(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return ([sys.executable, "-m", "nanosnp_tpu_torch.runtime.cli"] + args
            + ["--device", "cpu"]), env


@pytest.mark.parametrize("kill_after", ["s1_pileup_features",
                                        "s4_haplotype_features"])
def test_kill_and_resume_matches_clean_run(world, runs, tmp_path, kill_after):
    """SIGKILL a `call` right after a stage wrote its marker, start the
    same command again: the outputs are the clean run's, byte for byte."""
    _, clean = runs
    out = tmp_path / f"crash_{kill_after}"
    cmd, env = _port_cli(call_args(world, out))
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    marker = out / ".stages" / f"{kill_after}.done"
    deadline = time.monotonic() + 300
    try:
        while time.monotonic() < deadline:
            if marker.exists():
                break
            if proc.poll() is not None:
                pytest.fail(f"pipeline exited before {kill_after} completed")
            time.sleep(0.02)
        else:
            pytest.fail(f"timed out waiting for {marker}")
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    assert not (out / "merge.vcf").exists()

    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert kill_after + ": already done, skipping" in r.stderr
    for name in ("pileup.vcf", "haplotype.csv", "merge.vcf"):
        assert (out / name).read_bytes() == (clean / name).read_bytes(), name


def test_make_train_data_equals_jax_cli(world):
    tmp = world["tmp"]
    args = ["make-train-data", "--config", str(tmp / "cfg.yaml"), "--bam",
            world["bam"], "--ref", world["fasta"], "--truth-vcf",
            str(tmp / "truth.vcf"), "--bed", str(tmp / "conf.bed")]
    assert jax_main(args + ["-o", str(tmp / "mtd_jax")]) == 0
    # the port's arrays are the ones the fixture made for its pileup model
    names = assert_same_npz_dirs(str(tmp / "mtd_torch" / "train_data"),
                                 str(tmp / "mtd_jax" / "train_data"))
    assert names == ["chrA.npz", "chrB.npz"]
    z = np.load(tmp / "mtd_torch" / "train_data" / "chrA.npz")
    assert z["is_variant"].sum() > 50
    # --h5 also writes each contig's reference-layout HDF5 train bin: the
    # same datasets as the JAX CLI's, and the same arrays beside them
    import h5py

    assert jax_main(args + ["--h5", "-o", str(tmp / "mtd_jax_h5")]) == 0
    assert torch_main(args + ["--h5", "-o", str(tmp / "mtd_h5")]) == 0
    got_dir, want_dir = tmp / "mtd_h5" / "train_data", \
        tmp / "mtd_jax_h5" / "train_data"
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir)) == [
        "chrA.bin", "chrA.npz", "chrB.bin", "chrB.npz"]
    for name in ("chrA.bin", "chrB.bin"):
        with h5py.File(got_dir / name) as g, h5py.File(want_dir / name) as w:
            assert sorted(g) == sorted(w) == ["alt_info", "label",
                                              "position", "position_matrix"]
            for k in w:
                assert g[k].dtype == w[k].dtype, (name, k)
                assert np.array_equal(g[k][()], w[k][()]), (name, k)
    for name in ("chrA.npz", "chrB.npz"):
        a, b = np.load(got_dir / name), np.load(want_dir / name)
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_call_refusals(world, tmp_path):
    """What `call` does not do, it says: more than one host without a
    coordinator and a host id (test_torch_multihost.py runs two hosts);
    whatshap is not installed, so that phaser raises as the reference
    does; and the card is the default device, which raises without one."""
    with pytest.raises(ValueError, match="coordinator"):
        torch_main(call_args(world, tmp_path / "mh")
                   + ["--device", "cpu", "--num-hosts", "2"])
    args = [a if a != "native" else "whatshap"
            for a in call_args(world, tmp_path / "ws")]
    with pytest.raises(SystemExit, match="whatshap"):
        torch_main(args + ["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_main(call_args(world, tmp_path / "nocard"))
        assert not (tmp_path / "nocard").exists()
