"""Multi-host `call` of the port on the CPU: two processes joined by gloo
over localhost, each a "host" (one process a GPU on the card), against a
one-process port `call` and a one-process JAX CLI `call` of the same
world.

The world has three contigs, the narrow `--config` and the fitted
reference-layout pileup model of test_torch_call.py, so that every stage
has work on every host. What must hold: each host works its LPT share of
the contigs (parallel/launch.plan_contig_shards) in OUT/host{id}; host
0's merged pileup.vcf, haplotype.csv and merge.vcf are byte-identical to
the one-process port run's (every row is computed on its own, and in f32
on the CPU), and hold to the JAX CLI's rows as test_torch_call.py holds
the one-process port's (same rows and genotypes, QUAL within 0.01 in
fewer than 5% of them); a second two-process call runs no stage and
changes no output; and a host that fails makes both processes exit
non-zero, none waiting for the other."""
import os
import pickle
import socket
import subprocess
import sys

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
from nanosnp_tpu_torch.parallel.launch import plan_contig_shards
from nanosnp_tpu_torch.runtime.cli import main as torch_main

from test_torch_call import CONFIG, fit_reference_pileup
from test_torch_stages import assert_same_calls

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240            # seconds a process of the pair may take
CONTIGS = {"chrA": 16_000, "chrB": 12_000, "chrC": 9_000}
OUTPUTS = ("pileup.vcf", "haplotype.csv", "merge.vcf")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_multihost")
    rng = np.random.default_rng(5150)
    genome = random_genome(rng, CONTIGS)
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
    assert torch_main(
        ["make-train-data", "--config", str(tmp / "cfg.yaml"), "--bam",
         str(bam), "--ref", str(fasta), "--truth-vcf", str(tmp / "truth.vcf"),
         "--bed", str(tmp / "conf.bed"), "-o", str(tmp / "mtd")]) == 0
    torch.save(fit_reference_pileup(cfg.pileup_model,
                                    tmp / "mtd" / "train_data"),
               str(tmp / "pileup.chkpt"))
    hparams = init_haplotype_params(torch.Generator().manual_seed(7),
                                    cfg.haplotype_model)
    with open(tmp / "hap.ckpt", "wb") as f:
        pickle.dump({"params": params_to_numpy(hparams), "step": 0,
                     "epoch": 0}, f)
    args = ["call", "--config", str(tmp / "cfg.yaml"), "--bam", str(bam),
            "--ref", str(fasta), "--pileup-model", str(tmp / "pileup.chkpt"),
            "--haplotype-model", str(tmp / "hap.ckpt"), "--phaser", "native",
            "--contigs"] + list(CONTIGS)
    jax_run = tmp / "jax"
    old = os.environ.get("NSP_JAX_CACHE")
    os.environ["NSP_JAX_CACHE"] = "0"
    try:
        assert jax_main(args + ["-o", str(jax_run)]) == 0
    finally:
        if old is None:
            del os.environ["NSP_JAX_CACHE"]
        else:
            os.environ["NSP_JAX_CACHE"] = old
    args = args + ["--device", "cpu"]
    single = tmp / "single"
    assert torch_main(args + ["-o", str(single)]) == 0
    return dict(tmp=tmp, args=args, single=single, jax=jax_run)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("NSP_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return env


def _two_hosts(args, out):
    """Both hosts of a two-process `call` into `out` -> [(rc, stderr)]."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nanosnp_tpu_torch.runtime.cli"] + args
        + ["-o", str(out), "--coordinator", f"127.0.0.1:{port}",
           "--num-hosts", "2", "--host-id", str(h)],
        env=_env(), cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for h in range(2)]
    try:
        errs = [p.communicate(timeout=TIMEOUT)[1] for p in procs]
        return [(p.returncode, e) for p, e in zip(procs, errs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _body(path):
    with open(path) as f:
        return [l for l in f if not l.startswith("#")]


def _files(root):
    """{relative path: bytes} of every file under root but the run logs."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if n != "pipeline.log":
                p = os.path.join(d, n)
                with open(p, "rb") as f:
                    out[os.path.relpath(p, root)] = (f.read(),
                                                     os.stat(p).st_mtime_ns)
    return out


@pytest.fixture(scope="module")
def two_host_run(world):
    out = world["tmp"] / "multi"
    for rc, err in _two_hosts(world["args"], out):
        assert rc == 0, err[-3000:]
    return out


def test_each_host_works_its_lpt_contig_share(world, two_host_run):
    plan = plan_contig_shards(CONTIGS, 2)
    assert plan == [["chrA"], ["chrB", "chrC"]]
    seen = []
    for h in range(2):
        rows = _body(two_host_run / f"host{h}" / "pileup.vcf")
        got = sorted({r.split("\t")[0] for r in rows})
        assert got == plan[h]
        seen.append(set(got))
        done = os.listdir(two_host_run / f"host{h}" / ".stages")
        assert len([n for n in done if n.endswith(".done")]) == 6
    assert not seen[0] & seen[1]


@pytest.mark.parametrize("name", OUTPUTS)
def test_merged_rows_are_the_one_process_rows_byte_for_byte(
        world, two_host_run, name):
    want = _body(world["single"] / name)
    assert want, f"the one-process run wrote no {name} row"
    assert _body(two_host_run / name) == want


@pytest.mark.parametrize("name,qual_col,sample_col",
                         [("pileup.vcf", 5, 9), ("haplotype.csv", 3, None),
                          ("merge.vcf", 5, 9)])
def test_merged_rows_match_the_jax_call(world, two_host_run, name, qual_col,
                                        sample_col):
    """The merged two-host rows against the JAX CLI's one-process rows:
    same rows and genotypes, QUAL within 0.01 (test_torch_call.py says
    why two frameworks' f32 probabilities may round to either side)."""
    n_rows = len(_body(two_host_run / name))
    assert n_rows > 0
    n_qual = assert_same_calls(two_host_run / name, world["jax"] / name,
                               qual_col, sample_col)
    assert n_qual <= max(0.05 * n_rows, 2)


def test_second_two_host_call_runs_no_stage_and_changes_no_file(
        world, two_host_run):
    before = _files(two_host_run)
    for rc, err in _two_hosts(world["args"], two_host_run):
        assert rc == 0, err[-3000:]
    after = _files(two_host_run)
    assert after.keys() == before.keys()
    for path, (data, mtime) in before.items():
        assert after[path][0] == data, path
        if "/.stages/" in f"/{path}":
            assert after[path][1] == mtime, path     # no stage ran again


def test_a_host_that_fails_fails_both(world):
    out = world["tmp"] / "broken"
    out.mkdir()
    (out / "host1").write_text("a file where host 1's work dir would go\n")
    res = _two_hosts(world["args"], out)
    assert all(rc != 0 for rc, _ in res), [rc for rc, _ in res]
    assert "FileExistsError" in res[1][1]
    assert "host(s) [1] failed" in res[0][1]
    assert not any((out / n).exists() for n in OUTPUTS)
