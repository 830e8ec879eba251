"""Evaluation and the HDF5 bins of the port against the JAX package: the
copied eval/ functions on tests/test_eval.py's inputs; `compare-failed`,
`evaluate-pileup` (with and without --for-evaluate) and
`evaluate-haplotype` through both CLIs on one checkpoint and one data set
(f32 on both sides: `inference: {use_bf16: false}` for the port, whose
`--device cpu` then runs the f32 encoders, as the JAX CLI does); the HDF5
shard and train bins written by one package and read by the other.

The reports must be equal (floats to 1e-9) and the printed confusion
matrices identical: the two packages' f32 probabilities differ only in
summation order, far below the gap between the top two classes of these
inputs.

At the default config (no `inference` section: bf16, `use_pallas: auto`)
the JAX CLI's evaluate commands still compute in f32 on its scan route;
the port's `runtime/evaluate` probabilities are held to the JAX
`pileup_predict` / `haplotype_predict` f32 ones within EVAL_PROB_TOL, and
the CLI reports to the JAX CLI's."""
import json
import pickle
import sys

import numpy as np
import pytest
import torch

from nanosnp_tpu import eval as jax_eval
from nanosnp_tpu.eval import diff as jax_diff
from nanosnp_tpu.eval import f1 as jax_f1
from nanosnp_tpu.io import bins as jax_bins
from nanosnp_tpu.runtime.cli import main as jax_main
from nanosnp_tpu.train import data as JD
from nanosnp_tpu_torch import eval as port_eval
from nanosnp_tpu_torch.config import (HaplotypeModelConfig,
                                      PileupModelConfig)
from nanosnp_tpu_torch.eval import diff as port_diff
from nanosnp_tpu_torch.eval import f1 as port_f1
from nanosnp_tpu_torch.io import bins
from nanosnp_tpu_torch.io.fasta import write_fasta
from nanosnp_tpu_torch.models.convert import params_to_numpy
from nanosnp_tpu_torch.models.haplotype_model import init_haplotype_params
from nanosnp_tpu_torch.models.pileup_model import init_pileup_params
from nanosnp_tpu_torch.runtime.cli import main as torch_main
from nanosnp_tpu_torch.train import data as D

from synth import random_genome
from test_torch_train_step import _hap_batch, _haplotype_world

HDR = ("##fileformat=VCFv4.3\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\t"
       "INFO\tFORMAT\tSample\n")
PILE = dict(hidden_size=16, output_size=32, inner_size=32, n_layers=2)
HAP = dict(hidden_size=8, lstm_layers=2)
CONFIG = """\
pileup_model:
  hidden_size: 16
  output_size: 32
  inner_size: 32
haplotype_model:
  hidden_size: 8
  lstm_layers: 2
inference:
  use_bf16: false
"""
# the same models at the default inference settings
DEFAULT_CONFIG = CONFIG[:CONFIG.index("inference:")]
# f32 on both sides: summation order only
EVAL_PROB_TOL = 1e-5


def _row(ctg, pos, ref, alt, qual=30.0, filt="PASS", gt="0/1"):
    return (f"{ctg}\t{pos}\t.\t{ref}\t{alt}\t{qual}\t{filt}\t.\tGT:GQ:DP:AF\t"
            f"{gt}:30:30:0.5\n")


# -- eval/: the copy against the JAX module --------------------------------

def _f1_cases():
    called = [HDR, _row("c", 10, "A", "C"), _row("c", 20, "G", "T", gt="1/1"),
              _row("c", 30, "T", "A"),
              _row("c", 40, "A", "A", filt="RefCall", gt="0/0"),
              _row("c", 500, "G", "T")]
    truth = [HDR, _row("c", 10, "A", "C"), _row("c", 20, "G", "T", gt="0/1"),
             _row("c", 50, "C", "G", gt="1/1")]
    return [(called, truth, {}),
            (called, truth, {"genotype_aware": False}),
            (called, truth, {"confident_bed": [("c", 0, 100)]})]


@pytest.mark.parametrize("case", range(3))
def test_evaluate_calls_matches_jax(case):
    called, truth, kw = _f1_cases()[case]
    got = port_f1.evaluate_calls(called, truth, **kw)
    want = jax_f1.evaluate_calls(called, truth, **kw)
    assert (got.tp, got.fp, got.fn) == (want.tp, want.fp, want.fn)
    assert got.summary() == want.summary()
    assert port_f1.genotype_confusion(called, truth) == \
        jax_f1.genotype_confusion(called, truth)


def test_diffs_match_jax():
    a = [HDR, _row("c", 10, "A", "C"), _row("c", 20, "G", "T")]
    b = [HDR, _row("c", 10, "A", "G"), _row("c", 30, "T", "A")]
    for x, y in ((a, b), (a, a), (b, a)):
        assert vars(port_diff.diff_vcfs(x, y)) == vars(jax_diff.diff_vcfs(x, y))
    ca = ["chr1\t10\tAC\t12.0\n", "chr1\t20\tGG\t9.0\n", "chr2\t5\tTT\t7.0\n"]
    cb = ["chr1\t10\tAC\t12.5\n", "chr1\t20\tGT\t9.0\n", "chr2\t7\tTT\t7.0\n"]
    assert vars(port_diff.diff_haplotype_csvs(ca, cb)) == \
        vars(jax_diff.diff_haplotype_csvs(ca, cb))
    public = {n for n in dir(jax_eval) if not n.startswith("_")}
    assert public - {"diff", "f1"} <= set(dir(port_eval))


# -- compare-failed --------------------------------------------------------

def test_compare_failed_writes_the_jax_clis_file(tmp_path):
    rng = np.random.default_rng(42)
    genome = random_genome(rng, {"ctg": 300, "ctg2": 200})
    write_fasta(str(tmp_path / "ref.fa"), genome)
    seq = genome["ctg"]

    def alt_of(pos1):
        return "ACGT"[("ACGT".index(seq[pos1 - 1].upper()) + 1) % 4]

    (tmp_path / "truth.vcf").write_text(HDR + "".join(
        _row("ctg", p, seq[p - 1].upper(), alt_of(p), gt=gt)
        for p, gt in ((50, "0/1"), (80, "0|1"), (120, "1/1"), (250, "0/1"))))
    (tmp_path / "conf.bed").write_text("ctg\t0\t200\nctg2\t0\t200\n")
    (tmp_path / "failed.tsv").write_text("".join(
        f"{c}\t{p}\textra\n" for c, p in (("ctg", 50), ("ctg", 80),
                                          ("ctg", 120), ("ctg", 150),
                                          ("ctg", 250), ("ctg2", 50))))
    args = ["compare-failed", "--failed", str(tmp_path / "failed.tsv"),
            "--ref", str(tmp_path / "ref.fa"), "--truth-vcf",
            str(tmp_path / "truth.vcf"), "--bed", str(tmp_path / "conf.bed")]
    assert jax_main(args + ["--out", str(tmp_path / "jax.tsv")]) == 0
    assert torch_main(args + ["--out", str(tmp_path / "port.tsv")]) == 0
    got = (tmp_path / "port.tsv").read_text()
    assert got == (tmp_path / "jax.tsv").read_text()
    assert got.splitlines() == ["ctg\t50\textra", "ctg\t80\textra"]


# -- evaluate-pileup / evaluate-haplotype ----------------------------------

def _stdout_report(capsys):
    """(the JSON line as a dict, the rest of stdout) of a CLI run."""
    lines = capsys.readouterr().out.splitlines()
    at = next(i for i, line in enumerate(lines) if line.startswith("{\""))
    return json.loads(lines[at]), lines[at + 1:]


def _assert_same_reports(port, want, out_port, out_jax, name):
    (pj, ptext), (jj, jtext) = port, want
    assert pj.keys() == jj.keys()
    for k in jj:
        assert pj[k] == pytest.approx(jj[k], abs=1e-9), k
    assert ptext == jtext
    with open(out_port / name) as f, open(out_jax / name) as g:
        fp, fj = json.load(f), json.load(g)
    assert fp.keys() == fj.keys()
    assert all(fp[k] == pytest.approx(fj[k], abs=1e-9) for k in fj)


def _pileup_arrays(rng, n):
    label = np.zeros((n, 90), np.int32)
    label[np.arange(n), rng.integers(0, 21, n)] = 1
    label[np.arange(n), 21 + rng.integers(0, 3, n)] = 1
    return D.PileupTrainArrays(
        rng.integers(-25, 25, (n, 33, 18)).astype(np.int32), label,
        np.arange(n, dtype=np.int64), label[:, 22:24].any(1))


@pytest.fixture(scope="module")
def eval_world(tmp_path_factory):
    """Two labeled pileup array files, a haplotype world (shards, truth,
    BED), a pickled checkpoint of seeded weights for each model, and the
    YAML both CLIs read."""
    tmp = tmp_path_factory.mktemp("torch_eval")
    rng = np.random.default_rng(31)
    (tmp / "data").mkdir()
    for ctg, n in (("chr1", 700), ("chr2", 333)):
        D.save_train_arrays(str(tmp / "data" / f"{ctg}.npz"),
                            _pileup_arrays(rng, n))
    _haplotype_world(tmp, rng)
    (tmp / "cfg.yaml").write_text(CONFIG)
    (tmp / "default.yaml").write_text(DEFAULT_CONFIG)
    gen = torch.Generator().manual_seed(5)
    for name, params in (
            ("pileup.ckpt", init_pileup_params(gen, PileupModelConfig(**PILE))),
            ("hap.ckpt", init_haplotype_params(
                gen, HaplotypeModelConfig(**HAP)))):
        with open(tmp / name, "wb") as f:
            pickle.dump({"params": params_to_numpy(params), "step": 0,
                         "epoch": 0}, f)
    return tmp


@pytest.mark.parametrize("for_evaluate", [False, True])
def test_evaluate_pileup_reports_what_the_jax_cli_reports(
        eval_world, capsys, tmp_path, for_evaluate):
    w = eval_world
    args = ["evaluate-pileup", "--config", str(w / "cfg.yaml"), "--data",
            str(w / "data"), "--model", str(w / "pileup.ckpt"),
            "--batch-size", "256"] + (["--for-evaluate"] if for_evaluate
                                      else [])
    capsys.readouterr()
    assert jax_main(args + ["-o", str(tmp_path / "jax")]) == 0
    want = _stdout_report(capsys)
    assert torch_main(args + ["-o", str(tmp_path / "port"), "--device",
                              "cpu"]) == 0
    got = _stdout_report(capsys)
    _assert_same_reports(got, want, tmp_path / "port", tmp_path / "jax",
                         "evaluate_pileup.json")
    n_rows = 1033
    n_variant = sum(int((np.load(w / "data" / f)["label"][:, 22:24]).sum())
                    for f in ("chr1.npz", "chr2.npz"))
    assert got[0]["n"] == (n_variant if for_evaluate else n_rows)
    # the seeded model predicts more than one class
    matrix = np.array([[int(v) for v in line.split()[1:]]
                       for line in got[1][1:22]])
    assert (matrix.sum(0) > 0).sum() > 1


def test_evaluate_haplotype_reports_what_the_jax_cli_reports(
        eval_world, capsys, tmp_path):
    w = eval_world
    args = ["evaluate-haplotype", "--config", str(w / "cfg.yaml"),
            "--shards", str(w / "shards"), "--ref", str(w / "ref.fa"),
            "--truth-vcf", str(w / "truth.vcf"), "--bed", str(w / "conf.bed"),
            "--model", str(w / "hap.ckpt"), "--batch-size", "64"]
    capsys.readouterr()
    assert jax_main(args + ["-o", str(tmp_path / "jax")]) == 0
    want = _stdout_report(capsys)
    assert torch_main(args + ["-o", str(tmp_path / "port"), "--device",
                              "cpu"]) == 0
    got = _stdout_report(capsys)
    _assert_same_reports(got, want, tmp_path / "port", tmp_path / "jax",
                         "evaluate_haplotype.json")
    # the sites in batches of 64 end in a tiled tail, scored once
    assert got[0]["n"] > 64 and got[0]["n"] % 64


def _jax_probabilities(w, cmd):
    """The JAX package's f32 predict functions (their defaults, as its
    CLI calls them) on the batches the port's evaluate generator scores,
    in its order."""
    import jax.numpy as jnp

    from nanosnp_tpu import config as jconfig
    from nanosnp_tpu.features.haplotype import haplotype_features
    from nanosnp_tpu.models.haplotype_model import haplotype_predict
    from nanosnp_tpu.models.pileup_model import pileup_predict
    from nanosnp_tpu.train.train_pileup import load_checkpoint

    cfg = jconfig.load_config(str(w / "default.yaml"))
    if cmd == "evaluate-pileup":
        params, _ = load_checkpoint(str(w / "pileup.ckpt"))
        for path in bins.list_shards(str(w / "data")):
            x = JD.load_train_arrays(path).matrix.astype(np.float32)
            yield [np.asarray(p) for p in pileup_predict(
                params, jnp.asarray(x), cfg.pileup_model)]
        return
    from nanosnp_tpu_torch.io.fasta import FastaReference
    from nanosnp_tpu_torch.runtime import evaluate as E

    params, _ = load_checkpoint(str(w / "hap.ckpt"))
    ref = FastaReference(str(w / "ref.fa"))
    truth = E.truth_arrays(ref, str(w / "truth.vcf"), str(w / "conf.bed"))
    D.set_reference_for_training({n: ref.contig(n) for n in ref.names})
    for batch in D.haplotype_train_iterator(
            bins.list_shards(str(w / "shards")), truth, 64,
            np.random.default_rng(0), epochs=1, pn_value=1.0):
        n = batch.pop("_n", None)
        feats = [haplotype_features(*[
            jnp.asarray(batch[v + k], jnp.float32)
            for k in ("seq", "baseq", "mapq", "hap", "ref")])
            for v in ("p_", "h_")]
        yield [np.asarray(p)[:n] for p in haplotype_predict(
            params, *feats, cfg.haplotype_model)]


@pytest.mark.parametrize("cmd", ["evaluate-pileup", "evaluate-haplotype"])
def test_evaluate_at_the_default_config_computes_as_the_jax_cli(
        eval_world, capsys, tmp_path, cmd):
    """The default config asks for bf16; the JAX CLI's evaluate commands
    compute in f32 regardless, and so must the port's."""
    from nanosnp_tpu_torch.config import load_config
    from nanosnp_tpu_torch.io.fasta import FastaReference
    from nanosnp_tpu_torch.runtime import evaluate as E

    w = eval_world
    cfg = load_config(str(w / "default.yaml"))
    assert cfg.inference.use_bf16 and cfg.inference.use_pallas == "auto"
    if cmd == "evaluate-pileup":
        got = E.pileup_scores(cfg, str(w / "pileup.ckpt"), str(w / "data"),
                              False, 256, "cpu")
    else:
        ref = FastaReference(str(w / "ref.fa"))
        got = E.haplotype_scores(
            cfg, str(w / "hap.ckpt"), bins.list_shards(str(w / "shards")),
            ref, E.truth_arrays(ref, str(w / "truth.vcf"),
                                str(w / "conf.bed")), 64, "cpu")
    got, want = list(got), list(_jax_probabilities(w, cmd))
    assert len(got) == len(want) > 0
    worst = 0.0
    for (gt_p, zy_p, _, _), (gt_w, zy_w) in zip(got, want):
        for g, v in ((gt_p, gt_w), (zy_p, zy_w)):
            assert g.shape == v.shape
            worst = max(worst, float(np.abs(g - v).max()))
    assert worst <= EVAL_PROB_TOL, worst

    if cmd == "evaluate-pileup":
        args = ["--data", str(w / "data"), "--model", str(w / "pileup.ckpt"),
                "--batch-size", "256"]
    else:
        args = ["--shards", str(w / "shards"), "--ref", str(w / "ref.fa"),
                "--truth-vcf", str(w / "truth.vcf"), "--bed",
                str(w / "conf.bed"), "--model", str(w / "hap.ckpt"),
                "--batch-size", "64"]
    args = [cmd, "--config", str(w / "default.yaml")] + args
    capsys.readouterr()
    assert jax_main(args + ["-o", str(tmp_path / "jax")]) == 0
    want_report = _stdout_report(capsys)
    assert torch_main(args + ["-o", str(tmp_path / "port"), "--device",
                              "cpu"]) == 0
    name = cmd.replace("-", "_") + ".json"
    _assert_same_reports(_stdout_report(capsys), want_report,
                         tmp_path / "port", tmp_path / "jax", name)
    print(f"{cmd} at the default config: max |dp| {worst:.2e} against the "
          "JAX f32 predict")


@pytest.mark.parametrize("cmd", ["evaluate-pileup", "evaluate-haplotype"])
def test_evaluate_clis_ask_for_the_card_and_raise_before_writing(
        eval_world, tmp_path, cmd):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    w = eval_world
    extra = (["--data", str(w / "data"), "--model", str(w / "pileup.ckpt")]
             if cmd == "evaluate-pileup" else
             ["--shards", str(w / "shards"), "--ref", str(w / "ref.fa"),
              "--truth-vcf", str(w / "truth.vcf"), "--bed",
              str(w / "conf.bed"), "--model", str(w / "hap.ckpt")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_main([cmd, "-o", str(tmp_path / "out")] + extra)
    assert not (tmp_path / "out").exists()


# -- HDF5 bins --------------------------------------------------------------

def _pileup_shard(mod, rng, n=37):
    refs = np.array([bytes(rng.choice(list(b"ACGT"), 33)) for _ in range(n)],
                    dtype="S33")
    return mod.PileupShard(
        contig="chr7", positions=np.sort(rng.choice(10_000, n, False)) + 1,
        matrix=rng.integers(-30, 30, (n, 33, 18)).astype(np.int32),
        ref_seqs=refs,
        alt_info=np.array([f"{i}-A:{i % 5}".encode() for i in range(n)],
                          dtype=object))


def _train_arrays(mod, rng, n=29):
    label = np.zeros((n, 90), np.int32)
    label[np.arange(n), rng.integers(0, 21, n)] = 1
    label[np.arange(n), 21 + rng.integers(0, 3, n)] = 1
    return mod.PileupTrainArrays(
        matrix=rng.integers(-30, 30, (n, 33, 18)).astype(np.int32),
        label=label, positions=np.arange(100, 100 + n, dtype=np.int64),
        is_variant=label[:, 22:24].any(1), contig="chr3",
        ref_seqs=np.array([bytes(rng.choice(list(b"ACGT"), 33))
                           for _ in range(n)], dtype="S33"),
        alt_info=np.array([f"a{i}".encode() for i in range(n)], dtype=object))


def _haplotype_shard(mod, rng, n=19):
    b = _hap_batch(rng, n, 5)
    pos = np.sort(rng.choice(np.arange(100, 5000), n, False)).astype(np.int64)
    shard = mod.HaplotypeShard(
        contig="chr2", candidate_positions=pos,
        group_positions=pos[:, None] + np.arange(-5, 6)[None, :],
        pileup={k: b["p_" + k].astype(np.int32)
                for k in ("seq", "baseq", "mapq", "hap")},
        haplotype={k: b["h_" + k].astype(np.int32)
                   for k in ("seq", "baseq", "mapq", "hap")})
    for view in (shard.pileup, shard.haplotype):
        view["sequences"] = view.pop("seq")
    return shard


def _assert_same(a, b):
    """Equal dataclasses of arrays, dicts of arrays and strings."""
    va, vb = vars(a), vars(b)
    assert va.keys() == vb.keys()
    for k in va:
        x, y = va[k], vb[k]
        if isinstance(x, dict):
            assert x.keys() == y.keys(), k
            for kk in x:
                assert x[kk].dtype == y[kk].dtype and np.array_equal(
                    x[kk], y[kk]), (k, kk)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), k
        else:
            assert x == y, k


H5_KINDS = {
    "pileup_shard": (_pileup_shard, "save_pileup_shard_h5",
                     "load_pileup_shard_h5"),
    "pileup_train": (_train_arrays, "save_pileup_train_h5",
                     "load_pileup_train_h5"),
    "haplotype_shard": (_haplotype_shard, "save_haplotype_shard_h5",
                        "load_haplotype_shard_h5"),
}
PACKAGES = {"port": (bins, D), "jax": (jax_bins, JD)}


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "jax"),
                                           ("jax", "port")])
@pytest.mark.parametrize("kind", sorted(H5_KINDS))
def test_h5_bins_read_back_equal_across_packages(tmp_path, kind, writer,
                                                 reader):
    make, save, load = H5_KINDS[kind]
    rng = np.random.default_rng(17)
    wb, wd = PACKAGES[writer]
    obj = make(wd if kind == "pileup_train" else wb, rng)
    path = str(tmp_path / "x.bin")
    getattr(wb, save)(path, obj)
    got = getattr(PACKAGES[reader][0], load)(path)
    # what the reader's own package reads from its own writer's file
    rb, rd = PACKAGES[reader]
    want_obj = make(rd if kind == "pileup_train" else rb,
                    np.random.default_rng(17))
    getattr(rb, save)(str(tmp_path / "own.bin"), want_obj)
    want = getattr(rb, load)(str(tmp_path / "own.bin"))
    _assert_same(got, want)
    # and the numbers are the ones written
    for k, v in vars(obj).items():
        if isinstance(v, dict):
            for kk in v:
                assert np.array_equal(getattr(got, k)[kk], v[kk]), (k, kk)
        elif isinstance(v, np.ndarray) and v.dtype.kind in "iub":
            assert np.array_equal(getattr(got, k), v), k


def test_h5_bins_need_h5py(tmp_path, monkeypatch):
    """Where h5py is not installed (the card's machine) the HDF5 helpers
    raise an ImportError that says so; nothing else of io.bins needs it."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    shard = _pileup_shard(bins, np.random.default_rng(1))
    for fn, a in ((bins.save_pileup_shard_h5, (shard,)),
                  (bins.load_pileup_shard_h5, ()),
                  (bins.load_pileup_train_h5, ()),
                  (bins.load_haplotype_shard_h5, ())):
        with pytest.raises(ImportError, match="h5py"):
            fn(str(tmp_path / "x.bin"), *a)
    bins.save_pileup_shard(str(tmp_path / "x.npz"), shard)
    assert len(bins.load_pileup_shard(str(tmp_path / "x.npz"))) == len(shard)
    # make-train-data --h5 says so before it reads any input
    with pytest.raises(ImportError, match="h5py"):
        torch_main(["make-train-data", "--bam", str(tmp_path / "none.bam"),
                    "--ref", str(tmp_path / "none.fa"), "--truth-vcf",
                    str(tmp_path / "none.vcf"), "--h5", "-o",
                    str(tmp_path / "out")])
