"""The reference and the check: the frozen decode on a hand-worked case,
the seeded worlds, the control coming out as not correct, and every
fault the cells can have turning `correct` false."""
import subprocess
import sys

import numpy as np
import pytest
import torch

import harness
import reference.decode as RD
from conftest import BENCH, tiny_cell
from worlds import haplotype as HW
from worlds import pileup as PW
from worlds.weights import make_params


def _probs(cls, p, n):
    row = np.full(n, (1 - p) / (n - 1))
    row[cls] = p
    return row


def test_decode_hand_worked_case():
    center = np.zeros((4, 18), np.int16)
    center[0, 0], center[0, 9] = -5, -3            # A reads: depth 8
    center[1, 1], center[1, 10] = -4, -2           # C reads: depth 6
    center[1, 0], center[1, 9] = 3, 1              # A support 4
    center[2, 2] = -7
    center[3, 0] = -9
    gt = np.stack([_probs(0, 0.9, 21), _probs(1, 0.9, 21),
                   _probs(15, 0.9, 21), _probs(0, 0.9, 21)])
    zy = np.stack([_probs(0, 0.8, 3), _probs(2, 0.8, 3), _probs(0, 0.8, 3),
                   _probs(1, 0.8, 3)])
    rows = RD.pileup_rows(np.array([10, 20, 30, 40]), "ACGA", gt, zy, center)
    # phred(0.9) = 10 log10(9) + 10 = 19.54, phred(0.8) = 16.02
    assert rows[10] == (("A", "A", "RefCall", "0/0", "8", "0.000000"),
                        16.02, False)
    assert rows[20] == (("C", "A", "PASS", "0/1", "6", "0.666667"),
                        16.02, False)
    assert 30 not in rows          # an indel class: no row
    assert 40 not in rows          # the fallback reads row 4 of a 4-row batch
    assert RD.phred(0.9) == 19.54


def test_worlds_repeat_for_a_seed_and_have_the_stated_sizes():
    t = harness.load_cell("pileup.s2")["traffic"]
    a = PW.pileup_world(np.random.default_rng([5, 2]), 50_000, 2_000)
    b = PW.pileup_world(np.random.default_rng([5, 2]), 50_000, 2_000)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a.columns.shape == (50_000, 18) and len(a.positions) == 2_000
    assert t["candidates"] == 100_000 and t["contig_bp"] == 3_000_000
    h = harness.load_cell("haplotype.s5")["traffic"]
    w1 = HW.hap_world(np.random.default_rng(9), 30_000, 100, (64, 96), 0.25)
    w2 = HW.hap_world(np.random.default_rng(9), 30_000, 100, (64, 96), 0.25)
    for b1, b2 in zip(w1.buckets, w2.buckets):
        assert np.array_equal(b1.centers, b2.centers)
        assert all(np.array_equal(b1.pileup[k], b2.pileup[k])
                   for k in b1.pileup)
        assert b1.pileup["sequences"].shape == (100, b1.depth, 33)
        untagged = b1.haplotype["hap"][:25]
        assert ((untagged == 3) | (untagged == -2)).all()
    assert h["sites_per_bucket"] * len(h["depths"]) == 16_000
    p1 = PW.pileup_train_arrays(np.random.default_rng(3), 100)
    p2 = PW.pileup_train_arrays(np.random.default_rng(3), 100)
    assert np.array_equal(p1.matrix, p2.matrix)
    assert harness.load_cell("pileup.train")["traffic"]["rows"] == 40_000


def test_truth_repeats_for_a_seed_and_matches_its_vcf(tmp_path):
    """The haplotype trainer's labels are checked against the truth that
    the world's generator returns: the same for a seed, and the VCF's."""
    w = HW.hap_world(np.random.default_rng(4), 20_000, 50, (64,), 0.0)
    runs = []
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
        runs.append(HW.truth_files(np.random.default_rng(6), w,
                                   str(tmp_path / d), "chr1"))
    assert runs[0][2] == runs[1][2] and runs[0][2]
    rows = [r.rstrip("\n").split("\t") for r in open(runs[0][0])
            if r[0] != "#"]
    for _, pos, _, ref, alt, *_, gt in rows:
        pair, zy = runs[0][2][int(pos)]
        want = sorted(ref + alt) if gt == "0|1" else [alt, alt]
        assert list(pair) == want and zy == (2 if gt == "0|1" else 1)


def test_weights_repeat_for_a_seed():
    model = harness.load_cell("pileup.s2")["config_data"]["model"]
    a = make_params(model, 2 ** 31 + 7, "cpu")
    b = make_params(model, 2 ** 31 + 7, "cpu")
    assert torch.equal(a["encoder"][1]["w_hh"], b["encoder"][1]["w_hh"])
    assert a["encoder"][0]["w_ih"].shape == (2, 18, 256)


@pytest.mark.parametrize("name", ["pileup.s2", "haplotype.s5",
                                  "pileup.train", "haplotype.train"])
def test_control_is_not_correct(name):
    """A run with the control in the program's place (the reference one
    precision down: fp8 for the stages' bf16, TF32 for the trainers' f32)
    comes out not correct through the harness's own comparison."""
    res = harness.run_cell(tiny_cell(name), 11, 0.2, False, "cpu",
                           control=True, log=lambda m: None)
    assert res["correct"] is False and res["failed"] >= 1, res["readings"]


FAULTS = [("pileup.s2", "answer"), ("pileup.s2", "half"),
          ("haplotype.s5", "answer"), ("haplotype.s5", "half"),
          ("pileup.train", "unchanged"), ("pileup.train", "half"),
          ("pileup.train", "label"),
          ("haplotype.train", "unchanged"), ("haplotype.train", "half"),
          ("haplotype.train", "label")]


@pytest.mark.parametrize("name", ["pileup.s2", "haplotype.s5",
                                  "pileup.train", "haplotype.train"])
def test_a_sound_run_is_correct(name):
    """The same run as the faults' below, with nothing broken, is
    correct: the faults fail for what they break."""
    res = harness.run_cell(tiny_cell(name), 2 ** 31 + 3, 0.2, False, "cpu",
                           log=lambda m: None)
    assert res["correct"] is True, res["readings"]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    """A run with the look for a chip skipped and the timed path broken
    underneath prints correct false."""
    res = harness.run_cell(tiny_cell(name), 2 ** 31 + 3, 0.2, False, "cpu",
                           fault=fault, log=lambda m: None)
    assert res["correct"] is False and res["failed"] >= 1
    assert list(res)[-1] == "checks"


@pytest.mark.gpu
def test_control_fails_on_the_card(card):
    res = harness.run_cell(tiny_cell("pileup.s2"), 12, 0.2, False, card,
                           control=True, log=lambda m: None)
    assert res["correct"] is False


def _modules_after(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); sys.path.insert(0, '..')\n"
            "import harness\n"
            "for n in ('stage_s2', 'stage_s5', 'train'):\n"
            "    harness.load_module('drivers', n)\n"
            "import nanosnp_tpu_torch.runtime.stages, "
            "nanosnp_tpu_torch.train.train_haplotype, "
            "nanosnp_tpu_torch.train.data, nanosnp_tpu_torch.runtime.evaluate\n"
            "print(harness.forbidden_modules())")
    assert _modules_after(code) == "[]"


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["nanosnp_tpu_torch.models.bilstm", "jaxlib_like", "flaxen"]) == []
    assert harness.forbidden_modules(
        ["nanosnp_tpu.ops", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "nanosnp_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import reference.models, reference.train, reference.decode, "
            "reference.features, reference.compare, reference.precision\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'nanosnp_tpu_torch', 'nanosnp_tpu', 'jax'}))")
    assert _modules_after(code) == "[]"


def test_s2_gap_finds_the_classes_behind_a_row():
    """A row written from a near-tie's other class reads the tie's cost;
    a row no near class gives reads large."""
    from reference.compare import margins, s2_gaps

    n = 10
    pos = np.arange(100, 100 + n)
    center = np.zeros((n, 18), np.int16)
    center[:, 2], center[:, 11] = -6, -2               # G reads: depth 8
    gt = np.stack([_probs(4, 0.5, 21)] * n)
    gt[0] = _probs(7, 0.182, 21)
    gt[0, 5] = 0.180                                   # CG just below GG
    zy = np.stack([_probs(1, 0.8, 3)] * n)
    bases = "G" * n
    ref = RD.pileup_rows(pos, bases, gt, zy, center)

    def rows_of(combos):
        return RD.site_rows(pos, bases, gt, zy, center, combos=combos)

    lp_gt, lp_zy = np.log(gt), np.log(zy)
    heads = np.full(n, margins(lp_gt)[:10].min())     # one decode batch
    cov = center[0, RD.COV_CH].astype(np.int64)
    flipped = RD.row_for("G", 5, 1, RD.phred(0.182), RD.phred(0.8), cov,
                         gt.argmax(1))
    prog = {p: r[:2] for p, r in ref.items()}
    prog[100] = flipped[:2]
    g = s2_gaps(prog, ref, pos, lp_gt, lp_zy, heads, rows_of)
    assert g["decision_gap"] == pytest.approx(np.log(0.182 / 0.180))
    assert g["qual_gap"] == 0.0
    wrong = RD.row_for("G", 3, 1, RD.phred(0.182), RD.phred(0.8), cov,
                       gt.argmax(1))               # AT: no near class
    prog[100] = wrong[:2]
    g = s2_gaps(prog, ref, pos, lp_gt, lp_zy, heads, rows_of)
    assert g["decision_gap"] > 1.0


def test_s2_qual_follows_the_classes_that_gave_the_row():
    """A near-tie flip that writes the reference's fields with another
    QUAL (a fallback row against a het row of the same alt) reads the
    tie's cost, not a QUAL gap."""
    from reference.compare import margins, s2_gaps

    n = 10
    pos = np.arange(100, 100 + n)
    center = np.zeros((n, 18), np.int16)
    center[:, 2], center[:, 11] = -6, -2
    gt = np.stack([_probs(4, 0.5, 21)] * n)
    gt[4] = _probs(20, 0.5, 21)          # the fallback reads row 4: CC
    gt[0] = _probs(7, 0.182, 21)
    gt[0, 5] = 0.180
    zy = np.stack([_probs(1, 0.8, 3)] * n)
    bases = "G" * n
    ref = RD.pileup_rows(pos, bases, gt, zy, center)
    cov = center[0, RD.COV_CH].astype(np.int64)
    flipped = RD.row_for("G", 5, 1, RD.phred(0.182), RD.phred(0.8), cov,
                         gt.argmax(1))
    assert ref[100][0] == flipped[0] and ref[100][1] - flipped[1] > 10
    prog = {p: r[:2] for p, r in ref.items()}
    prog[100] = flipped[:2]
    lp_gt, lp_zy = np.log(gt), np.log(zy)
    heads = np.full(n, margins(lp_gt)[:10].min())
    g = s2_gaps(prog, ref, pos, lp_gt, lp_zy, heads,
                lambda combos: RD.site_rows(pos, bases, gt, zy, center,
                                            combos=combos))
    assert g["decision_gap"] == pytest.approx(np.log(0.182 / 0.180))
    assert g["qual_gap"] == 0.0
