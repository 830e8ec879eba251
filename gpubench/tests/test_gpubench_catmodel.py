"""The CatModel trainer cell and the several-contig s2 cell: their worlds,
work, readers and checks at a size a CPU test can hold (widths as
published, fewer groups, sites and rows)."""
import subprocess
import sys

import numpy as np
import pytest
import torch

import harness
from conftest import BENCH
from worlds import contigs as CW
from worlds import legacy as LW


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two threads a process, so that test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(name: str) -> dict:
    cell = harness.load_cell(name)
    if name == "catmodel.train":
        cell["traffic"].update(groups=96)
        cell["config_data"]["train"]["batch_size"] = 8
    else:
        cell["traffic"].update(contigs=3, contig_bp=20_000,
                               candidates_per_contig=300)
    return cell


def test_the_legacy_world_repeats_for_a_seed_and_is_ragged():
    t = harness.load_cell("catmodel.train")["traffic"]
    a = LW.legacy_world(np.random.default_rng([5, 2]), 400, (8, 20), 20,
                        0.4, 0.6)
    b = LW.legacy_world(np.random.default_rng([5, 2]), 400, (8, 20), 20,
                        0.4, 0.6)
    assert np.array_equal(a.labels, b.labels)
    for v in ("surrounding", "het"):
        for x, y in zip(a.views[v], b.views[v]):
            assert all(np.array_equal(x[k], y[k]) for k in x)
            depth = (x["read"] != -2).any(2).sum(1)
            assert depth.min() >= 8 and depth.max() <= 20 and depth.min() < 20
    zy = a.labels[:, 2]
    assert 0.3 < (zy >= 0).mean() < 0.5 and (zy == 2).sum() > (zy == 1).sum()
    assert t["groups"] == 32_768 and t["depth"] == [8, 20]


def test_catmodel_weights_repeat_for_a_seed():
    model = harness.load_cell("catmodel.train")["config_data"]["model"]
    a = LW.catmodel_params(model, 2 ** 31 + 7, "cpu")
    b = LW.catmodel_params(model, 2 ** 31 + 7, "cpu")
    assert torch.equal(a["res_blocks"][5]["conv2"],
                       b["res_blocks"][5]["conv2"])
    assert a["res_blocks"][0]["conv1"].shape == (32, 10, 3, 3)
    assert a["percentage_rnn"][0]["w_ih"].shape == (2, 20, 1024)
    assert torch.equal(a["res_blocks"][1]["bn2"]["var"], torch.ones(64))


def test_catmodel_flop_and_conv_bound():
    """The forward FLOP a sample (434.3 M: the tower 297.8 M) and the
    tower's bound at batch 512."""
    model = harness.load_cell("catmodel.train")["config_data"]["model"]
    fam = harness.work_families()["catmodel_model"]
    tower = harness.load_module("work", "_conv_tower")
    assert round(fam.forward_flop(model, True) / 1e6, 1) == 434.3
    fprop = sum(c["flop"] for c in tower.convs(model) if c["pass"] == "fprop")
    assert round(fprop / 1e6, 1) == 297.8
    # 18 convolutions forward and for their weights, 16 for their input
    # (the two that read the images take none)
    assert len(tower.convs(model)) == 18 * 2 + 16
    call = {"op": "conv_tower", "n": 512, "count": 1}
    assert round(tower.bound(call, model) * 1e3, 2) == 6.84
    assert tower.bound({"op": "lstm_train", "n": 512, "L": 11, "H": 256,
                        "count": 1}, model) is None
    assert "_conv_tower" not in harness.work_families()


class _Trace:
    def __init__(self, ran, window_s=10.0):
        self.ran, self.window_s = ran, window_s

    def kernel_seconds(self, names):
        hit = [n for n in self.ran if any(k in n for k in names)]
        return (2.0 * len(hit), len(hit))


def test_conv_readers_count_the_tower_alone():
    model = harness.load_cell("catmodel.train")["config_data"]["model"]
    tower = harness.load_module("work", "_conv_tower")

    class Ctx:
        config = {"model": model}
        window = {"calls": [{"op": "lstm_train", "n": 512, "L": 11, "H": 256,
                             "count": 100},
                            {"op": "conv_tower", "n": 512, "count": 100}]}
        trace = _Trace([tower.KERNELS[0] + "_some_tile"])

    roof = harness.load_module("metrics", "conv_roofline.train")
    share = harness.load_module("metrics", "conv_share.train")
    want = 100 * tower.bound(Ctx.window["calls"][1], model) / 2.0
    assert roof.read(Ctx) == pytest.approx(want)
    assert share.read(Ctx) == pytest.approx(20.0)
    Ctx.trace = _Trace(["lstm_fwd_cluster_kernel"])
    assert roof.read(Ctx) is None and share.read(Ctx) is None
    Ctx.window = {"calls": Ctx.window["calls"][:1]}
    Ctx.trace = _Trace([tower.KERNELS[0]])
    assert roof.read(Ctx) is None and share.read(Ctx) is None


@pytest.mark.gpu
def test_no_kernel_but_the_towers_bears_its_names(card, tmp_path,
                                                  monkeypatch):
    """On the card, at the cell's batch and widths: the kernels of one
    training step (work/_conv_tower.py's KERNELS pick out the tower's by
    name), once whole and once with every ResBlock stubbed out (a mean
    over channels in its output's shape: no convolution, no BatchNorm).
    The whole step's tower kernels match; none of the stubbed step's
    (the BiLSTMs, projections, head, pools, Adam) does, so the readers
    count no other GEMM as the tower's."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from nanosnp_tpu_torch.legacy import catmodel as CM
    from nanosnp_tpu_torch.legacy.train import (CatModelTrainer,
                                                int8_images)

    cell = harness.load_cell("catmodel.train")
    m, n = cell["config_data"]["model"], \
        cell["config_data"]["train"]["batch_size"]
    w = LW.legacy_world(np.random.default_rng([7, 2]), n,
                        tuple(cell["traffic"]["depth"]), m["max_depth"],
                        0.4, 0.6)
    g0, g1 = (int8_images(CM.build_g_images(*w.views[v], m["max_depth"]))
              for v in ("surrounding", "het"))
    tr = CatModelTrainer(LW.catmodel_params(m, 7, card), batch_size=n,
                         device=card, use_kernels=True,
                         out_dir=str(tmp_path), gt_classes=m["gt_num_class"])
    batch = {"g0": g0[:n], "g1": g1[:n], "y": w.labels[:n, 1]}
    tower = harness.load_module("work", "_conv_tower")

    def matched():
        tr.run_group([batch])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tr.run_group([batch])
            torch.cuda.synchronize()
        path = str(tmp_path / "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            names = {e["name"] for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"}
        assert names
        return sorted(k for k in names
                      if any(p in k for p in tower.KERNELS))

    assert matched()
    monkeypatch.setattr(CM.ResBlock, "forward", lambda self, x, train: (
        x.mean(1, keepdim=True).expand(x.shape[0], self.conv1.shape[0],
                                       *x.shape[2:])))
    assert matched() == []


def test_write_idle_reads_the_idle_inside_s2s_waits():
    from trace_reduce import WINDOW_SPAN, Reduced

    class Ctx:
        window = {}

    read = harness.load_module("metrics", "write_idle.infer").read
    device = [("k1", 10.0, 20.0), ("k2", 30.0, 60.0)]
    host = [(WINDOW_SPAN, 0.0, 100.0), ("nsp.s2.write_wait", 0.0, 40.0),
            ("nsp.s2.write_wait", 90.0, 110.0), ("nsp.s2.write", 40.0, 90.0)]
    Ctx.trace = Reduced(device, host, (0.0, 100.0))
    # 0..40 less busy 10..20 and 30..40, and 90..100
    assert read(Ctx) == pytest.approx(30.0)
    Ctx.trace = Reduced(device, host[:1] + host[-1:], (0.0, 100.0))
    assert read(Ctx) is None


def test_contig_worlds_write_a_shard_a_contig(tmp_path):
    from nanosnp_tpu_torch.io import bins, fasta

    worlds = CW.contig_worlds(np.random.default_rng(3), 3, 5_000, 40)
    fa, shards = CW.write_contigs(worlds, str(tmp_path), bins, fasta)
    paths = bins.list_shards(shards)
    assert len(paths) == 3
    ref = fasta.FastaReference(fa)
    for name, w, path in zip(CW.contig_names(3), worlds, paths):
        s = bins.load_pileup_shard(path)
        assert s.contig == name and np.array_equal(s.positions, w.positions)
        assert np.array_equal(ref.contig(name), w.seq)


@pytest.mark.parametrize("name", ["catmodel.train", "pileup.s2_sparse"])
def test_a_sound_run_is_correct_and_the_control_is_not(name):
    res = harness.run_cell(tiny(name), 2 ** 31 + 3, 0.2, False, "cpu",
                           log=lambda m: None)
    assert res["correct"] is True, res["readings"]
    assert res["window"]["attempted"] > 0
    res = harness.run_cell(tiny(name), 2 ** 31 + 3, 0.2, False, "cpu",
                           control=True, log=lambda m: None)
    assert res["correct"] is False and res["failed"] >= 1, res["readings"]


@pytest.mark.parametrize("name,fault", [
    ("catmodel.train", "unchanged"), ("catmodel.train", "half"),
    ("catmodel.train", "label"), ("pileup.s2_sparse", "answer"),
    ("pileup.s2_sparse", "half")])
def test_a_broken_timed_path_is_not_correct(name, fault):
    res = harness.run_cell(tiny(name), 2 ** 31 + 3, 0.2, False, "cpu",
                           fault=fault, log=lambda m: None)
    assert res["correct"] is False and res["failed"] >= 1


def test_the_catmodel_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import reference.catmodel\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'nanosnp_tpu_torch', 'nanosnp_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_new_drivers_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); sys.path.insert(0, '..')\n"
            "import harness\n"
            "for n in ('train_catmodel', 'stage_s2_contigs'):\n"
            "    harness.load_module('drivers', n)\n"
            "import nanosnp_tpu_torch.legacy.train\n"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
