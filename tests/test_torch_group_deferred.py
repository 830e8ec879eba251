"""Deferred group metrics (train/group.py `GroupMetrics`,
`Trainer.run_group`): a trainer meters each group once the next one is
launched, and drains the last before an epoch ends and when it stops.
Against the same fit with every group's metrics read as soon as the
group is launched, the pileup, haplotype and CatModel trainers give the
same epoch meters, progress lines, checkpoints and final state, across
epoch ends, partial groups, `max_steps`, `steps_per_epoch` and two batch
shapes; the counters `nsp.group.deferred` and `nsp.group.drained` count
every group once, one drained a flush. On the card (the `test_card_*`
tests, which skip without one): a graph-route fit with deferral is the
same bits as one read at once, and a handle read after two later
replays of its graph holds its own metrics. Imports nothing of JAX:
`python -m pytest --noconftest -k card tests/test_torch_group_deferred.py`
runs the card's tests there."""
import json
import os
import pickle
import re

import numpy as np
import pytest
import torch
from torch.autograd import profiler

from nanosnp_tpu_torch.config import (HaplotypeModelConfig, OptimConfig,
                                      PileupModelConfig, TrainConfig)
from nanosnp_tpu_torch.legacy import train as LT
from nanosnp_tpu_torch.legacy.catmodel import init_catmodel_params
from nanosnp_tpu_torch.models.convert import flatten_tree
from nanosnp_tpu_torch.train.data import EPOCH_END
from nanosnp_tpu_torch.train.group import GroupMetrics, GroupRunner
from nanosnp_tpu_torch.train.train_haplotype import train_haplotype
from nanosnp_tpu_torch.train.train_pileup import train_pileup
from nanosnp_tpu_torch.utils import profiling as P

OPT = dict(lr=1e-3, max_grad_norm=0.2, begin_to_adjust_lr=1,
           decay_ratio=0.5)
RATE = re.compile(r" \([0-9.]+ steps/s\)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pileup_items(rng, n, marks=()):
    """n batches of 8 windows, EPOCH_END after each batch index in
    `marks`."""
    out = []
    for i in range(n):
        out.append((rng.integers(-15, 15, (8, 33, 18)).astype(np.float32),
                    rng.integers(0, 21, 8), rng.integers(0, 3, 8)))
        if i in marks:
            out.append(EPOCH_END)
    return out


def _hap_batch(rng, n, depth):
    b = {}
    for pre, seq_len in (("p_", 33), ("h_", 11)):
        for k in ("seq", "baseq", "mapq", "hap"):
            b[pre + k] = rng.integers(-2, 5, (n, depth, seq_len)
                                      ).astype(np.int8)
        b[pre + "ref"] = rng.integers(0, 5, (n, seq_len)).astype(np.int8)
    b["gt"] = rng.integers(0, 10, n).astype(np.int32)
    b["zy"] = rng.integers(0, 3, n).astype(np.int32)
    return b


def _cat_batch(rng, n, depth=12):
    def image():
        reads = rng.choice([-2, -1, 0, 1, 2, 3, 4], size=(n, 2 * depth, 11))
        pad = reads == -2
        bq = np.where(pad, -2, rng.integers(0, 41, reads.shape))
        mq = np.where(pad, -2, rng.integers(0, 61, reads.shape))
        ph = np.broadcast_to(np.where(
            np.arange(2 * depth)[None, :, None] < depth, 1, 2), reads.shape)
        return np.stack([reads, bq, mq, (~pad).astype(int), ph],
                        axis=3).astype(np.int8)
    return {"g0": image(), "g1": image(), "y": rng.integers(0, 10, n)}


def _pileup_cfg():
    return PileupModelConfig(hidden_size=8, output_size=16, inner_size=16,
                             n_layers=2, dropout=0.1)


def _pileup_epochs(out, device="cpu"):
    """Three epochs marked in the data (groups 2 2 1 | 2 1 | 2 at the
    iterator's end), validation and best.ckpt."""
    rng = np.random.default_rng(5)
    items = _pileup_items(rng, 10, marks=(4, 7))
    val = [b for b in _pileup_items(rng, 2)]
    return train_pileup(iter(items), _pileup_cfg(),
                        TrainConfig(optim=OptimConfig(**OPT), batch_size=8,
                                    steps_per_call=2, seed=3),
                        None, out, device=device, log_every=3,
                        lr_steps_per_epoch=5,
                        val_iter_factory=lambda: iter(val))


def _pileup_steps_per_epoch(out, device="cpu"):
    """Epochs of 3 single-step groups, stopped by max_steps 7."""
    items = _pileup_items(np.random.default_rng(6), 12)
    return train_pileup(iter(items), _pileup_cfg(),
                        TrainConfig(optim=OptimConfig(**OPT), batch_size=8,
                                    steps_per_call=4, seed=4),
                        3, out, device=device, log_every=2, max_steps=7)


def _haplotype_two_shapes(out, device="cpu"):
    """Depth buckets 6 and 8 in one epoch and the next (a partial group
    of each shape flushed at the first's end), stopped by max_steps 8."""
    rng = np.random.default_rng(7)
    items = [_hap_batch(rng, 8, d) for d in (6, 8, 6, 6, 8, 8)] \
        + [EPOCH_END] \
        + [_hap_batch(rng, 8, d) for d in (8, 6, 8, 6, 8, 6)]
    return train_haplotype(iter(items),
                           HaplotypeModelConfig(hidden_size=8,
                                                lstm_layers=2, dropout=0.1),
                           TrainConfig(optim=OptimConfig(**OPT), batch_size=8,
                                       steps_per_call=2, seed=5),
                           None, out, device=device, log_every=2,
                           max_steps=8, lr_steps_per_epoch=5)


def _catmodel(out, device="cpu"):
    """Two epochs, batches of 4 and 6 rows (two shapes), each epoch's
    partial groups flushed at its end; catmodel_epoch{n}.npz."""
    rng = np.random.default_rng(8)
    items = []
    for sizes in ((4, 4, 6, 4, 4), (6, 4, 6, 6)):
        items += [_cat_batch(rng, n) for n in sizes] + [EPOCH_END]
    tr = LT.CatModelTrainer(init_catmodel_params(
        torch.Generator().manual_seed(2)), out_dir=out, batch_size=4,
        steps_per_call=2, device=device, use_kernels=False, log_every=2,
        seed=6)
    state = tr.fit(iter(items), None, None, None, None)
    state.history = tr.history
    return state


FITS = {"pileup_epochs": (_pileup_epochs, 3),
        "pileup_steps_per_epoch": (_pileup_steps_per_epoch, 3),
        "haplotype_two_shapes": (_haplotype_two_shapes, 2),
        "catmodel": (_catmodel, 2)}


def _traced(fit, out, monkeypatch, capsys, at_once):
    """fit(out) under the benchmark's profiler, every group's handle kept
    (read at once with `at_once`) -> (state, handles, printed lines, the
    recorder's counters)."""
    handles, run = [], GroupRunner.run

    def keep(self, batches, freeze_on=0.0):
        m = run(self, batches, freeze_on)
        if at_once:
            m["loss"]
        handles.append(m)
        return m
    monkeypatch.setattr(GroupRunner, "run", keep)
    with P.session("nsp.test.reset"):       # the traced fit starts afresh
        pass
    capsys.readouterr()
    with profiler.profile(use_kineto=True):
        state = fit(out)
    counters = P.snapshot()["counters"]
    P._clear()      # the recorder is the process's: leave it empty
    monkeypatch.setattr(GroupRunner, "run", run)
    lines = [RATE.sub("", ln) for ln in capsys.readouterr().out.splitlines()
             if "] step " in ln]
    return state, handles, lines, counters


def _files(out):
    """The fit's files: pickles and scalars.jsonl as they are (less the
    records' wall-clock time), npz archives as their arrays."""
    got = {}
    for root, _, names in os.walk(out):
        for name in sorted(names):
            path = os.path.join(root, name)
            rel = os.path.relpath(path, out)
            if name.endswith(".npz"):
                with np.load(path) as z:
                    got[rel] = {k: z[k] for k in z.files}
            elif name.endswith(".jsonl"):
                with open(path) as f:
                    got[rel] = [re.sub(r'"time": [0-9.]+, ', "", ln)
                                for ln in f]
            else:
                with open(path, "rb") as f:
                    got[rel] = f.read()
    return got


def _same_files(a, b):
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, dict):
            assert v.keys() == b[k].keys(), k
            for name in v:
                np.testing.assert_array_equal(v[name], b[k][name],
                                              err_msg=f"{k} {name}")
        else:
            assert v == b[k], k


def _params(state):
    return [p.detach().clone() for _, p in flatten_tree(state.model.tree())]


@pytest.mark.parametrize("name", sorted(FITS))
def test_deferred_metrics_meter_and_save_as_read_at_once(
        name, tmp_path, monkeypatch, capsys):
    fit, flushes = FITS[name]
    runs = {}
    for at_once in (False, True):
        out = str(tmp_path / ("now" if at_once else "late"))
        state, handles, lines, counters = _traced(fit, out, monkeypatch,
                                                  capsys, at_once)
        runs[at_once] = (state, handles, lines, counters, _files(out))
    (late, handles, lines, counters, files), \
        (now, now_handles, now_lines, now_counters, now_files) = \
        runs[False], runs[True]

    assert all(isinstance(m, GroupMetrics) for m in handles)
    assert len(handles) == len(now_handles) and late.step == now.step
    for a, b in zip(_params(late), _params(now)):
        assert torch.equal(a, b)
    for m, m_now in zip(handles, now_handles):
        assert m.keys() == m_now.keys()
        for k in m:
            np.testing.assert_array_equal(m[k], m_now[k], err_msg=k)
    assert lines == now_lines and lines
    _same_files(files, now_files)
    if name == "catmodel":
        assert late.history == now.history

    # each group's progress line at the step that ended it, with its own
    # last loss; every group counted once, one drained a flush
    ends = np.cumsum([len(m["loss"]) for m in handles])
    log_every = {"pileup_epochs": 3}.get(name, 2)
    group = 1 if name == "pileup_steps_per_epoch" else 2
    assert [ln.split("] ", 1)[1] for ln in lines] == [
        f"step {s} loss {float(m['loss'][-1]):.4f} "
        f"gt_acc {float(m['gt_acc'][-1]):.4f}"
        for s, m in zip(ends, handles) if s % log_every < group]
    assert counters["nsp.group.drained"] == flushes
    assert counters["nsp.group.deferred"] == len(handles) - flushes
    assert now_counters["nsp.group.drained"] == len(handles)
    assert "nsp.group.deferred" not in now_counters


def test_each_epoch_meters_its_own_groups(tmp_path, monkeypatch, capsys):
    """The train records of scalars.jsonl (two epochs end in the data;
    the third stops with it): each epoch's mean loss is that of its own
    steps, though its last group is metered a group late."""
    out = str(tmp_path / "out")
    _, handles, _, _ = _traced(_pileup_epochs, out, monkeypatch, capsys,
                               False)
    losses = np.concatenate([m["loss"] for m in handles])
    with open(os.path.join(out, "scalars.jsonl")) as f:
        recs = [r for r in map(json.loads, f) if r["split"] == "train"]
    assert [r["step"] for r in recs] == [5, 8]
    start = 0
    for r in recs:
        total = 0.0
        for x in losses[start:r["step"]]:
            total += float(x)
        assert r["loss"] == round(total / (r["step"] - start), 6)
        start = r["step"]
    with open(os.path.join(out, "last.ckpt"), "rb") as f:
        assert pickle.load(f)["step"] == 10


def test_a_handle_resolves_once_and_counts_where_it_is_read(tmp_path):
    """On the CPU: read before the next group, a group is drained; read
    after it, deferred; a second read counts nothing."""
    from nanosnp_tpu_torch.train.optim import build_optimizer

    tx = build_optimizer(OptimConfig(type="sgd"))
    w = torch.zeros(3)
    state = type("S", (), {"opt_state": tx.init([w])})()

    def step(batch, row):
        tx.update([w], [batch["x"]], state.opt_state, row)
        return {"loss": batch["x"].sum()}

    runner = GroupRunner(step, tx, state, None, torch.device("cpu"), 2)
    x = [{"x": np.full(3, i, np.float32)} for i in range(6)]
    with P.session("nsp.test.reset"):
        pass
    with profiler.profile(use_kineto=True):
        with P.session("nsp.test.root"):
            a = runner.run(x[:2])
            np.testing.assert_array_equal(a["loss"], [0.0, 3.0])
            b = runner.run(x[2:4])
            c = runner.run(x[4:5])
            assert dict(b) == {"loss": b["loss"]} and len(c) == 1
            np.testing.assert_array_equal(c["loss"], [12.0])
            a["loss"], b["loss"]
    counters = P.snapshot()["counters"]
    P._clear()      # the recorder is the process's: leave it empty
    assert counters["nsp.group.drained"] == 2
    assert counters["nsp.group.deferred"] == 1
    assert runner.launched == 3


def test_card_graph_route_deferred_is_the_same_bits_as_read_at_once(
        card, tmp_path, monkeypatch, capsys):
    """A pileup fit on the card, 8 steps a graph (eager, captured, then
    replays, an epoch's partial group): parameters, every step's
    metrics and the files the same bits with deferral as read at
    once."""
    rng = np.random.default_rng(11)
    items = [(rng.integers(-15, 15, (512, 33, 18)).astype(np.float32),
              rng.integers(0, 21, 512), rng.integers(0, 3, 512))
             for _ in range(43)]
    items.insert(35, EPOCH_END)
    cfg = PileupModelConfig(dropout=0.1)

    def fit(out):
        return train_pileup(iter(items), cfg, TrainConfig(
            optim=OptimConfig(**OPT), batch_size=512, steps_per_call=8,
            seed=9), None, out, device=card, log_every=8,
            lr_steps_per_epoch=40)

    runs = []
    for at_once in (False, True):
        out = str(tmp_path / str(at_once))
        state, handles, lines, counters = _traced(fit, out, monkeypatch,
                                                  capsys, at_once)
        runs.append((_params(state), handles, lines, _files(out)))
    (pa, ha, la, fa), (pb, hb, lb, fb) = runs
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)
    assert len(ha) == len(hb) == 6
    for m, n in zip(ha, hb):
        for k in m:
            np.testing.assert_array_equal(m[k], n[k], err_msg=k)
    assert la == lb and la
    _same_files(fa, fb)


def test_card_a_handle_read_after_two_later_replays_holds_its_group(
        card, tmp_path):
    """Three replays of one graph launched before any is read: each
    handle holds its own group's metrics, those of the same groups read
    at once from the same seeded state."""
    from nanosnp_tpu_torch.models.pileup_model import init_pileup_params
    from nanosnp_tpu_torch.train.train_pileup import _PileupTrainer

    cfg = PileupModelConfig(dropout=0.1)
    params = init_pileup_params(torch.Generator().manual_seed(1), cfg)
    rng = np.random.default_rng(12)
    groups = [[(rng.integers(-15, 15, (256, 33, 18)).astype(np.float32),
                rng.integers(0, 21, 256), rng.integers(0, 3, 256))
               for _ in range(4)] for _ in range(5)]
    got = []
    for at_once in (True, False):
        tr = _PileupTrainer(cfg, TrainConfig(
            optim=OptimConfig(**OPT), batch_size=256, steps_per_call=4,
            seed=1), params, card, None, None, 10, str(tmp_path), None,
            10 ** 9)
        host = [[tr.host_batch(b) for b in g] for g in groups]
        tr.groups.run(host[0])["loss"]          # eager
        tr.groups.run(host[1])["loss"]          # captured and replayed
        if at_once:
            got.append([dict(tr.groups.run(h)) for h in host[2:]])
        else:
            ms = [tr.groups.run(h) for h in host[2:]]
            assert tr.groups.steps["graph"] == 16
            got.append([dict(m) for m in ms])
    for now, late in zip(*got):
        for k in now:
            np.testing.assert_array_equal(late[k], now[k], err_msg=k)
    assert not np.array_equal(got[0][0]["loss"], got[0][2]["loss"])
