"""The CatModel trainer (legacy/train.py: `Trainer.fit` and `GroupRunner`,
as the pileup and haplotype trainers) against the benchmark's plain
reference of the CatModel (gpubench/reference/catmodel.py), on seeded
weights at a small size: batch 8, 11 positions, the model's full channel
and hidden widths, and 2 x 12 reads, the least depth that the tower's
four max-pools collapse to one row (2 x 4 leaves none after the third).

Also: a group of steps against single steps, the percentage stack's
dropout on the kernel route with the trainer's generator, the int8 feed,
and the running statistics through a checkpoint.
"""
import os
import sys

import numpy as np
import pytest
import torch

from nanosnp_tpu_torch.legacy import train as LT
from nanosnp_tpu_torch.legacy.catmodel import init_catmodel_params
from nanosnp_tpu_torch.models import bilstm as MB
from nanosnp_tpu_torch.models.convert import flatten_tree, load_params_npz

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "gpubench"))
from reference import catmodel as RC  # noqa: E402
from reference.precision import PRECISIONS  # noqa: E402

MD, N, STEPS, LR = 12, 8, 4, 1e-3
# step 1's loss, f32 on both sides: the same products summed in other
# orders (torch's f32 convolution and matmul against the same ops
# reshaped, the port's step loop against the reference's written-out
# recurrence op); on the kernel route also bf16 roundings of h_{t-1}
# that fall on the other side of a tie
LOSS_TOL = {"f32": 1e-5, "train": 1e-4}
# the later steps' losses: Adam's first steps move each weight by about
# lr, so a weight whose gradient is within rounding of zero steps either
# way (below), 2 lr apart a step; at batch 8 that moves the loss by up
# to a few 1e-4 by step 4, against about 1e-2 a step for the updates
LATER_LOSS_TOL = 2e-3
# step 1's gradient, each leaf's norm relative to the larger of its own
# and the median leaf's: f32 summation order; on the kernel route also a
# bf16 rounding of h_{t-1} that lands on the other side of a tie
GRAD_TOL = {"f32": 1e-4, "train": 1e-3}
# the running statistics after the group, relative to each leaf's norm
# (reference stats_gap): they follow the weights, whose entries with a
# gradient within rounding of zero step either way (below), a few 1e-3
# on the first block's, whose inputs are qualities up to 60
STATS_TOL = 1e-2


def _images(rng, n):
    def image():
        reads = rng.choice([-2, -1, 0, 1, 2, 3, 4], size=(n, 2 * MD, 11))
        pad = reads == -2
        bq = np.where(pad, -2, rng.integers(0, 41, reads.shape))
        mq = np.where(pad, -2, rng.integers(0, 61, reads.shape))
        ph = np.broadcast_to(np.where(np.arange(2 * MD)[None, :, None] < MD,
                                      1, 2), reads.shape)
        return np.stack([reads, bq, mq, (~pad).astype(int), ph],
                        axis=3).astype(np.int8)
    return image(), image()


def _batches(seed, steps=STEPS):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        g0, g1 = _images(rng, N)
        out.append({"g0": g0, "g1": g1, "y": rng.integers(0, 10, N)})
    return out


@pytest.fixture(scope="module")
def params():
    return init_catmodel_params(torch.Generator().manual_seed(41))


def _trainer(params, use_kernels, out_dir, steps_per_call=STEPS,
             dropout=False, seed=0):
    """A CatModel trainer on the CPU whose `losses` keeps every step's
    loss."""
    tr = LT.CatModelTrainer(params, lr=LR, batch_size=N, seed=seed,
                            steps_per_call=steps_per_call, device="cpu",
                            use_kernels=use_kernels, dropout=dropout,
                            out_dir=str(out_dir))
    tr.losses, run = [], tr.groups.run

    def keep(batches, freeze_on=0.0):
        m = run(batches, freeze_on)
        tr.losses.extend(float(x) for x in m["loss"])
        return m
    tr.groups.run = keep
    return tr


def _weights(tr):
    return {path: p.detach() for path, p in flatten_tree(
        tr.state.model.tree()) if not RC.is_stat(path)}


def _stats(tr):
    return {path: p.detach() for path, p in flatten_tree(
        tr.state.model.tree()) if RC.is_stat(path)}


@pytest.mark.parametrize("route,use_kernels",
                         [("f32", False), ("train", True)],
                         ids=["f32_route", "kernel_route"])
def test_trainer_holds_to_the_plain_reference(params, route, use_kernels,
                                              tmp_path):
    """Dropout off: each step's loss, step 1's gradient, the weights after
    a group of 4 and the BatchNorm running statistics after it. The
    kernel route's plain versions round as the configuration states
    (`train`: the recurrence's products in bf16)."""
    batches = _batches(7)
    ref = RC.first_steps(params, batches, PRECISIONS[route], LR, 0.1, 0,
                         "cpu", dropout=False)

    one = _trainer(params, use_kernels, tmp_path / "one")
    one.fit(iter(batches[:1]), None, None, None, None)
    weights = [path for path, p in flatten_tree(one.state.model.tree())
               if p.requires_grad]
    grad = {path: float(mu.double().norm()) / 0.1
            for path, mu in zip(weights, one.state.opt_state["mu"])}
    floor = np.median(list(ref["grad"].values()))
    for path, want in ref["grad"].items():
        assert abs(grad[path] - want) / max(want, floor) \
            < GRAD_TOL[route], path

    tr = _trainer(params, use_kernels, tmp_path / "group")
    tr.fit(iter(batches), None, None, None, None)
    assert tr.groups.steps == {"graph": 0, "eager": STEPS, "partial": 0}
    assert len(tr.losses) == STEPS
    for i, (got, want) in enumerate(zip(tr.losses, ref["losses"])):
        assert abs(got - want) / want \
            < (LATER_LOSS_TOL if i else LOSS_TOL[route]), i
    # Adam's first steps move a weight by about lr whatever its gradient,
    # so where a gradient is within rounding of zero the two sides step
    # opposite ways: an entry is bounded by 2 lr a step, and each leaf's
    # whole update points the same way
    init = dict(flatten_tree(params))
    for path, got in _weights(tr).items():
        want = ref["weights"][path]
        assert float((got - want).abs().max()) <= 2 * LR * STEPS, path
        du, dw = (got - init[path]).ravel(), (want - init[path]).ravel()
        assert float(du @ dw / (du.norm() * dw.norm())) > 0.99, path
    assert RC.stats_gap(_stats(tr), ref["stats"]) < STATS_TOL
    moved = _stats(tr)[("res_blocks", 0, "bn1", "mean")]
    assert not torch.equal(moved, torch.zeros_like(moved))


def test_a_group_equals_single_steps(params, tmp_path):
    """Four steps as one group and as four groups of one: the same
    weights and statistics to 1e-5, dropout and kernel route on."""
    batches = _batches(11)
    runs = []
    for spc in (STEPS, 1):
        tr = _trainer(params, True, tmp_path / str(spc), steps_per_call=spc,
                      dropout=True, seed=5)
        tr.fit(iter(batches), None, None, None, None)
        assert tr.state.step == STEPS and tr.state.opt_state["count"] == STEPS
        runs.append(dict(flatten_tree(tr.state.model.tree())))
        runs[-1]["losses"] = torch.tensor(tr.losses)
    assert runs[0].keys() == runs[1].keys()
    for k, v in runs[0].items():
        assert float((v.detach() - runs[1][k].detach()).abs().max()) \
            <= 1e-5, k


def test_dropout_runs_on_the_kernel_route_with_the_trainers_generator(
        params, monkeypatch, tmp_path):
    """With dropout on, every BiLSTM layer of a step, the percentage
    stack's three included, runs the training recurrence; its two masks a
    step are drawn from the trainer's generator, and from nothing else."""
    calls, masks = [], []
    real_rec, real_drop = MB.lstm_recurrence, MB.dropout_between_layers
    monkeypatch.setattr(MB, "lstm_recurrence", lambda xp, w: calls.append(
        (tuple(xp.shape), w.dtype, xp.requires_grad)) or real_rec(xp, w))
    monkeypatch.setattr(MB, "dropout_between_layers",
                        lambda out, rate, gen: masks.append(
                            (tuple(out.shape), rate, gen))
                        or real_drop(out, rate, gen))
    tr = _trainer(params, True, tmp_path, dropout=True, seed=9)
    batches = _batches(13, steps=2)
    tr.fit(iter(batches), None, None, None, None)
    assert calls == [((N, 11, 2, 1024), torch.bfloat16, True)] * 5 * 2
    assert [(s, r) for s, r, _ in masks] == [((N, 11, 512), 0.5)] * 2 * 2
    assert all(g is tr.generator for _, _, g in masks)
    fresh = torch.Generator().manual_seed(9)
    for _ in range(4):
        torch.rand((N, 11, 512), generator=fresh)
    assert torch.equal(fresh.get_state(), tr.generator.get_state())


def test_the_feed_stages_int8_and_raises_outside_it(params, tmp_path):
    tr = _trainer(params, False, tmp_path)
    b = _batches(3, steps=1)[0]
    wide = {k: v.astype(np.int32) if k != "y" else v for k, v in b.items()}
    host = tr.host_batch(wide)
    assert host["g0"].dtype == np.int8 and host["g1"].dtype == np.int8
    assert np.array_equal(host["g0"], b["g0"])
    # 4,400 bytes of images a sample at the published depth (2 x 20 x 11
    # x 5 twice), a quarter of them in f32
    assert 2 * 40 * 11 * 5 == 4400
    for bad in (128, -129, 0.5):
        g0 = wide["g0"].astype(np.float64)
        g0[0, 0, 0, 1] = bad
        with pytest.raises(ValueError, match="outside int8"):
            tr.host_batch({**wide, "g0": g0})
    with pytest.raises(ValueError, match="outside int8"):
        LT.int8_images(np.array([300]))


def test_a_checkpoint_round_trips_the_running_statistics(params, tmp_path):
    """catmodel_epoch1.npz and catmodel.npz hold the weights and the
    moved running statistics, in the archive's f16 layout."""
    rng = np.random.default_rng(17)
    g0, g1 = _images(rng, 40)
    labels = np.stack([np.ones(40, int), rng.integers(0, 10, 40),
                       np.where(np.arange(40) < 20, 1, -1)], axis=1)
    tr = _trainer(params, False, tmp_path, steps_per_call=2, dropout=True)
    tr.fit(tr.feed(g0, g1, labels, np.random.default_rng(1), 1), None, None,
           None, None)
    assert tr.history == [{"epoch": 1, "loss": pytest.approx(
        np.mean(tr.losses), abs=1e-4), "steps": 5, "sites": 40}]
    assert tr.groups.steps == {"graph": 0, "eager": 4, "partial": 1}
    want = _stats(tr)
    for name in ("catmodel_epoch1.npz", "catmodel.npz"):
        got = dict(flatten_tree(load_params_npz(str(tmp_path / name))))
        for path, v in want.items():
            assert torch.equal(got[path], v.half().float()), (name, path)
        assert not torch.equal(got[("res_blocks", 2, "bn2", "var")],
                               torch.ones_like(got[("res_blocks", 2, "bn2",
                                                    "var")]))
