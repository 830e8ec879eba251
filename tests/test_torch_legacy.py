"""The port's legacy CatModel family against the JAX package's.

The same numpy-seeded images and the same parameters (the JAX package's
`init_catmodel_params`, carried across as numpy) go through both CatModels:
the f32 forward, the kernel path (the port's plain version of the inference
recurrence against the Pallas kernel in interpret mode), a training step
without dropout (loss, gradients, BatchNorm running statistics) and a few
Adam steps against optax. The copied numpy modules are held against the
JAX package's on fuzzed inputs, and the legacy CLIs of both packages run on
one small world of `save_legacy_bin` files.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from nanosnp_tpu.legacy import bins as jbins
from nanosnp_tpu.legacy import catmodel as jcat
from nanosnp_tpu.legacy import config_archive as jarchive
from nanosnp_tpu.legacy import edges as jedges
from nanosnp_tpu.legacy import heuristic as jheur
from nanosnp_tpu.legacy import labelcheck as jcheck
from nanosnp_tpu.legacy import train as jtrain
from nanosnp_tpu.runtime.cli import main as jax_cli
from nanosnp_tpu.train.train_pileup import save_params_npz as jax_save_npz
from nanosnp_tpu_torch.io.fasta import write_fasta
from nanosnp_tpu_torch.legacy import bins as tbins
from nanosnp_tpu_torch.legacy import catmodel as tcat
from nanosnp_tpu_torch.legacy import config_archive as tarchive
from nanosnp_tpu_torch.legacy import edges as tedges
from nanosnp_tpu_torch.legacy import heuristic as theur
from nanosnp_tpu_torch.legacy import labelcheck as tcheck
from nanosnp_tpu_torch.legacy import train as ttrain
from nanosnp_tpu_torch.models.convert import (flatten_tree, load_params_npz,
                                              params_from_jax,
                                              params_to_numpy)
from nanosnp_tpu_torch.runtime.cli import main as torch_cli
from nanosnp_tpu_torch.train.data import EPOCH_END
from nanosnp_tpu_torch.train.optim import Optimizer
from nanosnp_tpu_torch.train.train_pileup import trainable

# f32 on both sides: convolution and matmul summation order only
F32_TOL = 1e-5
# kernel path: bf16 w_hh and h_{t-1} on both sides, f32 summation order can
# flip a bf16 rounding of h_{t-1}; five recurrences deep, on probabilities
KERNEL_TOL = 1e-4
# gradients, relative to each leaf's largest entry: f32 summation order
# through six conv blocks, batch statistics and five recurrences
GRAD_TOL = 2e-4


def _images(rng, n, md=20):
    def image(phase_split):
        reads = rng.choice([-2, -1, 0, 1, 2, 3, 4],
                           size=(n, 2 * md, 11)).astype(np.float32)
        bq = rng.integers(0, 40, reads.shape).astype(np.float32)
        mq = rng.integers(0, 60, reads.shape).astype(np.float32)
        mask = (reads != -2).astype(np.float32)
        ph = np.broadcast_to(np.where(
            np.arange(2 * md)[None, :, None] < phase_split, 1.0, 2.0),
            reads.shape).astype(np.float32)
        return np.stack([reads, bq, mq, mask, ph], axis=3)
    return image(md), image(md)


@pytest.fixture(scope="module")
def jax_params():
    return jcat.init_catmodel_params(jax.random.key(5))


def _carry(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params))


def test_percentage_matches_jax():
    rng = np.random.default_rng(3)
    ts = rng.choice([-2, -1, 0, 1, 2, 3, 4], size=(11, 4, 20)).astype(
        np.float32)
    ts[0, 0] = -2                                     # an all-pad cell
    want = np.asarray(jcat.calculate_percentage(jnp.asarray(ts)))
    got = tcat.calculate_percentage(torch.from_numpy(ts)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    assert got[0, 0].tolist() == [0.0] * 5
    # -1 (deletion) is the fifth channel, -2 is absent
    assert got[3, 2, 4] == np.float32(
        (ts[3, 2] == -1).sum() / (ts[3, 2] != -2).sum())


def test_f32_forward_matches_jax(jax_params):
    g0, g1 = _images(np.random.default_rng(17), 6)
    want, _ = jcat.catmodel_forward(jax_params, jnp.asarray(g0),
                                    jnp.asarray(g1))
    model = tcat.CatModel(_carry(jax_params))
    with torch.no_grad():
        got = tcat.catmodel_forward(model, torch.from_numpy(g0),
                                    torch.from_numpy(g1))
    assert tuple(got.shape) == (6, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=0)
    probs = tcat.catmodel_predict(model, torch.from_numpy(g0),
                                  torch.from_numpy(g1))   # CPU: f32 loop
    np.testing.assert_allclose(
        probs.numpy(), np.asarray(jcat.catmodel_predict(
            jax_params, jnp.asarray(g0), jnp.asarray(g1))), atol=F32_TOL,
        rtol=0)


def test_kernel_path_matches_pallas_interpret(jax_params, monkeypatch):
    """Five launches of the inference recurrence a batch: three layers of
    the percentage RNN and the two CRNN BiLSTMs."""
    from nanosnp_tpu_torch.ops import lstm_train as T

    g0, g1 = _images(np.random.default_rng(29), 5)
    want, _ = jcat.catmodel_forward(jax_params, jnp.asarray(g0),
                                    jnp.asarray(g1), use_pallas=True,
                                    pallas_interpret=True)
    want = np.asarray(jax.nn.softmax(want, axis=-1))
    calls = []
    real = T.lstm_recurrence_infer
    monkeypatch.setattr(T, "lstm_recurrence_infer",
                        lambda xp, w: calls.append(
                            (tuple(xp.shape), xp.dtype, w.dtype))
                        or real(xp, w))
    got = tcat.catmodel_predict(tcat.CatModel(_carry(jax_params)),
                                torch.from_numpy(g0), torch.from_numpy(g1),
                                use_kernels=True)
    assert calls == [((5, 11, 2, 1024), torch.float32, torch.bfloat16)] * 5
    np.testing.assert_allclose(got.numpy(), want, atol=KERNEL_TOL, rtol=0)


def _jax_loss(p, g0, g1, y):
    logits, new_p = jcat.catmodel_forward(p, g0, g1, train=True)
    smoothed = optax.smooth_labels(jax.nn.one_hot(y, logits.shape[-1]), 0.1)
    return optax.softmax_cross_entropy(logits, smoothed).mean(), new_p


def _trainable_leaves(model):
    """The leaves Adam updates, in the tree's order: everything but the
    BatchNorm running statistics."""
    tree = model.tree()
    return [leaf for (_, leaf), m in zip(flatten_tree(tree), trainable(tree))
            if m]


def test_train_step_without_dropout_matches_jax(jax_params):
    rng = np.random.default_rng(23)
    g0, g1 = _images(rng, 8)
    y = rng.integers(0, 10, 8)
    (want_loss, new_p), want_g = jax.value_and_grad(_jax_loss, has_aux=True)(
        jax_params, jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(y))

    model = tcat.CatModel(_carry(jax_params))
    logits = model(torch.from_numpy(g0), torch.from_numpy(g1), train=True)
    loss = ttrain.smoothed_cross_entropy(logits, torch.from_numpy(y))
    assert abs(float(loss.detach()) - float(want_loss)) < F32_TOL
    leaves = _trainable_leaves(model)
    grads = torch.autograd.grad(loss, leaves)
    by_id = {id(p): g for p, g in zip(leaves, grads)}
    want_flat = flatten_tree(jax.tree.map(np.asarray, want_g))
    for (path, leaf), (_, w) in zip(flatten_tree(model.tree()), want_flat):
        if path[-1] in ("mean", "var"):
            assert id(leaf) not in by_id and not leaf.requires_grad
            continue
        g = by_id[id(leaf)].numpy()
        scale = max(np.abs(w).max(), 1e-6)
        assert np.abs(g - w).max() / scale < GRAD_TOL, path
    # the running statistics moved, by the biased batch variance
    for blk, want_blk in zip(model.res_blocks, new_p["res_blocks"]):
        for bn, name in ((blk.bn1, "bn1"), (blk.bn2, "bn2")):
            np.testing.assert_allclose(bn.mean.numpy(),
                                       np.asarray(want_blk[name]["mean"]),
                                       atol=F32_TOL, rtol=1e-5)
            np.testing.assert_allclose(bn.var.numpy(),
                                       np.asarray(want_blk[name]["var"]),
                                       atol=F32_TOL, rtol=1e-5)
    assert not np.allclose(model.res_blocks[0].bn1.mean.numpy(), 0.0)


def test_adam_steps_match_optax(jax_params, tmp_path):
    rng = np.random.default_rng(31)
    batches = []
    for _ in range(3):
        g0, g1 = _images(rng, 6)
        batches.append((g0, g1, rng.integers(0, 10, 6)))

    tx = optax.adam(1e-3)
    p, opt_state = jax_params, tx.init(jax_params)
    want_losses = []
    for g0, g1, y in batches:
        (loss, new_p), grads = jax.value_and_grad(_jax_loss, has_aux=True)(
            p, jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(y))
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        # as the JAX package's train step: the running statistics are the
        # forward pass's, not the optimizer's
        p = {**p, "res_blocks": [
            {**bp, "bn1": {**bp["bn1"], "mean": nb["bn1"]["mean"],
                           "var": nb["bn1"]["var"]},
             "bn2": {**bp["bn2"], "mean": nb["bn2"]["mean"],
                     "var": nb["bn2"]["var"]}}
            for bp, nb in zip(p["res_blocks"], new_p["res_blocks"])]}
        want_losses.append(float(loss))

    # the port's CatModel trainer, its three steps one partial group
    tr = ttrain.CatModelTrainer(_carry(jax_params), lr=1e-3, batch_size=6,
                                device="cpu", dropout=False,
                                out_dir=str(tmp_path))
    losses, run = [], tr.groups.run

    def keep(batches, freeze_on=0.0):
        m = run(batches, freeze_on)
        losses.extend(m["loss"])
        return m
    tr.groups.run = keep
    tr.fit(({"g0": g0, "g1": g1, "y": y} for g0, g1, y in batches), None,
           None, None, None)
    got = tr.state.model.tree()
    assert tr.state.step == 3 and len(losses) == 3
    assert abs(np.mean(losses) - np.mean(want_losses)) < 1e-4
    # the later losses depend on the earlier updates
    for step, (loss, want) in enumerate(zip(losses, want_losses)):
        assert abs(float(loss) - want) < 2e-4, step
    # Adam's first steps move every weight by about lr whatever the
    # gradient's size, so where a gradient is within rounding of zero the
    # two runs step in opposite directions (a few percent of the entries):
    # an entry is bounded by 2 lr a step, and each leaf's whole update
    # points the same way
    start = flatten_tree(jax.tree.map(np.asarray, jax_params))
    for (path, g), (_, w), (_, w0) in zip(
            flatten_tree(params_to_numpy(got)),
            flatten_tree(jax.tree.map(np.asarray, p)), start):
        if path[-1] in ("mean", "var"):
            # running statistics of activations under slightly other weights
            assert np.abs(g - w).max() <= 0.05 * np.abs(w).max(), path
            continue
        assert np.abs(g - w).max() <= 2 * 1e-3 * 3, path
        du, dw = (g - w0).ravel(), (w - w0).ravel()
        assert du @ dw / np.sqrt((du @ du) * (dw @ dw)) > 0.99, path


def test_each_epoch_starts_adam_and_dropout_afresh(jax_params, tmp_path):
    """The JAX CLI runs train_catmodel once an epoch: a fresh
    optax.adam(lr).init state and the dropout key seed + epoch. The port's
    trainer over two epochs of one step: after each, Adam's state is that
    init's (count 0, zero moments) and the generator is seeded with
    seed + the next epoch's index, while the weights keep their steps."""
    rng = np.random.default_rng(37)
    tr = ttrain.CatModelTrainer(_carry(jax_params), lr=1e-3, batch_size=2,
                                seed=11, device="cpu", dropout=False,
                                out_dir=str(tmp_path))
    end, after = tr.end_epoch, []

    def ended(*a):
        end(*a)
        opt = tr.state.opt_state
        after.append((opt["count"], opt["steps_since_sync"],
                      [t.clone() for k in ("mu", "nu") for t in opt[k]],
                      tr.generator.get_state(),
                      [p.detach().clone() for p in _trainable_leaves(
                          tr.state.model)]))
    tr.end_epoch = ended

    def feed():
        for _ in range(2):
            g0, g1 = _images(rng, 2)
            yield {"g0": g0, "g1": g1, "y": rng.integers(0, 10, 2)}
            yield EPOCH_END
    tr.fit(feed(), None, None, None, None)
    assert tr.state.step == 2 and [h["steps"] for h in tr.history] == [1, 1]
    init = optax.adam(1e-3).init(jax_params)[0]
    want = [x for k in ("mu", "nu")
            for x in flatten_tree(jax.tree.map(np.asarray, getattr(init, k)))
            if x[0][-1] not in ("mean", "var")]
    for epoch, (count, since, moments, gen, _) in enumerate(after, 1):
        assert (count, since) == (int(init.count), 0), epoch
        assert len(moments) == len(want)
        for got, (_, w) in zip(moments, want):
            assert got.shape == w.shape and np.array_equal(got.numpy(), w)
        assert torch.equal(
            gen, torch.Generator().manual_seed(11 + epoch).get_state())
    # the second epoch stepped on from the first's weights
    start = [p.detach() for p in _trainable_leaves(tcat.CatModel(
        _carry(jax_params)))]
    assert any(not torch.equal(a, b) for a, b in zip(after[0][4], start))
    assert any(not torch.equal(a, b)
               for a, b in zip(after[1][4], after[0][4]))


def test_adam_is_optax_adam_on_the_same_gradients():
    """Order of operations: the same gradients through both optimizers."""
    rng = np.random.default_rng(9)
    shapes = [(7, 5), (11,), (3, 2, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = optax.adam(3e-3)
    jp = [jnp.asarray(a) for a in params]
    state = tx.init(jp)
    mine = Optimizer(ttrain.adam_config(3e-3))
    tp = [torch.tensor(a) for a in params]
    tstate = mine.init(tp)
    for step in range(5):
        grads = [(rng.standard_normal(s) * 10.0 ** rng.integers(-4, 3)
                  ).astype(np.float32) for s in shapes]     # no clipping
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        mine.step(tp, [torch.tensor(g) for g in grads], tstate)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=1e-6)


def _state_dict(params):
    """The reference CatModel's state_dict layout holding `params`."""
    sd = {}

    def lstm(prefix, layers):
        for k, layer in enumerate(layers):
            for d, suffix in enumerate(("", "_reverse")):
                sd[f"{prefix}.weight_ih_l{k}{suffix}"] = layer["w_ih"][d].T
                sd[f"{prefix}.weight_hh_l{k}{suffix}"] = layer["w_hh"][d].T
                sd[f"{prefix}.bias_ih_l{k}{suffix}"] = layer["b"][d] * 0.25
                sd[f"{prefix}.bias_hh_l{k}{suffix}"] = layer["b"][d] * 0.75

    def lin(prefix, p):
        sd[f"{prefix}.weight"] = p["w"].T
        sd[f"{prefix}.bias"] = p["b"]

    lstm("haplotype_percentage.rnn", params["percentage_rnn"])
    lin("haplotype_percentage.out_layer", params["percentage_proj"])
    lstm("haplotype_base.rnn.0.rnn", params["crnn_lstm1"])
    lin("haplotype_base.rnn.0.embedding", params["crnn_proj1"])
    lstm("haplotype_base.rnn.1.rnn", params["crnn_lstm2"])
    lin("haplotype_base.rnn.1.embedding", params["crnn_proj2"])
    lin("out_layer", params["out"])
    for i, blk in enumerate(params["res_blocks"]):
        base = f"haplotype_base.cnn.conv{i}"
        sd[f"{base}.base.conv{i}_base_conv1.weight"] = blk["conv1"]
        sd[f"{base}.base.conv{i}_base_conv2.weight"] = blk["conv2"]
        sd[f"{base}.shortcut.conv{i}_shortcut_conv1.weight"] = blk["shortcut"]
        for bn in ("bn1", "bn2"):
            pre = f"{base}.base.conv{i}_base_{bn}"
            sd[f"{pre}.weight"] = blk[bn]["scale"]
            sd[f"{pre}.bias"] = blk[bn]["bias"]
            sd[f"{pre}.running_mean"] = blk[bn]["mean"]
            sd[f"{pre}.running_var"] = blk[bn]["var"]
    return sd


def test_load_catmodel_torch_round_trip(jax_params, tmp_path):
    rng = np.random.default_rng(2)
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.01, jax_params)
    sd = _state_dict(params)
    want = jax.tree.map(np.asarray, jcat.load_catmodel_torch(sd))
    got = tcat.load_catmodel_torch({k: torch.from_numpy(np.ascontiguousarray(v))
                                    for k, v in sd.items()})
    flat_w, flat_g = flatten_tree(want), flatten_tree(params_to_numpy(got))
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_allclose(g, w, atol=1e-7, rtol=0, err_msg=str(path))
        np.testing.assert_allclose(
            g, flatten_tree(params)[[p for p, _ in flat_w].index(path)][1],
            atol=1e-6, rtol=0)
    # and through the npz archive of either package
    tcat_path, jax_path = tmp_path / "t.npz", tmp_path / "j.npz"
    from nanosnp_tpu_torch.models.convert import save_params_npz
    save_params_npz(str(tcat_path), got)
    jax_save_npz(str(jax_path), want)
    for (path, a), (_, b) in zip(
            flatten_tree(params_to_numpy(load_params_npz(str(tcat_path)))),
            flatten_tree(params_to_numpy(load_params_npz(str(jax_path))))):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    tcat.CatModel(load_params_npz(str(jax_path)))       # builds


# ---------------------------------------------------------------------------
# the copied numpy modules
# ---------------------------------------------------------------------------

def _reads(rng, depth, p=11):
    return rng.choice([-2, -1, 0, 1, 2, 3, 4], size=(depth, p),
                      p=[.1, .05, .05, .3, .2, .15, .15]).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edges_match_jax_package(seed):
    rng = np.random.default_rng(seed)
    assert tedges.EDGE_LABELS == jedges.EDGE_LABELS
    mats = [_reads(rng, int(d)) for d in rng.integers(0, 30, 12)]
    for m in mats:
        np.testing.assert_array_equal(tedges.edge_transition_counts(m),
                                      jedges.edge_transition_counts(m))
        np.testing.assert_array_equal(tedges.pair_route_counts(m),
                                      jedges.pair_route_counts(m))
    np.testing.assert_array_equal(tedges.pad_depth(mats, 16),
                                  jedges.pad_depth(mats, 16))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_heuristic_matches_jax_package(seed):
    rng = np.random.default_rng(10 + seed)
    em = rng.integers(0, 9, (40, 25, 10)) * (rng.random((40, 25, 10)) < 0.3)
    pos = [f"chr1:{100 + 7 * i}" for i in range(40)]
    np.testing.assert_array_equal(theur.call_homozygous(em),
                                  jheur.call_homozygous(em))
    np.testing.assert_array_equal(theur.call_homozygous_pair_route(em),
                                  jheur.call_homozygous_pair_route(em))
    for pair in (False, True):
        assert list(theur.run_heuristic(em, pos, pair_route=pair)) == \
            list(jheur.run_heuristic(em, pos, pair_route=pair))


def test_labelcheck_and_site_selection_match_jax_package():
    rng = np.random.default_rng(77)
    r1 = rng.choice([-2, -1, 0, 1, 2, 3, 4], size=(60, 12, 11),
                    p=[.15, .05, .1, .3, .1, .1, .2]).astype(np.int64)
    r2 = rng.permuted(r1, axis=1)
    gt = rng.integers(0, 15, 60)
    for col in (2, 5):
        for a, b in zip(tcheck.consensus_label_mismatches(r1, r2, gt, col),
                        jcheck.consensus_label_mismatches(r1, r2, gt, col)):
            np.testing.assert_array_equal(a, b)
    for a in range(-1, 6):
        for b in range(-1, 6):
            assert ttrain.cal_label(a, b) == jtrain.cal_label(a, b)
    labels = np.stack([rng.integers(0, 2, 300), rng.integers(-1, 21, 300),
                       rng.integers(-1, 3, 300)], axis=1)
    for n_cls in (10, 15):
        np.testing.assert_array_equal(
            ttrain.select_training_sites(labels, np.random.default_rng(4),
                                         n_cls),
            jtrain.select_training_sites(labels, np.random.default_rng(4),
                                         n_cls))


def test_config_archive_matches_jax_package():
    docs = [
        {"configname": "cat45", "model": {"gt_num_class": 15, "dropout": 0.5,
                                          "use_g0": True, "use_g2": False,
                                          "pileup_length": 11},
         "training": {"batch_size": 64, "epochs": 7, "seed": 3,
                      "first_stage": -1, "num_gpu": 2},
         "optim": {"type": "Ranger", "lr": 2e-4, "weight_decay": 0.01},
         "data": {"train1": "/a", "train2": "/b"}},
        {"model": {"enc": {"hidden_size": 32, "n_layers": 3},
                   "joint": {"inner_size": 64}, "feature_dim": 25},
         "training": {"first_stage": 4},
         "optim": {"type": "LookaheadAdam", "lr": 1e-3}},
    ]
    for doc in docs:
        got = tarchive.parse_archive_config(doc, "x")
        want = jarchive.parse_archive_config(doc, "x")
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        if got.family == "cat":
            assert got.catmodel_init_kwargs() == want.catmodel_init_kwargs()
    with pytest.raises(ValueError):
        tarchive.parse_archive_config({"training": {}})


def test_g_images_match_jax_package():
    rng = np.random.default_rng(6)

    def tag(depth):
        return {k: rng.integers(-2, 5, (4, depth, 11)).astype(np.int32)
                for k in ("read", "baseq", "mapq")}

    for d1, d2 in ((12, 25), (20, 3)):
        t1, t2 = tag(d1), tag(d2)
        np.testing.assert_array_equal(tcat.build_g_images(t1, t2, 20),
                                      jcat.build_g_images(t1, t2, 20))


# ---------------------------------------------------------------------------
# the CLIs on one small world of legacy bins
# ---------------------------------------------------------------------------

CONTIG, LENGTH, N_GROUPS = "chrL", 6000, 36


def _bin_arrays(rng, centers, hom):
    """legacy_group_arrays' output for one tag: reads mostly agreeing with
    a per-site consensus base (so the consensus filter has work)."""
    out = {k: [] for k in (
        "position", "group_positions", "read_matrix", "base_quality_matrix",
        "mapping_quality_matrix", "surrounding_read_matrix",
        "surrounding_base_quality_matrix",
        "surrounding_mapping_quality_matrix", "edge_matrix", "pair_route")}
    for c, base in zip(centers, hom):
        depth = int(rng.integers(6, 14))
        reads = np.where(rng.random((depth, 11)) < 0.85, base,
                         rng.integers(-1, 5, (depth, 11))).astype(np.int32)
        sur = np.where(rng.random((depth, 11)) < 0.9,
                       rng.integers(1, 5, (1, 11)),
                       rng.integers(-1, 5, (depth, 11))).astype(np.int32)
        out["position"].append(f"{CONTIG}:{c}")
        out["group_positions"].append(np.array(
            [f"{CONTIG}:{c + 9 * k}" for k in range(-5, 6)]))
        for key, m in (("", reads), ("surrounding_", sur)):
            out[f"{key}read_matrix"].append(m)
            out[f"{key}base_quality_matrix"].append(
                rng.integers(0, 40, m.shape).astype(np.int32))
            out[f"{key}mapping_quality_matrix"].append(
                rng.integers(0, 60, m.shape).astype(np.int32))
        out["edge_matrix"].append(tedges.edge_transition_counts(reads))
        out["pair_route"].append(tedges.pair_route_counts(reads))
    return out


@pytest.fixture(scope="module")
def legacy_world(tmp_path_factory, jax_params):
    tmp = tmp_path_factory.mktemp("torch_legacy")
    rng = np.random.default_rng(404)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, LENGTH)]
    write_fasta(str(tmp / "ref.fa"), {CONTIG: seq.tobytes().decode()})
    centers = np.sort(rng.choice(np.arange(100, LENGTH - 100, 60), N_GROUPS,
                                 replace=False))
    ref_code = np.searchsorted(np.frombuffer(b"ACGT", np.uint8),
                               seq[centers - 1]) + 1
    variant = rng.random(N_GROUPS) < 0.4
    alt_code = (ref_code - 1 + rng.integers(1, 4, N_GROUPS)) % 4 + 1
    het = rng.random(N_GROUPS) < 0.6
    # tag 1 carries the alt at every variant, tag 2 only at homozygous ones
    tag_bases = (np.where(variant, alt_code, ref_code),
                 np.where(variant & ~het, alt_code, ref_code))
    for tag, bases in zip(("tag1", "tag2"), tag_bases):
        os.makedirs(tmp / tag)
        arrays = _bin_arrays(rng, centers, bases)
        assert tbins.save_legacy_bin(str(tmp / tag / f"{CONTIG}.bin"),
                                     arrays) == N_GROUPS
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS"]
    for c, r, a, v, h in zip(centers, ref_code, alt_code, variant, het):
        if v:
            lines.append(f"{CONTIG}\t{c}\t.\t{'ACGT'[r - 1]}\t{'ACGT'[a - 1]}"
                         f"\t50\tPASS\t.\tGT\t{'0/1' if h else '1/1'}")
    (tmp / "truth.vcf").write_text("\n".join(lines) + "\n")
    (tmp / "conf.bed").write_text(f"{CONTIG}\t0\t{LENGTH}\n")
    jax_save_npz(str(tmp / "cat.npz"), jax_params)
    return tmp


def _world_args(tmp, truth=True):
    args = ["--data-tag1", str(tmp / "tag1"), "--data-tag2", str(tmp / "tag2")]
    if truth:
        args += ["--ref", str(tmp / "ref.fa"), "--truth-vcf",
                 str(tmp / "truth.vcf"), "--bed", str(tmp / "conf.bed")]
    return args


def _rows(path):
    return [ln.split("\t") for ln in open(path).read().splitlines()
            if not ln.startswith("#")]


def test_legacy_bins_round_trip_in_both_packages(legacy_world):
    path = str(legacy_world / "tag1" / f"{CONTIG}.bin")
    a, b = tbins.load_legacy_bin(path), jbins.load_legacy_bin(path)
    assert sorted(a) == sorted(b) and len(a["position"]) == N_GROUPS
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_npz_bins_hold_the_same_datasets(legacy_world, tmp_path):
    """The numpy container (for a machine without h5py) against HDF5."""
    rng = np.random.default_rng(12)
    arrays = _bin_arrays(rng, np.arange(200, 800, 50), rng.integers(1, 5, 12))
    tbins.save_legacy_bin(str(tmp_path / "a.bin"), arrays)
    assert tbins.save_legacy_bin(str(tmp_path / "a.npz"), arrays) == 12
    a = jbins.load_legacy_bin(str(tmp_path / "a.bin"))
    b = tbins.load_legacy_bin(str(tmp_path / "a.npz"))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with np.load(tmp_path / "a.npz", allow_pickle=False) as z:
        assert z["position"].dtype.kind == "S"


def _same_calls(got, want, qual_col):
    """Same sites and classes; QUAL (a rounded log-odds of a probability
    within F32_TOL) within 0.01."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[:qual_col] == w[:qual_col] and g[qual_col + 1:] == \
            w[qual_col + 1:]
        assert abs(float(g[qual_col]) - float(w[qual_col])) <= 0.01


def test_legacy_predict_cli_matches_jax_cli(legacy_world, tmp_path):
    args = _world_args(legacy_world, truth=False) + [
        "--model", str(legacy_world / "cat.npz"), "--batch-size", "16"]
    assert jax_cli(["legacy-predict", *args, "-o", str(tmp_path / "j")]) == 0
    assert torch_cli(["legacy-predict", *args, "-o", str(tmp_path / "t"),
                      "--device", "cpu"]) == 0
    _same_calls(_rows(tmp_path / "t" / "legacy_calls.tsv"),
                _rows(tmp_path / "j" / "legacy_calls.tsv"), 3)


def test_legacy_eval_cli_matches_jax_cli(legacy_world, tmp_path):
    args = _world_args(legacy_world) + [
        "--model", str(legacy_world / "cat.npz"), "--batch-size", "16",
        "--min-depth", "2"]
    assert jax_cli(["legacy-eval", *args, "-o", str(tmp_path / "j")]) == 0
    assert torch_cli(["legacy-eval", *args, "-o", str(tmp_path / "t"),
                      "--device", "cpu"]) == 0
    got, want = (tmp_path / d / "legacy_eval.tsv" for d in "tj")
    assert open(got).readline() == open(want).readline()
    _same_calls(_rows(got), _rows(want), 4)


def test_legacy_filter_and_heuristic_clis_match_jax_clis(legacy_world,
                                                          tmp_path):
    args = _world_args(legacy_world) + ["--min-depth", "2",
                                        "--threshold", "0.6"]
    for cli, out in ((jax_cli, "j"), (torch_cli, "t")):
        assert cli(["legacy-filter-labels", *args,
                    "-o", str(tmp_path / out)]) == 0
        for flag in ([], ["--pair-route"]):
            assert cli(["legacy-heuristic", "--data",
                        str(legacy_world / "tag1"), *flag, "-o",
                        str(tmp_path / (out + "h" + str(len(flag))))]) == 0
    got = (tmp_path / "t" / "filtered_positions.txt").read_text()
    assert got == (tmp_path / "j" / "filtered_positions.txt").read_text()
    for n in "01":
        a = (tmp_path / f"th{n}" / "legacy_homozygous.txt").read_text()
        assert a == (tmp_path / f"jh{n}" / "legacy_homozygous.txt").read_text()
        assert a


def test_legacy_train_cli_writes_what_the_jax_cli_writes(legacy_world,
                                                          tmp_path, capsys):
    """The two packages draw other initial weights and dropout masks, so
    the archives are compared by layout: the same keys and shapes, finite
    values, running statistics moved."""
    args = _world_args(legacy_world) + ["--min-depth", "2", "--epochs", "1",
                                        "--batch-size", "8", "--seed", "1"]
    assert jax_cli(["legacy-train", *args, "-o", str(tmp_path / "j")]) == 0
    jax_out = capsys.readouterr().out
    assert torch_cli(["legacy-train", *args, "-o", str(tmp_path / "t"),
                      "--device", "cpu"]) == 0
    torch_out = capsys.readouterr().out
    # the same sites selected, the same number of steps
    def counts(out):
        d = eval(out.strip().splitlines()[-1])
        return d["steps"], d["sites"]
    assert counts(torch_out) == counts(jax_out) and counts(jax_out)[0] > 0
    for name in ("catmodel_epoch1.npz", "catmodel.npz"):
        with np.load(tmp_path / "t" / name) as got, \
                np.load(tmp_path / "j" / name) as want:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                assert got[k].shape == want[k].shape, k
                assert got[k].dtype == want[k].dtype, k
                assert np.isfinite(got[k]).all(), k
    trained = load_params_npz(str(tmp_path / "t" / "catmodel.npz"))
    assert not np.allclose(trained["res_blocks"][0]["bn1"]["mean"].numpy(), 0)
    # and the trained archive predicts through the port's CLI
    assert torch_cli(["legacy-predict", *_world_args(legacy_world, False),
                      "--model", str(tmp_path / "t" / "catmodel.npz"),
                      "-o", str(tmp_path / "p"), "--device", "cpu"]) == 0
    assert _rows(tmp_path / "p" / "legacy_calls.tsv")


def _epoch_records(out):
    """(epoch, steps, sites) of each epoch record legacy-train printed."""
    recs = [eval(line) for line in out.splitlines()
            if line.startswith("{'epoch'")]
    return [(r["epoch"], r["steps"], r["sites"]) for r in recs]


def test_legacy_train_cli_two_epochs_count_as_the_jax_cli(legacy_world,
                                                          tmp_path, capsys):
    """Each epoch selects its own sites from one generator, in both
    packages: the same sites and steps in each epoch, and an archive for
    each."""
    args = _world_args(legacy_world) + ["--min-depth", "2", "--epochs", "2",
                                        "--batch-size", "16", "--seed", "3"]
    assert jax_cli(["legacy-train", *args, "-o", str(tmp_path / "j")]) == 0
    jax_out = capsys.readouterr().out
    assert torch_cli(["legacy-train", *args, "-o", str(tmp_path / "t"),
                      "--device", "cpu"]) == 0
    torch_out = capsys.readouterr().out
    want = _epoch_records(jax_out)
    assert [r[0] for r in want] == [1, 2] and all(r[1] > 0 for r in want)
    assert _epoch_records(torch_out) == want
    for name in ("catmodel_epoch1.npz", "catmodel_epoch2.npz",
                 "catmodel.npz"):
        assert (tmp_path / "t" / name).exists(), name
