"""Grouped training steps (`steps_per_call`) of the port on the CPU against
the JAX package's make_multi_step path and against the port's own single
steps.

The JAX trainers buffer batches and scan each full buffer of
steps_per_call in one dispatch (train_pileup(steps_per_epoch=None));
the port runs the same buffers as groups (nanosnp_tpu_torch/train/
group.py), eagerly on the CPU, and as one CUDA graph replay on the card
(chip_smoke.py phase 3 holds replay to eager steps there). Narrow models,
dropout 0, numpy-seeded inputs:

- pileup, 19 batches at steps_per_call 8 (groups of 8, 8 and a partial
  3): final parameters, Lookahead slow parameters and Adam / RAdam
  moments against JAX, with Lookahead-Adam and Ranger. A group of 8 from
  count 0 crosses RAdam's switch at update 6 and Lookahead's sync after
  update 6;
- haplotype, batches of two depth buckets interleaved: one buffer a
  bucket, so the order of the steps is the point;
- grouped against single steps (steps_per_call 1) in the port, bit for
  bit, for all ten optimizer types, novograd's first update inside the
  first group;
- max_steps 10 at steps_per_call 8 ends with the group that reaches it:
  16 steps in both packages.

Tolerance: both sides are f32 and sum in their own orders; lr is 1e-4, so
that Adam's full-size updates of near-cancelled gradient entries stay
inside 1e-5 (test_torch_train_dp.py says why)."""
import jax
import numpy as np
import pytest
import torch

from nanosnp_tpu.config import HaplotypeModelConfig as JHapCfg
from nanosnp_tpu.config import OptimConfig as JOptCfg
from nanosnp_tpu.config import PileupModelConfig as JPileCfg
from nanosnp_tpu.config import TrainConfig as JTrainCfg
from nanosnp_tpu.models.haplotype_model import \
    init_haplotype_params as jax_init_haplotype
from nanosnp_tpu.models.pileup_model import \
    init_pileup_params as jax_init_pileup
from nanosnp_tpu.train.train_haplotype import \
    train_haplotype as jax_train_haplotype
from nanosnp_tpu.train.train_pileup import train_pileup as jax_train_pileup
from nanosnp_tpu_torch.config import (HaplotypeModelConfig, OptimConfig,
                                      PileupModelConfig, TrainConfig)
from nanosnp_tpu_torch.models.convert import flatten_tree, params_from_jax
from nanosnp_tpu_torch.train.group import GroupRunner
from nanosnp_tpu_torch.train.train_haplotype import train_haplotype
from nanosnp_tpu_torch.train.train_pileup import train_pileup

from test_torch_train_step import (HAP, OPT, OPT_CASES, PILE,
                                   STEPS_PER_EPOCH, _hap_batch, _np_tree)

TOL = 1e-5
OPT_GROUP = dict(OPT, lr=1e-4)
N_PILEUP = 19          # groups of 8, 8 and 3


def _pileup_batches(rng, n, rows=24):
    return [(rng.integers(-15, 15, (rows, 33, 18)).astype(np.float32),
             rng.integers(0, 21, rows), rng.integers(0, 3, rows))
            for _ in range(n)]


def _jax_moments(opt_state):
    """The one optax state in the chain that holds mu and nu."""
    found = []

    def walk(s):
        if hasattr(s, "mu") and hasattr(s, "nu"):
            found.append(s)
        elif isinstance(s, (tuple, list)):
            for x in s:
                walk(x)

    walk(opt_state)
    assert len(found) == 1
    return found[0]


def _leaves(tree):
    return [v.detach().numpy() if isinstance(v, torch.Tensor) else
            np.asarray(v) for _, v in flatten_tree(tree)]


def _close(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                   err_msg=f"{what} leaf {i}")


def _check_against_jax(port, jstate, steps, adam_state=True):
    assert port.step == jstate.step == steps
    jp = params_from_jax(_np_tree(jstate.params))
    _close(_leaves(port.model.tree()), _leaves(jp["fast"]), "fast")
    _close(_leaves(port.slow), _leaves(jp["slow"]), "slow")
    moments = _jax_moments(jstate.opt_state)
    for name in ("mu", "nu"):
        want = _leaves(params_from_jax(_np_tree(getattr(moments, name))))
        _close([t.numpy() for t in port.opt_state[name]], want, name)
    assert port.opt_state["count"] == int(moments.count) == steps
    assert port.opt_state["steps_since_sync"] == steps % 6


@pytest.mark.parametrize("opt_type", ["lookahead_adam", "ranger"])
def test_grouped_pileup_training_matches_jax_multi_step(tmp_path, opt_type):
    rng = np.random.default_rng(41)
    jparams = _np_tree(jax_init_pileup(jax.random.key(6), JPileCfg(**PILE)))
    batches = _pileup_batches(rng, N_PILEUP)
    opt = dict(OPT_GROUP, type=opt_type)
    jstate = jax_train_pileup(
        iter(batches), JPileCfg(**PILE),
        JTrainCfg(optim=JOptCfg(**opt), batch_size=24), None,
        str(tmp_path / "jax"), init_params=jparams,
        lr_steps_per_epoch=STEPS_PER_EPOCH)
    port = train_pileup(
        iter(batches), PileupModelConfig(**PILE),
        TrainConfig(optim=OptimConfig(**opt), batch_size=24), None,
        str(tmp_path / "port"), init_params=params_from_jax(jparams),
        device="cpu", lr_steps_per_epoch=STEPS_PER_EPOCH)
    _check_against_jax(port, jstate, N_PILEUP)


def test_grouped_haplotype_training_keeps_jax_step_order(tmp_path):
    """Two depth buckets interleaved at steps_per_call 4: each bucket's
    buffer runs when it fills, the rest at the end in the order the
    buffers were opened."""
    rng = np.random.default_rng(42)
    depths = [6, 6, 8, 6, 8, 8, 6, 6, 8, 8, 6, 8, 6]
    batches = [_hap_batch(rng, 16, d) for d in depths]
    jparams = _np_tree(jax_init_haplotype(jax.random.key(7),
                                          JHapCfg(**HAP)))
    jstate = jax_train_haplotype(
        iter(batches), JHapCfg(**HAP),
        JTrainCfg(optim=JOptCfg(**OPT_GROUP), batch_size=16,
                  steps_per_call=4), None, str(tmp_path / "jax"),
        init_params=jparams, lr_steps_per_epoch=STEPS_PER_EPOCH)
    port = train_haplotype(
        iter(batches), HaplotypeModelConfig(**HAP),
        TrainConfig(optim=OptimConfig(**OPT_GROUP), batch_size=16,
                    steps_per_call=4), None, str(tmp_path / "port"),
        init_params=params_from_jax(jparams), device="cpu",
        lr_steps_per_epoch=STEPS_PER_EPOCH)
    _check_against_jax(port, jstate, len(batches))


@pytest.mark.parametrize("opt_type,weight_decay", OPT_CASES)
def test_grouped_steps_equal_single_steps_bit_for_bit(tmp_path, opt_type,
                                                      weight_decay):
    """11 batches (a group of 8, then 3) against 11 single steps; the
    encoders frozen from the second epoch's first step (an EPOCH_END after
    batch 5, so the second group runs with the freeze in its table)."""
    from nanosnp_tpu_torch.train import data as D

    rng = np.random.default_rng(43)
    params = params_from_jax(_np_tree(jax_init_pileup(jax.random.key(8),
                                                      JPileCfg(**PILE))))
    items = _pileup_batches(rng, 11)
    items.insert(5, D.EPOCH_END)
    runs = []
    for group in (8, 1):
        tcfg = TrainConfig(optim=OptimConfig(**dict(
            OPT, type=opt_type, weight_decay=weight_decay,
            ranger21_epochs=3)), batch_size=24, steps_per_call=group,
            first_stage=1)
        runs.append(train_pileup(
            iter(items), PileupModelConfig(**PILE), tcfg, None,
            str(tmp_path / f"g{group}"), init_params=params, device="cpu",
            lr_steps_per_epoch=STEPS_PER_EPOCH))
    grouped, single = runs
    assert grouped.step == single.step == 11
    for a, b in zip(_leaves(grouped.model.tree()), _leaves(
            single.model.tree())):
        assert np.array_equal(a, b)
    assert (grouped.slow is None) == (single.slow is None)
    if grouped.slow is not None:
        for a, b in zip(_leaves(grouped.slow), _leaves(single.slow)):
            assert np.array_equal(a, b)
    assert set(grouped.opt_state) == set(single.opt_state)
    for k, v in grouped.opt_state.items():
        if isinstance(v, list):
            assert all(torch.equal(a, b)
                       for a, b in zip(v, single.opt_state[k])), k
        else:
            assert v == single.opt_state[k], k


@pytest.mark.parametrize("model", ["pileup", "haplotype"])
def test_max_steps_ends_with_the_group_that_reaches_it(tmp_path, model):
    """max_steps 10 at steps_per_call 8: both packages check it after a
    group and stop at 16 steps."""
    rng = np.random.default_rng(44)
    if model == "pileup":
        batches = _pileup_batches(rng, 24, rows=8)
        jparams = _np_tree(jax_init_pileup(jax.random.key(9),
                                           JPileCfg(**PILE)))
        jax_fn, port_fn = jax_train_pileup, train_pileup
        jcfg, pcfg = JPileCfg(**PILE), PileupModelConfig(**PILE)
    else:
        batches = [_hap_batch(rng, 8, 6) for _ in range(24)]
        jparams = _np_tree(jax_init_haplotype(jax.random.key(9),
                                              JHapCfg(**HAP)))
        jax_fn, port_fn = jax_train_haplotype, train_haplotype
        jcfg, pcfg = JHapCfg(**HAP), HaplotypeModelConfig(**HAP)
    jstate = jax_fn(iter(batches), jcfg,
                    JTrainCfg(optim=JOptCfg(**OPT_GROUP), batch_size=8),
                    None, str(tmp_path / "jax"), init_params=jparams,
                    max_steps=10, lr_steps_per_epoch=STEPS_PER_EPOCH)
    port = port_fn(iter(batches), pcfg,
                   TrainConfig(optim=OptimConfig(**OPT_GROUP), batch_size=8),
                   None, str(tmp_path / "port"),
                   init_params=params_from_jax(jparams), device="cpu",
                   max_steps=10, lr_steps_per_epoch=STEPS_PER_EPOCH)
    assert jstate.step == port.step == port.opt_state["count"] == 16


def test_group_runner_routes_on_the_cpu():
    """On the CPU every group runs eagerly, whatever its size; a group
    larger than steps_per_call raises."""
    from nanosnp_tpu_torch.train.optim import build_optimizer

    tx = build_optimizer(OptimConfig(type="sgd"))
    w = torch.zeros(3)
    state = type("S", (), {"opt_state": tx.init([w])})()
    seen = []

    def step(batch, row):
        seen.append(float(batch["x"].sum()))
        tx.update([w], [batch["x"]], state.opt_state, row)
        return {"loss": batch["x"].sum()}

    runner = GroupRunner(step, tx, state, None, torch.device("cpu"), 4)
    assert not runner.use_graphs and runner.stream is None
    out = runner.run([{"x": np.full(3, i, np.float32)} for i in range(4)])
    assert seen == [0.0, 3.0, 6.0, 9.0]
    np.testing.assert_array_equal(out["loss"], [0.0, 3.0, 6.0, 9.0])
    runner.run([{"x": np.ones(3, np.float32)}])
    assert runner.steps == {"graph": 0, "eager": 4, "partial": 1}
    assert state.opt_state["count"] == 5
    with pytest.raises(ValueError, match="1 to 4"):
        runner.run([{"x": np.ones(3, np.float32)}] * 5)
