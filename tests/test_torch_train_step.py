"""The training slice as a whole against the JAX package: the train steps of
both models (13 optimizer steps, so that Lookahead syncs twice, with a
gradient clip that engages and an lr decay across an epoch boundary), the
optimizer alone against optax, the freeze mask, the trainers' CLIs on the
CPU with the JAX loader reading the port's checkpoint, and resume.

The JAX side runs its f32 scan path (use_pallas=False), the port its f32
path (use_kernels=False); on the card the port runs the training kernels,
held to their plain versions by chip_smoke.py and to the Pallas kernels by
test_torch_lstm_train.py."""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from nanosnp_tpu.config import HaplotypeModelConfig as JHapCfg
from nanosnp_tpu.config import OptimConfig as JOptCfg
from nanosnp_tpu.config import PileupModelConfig as JPileCfg
from nanosnp_tpu.config import TrainConfig as JTrainCfg
from nanosnp_tpu.models.haplotype_model import \
    init_haplotype_params as jax_init_haplotype
from nanosnp_tpu.models.pileup_model import \
    init_pileup_params as jax_init_pileup
from nanosnp_tpu.train import optim as jax_optim
from nanosnp_tpu.train.train_haplotype import \
    make_haplotype_train_step as jax_haplotype_step
from nanosnp_tpu.train.train_pileup import \
    load_checkpoint as jax_load_checkpoint
from nanosnp_tpu.train.train_pileup import \
    make_pileup_train_step as jax_pileup_step
from nanosnp_tpu_torch.config import (HaplotypeModelConfig, OptimConfig,
                                      PileupModelConfig, TrainConfig)
from nanosnp_tpu_torch.io import bins
from nanosnp_tpu_torch.io.fasta import write_fasta
from nanosnp_tpu_torch.models.convert import flatten_tree, params_from_jax
from nanosnp_tpu_torch.models.haplotype_model import HaplotypeModel
from nanosnp_tpu_torch.models.pileup_model import PileupModel
from nanosnp_tpu_torch.runtime import cli
from nanosnp_tpu_torch.train import data as D
from nanosnp_tpu_torch.train import optim
from nanosnp_tpu_torch.train.train_haplotype import \
    make_haplotype_train_step
from nanosnp_tpu_torch.train.train_pileup import (init_state, load_checkpoint,
                                                  make_pileup_train_step,
                                                  train_pileup)

# Per-step losses: f32 on both sides, summation order only.
LOSS_RTOL = 1e-5
# Params after 13 steps. Adam scales each entry's update to about lr
# whatever the gradient's size, so a gradient entry that is a near-total
# cancellation (its f32 summation order then decides a large part of it)
# carries that relative difference into a full-size update: a few entries
# in a thousand differ by a few 1e-5 (lr is 1e-3), the rest by f32
# rounding scaled by lr. The bound is a tenth of one step.
PARAM_ATOL, PARAM_RTOL = 1e-4, 1e-4
# The optimizer alone, on the same gradients: f32 rounding of the same
# operations (pow in the bias correction may differ by one ulp)
OPT_ATOL, OPT_RTOL = 1e-7, 1e-5
N_STEPS = 13          # Lookahead syncs after steps 6 and 12
STEPS_PER_EPOCH = 5   # lr halves from step 10 (epoch 2)
FREEZE_FROM = 11      # the last two steps freeze the encoders

OPT = dict(lr=1e-3, max_grad_norm=0.2, begin_to_adjust_lr=1,
           decay_ratio=0.5)
PILE = dict(hidden_size=16, output_size=32, inner_size=32, n_layers=2,
            dropout=0.0)
HAP = dict(hidden_size=8, lstm_layers=2, dropout=0.0)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(got, want, atol, rtol):
    got, want = dict(flatten_tree(got)), dict(flatten_tree(want))
    assert set(got) == set(want)
    for path in want:
        g, w = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else v for v in (got[path], want[path]))
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol,
                                   err_msg=str(path))


def _run_both(jax_step, jax_params, port_model, port_step, batches,
              opt=OPT):
    """13 steps on both sides. -> (jax losses, port losses, final JAX
    LookaheadParams as numpy, port state)."""
    tx = jax_optim.build_optimizer(JOptCfg(**opt), STEPS_PER_EPOCH)
    params = jax_optim.wrap_params_for_lookahead(
        jax.tree.map(jnp.asarray, jax_params), True)
    opt_state = tx.init(params)
    step = jax.jit(jax_step(tx))
    rng = jax.random.key(0)
    ptx = optim.build_optimizer(OptimConfig(**opt), STEPS_PER_EPOCH)
    state = init_state(port_model, ptx)
    pstep = port_step(ptx)
    gen = torch.Generator().manual_seed(0)
    want, got = [], []
    for i, (jb, pb) in enumerate(batches):
        fz = 1.0 if i >= FREEZE_FROM else 0.0
        params, opt_state, m, rng = step(params, opt_state, *jb, rng,
                                         jnp.float32(fz))
        want.append(float(m["loss"]))
        got.append(float(pstep(state, *pb, gen, fz)["loss"]))
    return want, got, params_from_jax(_np_tree(params)), state


def _check_run(want, got, jparams, state):
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert len(set(np.round(got, 4))) > 1       # the loss moves
    _assert_trees_close(state.model.tree(), jparams["fast"], PARAM_ATOL,
                        PARAM_RTOL)
    _assert_trees_close(state.slow, jparams["slow"], PARAM_ATOL, PARAM_RTOL)
    assert state.opt_state["count"] == N_STEPS
    assert state.opt_state["steps_since_sync"] == N_STEPS % 6


def test_pileup_train_step_matches_jax():
    _check_run(*_pileup_run(OPT))


def _pileup_run(opt):
    rng = np.random.default_rng(21)
    jcfg = JPileCfg(**PILE)
    jparams = _np_tree(jax_init_pileup(jax.random.key(1), jcfg))
    jt = JTrainCfg(optim=JOptCfg(**OPT))
    tcfg = TrainConfig(optim=OptimConfig(**OPT))
    batches = []
    for _ in range(N_STEPS):
        x = rng.integers(-15, 15, (24, 33, 18)).astype(np.float32)
        gt, zy = rng.integers(0, 21, 24), rng.integers(0, 3, 24)
        batches.append(((jnp.asarray(x), jnp.asarray(gt), jnp.asarray(zy)),
                        tuple(torch.from_numpy(a) for a in (x, gt, zy))))
    model = PileupModel(PileupModelConfig(**PILE), params_from_jax(jparams))
    # the clip engages: the first gradient's global norm is above it
    gt_l, zy_l = model.forward_train(batches[0][1][0], use_kernels=False)
    from nanosnp_tpu_torch.train.losses import label_smoothing_loss as ls
    grads = torch.autograd.grad(
        ls(gt_l, batches[0][1][1]) + ls(zy_l, batches[0][1][2]),
        [p for _, p in flatten_tree(model.tree())], allow_unused=True,
        materialize_grads=True)
    assert torch.sqrt(sum((g * g).sum() for g in grads)) > OPT["max_grad_norm"]
    run = _run_both(
        lambda tx: jax_pileup_step(jcfg, jt, tx, use_pallas=False), jparams,
        model,
        lambda tx: make_pileup_train_step(model.cfg, tcfg, tx,
                                          use_kernels=False), batches, opt)
    return run


def _hap_batch(rng, n, depth):
    def view(seq_len):
        seq = rng.integers(-2, 5, (n, depth, seq_len))
        hap = np.repeat(rng.integers(1, 4, (n, depth, 1)), seq_len, axis=2)
        pad = seq == -2
        return {"seq": seq, "baseq": np.where(pad, -2, rng.integers(
                    0, 60, seq.shape)),
                "mapq": np.where(pad, -2, rng.integers(0, 61, seq.shape)),
                "hap": np.where(pad, -2, hap)}

    b = {}
    for pre, seq_len in (("p_", 33), ("h_", 11)):
        for k, v in view(seq_len).items():
            b[pre + k] = v.astype(np.int8)
        b[pre + "ref"] = rng.integers(0, 5, (n, seq_len)).astype(np.int8)
    b["gt"] = rng.integers(0, 10, n).astype(np.int32)
    b["zy"] = rng.integers(0, 3, n).astype(np.int32)
    return b


def test_haplotype_train_step_matches_jax():
    _check_run(*_haplotype_run(OPT))


def _haplotype_run(opt):
    rng = np.random.default_rng(22)
    jcfg = JHapCfg(**HAP)
    jparams = _np_tree(jax_init_haplotype(jax.random.key(2), jcfg))
    jt = JTrainCfg(optim=JOptCfg(**OPT))
    tcfg = TrainConfig(optim=OptimConfig(**OPT))
    batches = []
    for _ in range(N_STEPS):
        b = _hap_batch(rng, 12, 6)
        batches.append((({k: jnp.asarray(v) for k, v in b.items()},),
                        ({k: torch.from_numpy(v) for k, v in b.items()},)))
    model = HaplotypeModel(HaplotypeModelConfig(**HAP),
                           params_from_jax(jparams))
    run = _run_both(
        lambda tx: jax_haplotype_step(jcfg, jt, tx, use_pallas=False),
        jparams, model,
        lambda tx: make_haplotype_train_step(model.cfg, tcfg, tx,
                                             use_kernels=False), batches,
        opt)
    return run


@pytest.mark.parametrize("model,opt_type", [("pileup", "ranger"),
                                            ("haplotype", "ranger21")])
def test_ranger_train_steps_match_jax(model, opt_type):
    """The reference's own optimizers of each model (Ranger for the pileup
    model, Ranger21 for the haplotype model), both with Lookahead: the
    same 13 steps as above."""
    run = (_pileup_run if model == "pileup" else _haplotype_run)(
        dict(OPT, type=opt_type))
    _check_run(*run)


# every optimizer type with the weight decay it reads (radam, sgd, adadelta
# and ranger read none)
OPT_CASES = [("lookahead_adam", 0.0), ("adam", 1e-2), ("radam", 0.0),
             ("lookahead_radam", 0.0), ("novograd", 1e-2),
             ("lookahead_novograd", 0.0), ("sgd", 0.0), ("adadelta", 0.0),
             ("ranger", 0.0), ("ranger21", 1e-2)]
# 30 updates: Lookahead syncs five times, RAdam's rectification starts at
# update 6 (rho crosses 5), novograd seeds its second moment at update 1,
# and ranger21's lr21 (30 planned updates: 6 epochs of 5) warms up over
# updates 1-3 and warms down over 28-30
OPT_STEPS = 30


@pytest.mark.parametrize("opt_type,weight_decay", OPT_CASES)
def test_optimizer_matches_optax(opt_type, weight_decay):
    """Fixed gradient sequences through optax (the JAX package's
    build_optimizer) and the port's Optimizer; some steps clip. The leaves
    have rank 1, 2 and 3, one of them [1, k], the shapes on which gradient
    centralization, norm loss and adaptive clipping choose their axes."""
    rng = np.random.default_rng(23)
    cfg = dict(OPT, type=opt_type, weight_decay=weight_decay,
               max_grad_norm=10.0, ranger21_epochs=6)
    tree = {"enc": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                    "w_hh": rng.standard_normal((2, 4, 8)).astype(
                        np.float32)},
            "head": [rng.standard_normal(5).astype(np.float32),
                     rng.standard_normal((1, 6)).astype(np.float32)]}
    tx = jax_optim.build_optimizer(JOptCfg(**cfg), STEPS_PER_EPOCH)
    lookahead = jax_optim.is_lookahead_type(opt_type)
    jp = jax_optim.wrap_params_for_lookahead(
        jax.tree.map(jnp.asarray, tree), lookahead)
    js = tx.init(jp)
    ptx = optim.build_optimizer(OptimConfig(**cfg), STEPS_PER_EPOCH)
    assert ptx.lookahead == lookahead
    fast = [torch.from_numpy(v.copy()) for _, v in flatten_tree(tree)]
    slow = [p.clone() for p in fast] if lookahead else None
    ps = ptx.init(fast)
    clipped = 0
    for i in range(OPT_STEPS):
        grads = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * (0.3 + i % 3)
                       ).astype(np.float32), tree)
        clipped += float(optax.global_norm(grads)) >= cfg["max_grad_norm"]
        updates, js = tx.update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, updates)
        ptx.step(fast, [torch.from_numpy(g) for _, g in flatten_tree(grads)],
                 ps, slow)
        want = params_from_jax(_np_tree(jp))
        got_fast = [p.numpy() for p in fast]
        want_fast = want["fast"] if lookahead else want
        for g, (_, w) in zip(got_fast, flatten_tree(want_fast)):
            np.testing.assert_allclose(g, w.numpy(), atol=OPT_ATOL,
                                       rtol=OPT_RTOL, err_msg=f"step {i}")
        if lookahead:
            for g, (_, w) in zip(slow, flatten_tree(want["slow"])):
                np.testing.assert_allclose(g.numpy(), w.numpy(),
                                           atol=OPT_ATOL, rtol=OPT_RTOL)
    assert 0 < clipped < OPT_STEPS
    assert ps["count"] == OPT_STEPS


def test_radam_rectification_starts_at_update_six():
    """The branch the optimizer test crosses: rho is below 5 for the first
    five updates and above it from the sixth (optax 0.2.6, b2 0.999)."""
    radam = optim.ScaleByRAdam()
    assert [bool(radam.rectification(n)[0] >= 5) for n in range(1, 9)] == \
        [False] * 5 + [True] * 3


def test_ranger21_schedule_warms_up_and_down():
    """lr21 around the base schedule, 30 planned updates: warmup over the
    first 3 (10%), warmdown after update 27 (90%), base lr between."""
    cfg = OptimConfig(**dict(OPT, type="ranger21", ranger21_epochs=6))
    base = optim.lr_schedule(cfg, STEPS_PER_EPOCH)
    lr21 = optim.ranger21_schedule(cfg, STEPS_PER_EPOCH, base)
    factor = [min((s + 1) / 3, 1.0) * (min((30 - s) / 3, 1.0) if s > 27
                                       else 1.0) for s in range(OPT_STEPS)]
    np.testing.assert_allclose([lr21(s) for s in range(OPT_STEPS)],
                               [base(s) * f for s, f in enumerate(factor)],
                               rtol=1e-6)
    assert factor[:3] == [1 / 3, 2 / 3, 1.0] and factor[28:] == [2 / 3, 1 / 3]


def test_unknown_optimizer_type_raises():
    with pytest.raises(NotImplementedError, match="lamb"):
        optim.build_optimizer(OptimConfig(type="lamb"))


def test_lr_schedule_matches_jax_across_epochs():
    cfg = dict(lr=1e-3, begin_to_adjust_lr=2, decay_ratio=0.9)
    port = optim.lr_schedule(OptimConfig(**cfg), 7)
    ref = jax_optim.lr_schedule(JOptCfg(**cfg), 7)
    got = [port(s) for s in range(60)]
    np.testing.assert_allclose(got, [float(ref(jnp.int32(s)))
                                     for s in range(60)], rtol=1e-6)
    assert got[20] == got[0] and got[21] < got[20]   # decay from epoch 3


def test_freeze_mask_keeps_frozen_leaves_while_adam_moves():
    cfg = PileupModelConfig(**PILE)
    model = PileupModel(cfg, params_from_jax(_np_tree(
        jax_init_pileup(jax.random.key(5), JPileCfg(**PILE)))))
    tcfg = TrainConfig(optim=OptimConfig(**OPT))
    tx = optim.build_optimizer(tcfg.optim, 100)
    state = init_state(model, tx)
    step = make_pileup_train_step(cfg, tcfg, tx, use_kernels=False)
    before = {p: v.detach().clone() for p, v in flatten_tree(model.tree())}
    rng = np.random.default_rng(3)
    for i in range(7):                       # through one Lookahead sync
        step(state, torch.from_numpy(rng.integers(-9, 9, (8, 33, 18)).astype(
                 np.float32)), torch.from_numpy(rng.integers(0, 21, 8)),
             torch.from_numpy(rng.integers(0, 3, 8)), None, 1.0)
    flat = flatten_tree(model.tree())
    for i, (path, v) in enumerate(flat):
        moved = not torch.equal(v, before[path])
        assert moved == (path[0] not in ("encoder", "id1", "id2")), path
        if path[0] == "encoder":
            assert state.opt_state["mu"][i].abs().max() > 0
            slow = dict(flatten_tree(state.slow))[path]
            torch.testing.assert_close(slow, before[path], atol=0, rtol=0)


# -- the trainers through their entry points, on the CPU ------------------

SMALL_YAML = """pileup_model:
  hidden_size: 16
  output_size: 32
  inner_size: 32
haplotype_model:
  hidden_size: 8
  lstm_layers: 2
"""


def _pileup_arrays(rng, n):
    label = np.zeros((n, 90), np.int32)
    label[np.arange(n), rng.integers(0, 21, n)] = 1
    label[np.arange(n), 21 + rng.integers(0, 3, n)] = 1
    return D.PileupTrainArrays(
        rng.integers(-20, 20, (n, 33, 18)).astype(np.int32), label,
        np.arange(n, dtype=np.int64), np.zeros(n, bool))


def _read_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_pileup_cli_on_cpu_writes_jax_readable_checkpoints(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    D.save_train_arrays(str(data / "chr1.npz"),
                        _pileup_arrays(np.random.default_rng(4), 200))
    (tmp_path / "small.yaml").write_text(SMALL_YAML)
    out = tmp_path / "out"
    assert cli.main(["train-pileup", "--data", str(data), "-o", str(out),
                     "--device", "cpu", "--epochs", "2", "--batch-size",
                     "40", "--val-fraction", "0.2", "--config",
                     str(tmp_path / "small.yaml")]) == 0
    run = out / "pileup_train"
    recs = _read_records(run / "scalars.jsonl")
    assert [(r["epoch"], r["split"]) for r in recs] == [
        (1, "train"), (1, "val"), (2, "train"), (2, "val")]
    assert all(np.isfinite(r["loss"]) for r in recs)
    for name in ("best.ckpt", "last.ckpt", "epoch_2.ckpt"):
        assert (run / name).exists()
    # the JAX package reads the port's checkpoint into its own tree
    jparams, blob = jax_load_checkpoint(str(run / "best.ckpt"))
    ref = jax_init_pileup(jax.random.key(0), JPileCfg(**PILE))
    assert jax.tree.structure(jparams) == jax.tree.structure(ref)
    assert [a.shape for a in jax.tree.leaves(jparams)] == \
        [a.shape for a in jax.tree.leaves(ref)]
    assert blob["step"] in (4, 8) and blob["epoch"] in (1, 2)
    # and the port's loader gives a model that predicts
    params, _ = load_checkpoint(str(run / "last.ckpt"))
    model = PileupModel(PileupModelConfig(**PILE), params)
    with torch.inference_mode():
        gt, zy, _, _ = model(torch.randn(3, 33, 18), all_heads=False)
    assert torch.isfinite(gt).all() and gt.shape == (3, 21)


def _haplotype_world(tmp_path, rng):
    """A 4 kbp contig, one haplotype shard of 240 sites (depth 6), a truth
    VCF with SNPs at a third of them, a BED over the whole contig."""
    length, n = 4000, 240
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, length)]
    write_fasta(str(tmp_path / "ref.fa"), {"chr1": seq.tobytes().decode()})
    pos = np.sort(rng.choice(np.arange(100, length - 100), n,
                             replace=False)).astype(np.int64)
    b = _hap_batch(rng, n, 6)
    shard = bins.HaplotypeShard(
        contig="chr1", candidate_positions=pos,
        group_positions=pos[:, None] + np.arange(-5, 6)[None, :] * 3,
        pileup={k: b["p_" + k] for k in ("seq", "baseq", "mapq", "hap")},
        haplotype={k: b["h_" + k] for k in ("seq", "baseq", "mapq", "hap")})
    for view in (shard.pileup, shard.haplotype):
        view["sequences"] = view.pop("seq")
    (tmp_path / "shards").mkdir()
    bins.save_haplotype_shard(str(tmp_path / "shards" / "chr1_d8x8.npz"),
                              shard)
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS"]
    for p in pos[::3]:
        ref_b = chr(seq[p - 1])
        alt = "ACGT"[("ACGT".index(ref_b) + 1) % 4]
        gt = "0|1" if p % 2 else "1|1"
        lines.append(f"chr1\t{p}\t.\t{ref_b}\t{alt}\t50\tPASS\t.\tGT\t{gt}")
    (tmp_path / "truth.vcf").write_text("\n".join(lines) + "\n")
    (tmp_path / "conf.bed").write_text(f"chr1\t0\t{length}\n")


def test_train_haplotype_cli_on_cpu(tmp_path):
    _haplotype_world(tmp_path, np.random.default_rng(6))
    (tmp_path / "small.yaml").write_text(SMALL_YAML)
    out = tmp_path / "out"
    assert cli.main([
        "train-haplotype", "--shards", str(tmp_path / "shards"), "--ref",
        str(tmp_path / "ref.fa"), "--truth-vcf", str(tmp_path / "truth.vcf"),
        "--bed", str(tmp_path / "conf.bed"), "-o", str(out), "--device",
        "cpu", "--epochs", "2", "--batch-size", "32", "--val-fraction",
        "0.2", "--config", str(tmp_path / "small.yaml")]) == 0
    run = out / "haplotype_train"
    recs = _read_records(run / "scalars.jsonl")
    assert [(r["epoch"], r["split"]) for r in recs] == [
        (1, "train"), (1, "val"), (2, "train"), (2, "val")]
    assert recs[-1]["step"] > 2
    for name in ("best.ckpt", "last.ckpt"):
        assert (run / name).exists()
    jparams, _ = jax_load_checkpoint(str(run / "best.ckpt"))
    ref = jax_init_haplotype(jax.random.key(0), JHapCfg(**HAP))
    assert jax.tree.structure(jparams) == jax.tree.structure(ref)


def test_resume_from_last_ckpt_continues_like_an_uninterrupted_run(tmp_path):
    """Two epochs in one run against one epoch, then a run resumed from its
    last.ckpt (params, Lookahead slow params, Adam state, step counts and
    the dropout generator's state) for the second epoch."""
    arrays = _pileup_arrays(np.random.default_rng(7), 120)
    items = list(D.batch_iterator(arrays, 30, np.random.default_rng(8),
                                  epochs=2, mark_epochs=True))
    cut = items.index(D.EPOCH_END) + 1
    mcfg = PileupModelConfig(**dict(PILE, dropout=0.3))
    tcfg = TrainConfig(optim=OptimConfig(**OPT))
    kw = dict(steps_per_epoch=None, device="cpu", lr_steps_per_epoch=2)
    whole = train_pileup(iter(items), mcfg, tcfg, out_dir=str(tmp_path / "a"),
                         **kw)
    train_pileup(iter(items[:cut]), mcfg, tcfg, out_dir=str(tmp_path / "b"),
                 **kw)
    resumed = train_pileup(iter(items[cut:]), mcfg, tcfg,
                           out_dir=str(tmp_path / "c"),
                           resume_from=str(tmp_path / "b" / "last.ckpt"), **kw)
    assert (resumed.step, resumed.epoch) == (whole.step, whole.epoch) == (8, 2)
    _assert_trees_close(resumed.model.tree(), whole.model.tree(), 0, 0)
    _assert_trees_close(resumed.slow, whole.slow, 0, 0)


@pytest.mark.parametrize("opt_type,state_keys", [
    ("ranger21", {"count", "steps_since_sync", "mu", "nu"}),
    ("sgd", {"count", "steps_since_sync", "trace"})])
def test_resume_with_another_optimizer_continues_like_an_uninterrupted_run(
        tmp_path, opt_type, state_keys):
    """As above with Ranger21 (Lookahead, Adam moments, lr21's warmup
    across the cut) and SGD (momentum trace, no Lookahead): last.ckpt
    holds whatever state the optimizer keeps, and the resumed run's
    second epoch is the uninterrupted run's."""
    import pickle

    arrays = _pileup_arrays(np.random.default_rng(9), 120)
    items = list(D.batch_iterator(arrays, 30, np.random.default_rng(10),
                                  epochs=2, mark_epochs=True))
    cut = items.index(D.EPOCH_END) + 1
    mcfg = PileupModelConfig(**dict(PILE, dropout=0.3))
    tcfg = TrainConfig(optim=OptimConfig(**dict(OPT, type=opt_type,
                                                ranger21_epochs=2)))
    kw = dict(steps_per_epoch=None, device="cpu", lr_steps_per_epoch=4)
    whole = train_pileup(iter(items), mcfg, tcfg, out_dir=str(tmp_path / "a"),
                         **kw)
    train_pileup(iter(items[:cut]), mcfg, tcfg, out_dir=str(tmp_path / "b"),
                 **kw)
    with open(tmp_path / "b" / "last.ckpt", "rb") as f:
        assert set(pickle.load(f)["opt_state"]) == state_keys
    resumed = train_pileup(iter(items[cut:]), mcfg, tcfg,
                           out_dir=str(tmp_path / "c"),
                           resume_from=str(tmp_path / "b" / "last.ckpt"), **kw)
    assert (resumed.step, resumed.epoch) == (whole.step, whole.epoch) == (8, 2)
    _assert_trees_close(resumed.model.tree(), whole.model.tree(), 0, 0)
    assert (resumed.slow is None) == (opt_type == "sgd")
    if resumed.slow is not None:
        _assert_trees_close(resumed.slow, whole.slow, 0, 0)
    for k in state_keys - {"count", "steps_since_sync"}:
        for a, b in zip(resumed.opt_state[k], whole.opt_state[k]):
            assert torch.equal(a, b), k
