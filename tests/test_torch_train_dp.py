"""Data-parallel training of the port on the CPU: two ranks joined by gloo
over localhost (NSP_COORDINATOR / NSP_NUM_PROCS / NSP_PROC_ID, the
environment parallel/launch.initialize_distributed reads; each rank joins
the group before it calls the trainer, as the CLI does), each training
on its half of every global batch, against one process on the joined
batches and against the JAX package's train step on them.

Three optimizer steps of each trainer (train_pileup, train_haplotype;
dropout off, so that no mask tells the runs apart), then an epoch's end:
the ranks' final parameters are the same bits, and within 1e-5 of the
one-process port's and of the JAX step's; the one-process run's
scalars.jsonl is rank 0's within 1e-6 (the loss is rounded to six
places); rank 1 writes nothing; a batch the ranks cannot split raises
before any step.

All three runs are f32, but they sum in other orders: the ranks sum half
batches where one process sums the whole, and gloo adds the halves'
gradients. Adam scales each entry's update to about lr whatever the
gradient's size, so an entry whose gradient is a near-total cancellation
carries that reordering into a full-size update (test_torch_train_step.py
says the same of 13 steps). The bound is a tenth of one update, so lr is
1e-4 here: at test_torch_train_step's 1e-3 a few haplotype entries in
ten thousand differ from the JAX step's by 3e-5."""
import json
import os
import pickle
import socket
import subprocess
import sys

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
    make_haplotype_train_step as jax_haplotype_step
from nanosnp_tpu.train.train_pileup import \
    make_pileup_train_step as jax_pileup_step
from nanosnp_tpu_torch.config import (HaplotypeModelConfig, OptimConfig,
                                      PileupModelConfig, TrainConfig)
from nanosnp_tpu_torch.models.convert import (flatten_tree, params_from_jax,
                                              params_to_numpy)
from nanosnp_tpu_torch.models.haplotype_model import HaplotypeModel
from nanosnp_tpu_torch.models.pileup_model import PileupModel
from nanosnp_tpu_torch.train import data as D
from nanosnp_tpu_torch.train.train_haplotype import (
    make_haplotype_train_step, train_haplotype)
from nanosnp_tpu_torch.train.train_pileup import (make_pileup_train_step,
                                                  train_pileup)

from test_torch_train_step import HAP, OPT, PILE, STEPS_PER_EPOCH, \
    _hap_batch, _np_tree, _run_both

OPT_DP = dict(OPT, lr=1e-4)
TOL = 1e-5             # final parameters, any pair of the three runs
SCALAR_TOL = 1e-6      # scalars.jsonl
N_STEPS = 3
TIMEOUT = 120          # seconds a rank may take
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one rank: the trainer through its entry point on the batches of
# inputs.pkl, then its final parameters into result{rank}.pkl
WORKER = """
import os, pickle, sys
from nanosnp_tpu_torch.models.convert import params_to_numpy
from nanosnp_tpu_torch.parallel.launch import initialize_distributed, shutdown
from nanosnp_tpu_torch.train import data as D
from nanosnp_tpu_torch.train.train_haplotype import train_haplotype
from nanosnp_tpu_torch.train.train_pileup import train_pileup

work, rank = sys.argv[1], os.environ["NSP_PROC_ID"]
with open(os.path.join(work, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
fn = train_pileup if inp["model"] == "pileup" else train_haplotype
initialize_distributed()
try:
    state = fn(iter(inp["batches"] + [D.EPOCH_END]), inp["mcfg"],
               inp["tcfg"], None, os.path.join(work, "rank" + rank),
               init_params=inp["params"], device="cpu", use_kernels=False,
               lr_steps_per_epoch=inp["lr_steps"])
finally:
    shutdown()
with open(os.path.join(work, "result" + rank + ".pkl"), "wb") as f:
    pickle.dump(params_to_numpy(state.model.tree()), f)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_ranks(work, model, mcfg, tcfg, params, batches):
    """Both ranks of a data-parallel run in `work` -> [(rc, stderr)]."""
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(dict(model=model, mcfg=mcfg, tcfg=tcfg,
                         params=params_to_numpy(params), batches=batches,
                         lr_steps=STEPS_PER_EPOCH), f)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("NSP_")}
        env.update(NSP_COORDINATOR=f"127.0.0.1:{port}", NSP_NUM_PROCS="2",
                   NSP_PROC_ID=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(work)], env=env, cwd=REPO,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    try:
        errs = [p.communicate(timeout=TIMEOUT)[1] for p in procs]
        return [(p.returncode, e) for p, e in zip(procs, errs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _pileup_case():
    rng = np.random.default_rng(31)
    jcfg = JPileCfg(**PILE)
    jparams = _np_tree(jax_init_pileup(jax.random.key(3), jcfg))
    batches = []
    for _ in range(N_STEPS):
        x = rng.integers(-15, 15, (24, 33, 18)).astype(np.float32)
        batches.append((x, rng.integers(0, 21, 24), rng.integers(0, 3, 24)))
    return dict(
        model="pileup", mcfg=PileupModelConfig(**PILE), jparams=jparams,
        batches=batches, train=train_pileup, model_cls=PileupModel,
        jax_step=lambda tx: jax_pileup_step(
            jcfg, JTrainCfg(optim=JOptCfg(**OPT_DP)), tx, use_pallas=False),
        port_step=lambda cfg, tcfg: lambda tx: make_pileup_train_step(
            cfg, tcfg, tx, use_kernels=False),
        pairs=lambda: [(tuple(jax.numpy.asarray(a) for a in b),
                        tuple(torch.from_numpy(a) for a in b))
                       for b in batches])


def _haplotype_case():
    rng = np.random.default_rng(32)
    jcfg = JHapCfg(**HAP)
    jparams = _np_tree(jax_init_haplotype(jax.random.key(4), jcfg))
    batches = [_hap_batch(rng, 12, 6) for _ in range(N_STEPS)]
    return dict(
        model="haplotype", mcfg=HaplotypeModelConfig(**HAP), jparams=jparams,
        batches=batches, train=train_haplotype, model_cls=HaplotypeModel,
        jax_step=lambda tx: jax_haplotype_step(
            jcfg, JTrainCfg(optim=JOptCfg(**OPT_DP)), tx, use_pallas=False),
        port_step=lambda cfg, tcfg: lambda tx: make_haplotype_train_step(
            cfg, tcfg, tx, use_kernels=False),
        pairs=lambda: [(({k: jax.numpy.asarray(v) for k, v in b.items()},),
                        ({k: torch.from_numpy(v) for k, v in b.items()},))
                       for b in batches])


CASES = {"pileup": _pileup_case, "haplotype": _haplotype_case}


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _close(got, want, tol, what):
    got, want = dict(flatten_tree(got)), dict(flatten_tree(want))
    assert set(got) == set(want)
    for path in want:
        g, w = (np.asarray(v.detach().numpy() if hasattr(v, "detach")
                           else v) for v in (got[path], want[path]))
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol,
                                   err_msg=f"{what} {path}")


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request, tmp_path_factory):
    """The case's three runs: two ranks, one process, the JAX step."""
    case = CASES[request.param]()
    work = tmp_path_factory.mktemp(f"dp_{request.param}")
    tcfg = TrainConfig(optim=OptimConfig(**OPT_DP), batch_size=len(
        case["batches"][0][0] if case["model"] == "pileup"
        else case["batches"][0]["gt"]))
    params = params_from_jax(case["jparams"])
    res = _two_ranks(work, case["model"], case["mcfg"], tcfg, params,
                     case["batches"])
    for rc, err in res:
        assert rc == 0, err[-3000:]
    ranks = []
    for r in range(2):
        with open(work / f"result{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    one = case["train"](iter(case["batches"] + [D.EPOCH_END]), case["mcfg"],
                        tcfg, None, str(work / "one"), init_params=params,
                        device="cpu", use_kernels=False,
                        lr_steps_per_epoch=STEPS_PER_EPOCH)
    model = case["model_cls"](case["mcfg"], params_from_jax(case["jparams"]))
    _, _, jax_params, _ = _run_both(
        case["jax_step"], case["jparams"], model,
        case["port_step"](case["mcfg"], tcfg), case["pairs"](), OPT_DP)
    return dict(case=case, work=work, tcfg=tcfg, ranks=ranks, one=one,
                jax=jax_params["fast"])


def test_ranks_end_with_the_same_bits(runs):
    a, b = runs["ranks"]
    for (path, x), (_, y) in zip(flatten_tree(a), flatten_tree(b)):
        assert np.array_equal(x, y), path


def test_two_ranks_equal_one_process_on_the_joined_batches(runs):
    assert runs["one"].step == N_STEPS
    _close(runs["ranks"][0], runs["one"].model.tree(), TOL, "one process")


def test_two_ranks_equal_the_jax_step_on_the_joined_batches(runs):
    _close(runs["ranks"][0], runs["jax"], TOL, "JAX")


def test_scalars_are_the_one_process_runs(runs):
    got = _records(runs["work"] / "rank0" / "scalars.jsonl")
    want = _records(runs["work"] / "one" / "scalars.jsonl")
    assert [(r["epoch"], r["split"], r["step"]) for r in got] == \
        [(r["epoch"], r["split"], r["step"]) for r in want] == \
        [(1, "train", N_STEPS)]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k not in ("time", "split"):
                assert abs(g[k] - w[k]) <= SCALAR_TOL + 1e-12, k


def test_only_rank_zero_writes(runs):
    assert sorted(os.listdir(runs["work"] / "rank0")) == \
        sorted(os.listdir(runs["work"] / "one")) == \
        ["epoch_1.ckpt", "last.ckpt", "scalars.jsonl"]
    assert not (runs["work"] / "rank1").exists()


def test_a_batch_the_ranks_cannot_split_raises_before_any_step(runs):
    case = runs["case"]
    work = runs["work"] / "odd"
    work.mkdir()
    n = runs["tcfg"].batch_size - 1
    odd = [jax.tree.map(lambda a: a[:n], b) for b in case["batches"]]
    tcfg = TrainConfig(optim=OptimConfig(**OPT_DP), batch_size=n)
    res = _two_ranks(work, case["model"], case["mcfg"], tcfg,
                     params_from_jax(case["jparams"]), odd)
    for rc, err in res:
        assert rc != 0 and "not divisible by 2" in err, err[-2000:]
    assert sorted(os.listdir(work)) == ["inputs.pkl"]
