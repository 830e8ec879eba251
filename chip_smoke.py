#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nanosnp_tpu_torch) on one card.

    python3 chip_smoke.py

  setup    prints the card (nvidia-smi name and power limit), torch, CUDA
           and nvcc versions; builds the CUDA kernels from ops/csrc
           (nvcc) and the host BAM/mpileup engine from io/native (g++).
  phase 1  the BiLSTM layer kernels at every layer call of the main path:
           each shape's wrapper (`bilstm_stream` / `bilstm_center`) against
           its plain PyTorch version at N=3001 and, at H=256, at N=1, 65
           and 2558, at H=64 at N=8191 (the tile of N=8192); the cluster
           path's in-projection and recurrence each against its own plain
           version; then at N=8192 the wrapper, the
           kernels alone (weights packed once), the plain version and cuDNN
           nn.LSTM (a yardstick only: the port never calls it); a
           `{"layers": [...]}` line.
  phase 1b holds the training recurrence kernels of each shape's plan
           (`plan_train`: w_hh in shared memory and dW summed in the sweep
           at H=64; w_hh sliced over a 4-CTA cluster and `lstm_dw_reduce`
           at H=256), and the packed kernels at H=128 (the path of every
           other width), against their plain versions at the trainers'
           shapes, at N off the tiles and at N = 1 and 17, and the sweep's
           dW and `lstm_dw_reduce` (tensor cores, `plan_dw`) against
           `lstm_dw_reduce_plain`; dxp and dW bit for bit the same on a
           second run; prints the cluster kernels' resident clusters;
           then times them alone and through their wrappers beside cuDNN
           nn.LSTM in training mode and, for dW, one f32 torch.bmm
           (yardsticks only).
  phase 1c holds the inference recurrence (f32 and bf16 xp; `plan_infer`:
           the cluster forward at the CatModel's H=256 and the bf16 scan
           route's (33, H=256), the smem forward at the pileup shape's
           H=64), the f32 inference recurrence of the f32 scan route
           (`plan_infer_f32`, at (33, 64), (33, 256) and (11, 256); max
           |d| 1e-5 on hs, then timed alone and through its wrapper beside
           its FFMA bound and cuDNN nn.LSTM in f32, TF32 off), the center
           + head kernel (24 and
           96 head rows) and the two-layer kernel (both on 2-CTA clusters)
           against their plain versions at N = 1, 65, 3001 and 8191 (the
           tile of N=8192), each twice for the same bits; prints the smem
           forward's blocks resident an SM; times them alone (weights
           packed once beforehand; the packed kernel beside the cluster
           and the smem one) and through their
           wrappers beside cuDNN nn.LSTM in inference mode (plus three
           torch.matmul for the head; yardsticks only) and the per-layer
           kernels of the fused kernels' routes, weights packed once,
           alone and through their wrappers; prints the clusters
           resident; and shows by the launch counts that
           `lstm_recurrence` takes the inference kernel without gradients
           and the training kernels with them.
  phase 1d the knock-out probe of the pileup model's first layer
           (ops/probe.py, knock-outs of the layer code `bilstm_stream`
           runs): `full` against `bilstm_stream` bit for bit at N = 1, 65,
           3001, 8191 and 8192; each of the four modes against
           `probe_plain` at N=8192; the modes timed alone and through the
           wrapper, `full` and `bilstm_stream` alone in turns; then the
           probe's entry point (`python -m nanosnp_tpu_torch.ops.probe`),
           and the four times and three shares on a line of their own.
  phase 2  drives the serving slice through its entry points at full
           model width:
           s2-predict (CLI) on a 100k-candidate columnar shard with seeded
           full-width pileup weights, s5 stage_haplotype_predict on two
           depth buckets with the shipped v6b haplotype weights, s6-merge
           (CLI). Kernel launch counts are zeroed before each stage and
           read after it. The outputs are checked for shape and finite
           values, and the models on the card against their plain versions
           on the CPU on a small input.
  phase 2b s2-predict (CLI) again on a 24k-candidate shard under the default
           route, NSP_FUSE_HEAD=1, NSP_FUSE_LAYERS=1 and a one-layer
           encoder configuration; each fused route's pileup.vcf is held
           against the default route's.
  phase 2d the scan route (`inference.use_pallas: false`): s2-predict
           (CLI) on phase 2b's 24k-candidate shard and the s5 stage on one
           depth bucket of 2,048 sites (v6b weights), each with use_bf16
           false and true, on the card and on the CPU. f32: the card's rows
           and genotypes the CPU's, QUAL within 0.01; bf16: at least 99% of
           the genotypes agree; the byte-identical share printed. Each card
           run launches `lstm_recurrence_infer_f32` (f32) or
           `lstm_recurrence_infer` (bf16) and no other kernel; s5 under the
           default route on the same bucket launches `bilstm_inproj` and
           `bilstm_cluster` and no other.
  phase 2c the legacy CatModel at full width: two tags of 16k-group legacy
           bins -> legacy-predict and legacy-eval (CLI, batch 8192) on the
           card, its probabilities against the kernel path's plain version
           on the CPU on a small input, then two epochs of legacy-train
           (batch 64) through the CatModel trainer, on the training
           kernels, its second epoch's full group by graph replay.
  phase 3  trains both models through the CLI at full width: train-pileup
           on 40k labeled windows (batch 2000) and train-haplotype on 10k
           sites in depth buckets 64 and 96 with a truth VCF (batch 512),
           2 epochs each with validation, in groups of the default
           steps_per_call 8 (train/group.py): each batch shape's full
           groups must replay a CUDA graph after its first, and each
           training kernel be counted once a step a layer, replays
           included (train-pileup launches no `lstm_dw_reduce`). Launch
           counts are zeroed before each and read after; each graph's
           capture seconds and pool bytes are printed; losses must be
           finite, checkpoints written, and the trained pileup
           checkpoint must load and predict.
           `evaluate-haplotype` (CLI) on the training world's shards with
           the v6b weights and with the trained last.ckpt (f32 on the scan
           route, as the JAX CLI: `lstm_recurrence_infer_f32` launched and
           no other kernel), its first shard's argmax decisions on the card
           against the CPU's (at least 99.9% agree).
           Two epochs each of train-pileup with `optim.type: ranger` and
           train-haplotype with `ranger21` (the same checks). Then one
           full-width pileup step's gradients on the card are held
           against the plain versions on the CPU; for both trainers, with
           Lookahead-Adam and their Ranger flavor, dropout 0 and on, three
           groups of 8 steps (eager, captured and replayed, replayed)
           against the same 24 single eager steps from the same seeded
           state: parameters, slow parameters and optimizer state the
           same bits (or within REPLAY_TOL, printed), the dropout
           generators' states equal; last, steady-state steps of both
           trainers and flavors as single steps and as groups of 8 are
           timed in turns and profiled (torch.profiler; a replay's
           training kernels counted by name in the trace against the
           launch counts).
  phase 4  `call` end to end from a BAM at full model width. Writes a
           diploid world (a training and a calling contig, 30x reads in one
           untagged BAM, truth VCF, BED); then, all through the CLI on the
           card: make-train-data on the training contig, train-pileup for
           a few epochs, that model written as a reference-layout .chkpt,
           `call --phaser native` on the calling contig with the shipped
           haplotype weights (s1 BAM pileup, s2, s3 native phaser, s4 read
           matrices, s5, s6). Every stage must write its marker, s3 phase
           sites, s5 see sites, `bilstm_stream`, `bilstm_center`,
           `bilstm_inproj` and `bilstm_cluster` be launched, merge.vcf
           have rows, and a second `call` on the same output run no stage.
           Prints per-stage seconds and rates, het-SNP recall and precision
           against the world's truth (`eval.f1.evaluate_calls`), and
           `compare-failed` on the hets the call missed (it must keep each
           one inside the BED). `evaluate-pileup` with the fitted model on the training
           contig's arrays, every row and `--for-evaluate` (f32 on the scan
           route: `lstm_recurrence_infer_f32` launched and no other kernel;
           the variant rows' argmax decisions on the card against the
           CPU's, at least 99.9% agree). `call` once more under
           `inference: {use_pallas: false, use_bf16: false}`: every stage
           marker written, `lstm_recurrence_infer_f32` the only kernel
           launched, its stage seconds and het-SNP recall and precision
           beside the default route's. Last, the card's busy share of one
           more `call` under torch.profiler.
  phase 4b on phase 4's world and fitted model: `call --contigs chrT chrC`
           in one process, then as two hosts (two child processes on
           cuda:0, gloo at 127.0.0.1 on a free port, each printing its
           launch counts); each host must work its LPT contig and the
           merged pileup.vcf, haplotype.csv and merge.vcf rows must be the
           one-process rows byte for byte. Then train-pileup (batch 2000,
           2 epochs on phase 4's training arrays) and train-haplotype
           (batch 512, 1 epoch), dropout 0, in one process and over two
           data-parallel ranks (children with NSP_* set), in groups of 2
           steps: how far each run moved the parameters from their
           seeded start, the two held to each other within MOVE_TOL (L2
           over all parameters), and a control whose ranks skip the
           gradient average held outside it; the training kernels
           launched in each rank, each rank's full groups run as eager
           steps (no graph holds gloo's average) and the one process's
           replayed. Prints both wall times and each host's
           stage split beside the card's line; two processes share one
           card, so no time is a claim.

`python3 chip_smoke.py --train-times TREE` times the training kernels
alone and through their wrappers and profiles both trainers' steps
(single steps, and groups of 8 by graph replay where TREE's package
groups steps), with the package of TREE; `--train-turns PARENT` does so
for PARENT and this tree in turns, parent, change, change, parent. `--fused-times TREE` and
`--fused-turns PARENT` do the same for the two fused kernels and the
per-layer kernels of their routes, and `--probe-times TREE` and
`--probe-turns PARENT` for the probe's four modes and `bilstm_stream`.

Prints a `{"kernels": [...]}` line, then as the last line
`{"ok": true, "device": {...}}`. Exits non-zero on any failure, when no
card is present, or when the package is missing.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
from dataclasses import replace
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke_work")
V6B = os.path.join(ROOT, "nanosnp_tpu", "models", "weights",
                   "ont_haplotype_synthetic.npz")

# H100 SXM published dense peaks (NVIDIA data sheet), at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

SEED = 20261016
N_CHECK = 3001          # not a multiple of either kernel tile (16 or 64)
N_TIME = 8192           # the main path's batch
N_WIDE = N_TIME - 1     # off the tiles, on the tile the H=64 plans take at
                        # N_TIME (bn 64 or 128: 128 from N = 4225)
N_RAGGED = (1, 65, 2558)  # more batch sizes off the tiles, at H=256
STREAM_TOL = 1e-2       # bf16 output: two bf16 ulps near 1
CENTER_TOL = 2e-3       # f32 output; the gap is f32 summation order
                        # carried through the bf16 rounding of h_{t-1}
PROB_TOL = 1e-2         # model probabilities, card vs CPU plain versions
INPROJ_TOL = 1e-4       # xp, over max(1, max|xp|): f32 sums of up to 512
                        # bf16 products in another order (K eps = 3e-5)
CONTIG_LEN = 3_000_000  # a few-Mbp contig at 30x ...
N_CAND = 100_000        # ... gives ~100k candidates: 13 batches of 8192
HAP_SITES = 8000        # haplotype sites in each of two depth buckets
PILEUP_TRAIN_ROWS = 40_000   # 18 steps of 2000 a epoch after the 10% split
HAP_TRAIN_SITES = 5000       # haplotype training sites per depth bucket:
                             # about ten batches of 512 a bucket an epoch,
                             # so each fills a group of 8 steps every epoch
DP_HAP_SITES = 2000          # the same for phase 4b's data-parallel runs
ROUTE_CAND = 24_000     # s2 candidates of the route comparison: 3 batches
# a fused route against the default route, row by row: the same call, and
# QUAL (a log-odds of a probability, rounded to 0.01) within 0.02; rows
# that differ (an argmax at a tie) may be at most one in a thousand
ROUTE_QUAL_TOL = 0.02
ROUTE_ROWS_OFF = 1e-3
LEGACY_GROUPS = 16_384  # legacy groups a tag: two predict batches of 8192
LEGACY_TRAIN_GROUPS = 1024   # of them, the part legacy-train sees
GRAD_N = 256            # batch of the card-vs-CPU gradient check
GROUP = 8               # the CLI's steps_per_call: steps a timed run, a
                        # profiled run and a replay-parity group take
TIME_RUNS = 3           # runs of GROUP steps timed in each turn
REPLAY_TOL = 1e-6       # graph replay against eager steps, relative, should
                        # a library GEMM not give the same bits under capture
AGREE_MIN = 0.999       # evaluate-*: share of argmax decisions, card vs CPU
                        # (both f32: the scan route, as the JAX CLI)
# gradients of one step, card vs CPU, over the largest entry of each leaf:
# both sides round h_{t-1}, dgates and dW to bf16, so a reordered f32 sum
# can flip a rounding (2^-8 relative) and carry it through the layers
GRAD_TOL = 2e-2
PROBE_TOL = 4e-3        # bf16 output: one bf16 ulp below 1 (2^-8). Kernel and
                        # plain version sum in another order, which can flip
                        # the rounding of an h; 2e-3 holds only where |h| < 0.5
PROBE_ITERS = 50        # launches a mode in the probe's timing loop
# batch sizes where the probe's full mode must equal bilstm_stream bit for
# bit: one row, one past a tile, off every tile, and the main path's tile
N_PROBE_EQUAL = (1, 65, N_CHECK, N_WIDE, N_TIME)
# the `call` world: an untagged BAM of all-match reads over two contigs
CALL_TRAIN_LEN = 300_000    # training contig, bp
CALL_LEN = 2_000_000        # calling contig: about 12 batches of 8192
                            # candidates in s2, a few thousand s5 sites
CALL_MIN_CANDIDATES = 2 * 8192   # s2 must see two full batches
CALL_COVERAGE = 30
CALL_READ_LEN = 2000
CALL_READ_ERR = 0.12        # substitutions a base: errors alone make most
                            # of the candidates, as in low-coverage ONT
CALL_TRAIN_EPOCHS = 4
CALL_TRAIN_BATCH = 500
CALL_TRAIN_LR = 3e-3
CALL_STAGES = ("s1_pileup_features", "s2_pileup_predict", "s3_phasing",
               "s4_haplotype_features", "s5_haplotype_predict", "s6_merge")


def log(*a):
    print(*a, flush=True)


class _Tee:
    """stdout as it is, and a copy of what was written."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _groups_record(text):
    """The last `{"train_groups": ...}` line a trainer printed, or None."""
    recs = [json.loads(line)["train_groups"] for line in text.splitlines()
            if line.startswith('{"train_groups"')]
    return recs[-1] if recs else None


def _cli_train(argv):
    """A train-* command through the port's CLI in this process -> the
    trainer's record of its group routes (steps a route, graphs)."""
    import contextlib

    from nanosnp_tpu_torch.runtime import cli

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        if cli.main(argv) != 0:
            raise AssertionError(f"{argv[0]} failed")
    rec = _groups_record("".join(tee.parts))
    if rec is None:
        raise AssertionError(f"{argv[0]}: no train_groups record")
    return rec


def _check_groups(name, rec, launches, layers, dw, graphs):
    """A training command's group routes and launch counts: `graphs`
    shapes captured and some steps replayed, and each training kernel's
    wrapper counted once a step a layer (`lstm_dw_reduce` only where
    `dw`), replays included."""
    steps = sum(rec["steps"].values())
    log(f"[{name}] steps by route {rec['steps']} at steps_per_call "
        f"{rec['steps_per_call']}; graphs: " + json.dumps([
            {k: g[k] for k in ("shapes", "capture_seconds", "pool_bytes")}
            for g in rec["graphs"]]))
    if len(rec["graphs"]) != graphs or rec["steps"]["graph"] <= 0:
        raise AssertionError(f"{name}: {len(rec['graphs'])} graphs, "
                             f"{rec['steps']['graph']} replayed steps")
    want = {"lstm_recurrence_train": steps * layers,
            "lstm_recurrence_bwd": steps * layers,
            "lstm_dw_reduce": steps * layers if dw else 0}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{name}: launches {got}, want {want}")


def cuda_time(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# (label, kernel, L, D, H): every layer call of the main path
SHAPES = [
    ("s2 L1", "bilstm_stream", 33, 18, 64),
    ("s2 L2", "bilstm_center", 33, 128, 64),
    ("s5 pileup L1", "bilstm_stream", 33, 105, 256),
    ("s5 pileup L2", "bilstm_stream", 33, 512, 256),
    ("s5 pileup L3", "bilstm_center", 33, 512, 256),
    ("s5 haplotype L1", "bilstm_stream", 11, 105, 256),
    ("s5 haplotype L2", "bilstm_stream", 11, 512, 256),
    ("s5 haplotype L3", "bilstm_center", 11, 512, 256),
    # a one-layer pileup encoder: the K-fusable last layer of the JAX package
    ("s2 one-layer L1", "bilstm_center", 33, 18, 64),
]
REPLACES = {
    "bilstm_stream": "nanosnp_tpu/ops/pallas_lstm.py:423 (_enc_stream_kernel)"
                     ", nanosnp_tpu/ops/pallas_lstm.py:733 "
                     "(_enc_stream_kfused_kernel)",
    "bilstm_center": "nanosnp_tpu/ops/pallas_lstm.py:501 (_enc_center_kernel)"
                     ", nanosnp_tpu/ops/pallas_lstm.py:770 "
                     "(_enc_center_kfused_kernel)",
    # at H=256 the two Pallas kernels' in-projection dot and their
    # recurrence run as two kernels of the cluster path
    "bilstm_inproj": "nanosnp_tpu/ops/pallas_lstm.py:469 (the in-projection"
                     " of _enc_stream_kernel :423), :535 (of "
                     "_enc_center_kernel :501)",
    "bilstm_cluster": "nanosnp_tpu/ops/pallas_lstm.py:473 (the recurrence "
                      "of _enc_stream_kernel :423), :539 (of "
                      "_enc_center_kernel :501)",
    "lstm_recurrence_train": "nanosnp_tpu/ops/pallas_lstm.py:178 "
                             "(_train_kernel)",
    "lstm_recurrence_bwd": "nanosnp_tpu/ops/pallas_lstm.py:235 (_bwd_kernel"
                           "; at H=64 its dW accumulation too)",
    "lstm_dw_reduce": "nanosnp_tpu/ops/pallas_lstm.py:291 (_bwd_kernel's dW "
                      "accumulation) and :417 (its sum over batch tiles), "
                      "at H=256",
    "lstm_recurrence_infer": "nanosnp_tpu/ops/pallas_lstm.py:64 (_kernel)",
    "lstm_recurrence_infer_f32": "XLA lax.scan route, nanosnp_tpu/models/"
                                 "bilstm.py:82-97 (no Pallas kernel)",
    "bilstm_center_head": "nanosnp_tpu/ops/pallas_lstm.py:556 "
                          "(_enc_center_head_kernel)",
    "bilstm2_center": "nanosnp_tpu/ops/pallas_lstm.py:842 "
                      "(_enc2_center_kernel)",
    "bilstm_probe": "scripts/kernel_probe.py:36 (_variant_kernel)",
}
SOURCES = {"bilstm_stream": "bilstm.cu", "bilstm_center": "bilstm.cu",
           "bilstm_inproj": "bilstm.cu", "bilstm_cluster": "bilstm.cu",
           "lstm_recurrence_train": "lstm_train.cu",
           "lstm_recurrence_bwd": "lstm_train.cu",
           "lstm_dw_reduce": "lstm_train.cu",
           "lstm_recurrence_infer": "lstm_train.cu",
           "lstm_recurrence_infer_f32": "lstm_train.cu",
           "bilstm_center_head": "bilstm_fused.cu",
           "bilstm2_center": "bilstm_fused.cu",
           "bilstm_probe": "bilstm_probe.cu"}
# (label, L, D of the cuDNN yardstick's first layer, H): the inference
# recurrence's calls: five a CatModel batch, the fused=False encoder, and
# the bf16 scan route's layers (the pileup model's H=64 at L=33 is the
# fused=False shape; the haplotype model's at L=33, H=256)
INFER_SHAPES = [
    ("CatModel", 11, 256, 256),
    ("pileup fused=False", 33, 18, 64),
    ("s5 pileup scan route", 33, 105, 256),
]
# the f32 inference recurrence's calls on the f32 scan route: the pileup
# model's layers and the haplotype model's two branches
F32_SHAPES = [
    ("s2 scan f32", 33, 18, 64),
    ("s5 pileup scan f32", 33, 105, 256),
    ("s5 haplotype scan f32", 11, 105, 256),
]
# f32 on both sides, nothing rounded: summation order only, through L steps
F32_KERNEL_TOL = 1e-5
HEAD_ROWS = (24, 96)    # gt + zy, and all four heads (rows padded to 8)
# batch sizes of the inference recurrence's and the fused kernels' checks:
# one row, one past a tile of 64, N_CHECK (off every tile) and N_WIDE
N_INFER_CHECK = (1, 65, N_CHECK, N_WIDE)

# H100 SXM f32 peak outside the tensor cores (NVIDIA data sheet): the floor
# of an f32 SIMT dW product (lstm_dw_reduce's design before the tensor
# cores), printed beside the dW rows' bound for comparison
PEAK_F32_FLOPS = 67e12
# (label, N, L, D, H): every recurrence call of a training step, at the
# trainers' batch sizes. The kernels see only H (xp is 4H wide); D is the
# first layer's input, for the cuDNN yardstick, which includes the
# in-projection.
TRAIN_SHAPES = [
    ("pileup", 2000, 33, 18, 64),
    ("haplotype pileup branch", 512, 33, 105, 256),
    ("haplotype haplotype branch", 512, 11, 105, 256),
]
# a width no model of the repo trains at, so that the packed kernels (the
# path of every H but 64 and 256) stay held against their plain versions
PACKED_SHAPE = ("packed path, H=128", 512, 11, 105, 128)
# f32 outputs, bf16 cast sites on both sides: the gap is summation order,
# which can flip the bf16 rounding of an h_{t-1} or a dgate, carried
# through the later steps; relative to the largest value
TRAIN_TOL = 2e-3
# dW: both sides round the f32 sum to bf16 once, so one bf16 ulp (2^-8)
# of the largest entry, plus margin for a flipped rounding
DW_TOL = 1e-2


def phase_kernels(dev):
    """Phase 1: the BiLSTM layer kernels at every layer call of the main
    path. Each shape through its wrapper against the plain version at
    N_CHECK and, at H=256, at the ragged N_RAGGED, at H=64 at N_WIDE (the
    fused plan's tile at N_TIME); the cluster path's two
    kernels each against its own plain version; then at N_TIME the wrapper
    (which packs the weights every call), the kernels alone (weights packed
    once, as a model does), the plain version and cuDNN nn.LSTM (a
    yardstick only). At H=256 the wrapper's row times its two kernels
    alone, summed, against the layer's bound; the two kernels' own rows
    are bound by their own I/O, which counts xp's f32 round trip through
    device memory that the layer's bound does not."""
    import torch

    from nanosnp_tpu_torch.ops import bilstm as K

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def inputs(n, seq_len, d_in, hidden, x_scale):
        k = 1.0 / math.sqrt(hidden)

        def u(*shape, scale=1.0):
            return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) \
                * scale

        return (u(n, seq_len, d_in, scale=x_scale).bfloat16(),
                u(2, d_in, 4 * hidden, scale=k).bfloat16(),
                u(2, hidden, 4 * hidden, scale=k).bfloat16(),
                u(2, 4 * hidden, scale=2 * k))

    def bound(cost):
        t_ops = cost[0] / PEAK_BF16_FLOPS * 1e3
        t_bytes = cost[1] / PEAK_BYTES * 1e3
        return dict(bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes")

    rows, layers = [], []
    for label, name, seq_len, d_in, hidden in SHAPES:
        center = name == "bilstm_center"
        kern = getattr(K, name)
        plain = getattr(K, name + "_plain")
        tol = CENTER_TOL if center else STREAM_TOL
        # first layers see counts / statistics, inner layers h in (-1, 1)
        x_scale = 8.0 if d_in in (18, 105) else 1.0
        errs = []
        for n in (N_CHECK,) + (N_RAGGED if hidden == 256 else (N_WIDE,)):
            args = inputs(n, seq_len, d_in, hidden, x_scale)
            got = kern(*args)
            torch.cuda.synchronize()
            errs.append((got.float() - plain(*args).float()).abs().max()
                        .item())
            log(f"[check] {name:14s} {label:16s} N={n} L={seq_len} D={d_in} "
                f"H={hidden}: max|d|={errs[-1]:.3e} (tol {tol})")
            if not errs[-1] <= tol:
                raise AssertionError(f"{name} {label} N={n}: max|d| "
                                     f"{errs[-1]} > {tol}")
        plan = K.plan_layer(N_TIME, seq_len, d_in, hidden, center)
        out_dtype = torch.float32 if center else torch.bfloat16
        if plan.path == "cluster":
            # each kernel of the path against its own plain version
            cplan = K.plan_layer(N_CHECK, seq_len, d_in, hidden, center)
            args = inputs(N_CHECK, seq_len, d_in, hidden, x_scale)
            xp = K.bilstm_inproj(*args, cplan)
            torch.cuda.synchronize()
            xp_want = K.bilstm_inproj_plain(args[0], args[1], args[3], cplan)
            err_in, rel_in = _errs(xp, xp_want)
            got = K.bilstm_cluster(xp_want, args[1], args[2], cplan,
                                   out_dtype)
            torch.cuda.synchronize()
            err_rec = (got.float() - K.bilstm_cluster_plain(
                xp_want, args[2], cplan, out_dtype).float()).abs().max().item()
            log(f"[check] bilstm_inproj  {label:16s} N={N_CHECK}: max|d| "
                f"over max(1, max|want|) {rel_in:.3e} (tol {INPROJ_TOL}); "
                f"bilstm_cluster max|d| {err_rec:.3e} (tol {tol})")
            if not (rel_in <= INPROJ_TOL and err_rec <= tol):
                raise AssertionError(f"{label}: in-projection {rel_in} or "
                                     f"recurrence {err_rec} off")

        args = inputs(N_TIME, seq_len, d_in, hidden, x_scale)
        packed = K.pack_weights(args[1], args[2])
        wrapper_ms = cuda_time(lambda: kern(*args), 5)
        ms = cuda_time(lambda: kern(*args, packed=packed), 10)
        plain_ms = cuda_time(lambda: plain(*args), 2)
        lstm = torch.nn.LSTM(d_in, hidden, batch_first=True,
                             bidirectional=True, device=dev,
                             dtype=torch.bfloat16)
        with torch.inference_mode():
            library_ms = cuda_time(lambda: lstm(args[0]), 5)
        layer = dict(
            shape=label, wrapper=name, path=plan.path, cluster=plan.cluster,
            bn=plan.bn, N=N_TIME, L=seq_len, D=d_in, H=hidden,
            max_abs_err=max(errs), wrapper_ms=wrapper_ms, ms=ms,
            plain_ms=plain_ms, library_ms=library_ms,
            **bound(K.layer_cost(N_TIME, seq_len, d_in, hidden,
                                 center=center)),
            traffic_bytes=K.plan_traffic(plan))
        if plan.path == "cluster":
            layer["clusters_resident"] = K.cluster_occupancy(plan)
            xp = K.bilstm_inproj(*args, plan, packed)
            if center:
                # the rows each direction runs, as the kernel projects them
                xs = torch.stack([
                    args[0][:, :plan.t0_count].reshape(-1, d_in),
                    args[0][:, plan.t1_lo:].reshape(-1, d_in)])

                def library():
                    return torch.baddbmm(args[3][:, None], xs, args[1],
                                         out_dtype=torch.float32)
            else:
                x2 = args[0].reshape(-1, d_in)
                w_cat = args[1].permute(1, 0, 2).reshape(d_in, 8 * hidden)
                b_cat = args[3].reshape(-1)

                def library():
                    return torch.addmm(b_cat, x2, w_cat,
                                       out_dtype=torch.float32)
            split_note = ("bound counts xp's f32 round trip through device "
                          "memory, which the layer's bound does not")
            rows.append(dict(
                name="bilstm_inproj", shape=label, L=seq_len, D=d_in,
                H=hidden, max_abs_err=err_in,
                ms=cuda_time(lambda: K.bilstm_inproj(*args, plan, packed),
                             10),
                plain_ms=cuda_time(lambda: K.bilstm_inproj_plain(
                    args[0], args[1], args[3], plan), 2),
                # the same function as one library call: bf16 operands,
                # f32 out plus bias, over the rows the kernel projects
                library_ms=cuda_time(library, 10),
                bound_note=split_note, **bound(K.inproj_cost(plan))))
            rows.append(dict(
                name="bilstm_cluster", shape=label, L=seq_len, D=d_in,
                H=hidden, max_abs_err=err_rec,
                ms=cuda_time(lambda: K.bilstm_cluster(
                    xp, args[1], args[2], plan, out_dtype, packed), 10),
                plain_ms=cuda_time(lambda: K.bilstm_cluster_plain(
                    xp, args[2], plan, out_dtype), 2),
                library_ms=None, bound_note=split_note,
                **bound(K.cluster_cost(plan))))
            layer["inproj_ms"] = rows[-2]["ms"]
            layer["cluster_ms"] = rows[-1]["ms"]
            layer["kernels_ms"] = rows[-2]["ms"] + rows[-1]["ms"]
        # the layer's row: the fused kernel, or at H=256 the two kernels
        # alone summed, against the layer's own bound
        rows.append(dict(name=name, shape=label, L=seq_len, D=d_in,
                         H=hidden, max_abs_err=max(errs),
                         ms=layer.get("kernels_ms", ms),
                         wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=layer["bound_ms"],
                         bound_by=layer["bound_by"]))
        layers.append(layer)
        log(f"[time]  {name:14s} {label:16s} N={N_TIME} ({plan.path}, C="
            f"{plan.cluster}, BN={plan.bn}): alone {ms:.3f} ms, wrapper "
            f"{wrapper_ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN "
            f"{library_ms:.3f} ms, bound {layer['bound_ms']:.4f} ms "
            f"({layer['bound_by']})"
            + (f"; in-projection {layer['inproj_ms']:.3f} ms + recurrence "
               f"{layer['cluster_ms']:.3f} ms, "
               f"{layer['clusters_resident']} clusters resident"
               if plan.path == "cluster" else ""))
        if plan.path == "cluster" and not rows[-1]["ms"] < library_ms:
            log(f"[time]  {label}: the kernels alone are not faster than "
                "cuDNN")
    log(json.dumps({"layers": layers}))
    return rows


def _errs(got, want):
    """(max |got - want|, that over max(1, max |want|))."""
    want = want.float()
    err = (got.float() - want).abs().max().item()
    return err, err / max(1.0, want.abs().max().item())


def phase_train_kernels(dev):
    """Phase 1b: the training recurrence kernels of each shape's plan
    (`plan_train`: smem at H=64, cluster at H=256, packed at H=128) and
    `lstm_dw_reduce` (tensor cores, `plan_dw`) against their plain
    versions at N off the tiles and at N = 1 and 17 (fewer rows than a
    tile), the sweep and dW twice for the same bits; then timed alone
    (`_train_alone`) and through the wrappers, beside cuDNN (and one f32
    `torch.bmm` for dW) at the trainers' shapes."""
    import torch

    from nanosnp_tpu_torch.ops import lstm_train as T
    from nanosnp_tpu_torch.ops.build import library

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def inputs(n, seq_len, hidden):
        k = 1.0 / math.sqrt(hidden)

        def u(*shape, scale=1.0):
            return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) \
                * scale

        return (u(n, seq_len, 2, 4 * hidden, scale=3.0),
                u(2, hidden, 4 * hidden, scale=k).bfloat16(),
                u(n, seq_len, 2, hidden))

    def bound(flop_bf16, nbytes):
        t_ops = flop_bf16 / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes \
            else "bytes"

    rows = []
    resident = {"forward": T.cluster_occupancy(False),
                "sweep": T.cluster_occupancy(True)}
    log(f"[check] cluster_occupancy (4-CTA clusters resident at once): "
        f"{json.dumps(resident)}")
    if min(resident.values()) < 1:
        raise AssertionError("no cluster of the training plan fits the card")
    for label, n, seq_len, d_in, hidden in TRAIN_SHAPES + [PACKED_SHAPE]:
        path = T.plan_train(n, seq_len, hidden).path
        errs = {}
        for n_check in (n + 1, 1, 17):
            xp, w, g = inputs(n_check, seq_len, hidden)
            hs, cs = T.lstm_recurrence_train(xp, w)
            dxp, dw = T.lstm_recurrence_bwd(xp, w, hs, cs, g)
            dxp_again, dw_again = T.lstm_recurrence_bwd(xp, w, hs, cs, g)
            dw_sep = T.lstm_dw_reduce(dxp, hs)
            dw_sep_again = T.lstm_dw_reduce(dxp, hs)
            torch.cuda.synchronize()
            if not (torch.equal(dw, dw_again) and torch.equal(dxp,
                                                               dxp_again)):
                # dxp: the cluster sweep's dh sum is in a fixed order too
                raise AssertionError(f"{label} N={n_check}: a second sweep "
                                     "gave other bits")
            if not torch.equal(dw_sep, dw_sep_again):
                raise AssertionError(f"{label} N={n_check}: a second "
                                     "lstm_dw_reduce gave other bits")
            hs_p, cs_p = T.lstm_recurrence_train_plain(xp, w)
            dxp_p, _ = T.lstm_recurrence_bwd_plain(xp, w, hs, cs, g,
                                                   with_dw=False)
            dw_want = T.lstm_dw_reduce_plain(dxp, hs)
            for name, (err, rel) in {
                    "lstm_recurrence_train": max(_errs(hs, hs_p),
                                                 _errs(cs, cs_p)),
                    "lstm_recurrence_bwd": _errs(dxp, dxp_p),
                    "lstm_recurrence_bwd dW": _errs(dw, dw_want),
                    "lstm_dw_reduce": _errs(dw_sep, dw_want)}.items():
                tol = TRAIN_TOL if name in ("lstm_recurrence_train",
                                            "lstm_recurrence_bwd") \
                    else DW_TOL
                log(f"[check] {name:22s} {label:26s} ({path}) N={n_check} "
                    f"L={seq_len} H={hidden}: max|d|={err:.3e}, over "
                    f"max(1, max|want|) {rel:.3e} (tol {tol})")
                if not rel <= tol:
                    raise AssertionError(f"{name} {label} N={n_check}: "
                                         f"{rel} > {tol}")
                errs[name] = max(errs.get(name, 0.0), err)

        xp, w, g = inputs(n, seq_len, hidden)
        hs, cs = T.lstm_recurrence_train(xp, w)
        dxp, _ = T.lstm_recurrence_bwd(xp, w, hs, cs, g, with_dw=False)
        _, alone = _train_alone(T, library("lstm_train"), xp, w, hs, cs, g,
                                dxp)
        # cuDNN yardstick (never called by the port): bf16 nn.LSTM in
        # training mode, in-projection included; its backward alone is
        # timed by replaying autograd over one retained graph
        lstm = torch.nn.LSTM(d_in, hidden, batch_first=True,
                             bidirectional=True, device=dev,
                             dtype=torch.bfloat16).train()
        x = torch.randn(n, seq_len, d_in, device=dev, generator=gen,
                        dtype=torch.bfloat16, requires_grad=True)
        lib_fwd = cuda_time(lambda: lstm(x), 10)
        out, _ = lstm(x)
        g_lib = torch.randn_like(out)
        lib_bwd = cuda_time(lambda: torch.autograd.grad(
            out, [x, *lstm.parameters()], g_lib, retain_graph=True), 10)
        # the dW product as one batched library matmul, operands laid out
        # beforehand: [2, H, M] x [2, M, 4H], M = N (L-1)
        a_lib = torch.stack([hs[:, :-1, 0].reshape(-1, hidden).T,
                             hs[:, 1:, 1].reshape(-1, hidden).T])
        b_lib = torch.stack([dxp[:, 1:, 0].reshape(-1, 4 * hidden),
                             dxp[:, :-1, 1].reshape(-1, 4 * hidden)])
        flop_s, bytes_s = T.bwd_cost(n, seq_len, hidden)
        flop_w, bytes_w = T.dw_cost(n, seq_len, hidden)
        b_f, by_f = bound(*T.train_cost(n, seq_len, hidden))
        b_s, by_s = bound(flop_s, bytes_s)
        b_w, by_w = bound(flop_w, bytes_w)
        # sweep and dW as one function: the sweep's bytes and dW written
        b_sw, _ = bound(flop_s + flop_w,
                        bytes_s + 2 * hidden * 4 * hidden * 2)
        timed = [
            ("lstm_recurrence_train", alone["fwd"],
             lambda: T.lstm_recurrence_train(xp, w),
             lambda: T.lstm_recurrence_train_plain(xp, w), lib_fwd, b_f,
             by_f, {}),
            ("lstm_recurrence_bwd", alone["sweep"],
             lambda: T.lstm_recurrence_bwd(xp, w, hs, cs, g, with_dw=False),
             lambda: T.lstm_recurrence_bwd_plain(xp, w, hs, cs, g,
                                                 with_dw=False),
             lib_bwd, b_s, by_s, {
                 "ms_with_dw": cuda_time(alone["sweep+dW"], 20),
                 "wrapper_ms_with_dw": cuda_time(
                     lambda: T.lstm_recurrence_bwd(xp, w, hs, cs, g), 20),
                 "bound_ms_with_dw": b_sw,
                 "max_abs_err_dw": errs["lstm_recurrence_bwd dW"]}),
            ("lstm_dw_reduce", alone["dW"], lambda: T.lstm_dw_reduce(dxp, hs),
             lambda: T.lstm_dw_reduce_plain(dxp, hs),
             cuda_time(lambda: torch.bmm(a_lib, b_lib), 10), b_w, by_w, {
                 # the f32 SIMT design's floor: one f32 product at 67 TFLOP/s
                 "f32_simt_floor_ms": flop_w / 3 / PEAK_F32_FLOPS * 1e3,
                 "plan": T.plan_dw(n, seq_len, hidden)._asdict()}),
        ]
        for name, alone_fn, kern, plain, library_ms, b_ms, b_by, extra in \
                timed:
            wrapper_ms = cuda_time(kern, 20)
            if alone_fn() not in (0, (0, 0)):
                raise AssertionError(f"{name} {label}: a launch of the "
                                     "kernels alone failed")
            ms = cuda_time(alone_fn, 20)
            rows.append(dict(
                name=name, shape=label, path=path, N=n, L=seq_len, H=hidden,
                max_abs_err=errs[name], ms=ms, wrapper_ms=wrapper_ms,
                plain_ms=cuda_time(plain, 2), library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by, **extra,
                **({"clusters_resident": resident} if path == "cluster"
                   else {})))
            log(f"[time]  {name:21s} {label:26s} ({path}) N={n}: alone "
                f"{ms:.3f} ms, wrapper {wrapper_ms:.3f} ms, plain "
                f"{rows[-1]['plain_ms']:.3f} ms, library {library_ms:.3f} "
                f"ms, bound {b_ms:.4f} ms ({b_by})"
                + (f"; with dW alone {extra['ms_with_dw']:.3f} ms, wrapper "
                   f"{extra['wrapper_ms_with_dw']:.3f} ms, bound "
                   f"{extra['bound_ms_with_dw']:.4f} ms"
                   if "ms_with_dw" in extra else "")
                + (f"; f32 SIMT floor {extra['f32_simt_floor_ms']:.4f} ms"
                   if "f32_simt_floor_ms" in extra else ""))
    return rows


def _train_alone(T, lib, xp, w, hs, cs, g, dxp):
    """The training kernels of the package `T` was imported from, launched
    with their outputs (and, on the packed path, the packed w_hh) made
    beforehand: {"fwd", "sweep", "sweep+dW", "dW"} -> callable, and the
    path ("dW" is `lstm_dw_reduce`'s kernels, on every path). A tree
    without `plan_train` runs the packed kernels at every H (their C
    interface is the same there); one without `plan_dw` the SIMT dW
    kernel, its splits from `dw_splits`."""
    import torch

    n, seq_len, _, four_h = xp.shape
    hidden = four_h // 4
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    plan = T.plan_train(n, seq_len, hidden) if hasattr(T, "plan_train") \
        else None
    hs2, cs2, dxp2 = (torch.empty_like(t) for t in (hs, cs, dxp))
    dw = torch.empty(2, hidden, 4 * hidden, dtype=torch.bfloat16,
                     device=xp.device)
    if hasattr(T, "plan_dw"):
        dplan = T.plan_dw(n, seq_len, hidden)
        dw_part = torch.empty(dplan.splits, 2, hidden, 4 * hidden,
                              device=xp.device)

        def dw_only():
            return lib.nsp_lstm_dw(
                dxp.data_ptr(), hs.data_ptr(), dw_part.data_ptr(),
                dw.data_ptr(), n, seq_len, hidden, dplan.rows, dplan.splits,
                dplan.smem, dplan.grid[0], stream)
    else:
        splits = T.dw_splits(n, seq_len, hidden)
        dw_part = torch.empty(splits, 2, hidden, 4 * hidden,
                              device=xp.device)

        def dw_only():
            return lib.nsp_lstm_dw(
                dxp.data_ptr(), hs.data_ptr(), dw_part.data_ptr(),
                dw.data_ptr(), n, seq_len, hidden, splits, stream)

    if plan is not None and plan.path == "smem":
        part = torch.empty(plan.dw_tiles, 2, hidden, 4 * hidden,
                           device=xp.device)

        def bwd(with_dw):
            return lambda: lib.nsp_lstm_bwd_smem(
                xp.data_ptr(), w.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                g.data_ptr(), dxp2.data_ptr(), part.data_ptr(), dw.data_ptr(),
                with_dw, n, seq_len, hidden, plan.bn, plan.bwd_smem,
                plan.grid[0], stream)

        return "smem", {
            "fwd": lambda: lib.nsp_lstm_fwd_smem(
                xp.data_ptr(), w.data_ptr(), hs2.data_ptr(), cs2.data_ptr(),
                n, seq_len, hidden, plan.bn, plan.fwd_smem, plan.grid[0],
                stream),
            "sweep": bwd(0), "sweep+dW": bwd(1), "dW": dw_only}
    if plan is not None and plan.path == "cluster":
        def sweep():
            return lib.nsp_lstm_bwd_cluster(
                xp.data_ptr(), w.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                g.data_ptr(), dxp2.data_ptr(), n, seq_len, hidden,
                plan.cluster, plan.bn, plan.bwd_smem, plan.grid[0], stream)

        return "cluster", {
            "fwd": lambda: lib.nsp_lstm_fwd_cluster(
                xp.data_ptr(), w.data_ptr(), hs2.data_ptr(), cs2.data_ptr(),
                n, seq_len, hidden, plan.cluster, plan.bn, plan.fwd_smem,
                plan.grid[0], stream),
            "sweep": sweep, "sweep+dW": lambda: (sweep(), dw_only()),
            "dW": dw_only}
    wpk_t = T.pack_a_fragments(w.transpose(1, 2))
    wpk_h = T.pack_a_fragments(w)

    def sweep():
        return lib.nsp_lstm_bwd(
            xp.data_ptr(), wpk_t.data_ptr(), wpk_h.data_ptr(), hs.data_ptr(),
            cs.data_ptr(), g.data_ptr(), dxp2.data_ptr(), n, seq_len, hidden,
            stream)

    return "packed", {
        "fwd": lambda: lib.nsp_lstm_fwd(
            xp.data_ptr(), wpk_t.data_ptr(), hs2.data_ptr(), cs2.data_ptr(),
            n, seq_len, hidden, stream),
        "sweep": sweep, "sweep+dW": lambda: (sweep(), dw_only()),
        "dW": dw_only}


def train_kernel_times(dev):
    """The training recurrences at TRAIN_SHAPES, each alone (outputs and
    packed weights made beforehand, `_train_alone`) and through its
    wrapper, in the package on sys.path; then train-pileup's and
    train-haplotype's steady-state steps (`profile_train_steps`). One
    process a tree: `python3 chip_smoke.py --train-times TREE`."""
    import numpy as np
    import torch

    from nanosnp_tpu_torch.ops import build
    from nanosnp_tpu_torch.ops import lstm_train as T

    build.build_all()
    lib = build.library("lstm_train")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    out = {"kernels": []}
    for label, n, seq_len, _, hidden in TRAIN_SHAPES:
        k = 1.0 / math.sqrt(hidden)
        xp = (torch.rand(n, seq_len, 2, 4 * hidden, generator=gen,
                         device=dev) * 2 - 1) * 3.0
        w = ((torch.rand(2, hidden, 4 * hidden, generator=gen, device=dev)
              * 2 - 1) * k).bfloat16()
        g = torch.rand(n, seq_len, 2, hidden, generator=gen, device=dev)
        hs, cs = T.lstm_recurrence_train(xp, w)
        dxp, _ = T.lstm_recurrence_bwd(xp, w, hs, cs, g, with_dw=False)
        path, alone = _train_alone(T, lib, xp, w, hs, cs, g, dxp)
        wrapped = {
            "fwd": lambda: T.lstm_recurrence_train(xp, w),
            "sweep": lambda: T.lstm_recurrence_bwd(xp, w, hs, cs, g,
                                                   with_dw=False),
            "sweep+dW": lambda: T.lstm_recurrence_bwd(xp, w, hs, cs, g),
            "dw_reduce": lambda: T.lstm_dw_reduce(dxp, hs)}
        row = dict(shape=label, N=n, L=seq_len, H=hidden, path=path)
        for key, fn in alone.items():
            row[key + " alone"] = cuda_time(fn, 20)
        for key, fn in wrapped.items():
            row[key + " wrapper"] = cuda_time(fn, 20)
        out["kernels"].append(row)
        log("[train-times] " + json.dumps(row))
    arrays = _pileup_train_arrays(np.random.default_rng(SEED + 3), 2000)
    # Lookahead-Adam only: a parent tree may have no other optimizer
    out["profile"] = profile_train_steps(dev, arrays,
                                         np.random.default_rng(SEED + 4),
                                         flavors=False)
    return out


def _turns(kind, parent):
    """`python3 chip_smoke.py --{kind}-turns PARENT` (kind `train`, `fused`
    or `probe`): `--{kind}-times` of the tree at PARENT (a `git archive` of
    the parent commit) and of this tree in turns, parent, change, change,
    parent, each in its own process; returns their rows, which `main`
    prints as one `{"{kind}_turns": [...]}` line."""
    runs = []
    for tree in (parent, ROOT, ROOT, parent):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), f"--{kind}-times",
             os.path.abspath(tree)], capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stdout.write(proc.stderr[-4000:])
            raise AssertionError(f"--{kind}-times {tree}: exit "
                                 f"{proc.returncode}")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith(f'{{"{kind}_times"')][-1]
        runs.append(dict(tree="parent" if tree == parent else "change",
                         **json.loads(line)[f"{kind}_times"]))
    return runs


def _fused_cases(F, K, lib, dev, gen):
    """The fused kernels of the package `F` was imported from, and the
    per-layer kernels their routes replace, on seeded inputs at the pileup
    encoder's shapes. Returns (alone, cases, routes):

      alone   {label: callable} launching each kernel alone at N_TIME, the
              plan, outputs and packed weights made beforehand;
      cases   {fused kernel: namespace}: `run(x)` through the wrapper as
              the model calls it, `plain(x)` its plain version,
              `make_x(n)` an input of n rows, `x` the one of N_TIME rows,
              `head` the head's weights (None for bilstm2_center);
      routes  {label: callable}: the per-layer route each fused kernel
              replaces, through its wrappers at N_TIME, weights packed
              once."""
    import torch

    stream = torch.cuda.current_stream(dev).cuda_stream

    def u(*shape, scale=1.0):
        return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * scale

    def layer(d_in, hidden):
        k = 1.0 / math.sqrt(hidden)
        return (u(2, d_in, 4 * hidden, scale=k).bfloat16(),
                u(2, hidden, 4 * hidden, scale=k).bfloat16(),
                u(2, 4 * hidden, scale=2 * k))

    seq_len, hidden, p_dim, q_dim = 33, 64, 128, 256

    def make_x1(n):
        return u(n, seq_len, 18, scale=8.0).bfloat16()

    def make_xh(n):
        return u(n, seq_len, 2 * hidden).bfloat16()

    x1 = make_x1(N_TIME)
    l1, l2 = layer(18, hidden), layer(2 * hidden, hidden)
    wpk1, wpk2 = K.pack_weights(*l1[:2]), K.pack_weights(*l2[:2])
    # the per-layer route's kernels (the same C interface in both trees)
    x2 = torch.empty(N_TIME, seq_len, 2 * hidden, dtype=torch.bfloat16,
                     device=dev)
    ctr = torch.empty(N_TIME, 2 * hidden, device=dev)
    p1 = K.plan_layer(N_TIME, seq_len, 18, hidden, False)
    p2 = K.plan_layer(N_TIME, seq_len, 2 * hidden, hidden, True)
    alone = {
        "bilstm_stream s2 L1": lambda: K._call(
            "nsp_bilstm_stream", dev, x1.data_ptr(), wpk1.data_ptr(),
            l1[2].data_ptr(), x2.data_ptr(), 0, N_TIME, seq_len, p1.d_x,
            hidden, p1.bn, p1.smem, p1.grid[0]),
        "bilstm_center s2 L2": lambda: K._call(
            "nsp_bilstm_center", dev, x2.data_ptr(), wpk2.data_ptr(),
            l2[2].data_ptr(), ctr.data_ptr(), N_TIME, seq_len, p2.d_x, hidden,
            p2.bn, p2.smem, p2.grid[0])}
    routes = {"bilstm_stream + bilstm_center": lambda: K.bilstm_center(
        K.bilstm_stream(x1, *l1, packed=wpk1), *l2, packed=wpk2)}
    out2 = torch.empty(N_TIME, 2 * hidden, device=dev)
    plan = F.plan_two_layer(N_TIME, seq_len, 18, hidden)
    mid = torch.empty_like(x2)
    alone["bilstm2_center"] = lambda: lib.nsp_bilstm2_center(
        x1.data_ptr(), wpk1.data_ptr(), l1[2].data_ptr(), wpk2.data_ptr(),
        l2[2].data_ptr(), mid.data_ptr(), out2.data_ptr(), N_TIME, seq_len,
        plan.d_x, hidden, plan.bn, plan.smem, plan.grid[0], stream)
    cases = {"bilstm2_center": SimpleNamespace(
        run=lambda x: F.bilstm2_center(x, *l1, *l2, wpk1, wpk2),
        plain=lambda x: F.bilstm2_center_plain(x, *l1, *l2),
        make_x=make_x1, x=x1, head=None)}
    xh = make_xh(N_TIME)
    for n_rows in HEAD_ROWS:
        head = _head_weights(u, hidden, p_dim, q_dim, n_rows)
        r_dim = -(-n_rows // 16) * 16
        wh = torch.nn.functional.pad(head[4], (0, 0, 0, r_dim - n_rows))
        pk = [K.pack_a_fragments(t[None]) for t in (head[0], head[2], wh)]
        pk.append(torch.nn.functional.pad(head[5], (0, r_dim - n_rows)))
        out = torch.empty(N_TIME, n_rows, device=dev)
        # the launches below hold raw pointers: each keeps its tensors
        # alive (`keep`), as the loop rebinds `out` and `pk`
        args = (xh.data_ptr(), wpk2.data_ptr(), l2[2].data_ptr(),
                pk[0].data_ptr(), head[1].data_ptr(), pk[1].data_ptr(),
                head[3].data_ptr(), pk[2].data_ptr(), pk[3].data_ptr(),
                out.data_ptr(), N_TIME, seq_len, 2 * hidden, hidden, p_dim,
                q_dim, r_dim, n_rows)
        key = f"bilstm_center_head {n_rows} rows"
        hp = F.plan_center_head(N_TIME, seq_len, 2 * hidden, hidden, p_dim,
                                q_dim)
        head_pk = F.pack_head(head)
        alone[key] = (lambda a=args, hp=hp, keep=(out, pk):
                      lib.nsp_bilstm_center_head(*a, hp.bn, hp.smem,
                                                 hp.grid[0], stream))
        run = (lambda x, h=head, hk=head_pk: F.bilstm_center_head(
            x, *l2, h, wpk2, hk))
        cases[key] = SimpleNamespace(
            run=run, plain=(lambda x, h=head: F.bilstm_center_head_plain(
                x, *l2, h)), make_x=make_xh, x=xh, head=head)
        routes[f"bilstm_center + plain head {n_rows} rows"] = (
            lambda h=head: F.head_plain(K.bilstm_center(xh, *l2, wpk2), h))
    for name, fn in alone.items():
        if fn() not in (0, None):
            raise AssertionError(f"{name}: a launch of the kernel alone "
                                 "failed")
    return alone, cases, routes


def fused_kernel_times(dev):
    """The fused kernels and the per-layer kernels of their routes, alone
    and through their wrappers (`_fused_cases`), at N_TIME, in the package
    on sys.path. One process a tree: `python3 chip_smoke.py --fused-times
    TREE`."""
    import torch

    from nanosnp_tpu_torch.ops import bilstm as K
    from nanosnp_tpu_torch.ops import bilstm_fused as F
    from nanosnp_tpu_torch.ops import build

    build.build_all()
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    alone, cases, routes = _fused_cases(F, K, build.library("bilstm_fused"),
                                        dev, gen)
    row = {k + " alone": cuda_time(fn, 20) for k, fn in alone.items()}
    row.update({k + " wrapper": cuda_time(lambda c=c: c.run(c.x), 20)
                for k, c in cases.items()})
    row.update({k + " wrapper": cuda_time(fn, 20)
                for k, fn in routes.items()})
    row["per-layer route alone"] = (row["bilstm_stream s2 L1 alone"]
                                    + row["bilstm_center s2 L2 alone"])
    log("[fused-times] " + json.dumps(row))
    return row


def _pileup_columns(rng, seq):
    """[len(seq), 18] int16 pileup counts in the s1 layout: reads matching
    the reference count negative in the reference base's channels, the
    other base positive, small indel channels."""
    import numpy as np

    n = len(seq)
    cols = np.zeros((n, 18), np.int16)
    base = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), seq)
    depth = rng.integers(8, 45, n)
    alt = rng.binomial(depth, rng.choice([0.02, 0.5, 0.95], n,
                                         p=[0.9, 0.07, 0.03]))
    fwd = rng.binomial(depth, 0.5)
    fwd_alt = rng.binomial(alt, 0.5)
    alt_base = (base + rng.integers(1, 4, n)) % 4
    r = np.arange(n)
    cols[r, base] -= (fwd - fwd_alt).clip(0).astype(np.int16)
    cols[r, base + 9] -= (depth - fwd - (alt - fwd_alt)).clip(0).astype(
        np.int16)
    cols[r, alt_base] += fwd_alt.astype(np.int16)
    cols[r, alt_base + 9] += (alt - fwd_alt).astype(np.int16)
    cols[:, [4, 5, 6, 7, 13, 14, 15, 16]] = rng.integers(
        0, 3, (n, 8)).astype(np.int16)
    return cols


def _read_matrices(rng, n, depth, seq_len, untagged):
    """One view of a haplotype shard: [n, depth, L] read matrices with
    ragged depth (pad -2); the first `untagged` sites carry no HP tag."""
    import numpy as np

    seq = rng.integers(-1, 5, (n, depth, seq_len)).astype(np.int8)
    keep = rng.integers(depth // 2, depth + 1, n)
    pad = np.arange(depth)[None, :, None] >= keep[:, None, None]
    seq[np.broadcast_to(pad, seq.shape)] = -2
    pad = seq == -2
    tags = rng.integers(1, 4, (n, depth, 1)).repeat(seq_len, axis=2)
    tags[:untagged] = 3
    return {"sequences": seq,
            "hap": np.where(pad, -2, tags).astype(np.int8),
            "baseq": np.where(pad, -2, rng.integers(0, 60, seq.shape)
                              ).astype(np.int8),
            "mapq": np.where(pad, -2, rng.integers(0, 254, seq.shape)
                             ).astype(np.int16)}


def _body(path):
    with open(path) as f:
        return [ln.rstrip("\n").split("\t") for ln in f if ln[0] != "#"]


def _pileup_world(rng, work, contig, length, n_cand, flank=16):
    """A reference contig and one columnar pileup shard of n_cand
    candidates -> (fasta path, FastaReference, sequence, shard, shard dir,
    candidate positions)."""
    import numpy as np

    from nanosnp_tpu_torch.io import bins
    from nanosnp_tpu_torch.io.fasta import FastaReference, write_fasta

    t0 = time.monotonic()
    fa = os.path.join(work, "ref.fa")
    write_fasta(fa, {contig: np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, length)].tobytes().decode()})
    ref = FastaReference(fa)
    seq = ref.contig(contig)
    pos = np.sort(rng.choice(np.arange(flank + 1, length - flank), n_cand,
                             replace=False)).astype(np.int64)
    win = pos[:, None] - 1 + np.arange(-flank, flank + 1)[None, :]
    shard = bins.PileupShard(
        contig=contig, positions=pos,
        ref_seqs=seq[win].view(f"S{2 * flank + 1}").reshape(-1),
        alt_info=np.full(n_cand, b"A:1", dtype="S3"),
        columns=_pileup_columns(rng, seq), cand_off=pos - 1, flank=flank)
    shard_dir = os.path.join(work, "pileup_shards")
    os.makedirs(shard_dir)
    bins.save_pileup_shard(os.path.join(shard_dir, f"{contig}.npz"), shard)
    log(f"[data]  pileup world: {length} bp, {n_cand} candidates, "
        f"{len(shard.columns)} columns ({time.monotonic() - t0:.1f} s)")
    return fa, ref, seq, shard, shard_dir, pos


def phase_slice(dev):
    import numpy as np
    import torch

    from nanosnp_tpu_torch import constants as C
    from nanosnp_tpu_torch.config import PipelineConfig
    from nanosnp_tpu_torch.features.haplotype import (haplotype_features,
                                                      ref_position_codes,
                                                      ref_window_codes)
    from nanosnp_tpu_torch.io import bins
    from nanosnp_tpu_torch.models.convert import (load_params_npz,
                                                  pileup_checkpoint_from_params)
    from nanosnp_tpu_torch.models.haplotype_model import (HaplotypeModel,
                                                          haplotype_predict)
    from nanosnp_tpu_torch.models.pileup_model import (PileupModel,
                                                       init_pileup_params,
                                                       pileup_predict)
    from nanosnp_tpu_torch.ops import bilstm as K
    from nanosnp_tpu_torch.runtime import cli, stages

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    rng = np.random.default_rng(SEED)
    cfg = PipelineConfig()
    contig, length, n_cand = "chr20", CONTIG_LEN, N_CAND
    flank = 16
    fa, ref, seq, shard, shard_dir, pos = _pileup_world(
        rng, WORK, contig, length, n_cand)
    gen = torch.Generator().manual_seed(SEED)
    pparams = init_pileup_params(gen, cfg.pileup_model)
    ckpt = os.path.join(WORK, "pileup.chkpt")
    torch.save(pileup_checkpoint_from_params(pparams), ckpt)

    stage_rows = {}
    launches = {}

    def run_stage(name, fn):
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.monotonic()
        fn()
        torch.cuda.synchronize()
        dt = time.monotonic() - t
        launches[name] = dict(K.LAUNCHES)
        log(f"[{name}] {dt:.3f} s, launches {launches[name]}")
        return dt

    out = os.path.join(WORK, "out")
    dt = run_stage("s2", lambda: cli.main([
        "s2-predict", "--shards", shard_dir, "--ref", fa,
        "--pileup-model", ckpt, "-o", out]))
    vcf = _body(os.path.join(out, "pileup.vcf"))
    stage_rows["s2"] = dict(sites=n_cand, rows=len(vcf), seconds=dt,
                            sites_per_s=n_cand / dt)
    cand = set(pos.tolist())
    if not vcf or any(len(r) != 10 or int(r[1]) not in cand
                      or not math.isfinite(float(r[5])) for r in vcf):
        raise AssertionError("pileup.vcf rows malformed or empty")

    # s5 world: two depth buckets on pileup-call positions, a quarter of
    # the sites untagged so the deferral gate drops them
    hap_dir = os.path.join(WORK, "hap_shards")
    os.makedirs(hap_dir)
    called = np.array(sorted(int(r[1]) for r in vcf), np.int64)
    called = called[(called > 200) & (called < length - 200)]
    n_hap = 0
    for depth, n in ((64, HAP_SITES), (96, HAP_SITES)):
        centers = np.sort(rng.choice(called, n, replace=False))
        hs = bins.HaplotypeShard(
            contig=contig, candidate_positions=centers,
            group_positions=centers[:, None]
            + np.arange(-5, 6)[None, :] * 7,
            pileup=_read_matrices(rng, n, depth, 33, n // 4),
            haplotype=_read_matrices(rng, n, depth, 11, n // 4))
        bins.save_haplotype_shard(
            os.path.join(hap_dir, f"{contig}_d{depth}x{depth}.npz"), hs)
        n_hap += n
    hparams = load_params_npz(V6B)
    csv = os.path.join(WORK, "haplotype.csv")
    m5 = {}
    dt = run_stage("s5", lambda: m5.update(stages.stage_haplotype_predict(
        cfg, ref, hap_dir, csv, hparams)))
    rows = _body(csv)
    stage_rows["s5"] = dict(sites=n_hap, rows=len(rows), seconds=dt,
                            sites_per_s=n_hap / dt,
                            deferred=m5.get("deferred"))
    if (m5["sites"] != n_hap or not m5.get("deferred")
            or len(rows) != n_hap - m5["deferred"]
            or any(r[2] not in C.GT21_LABELS[:10]
                   or not math.isfinite(float(r[3])) for r in rows)):
        raise AssertionError(f"haplotype.csv wrong: {m5}, {len(rows)} rows")

    dt = run_stage("s6", lambda: cli.main([
        "s6-merge", "--pileup-vcf", os.path.join(out, "pileup.vcf"),
        "--haplotype-csv", csv, "-o", out]))
    merged = _body(os.path.join(out, "merge.vcf"))
    stage_rows["s6"] = dict(rows=len(merged), seconds=dt,
                            rescued=sum(r[7] == "H" for r in merged))
    if not merged or any(len(r) != 10 for r in merged):
        raise AssertionError("merge.vcf rows malformed or empty")
    for k, v in stage_rows.items():
        log(f"[{k}] " + json.dumps(v))

    # the models on the card against their plain versions on the CPU (same
    # cast sites, bf16) on a small input
    with torch.inference_mode():
        idx = np.arange(2048)
        xw = torch.from_numpy(shard.matrix[idx].astype(np.float32))
        pm = PileupModel(cfg.pileup_model, pparams)
        want = pileup_predict(pm, xw, torch.bfloat16)
        got = pileup_predict(pm.to(dev), xw.to(dev), torch.bfloat16)
        check_probs("pileup model", got, want)
        hs = bins.load_haplotype_shard(os.path.join(hap_dir,
                                                    f"{contig}_d64x64.npz"))
        sl = slice(0, 512)
        feats = []
        for view, codes in (
                ("pileup", ref_window_codes(seq, hs.candidate_positions[sl],
                                            flank)),
                ("haplotype", ref_position_codes(seq,
                                                 hs.group_positions[sl]))):
            d = getattr(hs, view)
            feats.append(haplotype_features(*[
                torch.from_numpy(d[k][sl]).to(dev)
                for k in ("sequences", "baseq", "mapq", "hap")],
                torch.from_numpy(codes).to(dev)).bfloat16())
        hm = HaplotypeModel(cfg.haplotype_model, hparams)
        want = haplotype_predict(hm, feats[0].cpu(), feats[1].cpu(),
                                 torch.bfloat16)
        got = haplotype_predict(hm.to(dev), *feats, torch.bfloat16)
        check_probs("haplotype model (v6b)", got, want)
    shutil.rmtree(WORK, ignore_errors=True)
    return launches, stage_rows


def _head_weights(u, hidden, p_dim, q_dim, n_rows):
    """A seeded head (wp, bp, wd, bd, wh, bh) at the pileup model's scale."""
    return (u(p_dim, 2 * hidden, scale=0.09).bfloat16(), u(p_dim, scale=0.09),
            u(q_dim, p_dim, scale=0.09).bfloat16(), u(q_dim, scale=0.09),
            u(n_rows, q_dim, scale=0.06).bfloat16(), u(n_rows, scale=0.06))


def _fused_checks(name, label, fn, plain, make_x):
    """A fused kernel's wrapper against its plain version at each N of
    N_INFER_CHECK, each run twice (the same bits: no sum depends on timing);
    returns the largest max|d|."""
    import torch

    worst = 0.0
    for n in N_INFER_CHECK:
        x = make_x(n)
        got, again = fn(x), fn(x)
        torch.cuda.synchronize()
        err, _ = _errs(got, plain(x))
        same = torch.equal(got, again)
        log(f"[check] {name:21s} {label:30s} N={n}: max|d|={err:.3e} "
            f"(tol {CENTER_TOL}), second run the same bits: {same}")
        if not (err <= CENTER_TOL and same):
            raise AssertionError(f"{name} {label} N={n}: max|d| {err}, "
                                 f"same bits {same}")
        worst = max(worst, err)
    return worst


def phase_new_kernels(dev):
    """Phase 1c: the inference recurrence, the center + head kernel and the
    two-layer kernel against their plain versions, timed beside cuDNN."""
    import torch

    from nanosnp_tpu_torch.device import set_matmul_precision
    from nanosnp_tpu_torch.models.bilstm import (BiLSTM,
                                                 bilstm_encoder_fused,
                                                 bilstm_encoder_unfused,
                                                 init_bilstm_params)
    from nanosnp_tpu_torch.ops import bilstm as K
    from nanosnp_tpu_torch.ops import bilstm_fused as F
    from nanosnp_tpu_torch.ops import lstm_train as T
    from nanosnp_tpu_torch.ops.build import library

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def u(*shape, scale=1.0):
        return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * scale

    def cudnn_ms(d_in, hidden, seq_len, layers=1, then=None,
                 dtype=torch.bfloat16):
        lstm = torch.nn.LSTM(d_in, hidden, num_layers=layers,
                             batch_first=True, bidirectional=True,
                             device=dev, dtype=dtype)
        x = u(N_TIME, seq_len, d_in).to(dtype)

        def run():
            out, _ = lstm(x)
            if then is not None:
                then(out[:, seq_len // 2])

        with torch.inference_mode():
            return cuda_time(run, 5)

    rows = []

    def record(name, label, err, tol, kern, alone, plain, library_ms, cost,
               peak=PEAK_BF16_FLOPS, **dims):
        """kern: the wrapper, as a caller gets it (a model's packed weights
        made once, beforehand); alone: the kernel's C entry point with the
        plan, the packed weights and the outputs made beforehand; peak: the
        card's rate for the kernel's products."""
        if not err <= tol:
            raise AssertionError(f"{name} {label}: max|d| {err} > {tol}")
        wrapper_ms = cuda_time(kern, 10)
        ms = cuda_time(alone, 10)
        plain_ms = cuda_time(plain, 2)
        flop, nbytes = cost
        t_ops = flop / peak * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        rows.append(dict(
            name=name, shape=label, **dims, max_abs_err=err, ms=ms,
            wrapper_ms=wrapper_ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes"))
        log(f"[time]  {name:21s} {label:26s} N={N_TIME}: alone {ms:.3f} ms, "
            f"wrapper {wrapper_ms:.3f} ms, plain {plain_ms:.3f} ms, library "
            f"{library_ms:.3f} ms, bound {rows[-1]['bound_ms']:.4f} ms "
            f"({rows[-1]['bound_by']})")

    stream = torch.cuda.current_stream(dev).cuda_stream

    # ---- lstm_recurrence_infer: f32 and bf16 xp, the path of `plan_infer`
    # (cluster at the CatModel's H=256, smem at the pileup shape's H=64),
    # each against its plain version and twice for the same bits; the
    # packed kernel (the design before at both widths) is timed beside it
    # in the same run
    for label, seq_len, d_lib, hidden in INFER_SHAPES:
        lib = cudnn_ms(d_lib, hidden, seq_len)
        for xp_dtype in (torch.float32, torch.bfloat16):
            xp_bytes = torch.empty(0, dtype=xp_dtype).element_size()
            path = T.plan_infer(N_TIME, seq_len, hidden, xp_bytes).path
            w = u(2, hidden, 4 * hidden,
                  scale=1.0 / math.sqrt(hidden)).bfloat16()
            tag = f"{label}, xp {str(xp_dtype).split('.')[-1]}"
            err = 0.0
            for n_check in N_INFER_CHECK:
                xp = u(n_check, seq_len, 2, 4 * hidden, scale=3.0).to(
                    xp_dtype)
                K.reset_launch_counts()
                got, again = (T.lstm_recurrence_infer(xp, w),
                              T.lstm_recurrence_infer(xp, w))
                torch.cuda.synchronize()
                e, rel = _errs(got, T.lstm_recurrence_infer_plain(xp, w))
                same = torch.equal(got, again)
                log(f"[check] lstm_recurrence_infer {tag:30s} ({path}) "
                    f"N={n_check} L={seq_len} H={hidden}: max|d|={e:.3e}, "
                    f"over max(1, max|want|) {rel:.3e} (tol {TRAIN_TOL}), "
                    f"second run the same bits: {same}")
                if not (rel <= TRAIN_TOL and same
                        and K.LAUNCHES["lstm_recurrence_infer"] == 2):
                    raise AssertionError(f"lstm_recurrence_infer {tag} "
                                         f"N={n_check}: {rel} > {TRAIN_TOL}"
                                         f" or not the same bits twice")
                err = max(err, e)
            xp = u(N_TIME, seq_len, 2, 4 * hidden, scale=3.0).to(xp_dtype)
            xp_bf16 = int(xp.dtype == torch.bfloat16)
            wpk = K.pack_a_fragments(w.transpose(1, 2))
            hs = torch.empty(N_TIME, seq_len, 2, hidden, device=dev)
            plan = T.plan_infer(N_TIME, seq_len, hidden, xp_bytes)

            def packed():
                return library("lstm_train").nsp_lstm_infer(
                    xp.data_ptr(), xp_bf16, wpk.data_ptr(), hs.data_ptr(),
                    N_TIME, seq_len, hidden, stream)

            def cluster():
                return library("lstm_train").nsp_lstm_infer_cluster(
                    xp.data_ptr(), xp_bf16, w.data_ptr(), hs.data_ptr(),
                    N_TIME, seq_len, hidden, plan.cluster, plan.bn, plan.smem,
                    plan.grid[0], stream)

            def smem():
                return library("lstm_train").nsp_lstm_infer_smem(
                    xp.data_ptr(), xp_bf16, w.data_ptr(), hs.data_ptr(),
                    N_TIME, seq_len, hidden, plan.bn, plan.smem, plan.grid[0],
                    stream)

            alone = {"cluster": cluster, "smem": smem, "packed": packed}[path]
            if alone() != 0 or packed() != 0:
                raise AssertionError(f"lstm_recurrence_infer {tag}: a launch "
                                     "of the kernel alone failed")
            extra = {}
            if path == "smem":
                extra = dict(smem=plan.smem,
                             blocks_an_sm=T.infer_smem_occupancy(xp_bytes))
                log(f"[plan]  lstm_recurrence_infer {tag} (smem): "
                    f"{plan.smem} B a block, {extra['blocks_an_sm']} blocks "
                    f"an SM resident (cudaOccupancyMaxActiveBlocksPer"
                    f"Multiprocessor), {plan.grid[0] * plan.grid[1]} blocks")
            record("lstm_recurrence_infer", tag, err, TRAIN_TOL,
                   lambda: T.lstm_recurrence_infer(xp, w), alone,
                   lambda: T.lstm_recurrence_infer_plain(xp, w), lib,
                   T.infer_cost(N_TIME, seq_len, hidden, xp_bytes),
                   L=seq_len, H=hidden, path=path, **extra)
            if path != "packed":
                rows[-1]["packed_ms"] = cuda_time(packed, 10)
                log(f"[time]  the packed kernel alone at the same shape: "
                    f"{rows[-1]['packed_ms']:.3f} ms")

    # ---- lstm_recurrence_infer with f32 w_hh: the f32 kernel of the f32
    # scan route (`plan_infer_f32`) at each of its layer shapes, against its
    # plain version (the f32 step loop on the card, TF32 off) at
    # N_INFER_CHECK, each twice for the same bits; then timed alone and
    # through the wrapper beside cuDNN nn.LSTM in f32 with TF32 off (a
    # yardstick only); its bound is FFMA at the card's f32 rate
    set_matmul_precision()
    for label, seq_len, d_lib, hidden in F32_SHAPES:
        w = u(2, hidden, 4 * hidden, scale=1.0 / math.sqrt(hidden))
        err = 0.0
        for n_check in N_INFER_CHECK:
            xp = u(n_check, seq_len, 2, 4 * hidden, scale=3.0)
            K.reset_launch_counts()
            got, again = (T.lstm_recurrence_infer(xp, w),
                          T.lstm_recurrence_infer(xp, w))
            torch.cuda.synchronize()
            e, _ = _errs(got, T.lstm_recurrence_infer_plain(xp, w))
            same = torch.equal(got, again)
            log(f"[check] lstm_recurrence_infer_f32 {label:22s} N={n_check} "
                f"L={seq_len} H={hidden}: max|d|={e:.3e} (tol "
                f"{F32_KERNEL_TOL}), second run the same bits: {same}, "
                f"launches {K.LAUNCHES['lstm_recurrence_infer_f32']}")
            if not (e <= F32_KERNEL_TOL and same
                    and K.LAUNCHES["lstm_recurrence_infer_f32"] == 2
                    and K.LAUNCHES["lstm_recurrence_infer"] == 0):
                raise AssertionError(f"lstm_recurrence_infer_f32 {label} "
                                     f"N={n_check}: {e} > {F32_KERNEL_TOL}"
                                     " or not the same bits twice")
            err = max(err, e)
        xp = u(N_TIME, seq_len, 2, 4 * hidden, scale=3.0)
        hs = torch.empty(N_TIME, seq_len, 2, hidden, device=dev)
        plan = T.plan_infer_f32(N_TIME, seq_len, hidden)

        def f32_alone(xp=xp, w=w, hs=hs, plan=plan, seq_len=seq_len,
                      hidden=hidden):
            return library("lstm_train").nsp_lstm_infer_f32(
                xp.data_ptr(), w.data_ptr(), hs.data_ptr(), N_TIME, seq_len,
                hidden, plan.bn, plan.smem, plan.grid[0], stream)

        if f32_alone() != 0:
            raise AssertionError(f"lstm_recurrence_infer_f32 {label}: a "
                                 "launch of the kernel alone failed")
        resident = T.infer_f32_occupancy(hidden)
        log(f"[plan]  lstm_recurrence_infer_f32 {label}: {plan.smem} B a "
            f"CTA, {resident} CTAs an SM resident, "
            f"{plan.grid[0] * plan.grid[1]} CTAs")
        record("lstm_recurrence_infer_f32", label, err, F32_KERNEL_TOL,
               lambda xp=xp, w=w: T.lstm_recurrence_infer(xp, w), f32_alone,
               lambda xp=xp, w=w: T.lstm_recurrence_infer_plain(xp, w),
               cudnn_ms(d_lib, hidden, seq_len, dtype=torch.float32),
               T.infer_f32_cost(N_TIME, seq_len, hidden),
               peak=PEAK_F32_FLOPS, L=seq_len, H=hidden, path=plan.path,
               smem=plan.smem, ctas_an_sm=resident)

    # ---- bilstm_center_head at the s2 L2 shape, then bilstm2_center at the
    # pileup encoder's (`_fused_cases`): each against its plain version at
    # N_INFER_CHECK (cluster tails; N_WIDE on the tile of N_TIME), twice
    # (the same bits), then timed at N_TIME alone (the C entry point, plan,
    # packed weights and output made beforehand) and through the wrapper
    # with the weights packed once, as the model calls it, beside the
    # per-layer route it replaces
    alone, cases, routes = _fused_cases(F, K, library("bilstm_fused"), dev,
                                        gen)
    seq_len, hidden, p_dim, q_dim = 33, 64, 128, 256
    for n_rows in HEAD_ROWS:
        case = cases[f"bilstm_center_head {n_rows} rows"]
        label = f"s2 L2 + head, {n_rows} rows"
        err = _fused_checks("bilstm_center_head", label, case.run,
                            case.plain, case.make_x)
        wl = [t.float().T.contiguous() for t in case.head[::2]]

        def lib_head(ctr, wl=wl, head=case.head):
            feat = ctr.float() @ wl[0] + head[1]
            feat = torch.tanh(feat @ wl[1] + head[3])
            return feat @ wl[2] + head[5]

        plan = F.plan_center_head(N_TIME, seq_len, 2 * hidden, hidden,
                                  p_dim, q_dim)
        record("bilstm_center_head", label, err, CENTER_TOL,
               lambda c=case: c.run(c.x),
               alone[f"bilstm_center_head {n_rows} rows"],
               lambda c=case: c.plain(c.x),
               cudnn_ms(2 * hidden, hidden, seq_len, then=lib_head),
               F.center_head_cost(N_TIME, seq_len, 2 * hidden, hidden, p_dim,
                                  q_dim, n_rows),
               L=seq_len, D=2 * hidden, H=hidden, rows=n_rows, bn=plan.bn,
               clusters=plan.grid[0] // 2, smem=plan.smem,
               clusters_resident=F.fused_occupancy(plan, (p_dim, q_dim)))
        split = cuda_time(routes[f"bilstm_center + plain head {n_rows} rows"],
                          10)
        rows[-1]["center_then_plain_head_ms"] = split
        log(f"[time]  the same as bilstm_center + plain head (weights "
            f"packed once): {split:.3f} ms; clusters {plan.grid[0] // 2} of "
            f"{rows[-1]['clusters_resident']} resident, {plan.smem} B a CTA")

    case, d_in = cases["bilstm2_center"], 18
    err = _fused_checks("bilstm2_center", "pileup encoder", case.run,
                        case.plain, case.make_x)
    x = case.x
    plan = F.plan_two_layer(N_TIME, seq_len, d_in, hidden)
    record("bilstm2_center", "pileup encoder", err, CENTER_TOL,
           lambda: case.run(x), alone["bilstm2_center"],
           lambda: case.plain(x), cudnn_ms(d_in, hidden, seq_len, layers=2),
           F.two_layer_cost(N_TIME, seq_len, d_in, hidden),
           L=seq_len, D=d_in, H=hidden, bn=plan.bn,
           clusters=plan.grid[0] // 2, smem=plan.smem,
           clusters_resident=F.fused_occupancy(plan))
    split = cuda_time(routes["bilstm_stream + bilstm_center"], 10)
    split_alone = (cuda_time(alone["bilstm_stream s2 L1"], 10)
                   + cuda_time(alone["bilstm_center s2 L2"], 10))
    rows[-1].update(per_layer_kernels_ms=split,
                    per_layer_kernels_alone_ms=split_alone)
    log(f"[time]  the same as bilstm_stream + bilstm_center (weights packed "
        f"once): {split:.3f} ms, the two kernels alone {split_alone:.3f} ms; "
        f"clusters {plan.grid[0] // 2} of {rows[-1]['clusters_resident']} "
        f"resident, {plan.smem} B a CTA")

    # ---- the fused=False encoder (bf16 xp through the inference kernel)
    # against the fused encoder, on the pileup model's seeded encoder
    enc = BiLSTM(init_bilstm_params(torch.Generator().manual_seed(SEED),
                                    d_in, hidden, 2)).to(dev)
    K.reset_launch_counts()
    a = bilstm_encoder_unfused(enc.layers, x, center_only=True)
    b = bilstm_encoder_fused(enc.layers, x, center_only=True)
    err, _ = _errs(a, b)
    log(f"[check] bilstm_encoder_unfused against bilstm_encoder_fused: "
        f"max|d|={err:.3e} (tol {STREAM_TOL}: xp is rounded to bf16 on one "
        f"side only), launches {K.LAUNCHES['lstm_recurrence_infer']}")
    if not err <= STREAM_TOL or K.LAUNCHES["lstm_recurrence_infer"] != 2:
        raise AssertionError("fused=False encoder disagrees")

    # ---- lstm_recurrence: which kernel with and without gradients
    w = u(2, hidden, 4 * hidden, scale=0.125).bfloat16()
    xp = u(64, seq_len, 2, 4 * hidden).requires_grad_()
    seen = []
    for grad in (False, True):
        K.reset_launch_counts()
        with torch.set_grad_enabled(grad):
            T.lstm_recurrence(xp, w)
        seen.append((K.LAUNCHES["lstm_recurrence_infer"],
                     K.LAUNCHES["lstm_recurrence_train"]))
    log(f"[check] lstm_recurrence launches (infer, train): gradients off "
        f"{seen[0]}, on {seen[1]}")
    if seen != [(1, 0), (0, 1)]:
        raise AssertionError(f"lstm_recurrence dispatch: {seen}")
    return rows


def _qual_rows(path):
    """{(contig, pos): (the row without QUAL, QUAL)} of a VCF body."""
    return {(r[0], r[1]): (r[:5] + r[6:], float(r[5])) for r in _body(path)}


def phase_routes(dev):
    """Phase 2b: s2-predict on one shard under the default route, each
    opt-in route, and the one-layer configuration."""
    import numpy as np
    import torch

    from nanosnp_tpu_torch.config import PileupModelConfig
    from nanosnp_tpu_torch.models.convert import pileup_checkpoint_from_params
    from nanosnp_tpu_torch.models.pileup_model import (PileupModel,
                                                       init_pileup_params,
                                                       pileup_predict)
    from nanosnp_tpu_torch.ops import bilstm as K
    from nanosnp_tpu_torch.runtime import cli

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    rng = np.random.default_rng(SEED + 4)
    fa, _, _, shard, shard_dir, pos = _pileup_world(
        rng, WORK, "chr20", 1_000_000, ROUTE_CAND)
    one_cfg = PileupModelConfig(n_layers=1)
    ckpts = {}
    for name, mcfg in (("two", PileupModelConfig()), ("one", one_cfg)):
        params = init_pileup_params(torch.Generator().manual_seed(SEED), mcfg)
        ckpts[name] = os.path.join(WORK, f"pileup_{name}.chkpt")
        torch.save(pileup_checkpoint_from_params(params), ckpts[name])
    one_yaml = os.path.join(WORK, "one_layer.yaml")
    with open(one_yaml, "w") as f:
        f.write("pileup_model:\n  n_layers: 1\n")

    routes = (("s2 default", {}, "two", []),
              ("s2 NSP_FUSE_HEAD=1", {"NSP_FUSE_HEAD": "1"}, "two", []),
              ("s2 NSP_FUSE_LAYERS=1", {"NSP_FUSE_LAYERS": "1"}, "two", []),
              ("s2 both variables", {"NSP_FUSE_HEAD": "1",
                                     "NSP_FUSE_LAYERS": "1"}, "two", []),
              ("s2 one-layer", {}, "one", ["--config", one_yaml]))
    # what each route must launch, and must not
    expect = {"s2 default": ("bilstm_stream", "bilstm_center"),
              "s2 NSP_FUSE_HEAD=1": ("bilstm_stream", "bilstm_center_head"),
              "s2 NSP_FUSE_LAYERS=1": ("bilstm2_center",),
              "s2 both variables": ("bilstm2_center",),
              "s2 one-layer": ("bilstm_center",)}
    launches, rows, vcfs = {}, {}, {}
    saved = {k: os.environ.pop(k, None)
             for k in ("NSP_FUSE_HEAD", "NSP_FUSE_LAYERS")}
    try:
        for name, env, ckpt, extra in routes:
            out = os.path.join(WORK, name.replace(" ", "_").replace("=", ""))
            os.environ.update(env)
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.monotonic()
            cli.main(["s2-predict", "--shards", shard_dir, "--ref", fa,
                      "--pileup-model", ckpts[ckpt], "-o", out, *extra])
            torch.cuda.synchronize()
            dt = time.monotonic() - t
            for k in env:
                del os.environ[k]
            launches[name] = dict(K.LAUNCHES)
            used = tuple(k for k, v in launches[name].items() if v)
            log(f"[{name}] {dt:.3f} s, {ROUTE_CAND / dt:.0f} sites/s, "
                f"launches {launches[name]}")
            if set(used) != set(expect[name]):
                raise AssertionError(f"{name}: launched {used}, expected "
                                     f"{expect[name]}")
            vcfs[name] = _qual_rows(os.path.join(out, "pileup.vcf"))
            rows[name] = dict(sites=ROUTE_CAND, rows=len(vcfs[name]),
                              seconds=dt, sites_per_s=ROUTE_CAND / dt)
            if not vcfs[name] or not all(
                    math.isfinite(q) for _, q in vcfs[name].values()):
                raise AssertionError(f"{name}: pileup.vcf empty or malformed")
    finally:
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
    base = vcfs["s2 default"]
    for name in ("s2 NSP_FUSE_HEAD=1", "s2 NSP_FUSE_LAYERS=1",
                 "s2 both variables"):
        got = vcfs[name]
        off = len(set(base) ^ set(got))
        worst = 0.0
        for key in set(base) & set(got):
            if base[key][0] != got[key][0] or abs(
                    base[key][1] - got[key][1]) > ROUTE_QUAL_TOL:
                off += 1
            else:
                worst = max(worst, abs(base[key][1] - got[key][1]))
        rows[name].update(rows_off=off, max_qual_gap=worst)
        log(f"[check] {name} against the default route: {len(got)} rows, "
            f"{off} differ (allowed {ROUTE_ROWS_OFF:.1%}), others' max "
            f"|dQUAL| {worst:.3f} (tol {ROUTE_QUAL_TOL})")
        if off > ROUTE_ROWS_OFF * len(base):
            raise AssertionError(f"{name}: {off} rows differ from the "
                                 "default route's")
    # the one-layer model on the card against its plain version on the CPU
    with torch.inference_mode():
        xw = torch.from_numpy(shard.matrix[:2048].astype(np.float32))
        pm = PileupModel(one_cfg, init_pileup_params(
            torch.Generator().manual_seed(SEED), one_cfg))
        want = pileup_predict(pm, xw, torch.bfloat16)
        got = pileup_predict(pm.to(dev), xw.to(dev), torch.bfloat16)
        check_probs("one-layer pileup model", got, want)
    shutil.rmtree(WORK, ignore_errors=True)
    return launches, rows


# phase 2d: the scan route's kernels, and the kernels it must not launch
SCAN_KERNELS = {False: "lstm_recurrence_infer_f32",
                True: "lstm_recurrence_infer"}
SCAN_HAP_SITES = 2048    # s5 sites of phase 2d: one depth bucket, one batch
SCAN_QUAL_TOL = 0.0100001   # f32 card vs CPU: QUAL printed to 2 places
SCAN_BF16_AGREE = 0.99      # bf16 card vs CPU: share of genotypes


def _row_off(g, w, qual_col, gt_col):
    """Whether row g differs from w beyond QUAL within 0.01 and, in a VCF
    sample column GT:GQ:DP:AF, a GQ (which follows QUAL) within 1."""
    if len(g) != len(w) or abs(float(g[qual_col])
                               - float(w[qual_col])) > SCAN_QUAL_TOL:
        return True
    if any(a != b for i, (a, b) in enumerate(zip(g, w))
           if i not in (qual_col, gt_col)):
        return True
    gs, ws = g[gt_col].split(":"), w[gt_col].split(":")
    return (gs[:1] + gs[2:] != ws[:1] + ws[2:]
            or (len(gs) > 1 and abs(int(gs[1]) - int(ws[1])) > 1))


def compare_calls(label, got_path, want_path, gt_col, qual_col, f32):
    """The card's output rows against the CPU's on the same inputs: f32
    (the same arithmetic but for summation order) must give the same rows
    and genotypes with QUAL within 0.01 (and a GQ derived from it within
    1); bf16 (h_{t-1} rounded on both sides, where a flipped rounding can
    move a decision) must agree on SCAN_BF16_AGREE of the genotypes. Prints
    the byte-identical share."""
    got = {(r[0], r[1]): r for r in _body(got_path)}
    want = {(r[0], r[1]): r for r in _body(want_path)}
    keys = set(got) | set(want)
    same = sum(got.get(k) == want.get(k) for k in keys)
    gt = sum(k in got and k in want
             and got[k][gt_col].split(":")[0] == want[k][gt_col].split(":")[0]
             for k in keys)
    worst, bad = 0.0, 0
    for k in set(got) & set(want):
        g, w = got[k], want[k]
        worst = max(worst, abs(float(g[qual_col]) - float(w[qual_col])))
        bad += _row_off(g, w, qual_col, gt_col)
    out = dict(rows=len(want), byte_identical_share=same / max(len(keys), 1),
               genotype_agreement=gt / max(len(keys), 1),
               max_qual_gap=worst, rows_off=bad + len(set(got) ^ set(want)))
    log(f"[check] {label}: card vs CPU over {len(keys)} rows: "
        f"byte-identical {out['byte_identical_share']:.5f}, genotypes agree "
        f"{out['genotype_agreement']:.5f}, max |dQUAL| {worst:.4f}, "
        f"{out['rows_off']} rows off")
    if f32 and out["rows_off"]:
        raise AssertionError(f"{label}: the f32 card rows differ from the "
                             "CPU's")
    if not f32 and out["genotype_agreement"] < SCAN_BF16_AGREE:
        raise AssertionError(f"{label}: the bf16 card genotypes agree with "
                             f"the CPU's on {out['genotype_agreement']:.5f}")
    return out


def phase_scan_route(dev):
    """Phase 2d: the scan route (`use_pallas: false`) of s2-predict (CLI)
    on phase 2b's 24k-candidate shard and of the s5 stage on one depth
    bucket of SCAN_HAP_SITES sites, in f32 and bf16, on the card and on
    the CPU; the card's rows against the CPU's, the launches of each run,
    and s5 under the default route on the same bucket."""
    import numpy as np
    import torch

    from nanosnp_tpu_torch.config import PipelineConfig
    from nanosnp_tpu_torch.io import bins
    from nanosnp_tpu_torch.models.convert import (load_params_npz,
                                                  pileup_checkpoint_from_params)
    from nanosnp_tpu_torch.models.pileup_model import init_pileup_params
    from nanosnp_tpu_torch.ops import bilstm as K
    from nanosnp_tpu_torch.runtime import cli, stages

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    rng = np.random.default_rng(SEED + 4)
    contig = "chr20"
    fa, ref, _, _, shard_dir, pos = _pileup_world(
        rng, WORK, contig, 1_000_000, ROUTE_CAND)
    ckpt = os.path.join(WORK, "pileup.chkpt")
    torch.save(pileup_checkpoint_from_params(init_pileup_params(
        torch.Generator().manual_seed(SEED), PipelineConfig().pileup_model)),
        ckpt)
    hap_dir = os.path.join(WORK, "hap_shards")
    os.makedirs(hap_dir)
    centers = np.sort(rng.choice(pos[(pos > 200) & (pos < 1_000_000 - 200)],
                                 SCAN_HAP_SITES, replace=False))
    bins.save_haplotype_shard(
        os.path.join(hap_dir, f"{contig}_d64x64.npz"), bins.HaplotypeShard(
            contig=contig, candidate_positions=centers,
            group_positions=centers[:, None] + np.arange(-5, 6)[None, :] * 7,
            pileup=_read_matrices(rng, SCAN_HAP_SITES, 64, 33,
                                  SCAN_HAP_SITES // 4),
            haplotype=_read_matrices(rng, SCAN_HAP_SITES, 64, 11,
                                     SCAN_HAP_SITES // 4)))
    hparams = load_params_npz(V6B)

    launches, rows = {}, {}

    def run(name, fn, on_card):
        K.reset_launch_counts()
        t = time.monotonic()
        fn()
        if on_card:
            torch.cuda.synchronize()
        dt = time.monotonic() - t
        if on_card:
            launches[name] = dict(K.LAUNCHES)
        elif sum(K.LAUNCHES.values()):
            raise AssertionError(f"{name} launched kernels on the CPU")
        log(f"[{name}] {dt:.3f} s" + (f", launches {launches[name]}"
                                     if on_card else ""))
        return dt

    def expect(name, used):
        got = {k for k, v in launches[name].items() if v}
        if got != set(used):
            raise AssertionError(f"{name}: launched {sorted(got)}, expected "
                                 f"{sorted(used)}")

    for bf16 in (False, True):
        tag = "bf16" if bf16 else "f32"
        yaml = os.path.join(WORK, f"scan_{tag}.yaml")
        with open(yaml, "w") as f:
            f.write(f"inference:\n  use_pallas: false\n  use_bf16: "
                    f"{str(bf16).lower()}\n  batch_size: {SCAN_HAP_SITES}\n")
        cfg = PipelineConfig()
        cfg.inference.use_pallas = False
        cfg.inference.use_bf16 = bf16
        cfg.inference.batch_size = SCAN_HAP_SITES
        outs = {}
        for where, extra in (("card", []), ("cpu", ["--device", "cpu"])):
            name = f"s2 scan {tag} {where}"
            out = os.path.join(WORK, name.replace(" ", "_"))
            dt = run(name, lambda out=out, extra=extra: cli.main([
                "s2-predict", "--shards", shard_dir, "--ref", fa,
                "--pileup-model", ckpt, "--config", yaml, "-o", out,
                *extra]), where == "card")
            rows[name] = dict(sites=ROUTE_CAND, seconds=dt,
                              sites_per_s=ROUTE_CAND / dt)
            outs[where] = os.path.join(out, "pileup.vcf")
        expect(f"s2 scan {tag} card", (SCAN_KERNELS[bf16],))
        rows[f"s2 scan {tag} card"]["card_vs_cpu"] = compare_calls(
            f"s2 scan {tag}", outs["card"], outs["cpu"], 9, 5, not bf16)
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            name = f"s5 scan {tag} {where}"
            outs[where] = os.path.join(WORK, f"s5_{tag}_{where}.csv")
            m5 = {}
            dt = run(name, lambda o=outs[where], d=device: m5.update(
                stages.stage_haplotype_predict(cfg, ref, hap_dir, o, hparams,
                                               device=d)), where == "card")
            rows[name] = dict(sites=m5["sites"], seconds=dt,
                              sites_per_s=m5["sites"] / dt,
                              deferred=m5.get("deferred"))
            if m5["sites"] != SCAN_HAP_SITES or not m5.get("deferred"):
                raise AssertionError(f"{name}: {m5}")
        expect(f"s5 scan {tag} card", (SCAN_KERNELS[bf16],))
        rows[f"s5 scan {tag} card"]["card_vs_cpu"] = compare_calls(
            f"s5 scan {tag}", outs["card"], outs["cpu"], 2, 3, not bf16)
    # the default route on the same bucket launches the kernel route's
    # H=256 kernels and no inference recurrence
    cfg = PipelineConfig()
    cfg.inference.batch_size = SCAN_HAP_SITES
    run("s5 default card", lambda: stages.stage_haplotype_predict(
        cfg, ref, hap_dir, os.path.join(WORK, "s5_default.csv"), hparams,
        device=dev), True)
    expect("s5 default card", ("bilstm_inproj", "bilstm_cluster"))
    for k, v in rows.items():
        log(f"[{k}] " + json.dumps(v))
    shutil.rmtree(WORK, ignore_errors=True)
    return launches, rows


def _legacy_tag_arrays(rng, centers, bases, contig):
    """legacy_group_arrays' output for one HP tag: per group a ragged-depth
    het read matrix mostly agreeing with the tag's base at the site, an
    11-mer surrounding matrix, qualities, and the edge/pair-route counts."""
    import numpy as np

    from nanosnp_tpu_torch.legacy.edges import (edge_transition_counts,
                                                pair_route_counts)

    n, depth = len(centers), 14
    keep = rng.integers(6, depth + 1, n)
    live = np.arange(depth)[None, :, None] < keep[:, None, None]

    def reads(consensus, agree):
        r = np.where(rng.random((n, depth, 11)) < agree, consensus,
                     rng.integers(-1, 5, (n, depth, 11)))
        return np.where(live, r, -2).astype(np.int32)

    def quals(hi):
        return np.where(live, rng.integers(0, hi, (n, depth, 11)),
                        -2).astype(np.int32)

    het = reads(bases[:, None, None], 0.85)
    sur = reads(rng.integers(1, 5, (n, 1, 11)), 0.9)
    group_pos = centers[:, None] + 9 * np.arange(-5, 6)[None, :]
    out = {"position": [f"{contig}:{c}" for c in centers],
           "group_positions": [np.array([f"{contig}:{p}" for p in g])
                               for g in group_pos],
           "edge_matrix": [edge_transition_counts(m[:k])
                           for m, k in zip(het, keep)],
           "pair_route": [pair_route_counts(m[:k])
                          for m, k in zip(het, keep)]}
    for key, m in (("", het), ("surrounding_", sur)):
        out[f"{key}read_matrix"] = [a[:k] for a, k in zip(m, keep)]
        out[f"{key}base_quality_matrix"] = [a[:k] for a, k in
                                            zip(quals(40), keep)]
        out[f"{key}mapping_quality_matrix"] = [a[:k] for a, k in
                                               zip(quals(60), keep)]
    return out


def phase_legacy(dev):
    """Phase 2c: the legacy CatModel at full width on the card, through
    legacy-predict, legacy-eval and legacy-train."""
    import numpy as np
    import torch

    from nanosnp_tpu_torch import constants as C
    from nanosnp_tpu_torch.io.fasta import write_fasta
    from nanosnp_tpu_torch.legacy.bins import load_legacy_bin, save_legacy_bin
    from nanosnp_tpu_torch.legacy.catmodel import (CatModel, build_g_images,
                                                   catmodel_predict,
                                                   init_catmodel_params)
    from nanosnp_tpu_torch.models.convert import (load_params_npz,
                                                  save_params_npz)
    from nanosnp_tpu_torch.ops import bilstm as K
    from nanosnp_tpu_torch.runtime import cli

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    rng = np.random.default_rng(SEED + 5)
    t0 = time.monotonic()
    contig, n = "chr20", LEGACY_GROUPS
    length = 120 * n + 1000
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, length)]
    write_fasta(os.path.join(WORK, "ref.fa"), {contig: seq.tobytes().decode()})
    centers = 200 + 120 * np.arange(n) + rng.integers(0, 60, n)
    ref_code = np.searchsorted(np.frombuffer(b"ACGT", np.uint8),
                               seq[centers - 1]) + 1
    variant = rng.random(n) < 0.4
    alt_code = (ref_code - 1 + rng.integers(1, 4, n)) % 4 + 1
    het = rng.random(n) < 0.6
    # tag 1 carries the alt at every variant, tag 2 only at homozygous ones
    tag_bases = (np.where(variant, alt_code, ref_code),
                 np.where(variant & ~het, alt_code, ref_code))
    dirs = {}
    for tag, bases in zip(("tag1", "tag2"), tag_bases):
        arrays = _legacy_tag_arrays(rng, centers, bases, contig)
        # numpy archives: the same datasets as the HDF5 bins, without h5py
        for name, count in (("", n), ("train_", LEGACY_TRAIN_GROUPS)):
            dirs[name + tag] = os.path.join(WORK, name + tag)
            os.makedirs(dirs[name + tag])
            save_legacy_bin(os.path.join(dirs[name + tag], f"{contig}.npz"),
                            {k: v[:count] for k, v in arrays.items()})
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS"]
    for c, r, a, h in zip(centers[variant], ref_code[variant],
                          alt_code[variant], het[variant]):
        lines.append(f"{contig}\t{c}\t.\t{'ACGT'[r - 1]}\t{'ACGT'[a - 1]}\t50"
                     f"\tPASS\t.\tGT\t{'0/1' if h else '1/1'}")
    with open(os.path.join(WORK, "truth.vcf"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(WORK, "conf.bed"), "w") as f:
        f.write(f"{contig}\t0\t{length}\n")
    params = init_catmodel_params(torch.Generator().manual_seed(SEED))
    model_path = os.path.join(WORK, "cat.npz")
    save_params_npz(model_path, params)
    log(f"[data]  legacy world: {n} groups in two tags, "
        f"{int(variant.sum())} truth variants ({time.monotonic() - t0:.1f} s)")

    truth = ["--ref", os.path.join(WORK, "ref.fa"), "--truth-vcf",
             os.path.join(WORK, "truth.vcf"), "--bed",
             os.path.join(WORK, "conf.bed")]

    def tags(prefix=""):
        return ["--data-tag1", dirs[prefix + "tag1"], "--data-tag2",
                dirs[prefix + "tag2"]]

    launches, rows = {}, {}
    runs = (
        ("legacy-predict", [*tags(), "--model", model_path, "--batch-size",
                            str(N_TIME)], "legacy_calls.tsv"),
        ("legacy-eval", [*tags(), *truth, "--model", model_path,
                         "--batch-size", str(N_TIME)], "legacy_eval.tsv"),
        ("legacy-train", [*tags("train_"), *truth, "--epochs", "2",
                          "--batch-size", "64"], "catmodel.npz"))
    for name, argv, product in runs:
        out = os.path.join(WORK, "out_" + name)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.monotonic()
        if cli.main([name, *argv, "-o", out]) != 0:
            raise AssertionError(f"{name} failed")
        torch.cuda.synchronize()
        dt = time.monotonic() - t
        launches[name] = dict(K.LAUNCHES)
        log(f"[{name}] {dt:.3f} s, launches {launches[name]}")
        rows[name] = dict(seconds=dt)
        if not os.path.exists(os.path.join(out, product)):
            raise AssertionError(f"{name}: no {product}")
    for name in ("legacy-predict", "legacy-eval"):
        if launches[name]["lstm_recurrence_infer"] <= 0 or launches[name][
                "lstm_recurrence_train"]:
            raise AssertionError(f"{name}: wrong recurrence kernel: "
                                 f"{launches[name]}")
    # the CatModel trainer: five BiLSTM layers a step on the training
    # kernels, the percentage stack's dropout included
    if any(launches["legacy-train"].get(k, 0) <= 0 for k in (
            "lstm_recurrence_train", "lstm_recurrence_bwd",
            "lstm_dw_reduce")):
        raise AssertionError("legacy-train: no training kernel launched: "
                             f"{launches['legacy-train']}")

    calls = _body(os.path.join(WORK, "out_legacy-predict",
                               "legacy_calls.tsv"))
    if len(calls) != n or any(
            len(r) != 4 or r[2] not in C.GT21_LABELS[:10]
            or not math.isfinite(float(r[3])) for r in calls):
        raise AssertionError(f"legacy_calls.tsv wrong: {len(calls)} rows")
    rows["legacy-predict"].update(
        sites=n, sites_per_s=n / rows["legacy-predict"]["seconds"])
    evals = _body(os.path.join(WORK, "out_legacy-eval", "legacy_eval.tsv"))
    if not evals or any(len(r) != 6 or (r[5] == "-") != (r[2] == r[3])
                        for r in evals):
        raise AssertionError("legacy_eval.tsv wrong")
    rows["legacy-eval"].update(
        sites=len(evals), sites_per_s=len(evals) / rows["legacy-eval"][
            "seconds"], accuracy=sum(r[5] == "-" for r in evals) / len(evals))
    trained = load_params_npz(os.path.join(WORK, "out_legacy-train",
                                           "catmodel.npz"))
    flat_ok = all(bool(torch.isfinite(t).all()) for t in (
        trained["out"]["w"], trained["res_blocks"][5]["conv2"],
        trained["percentage_rnn"][2]["w_hh"],
        trained["res_blocks"][0]["bn1"]["var"]))
    if not flat_ok or bool((trained["res_blocks"][0]["bn1"]["mean"]
                            == 0).all()):
        raise AssertionError("legacy-train: bad trained parameters")
    for k, v in rows.items():
        log(f"[{k}] " + json.dumps(v))

    # the model on the card (inference kernel) against the kernel path's
    # plain version on the CPU, on a small input
    b1 = load_legacy_bin(os.path.join(dirs["train_tag1"], f"{contig}.npz"))
    b2 = load_legacy_bin(os.path.join(dirs["train_tag2"], f"{contig}.npz"))
    idx = np.arange(256)
    imgs = [torch.from_numpy(build_g_images(
        *[cli._legacy_tag_slices(b, idx, 20, key) for b in (b1, b2)],
        20).astype(np.float32)) for key in ("surrounding_", "")]
    model = CatModel(params)
    with torch.inference_mode():
        want = catmodel_predict(model, *imgs, use_kernels=True)
        want_logits = model(*imgs, use_kernels=True)
        model.to(dev)
        on_card = [g.to(dev) for g in imgs]
        got = catmodel_predict(model, *on_card).cpu()
        got_logits = model(*on_card, use_kernels=True).cpu()
    err = (got - want).abs().max().item()
    # seeded weights give flat probabilities: hold the logits too, over
    # their largest value
    rel = _errs(got_logits, want_logits)[1]
    agree = (got.argmax(1) == want.argmax(1)).float().mean().item()
    log(f"[check] CatModel: card vs CPU max|dp|={err:.3e} (tol {PROB_TOL}), "
        f"logits max|d| over max(1, max|want|) {rel:.3e} (tol {PROB_TOL}), "
        f"argmax agreement {agree:.5f}")
    if not (bool(got.isfinite().all()) and err <= PROB_TOL
            and rel <= PROB_TOL and agree >= 0.99):
        raise AssertionError("CatModel: card disagrees with CPU")

    # one warm predict batch on the card, apart from the CLI's loading,
    # image building and writing
    big = [g.repeat(N_TIME // len(idx), 1, 1, 1) for g in on_card]
    ms = cuda_time(lambda: catmodel_predict(model, *big), 3)
    rows["legacy-predict"].update(batch_ms=ms,
                                  batch_sites_per_s=N_TIME / ms * 1e3)
    log(f"[time]  CatModel predict, one warm batch of {N_TIME}: {ms:.2f} ms "
        f"({N_TIME / ms * 1e3:.0f} sites/s)")
    shutil.rmtree(WORK, ignore_errors=True)
    return launches, rows


def _pileup_train_arrays(rng, n):
    """Labeled pileup windows in the make-train-data layout: signed counts
    (reference-matching reads negative), 90-dim one-hot labels."""
    import numpy as np

    from nanosnp_tpu_torch.train import data as D

    matrix = rng.integers(-30, 30, (n, 33, 18)).astype(np.int32)
    label = np.zeros((n, 90), np.int32)
    label[np.arange(n), rng.integers(0, 21, n)] = 1
    label[np.arange(n), 21 + rng.integers(0, 3, n)] = 1
    label[np.arange(n), 24 + 16] = 1
    label[np.arange(n), 57 + 16] = 1
    return D.PileupTrainArrays(matrix, label, np.arange(n, dtype=np.int64),
                               label[:, 22:24].any(1))


def _haplotype_train_world(rng, work, sites=HAP_TRAIN_SITES):
    """A reference contig, haplotype shards of `sites` sites in each of
    the depth buckets 64 and 96, a truth VCF with SNPs at about 40% of the
    sites, a BED over the contig."""
    import numpy as np

    from nanosnp_tpu_torch.io import bins
    from nanosnp_tpu_torch.io.fasta import write_fasta

    length = 400_000
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, length)]
    write_fasta(os.path.join(work, "ref.fa"), {"chr1": seq.tobytes().decode()})
    shard_dir = os.path.join(work, "hap_train_shards")
    os.makedirs(shard_dir)
    pos = np.sort(rng.choice(np.arange(200, length - 200), 2 * sites,
                             replace=False)).astype(np.int64)
    for i, depth in enumerate((64, 96)):
        centers = pos[i::2]
        n = len(centers)
        bins.save_haplotype_shard(
            os.path.join(shard_dir, f"chr1_d{depth}x{depth}.npz"),
            bins.HaplotypeShard(
                contig="chr1", candidate_positions=centers,
                group_positions=centers[:, None]
                + np.arange(-5, 6)[None, :] * 7,
                pileup=_read_matrices(rng, n, depth, 33, 0),
                haplotype=_read_matrices(rng, n, depth, 11, 0)))
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS"]
    for p in pos[rng.random(len(pos)) < 0.4]:
        ref_b = chr(seq[p - 1])
        alt = "ACGT"[("ACGT".index(ref_b) + 1) % 4]
        gt = "0|1" if rng.random() < 0.6 else "1|1"
        lines.append(f"chr1\t{p}\t.\t{ref_b}\t{alt}\t50\tPASS\t.\tGT\t{gt}")
    with open(os.path.join(work, "truth.vcf"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(work, "conf.bed"), "w") as f:
        f.write(f"chr1\t0\t{length}\n")
    return shard_dir


def _train_records(run_dir, epochs=2):
    """The scalars of a training run: a train and a val record an epoch."""
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if len(recs) != 2 * epochs or not all(math.isfinite(r["loss"]) for r in recs):
        raise AssertionError(f"{run_dir}: bad scalars {recs}")
    for name in ("best.ckpt", "last.ckpt"):
        if not os.path.exists(os.path.join(run_dir, name)):
            raise AssertionError(f"{run_dir}: no {name}")
    return recs


def _evaluate(name, argv, report, kernels):
    """An evaluate-* command through the CLI on the card: launch counts,
    wall seconds and sites/s, its report. Each kernel in `kernels` must
    have been launched, and no other."""
    import torch

    from nanosnp_tpu_torch.ops import bilstm as K
    from nanosnp_tpu_torch.runtime import cli

    K.reset_launch_counts()
    t = time.monotonic()
    if cli.main(argv) != 0:
        raise AssertionError(f"{name} failed")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    dt = time.monotonic() - t
    counts = dict(K.LAUNCHES)
    with open(os.path.join(argv[argv.index("-o") + 1], report)) as f:
        rep = json.load(f)
    row = dict(seconds=dt, sites=rep["n"], sites_per_s=rep["n"] / dt,
               report=rep)
    log(f"[{name}] {dt:.3f} s, launches {counts}")
    log(f"[{name}] " + json.dumps(row))
    for k in kernels:
        if counts[k] <= 0:
            raise AssertionError(f"{name}: {k} was never launched")
    others = {k for k, v in counts.items() if v} - set(kernels)
    if others:
        raise AssertionError(f"{name}: launched {sorted(others)} too")
    if not rep["n"] > 0:
        raise AssertionError(f"{name}: scored no site")
    return row, counts


def check_agreement(label, got, want):
    """The (gt, zy) argmax decisions of an evaluate-* command's batches on
    the card against the same batches on the CPU: the labels must be the
    same, and at least AGREE_MIN of the decisions."""
    import numpy as np

    out = {}
    for i, head in ((0, "gt"), (1, "zy")):
        g = np.concatenate([b[i] for b in got])
        w = np.concatenate([b[i] for b in want])
        if g.shape != w.shape or not np.isfinite(g).all():
            raise AssertionError(f"{label} {head}: bad output {g.shape}")
        out[head] = float((g.argmax(1) == w.argmax(1)).mean())
    for i in (2, 3):
        if not np.array_equal(np.concatenate([b[i] for b in got]),
                              np.concatenate([b[i] for b in want])):
            raise AssertionError(f"{label}: the labels differ")
    out["sites"] = int(sum(len(b[0]) for b in got))
    log(f"[check] {label}: card vs CPU argmax agreement gt {out['gt']:.5f}, "
        f"zy {out['zy']:.5f} over {out['sites']} sites (min {AGREE_MIN})")
    if min(out["gt"], out["zy"]) < AGREE_MIN:
        raise AssertionError(f"{label}: card disagrees with the CPU")
    return out


def phase_train(dev):
    """Phase 3: train-pileup and train-haplotype through the CLI at full
    model width on the card, then one full-width pileup training step's
    gradients on the card against the plain versions on the CPU, then the
    steady-state step profile."""
    import numpy as np
    import torch

    from nanosnp_tpu_torch.config import (HaplotypeModelConfig,
                                          PileupModelConfig, PipelineConfig,
                                          TrainConfig)
    from nanosnp_tpu_torch.io.bins import list_shards
    from nanosnp_tpu_torch.io.fasta import FastaReference
    from nanosnp_tpu_torch.models.convert import flatten_tree
    from nanosnp_tpu_torch.models.pileup_model import (PileupModel,
                                                       init_pileup_params,
                                                       pileup_predict)
    from nanosnp_tpu_torch.ops import bilstm as K
    from nanosnp_tpu_torch.runtime import evaluate as E
    from nanosnp_tpu_torch.train import data as D
    from nanosnp_tpu_torch.train.losses import label_smoothing_loss
    from nanosnp_tpu_torch.train.train_pileup import load_checkpoint

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    rng = np.random.default_rng(SEED + 3)
    t0 = time.monotonic()
    data_dir = os.path.join(WORK, "pileup_train_data")
    os.makedirs(data_dir)
    arrays = _pileup_train_arrays(rng, PILEUP_TRAIN_ROWS)
    D.save_train_arrays(os.path.join(data_dir, "chr1.npz"), arrays)
    hap_shards = _haplotype_train_world(rng, WORK)
    log(f"[data]  training worlds: {PILEUP_TRAIN_ROWS} pileup rows, "
        f"{2 * HAP_TRAIN_SITES} haplotype sites "
        f"({time.monotonic() - t0:.1f} s)")

    out = os.path.join(WORK, "out")
    launches, rows = {}, {}
    # recurrence calls a training step: the pileup encoder's layers, both
    # haplotype branches' layers
    layers = {"train-pileup": PileupModelConfig().n_layers,
              "train-haplotype": 2 * HaplotypeModelConfig().lstm_layers}
    for name, argv, batch in (
            ("train-pileup", ["train-pileup", "--data", data_dir,
                              "--batch-size", "2000"], 2000),
            ("train-haplotype", ["train-haplotype", "--shards", hap_shards,
                                 "--ref", os.path.join(WORK, "ref.fa"),
                                 "--truth-vcf", os.path.join(WORK,
                                                             "truth.vcf"),
                                 "--bed", os.path.join(WORK, "conf.bed"),
                                 "--batch-size", "512"], 512)):
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.monotonic()
        groups = _cli_train(argv + ["--epochs", "2", "--val-fraction", "0.1",
                                    "-o", out])
        torch.cuda.synchronize()
        dt = time.monotonic() - t
        launches[name] = dict(K.LAUNCHES)
        recs = _train_records(os.path.join(
            out, name.replace("train-", "") + "_train"))
        steps = recs[-1]["step"]
        rows[name] = dict(steps=steps, batch=batch, seconds=dt,
                          steps_per_s=steps / dt,
                          sites_per_s=steps * batch / dt,
                          final_train_loss=recs[-2]["loss"],
                          final_val_loss=recs[-1]["loss"], groups=groups)
        log(f"[{name}] {dt:.3f} s, {steps} steps, launches {launches[name]}")
        log(f"[{name}] " + json.dumps(rows[name]))
        # H=64 sums dW inside the sweep; H=256 runs the separate dW kernel.
        # Full groups replay one graph a batch shape (two depth buckets)
        _check_groups(name, groups, launches[name], layers[name],
                      name == "train-haplotype",
                      1 if name == "train-pileup" else 2)

    # evaluate-haplotype on the training world's shards, with the shipped
    # v6b weights and with the checkpoint just trained
    ev_args = ["evaluate-haplotype", "--shards", hap_shards, "--ref",
               os.path.join(WORK, "ref.fa"), "--truth-vcf",
               os.path.join(WORK, "truth.vcf"), "--bed",
               os.path.join(WORK, "conf.bed")]
    for name, model in (("evaluate-haplotype v6b", V6B),
                        ("evaluate-haplotype trained", os.path.join(
                            out, "haplotype_train", "last.ckpt"))):
        rows[name], launches[name] = _evaluate(
            name, ev_args + ["--model", model, "-o", os.path.join(
                WORK, name.replace(" ", "_"))], "evaluate_haplotype.json",
            ("lstm_recurrence_infer_f32",))
    # card against CPU, the first shard: the command's own batches
    ref = FastaReference(os.path.join(WORK, "ref.fa"))
    truth = E.truth_arrays(ref, os.path.join(WORK, "truth.vcf"),
                           os.path.join(WORK, "conf.bed"))
    first = list_shards(hap_shards)[:1]
    rows["evaluate-haplotype v6b"]["card_vs_cpu"] = check_agreement(
        "evaluate-haplotype v6b, first shard", *[
            list(E.haplotype_scores(PipelineConfig(), V6B, first, ref, truth,
                                    512, d))
            for d in (dev, torch.device("cpu"))])

    # the reference's own optimizers, two epochs each (the second replays
    # the graphs the first captured): Ranger for the pileup model,
    # Ranger21 for the haplotype model
    for name, argv, batch, opt in (
            ("train-pileup ranger", ["train-pileup", "--data", data_dir,
                                     "--batch-size", "2000"], 2000, "ranger"),
            ("train-haplotype ranger21", [
                "train-haplotype", "--shards", hap_shards, "--ref",
                os.path.join(WORK, "ref.fa"), "--truth-vcf",
                os.path.join(WORK, "truth.vcf"), "--bed",
                os.path.join(WORK, "conf.bed"), "--batch-size", "512"], 512,
             "ranger21")):
        yaml = os.path.join(WORK, f"{opt}.yaml")
        with open(yaml, "w") as f:
            f.write(f"train:\n  optim:\n    type: {opt}\n")
        run_out = os.path.join(WORK, opt)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.monotonic()
        groups = _cli_train(argv + ["--config", yaml, "--epochs", "2",
                                    "--val-fraction", "0.1", "-o", run_out])
        torch.cuda.synchronize()
        dt = time.monotonic() - t
        launches[name] = dict(K.LAUNCHES)
        base = name.split()[0]
        recs = _train_records(os.path.join(
            run_out, base.replace("train-", "") + "_train"))
        steps = recs[-1]["step"]
        rows[name] = dict(optimizer=opt, epochs=2, steps=steps, batch=batch,
                          seconds=dt, steps_per_s=steps / dt,
                          lookahead_adam_steps_per_s=rows[base][
                              "steps_per_s"],
                          final_train_loss=recs[-2]["loss"],
                          final_val_loss=recs[-1]["loss"], groups=groups)
        log(f"[{name}] {dt:.3f} s, {steps} steps, launches {launches[name]}")
        log(f"[{name}] " + json.dumps(rows[name]))
        _check_groups(name, groups, launches[name], layers[base],
                      opt == "ranger21", 1 if opt == "ranger" else 2)

    # the trained pileup checkpoint loads into the port's model and predicts
    params, _ = load_checkpoint(os.path.join(out, "pileup_train",
                                             "best.ckpt"))
    with torch.inference_mode():
        probs = pileup_predict(
            PileupModel(PileupModelConfig(), params).to(dev),
            torch.from_numpy(arrays.matrix[:4096].astype(np.float32)).to(dev),
            torch.bfloat16)
    if not all(bool(p.isfinite().all()) and abs(
            p.sum(1).mean().item() - 1) < 1e-3 for p in probs):
        raise AssertionError("trained pileup model: bad probabilities")

    # one full-width training step's gradients: card (kernels) against the
    # CPU (the kernels' plain versions, same cast sites)
    mcfg = PileupModelConfig(dropout=0.0)
    init = init_pileup_params(torch.Generator().manual_seed(SEED), mcfg)
    idx = np.arange(GRAD_N)
    batch = [torch.from_numpy(a) for a in (
        arrays.matrix[idx].astype(np.float32),
        arrays.label[idx, :21].argmax(1), arrays.label[idx, 21:24].argmax(1))]
    smoothing = TrainConfig().optim.label_smoothing
    grads = []
    for d in (dev, torch.device("cpu")):
        model = PileupModel(mcfg, init).to(d)
        x, gt, zy = (t.to(d) for t in batch)
        g_logits, z_logits = model.forward_train(x, use_kernels=True)
        loss = (label_smoothing_loss(g_logits, gt, smoothing)
                + label_smoothing_loss(z_logits, zy, smoothing))
        flat = flatten_tree(model.tree())
        grads.append([(path, g.cpu()) for (path, _), g in zip(
            flat, torch.autograd.grad(loss, [p for _, p in flat],
                                      allow_unused=True,
                                      materialize_grads=True))])
    worst = 0.0
    for (path, g), (_, w) in zip(*grads):
        if path[0] in ("id1", "id2"):
            continue
        worst = max(worst, (g - w).abs().max().item()
                    / max(w.abs().max().item(), 1e-12))
    log(f"[check] full-width pileup step gradients, card vs CPU, N={GRAD_N}:"
        f" worst max|d|/max|want| over leaves {worst:.3e} (tol {GRAD_TOL})")
    if not worst <= GRAD_TOL:
        raise AssertionError(f"card gradients disagree: {worst}")
    rows["graph replay"] = check_graph_replay(dev, arrays, rng)
    profile = profile_train_steps(dev, arrays, rng)
    log(json.dumps({"train_profile": profile}))
    shutil.rmtree(WORK, ignore_errors=True)
    return launches, rows


def _probe_alone(P, K, x, w_ih, w_hh, b):
    """{label: callable} launching each probe mode, and `bilstm_stream`,
    alone through their C entry points at x's shape: the plan, the packed
    weights and the outputs made beforehand."""
    import torch

    from nanosnp_tpu_torch.ops.build import library

    n, seq_len, d_in = x.shape
    hidden = w_hh.shape[1]
    plan = P.probe_plan(n, seq_len, d_in, hidden)
    wpk = K.pack_weights(w_ih, w_hh)
    outs = [torch.empty(n, seq_len, 2 * hidden, dtype=torch.bfloat16,
                        device=x.device) for _ in range(2)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    common = (n, seq_len, plan.d_x, hidden, plan.bn, plan.smem, plan.grid[0])
    alone = {mode: (lambda m=i: library("bilstm_probe").nsp_bilstm_probe(
        x.data_ptr(), wpk.data_ptr(), b.data_ptr(), outs[0].data_ptr(),
        *common, m, stream)) for i, mode in enumerate(P.MODES)}
    alone["bilstm_stream"] = lambda: library("bilstm").nsp_bilstm_stream(
        x.data_ptr(), wpk.data_ptr(), b.data_ptr(), outs[1].data_ptr(), 0,
        *common, stream)
    for label, fn in alone.items():
        if fn() != 0:
            raise AssertionError(f"{label}: a launch of the kernel alone "
                                 "failed")
    return alone


def phase_probe(dev):
    """Phase 1d: the probe's `full` mode against `bilstm_stream`, bit for
    bit, at N_PROBE_EQUAL; its four modes against `probe_plain`; their
    times alone and through the wrapper and the three shares; `full` and
    `bilstm_stream` alone in turns; the probe's entry point."""
    import torch

    from nanosnp_tpu_torch.ops import bilstm as K
    from nanosnp_tpu_torch.ops import probe as P

    seq_len, d_in, hidden = 33, 18, 64
    # full is bilstm_stream's code on bilstm_stream's plan: the same bits
    # at every tile the plans take (N=8191 and 8192 both take 64 rows)
    for n in N_PROBE_EQUAL:
        x, w_ih, w_hh, b = P.probe_inputs(n, dev, seq_len, d_in, hidden,
                                          seed=SEED + n)
        got = P.bilstm_probe(x, w_ih, w_hh, b, "full")
        want = K.bilstm_stream(x, w_ih, w_hh, b, torch.bfloat16)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        log(f"[check] bilstm_probe   full against bilstm_stream N={n} "
            f"(plan bn {P.probe_plan(n, seq_len, d_in, hidden).bn}): the "
            f"same bits: {same}")
        if not same:
            raise AssertionError(f"probe mode full differs from "
                                 f"bilstm_stream at N={n}")
    x, w_ih, w_hh, b = P.probe_inputs(N_TIME, dev, seq_len, d_in, hidden,
                                      seed=SEED)
    errs = {}
    for mode in P.MODES:
        got = P.bilstm_probe(x, w_ih, w_hh, b, mode)
        torch.cuda.synchronize()
        errs[mode] = _errs(got, P.probe_plain(x, w_ih, w_hh, b, mode))[0]
        log(f"[check] bilstm_probe   {mode:7s} N={N_TIME} L={seq_len} "
            f"D={d_in} H={hidden}: max|d|={errs[mode]:.3e} (tol {PROBE_TOL})")
        if not errs[mode] <= PROBE_TOL:
            raise AssertionError(f"bilstm_probe {mode}: max|d| {errs[mode]} "
                                 f"> {PROBE_TOL}")
    # the kernels alone, and full against bilstm_stream in turns: full,
    # stream, stream, full (the same code: their gap is the noise)
    alone = _probe_alone(P, K, x, w_ih, w_hh, b)
    ms = {m: cuda_time(alone[m], PROBE_ITERS) for m in P.MODES}
    turns = [cuda_time(alone[k], PROBE_ITERS) for k in
             ("full", "bilstm_stream", "bilstm_stream", "full")]
    in_turns = {"probe_full_ms": (turns[0] + turns[3]) / 2,
                "bilstm_stream_ms": (turns[1] + turns[2]) / 2,
                "turns_ms": turns}
    log(f"[time]  (33, 18, 64) in turns, kernels alone: probe full "
        f"{in_turns['probe_full_ms']:.4f} ms, bilstm_stream "
        f"{in_turns['bilstm_stream_ms']:.4f} ms {json.dumps(turns)}")
    wrapper_ms = P.time_modes(x, w_ih, w_hh, b, PROBE_ITERS)
    plain_ms = {m: cuda_time(lambda: P.probe_plain(x, w_ih, w_hh, b, m), 2)
                for m in P.MODES}
    lstm = torch.nn.LSTM(d_in, hidden, batch_first=True, bidirectional=True,
                         device=dev, dtype=torch.bfloat16)
    with torch.inference_mode():
        library_ms = cuda_time(lambda: lstm(x), 5)
    flop, nbytes = K.layer_cost(N_TIME, seq_len, d_in, hidden, center=False)
    x_bytes = N_TIME * seq_len * d_in * 2
    # what a mode leaves out of the work: nomm the W_hh products, nodma all
    # of x but the one slab a direction stages
    cost = {"full": (flop, nbytes), "nogate": (flop, nbytes),
            "nomm": (flop * d_in // (d_in + hidden), nbytes),
            "nodma": (flop, nbytes - x_bytes + 2 * N_TIME * d_in * 2)}
    rows = []
    for mode in P.MODES:
        t_ops = cost[mode][0] / PEAK_BF16_FLOPS * 1e3
        t_bytes = cost[mode][1] / PEAK_BYTES * 1e3
        rows.append(dict(
            name="bilstm_probe", shape=mode, L=seq_len, D=d_in, H=hidden,
            max_abs_err=errs[mode], ms=ms[mode], wrapper_ms=wrapper_ms[mode],
            plain_ms=plain_ms[mode],
            # cuDNN computes the full layer only
            library_ms=library_ms if mode == "full" else None,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes"))
        log(f"[time]  bilstm_probe   {mode:7s} N={N_TIME}: alone "
            f"{ms[mode]:.4f} ms, wrapper {wrapper_ms[mode]:.4f} ms, plain "
            f"{plain_ms[mode]:.3f} ms, bound {rows[-1]['bound_ms']:.4f} ms "
            f"({rows[-1]['bound_by']})")
    log(json.dumps({"probe": {"N": N_TIME, "iters": PROBE_ITERS, "ms": ms,
                              "wrapper_ms": wrapper_ms,
                              "shares": P.shares(ms),
                              "wrapper_shares": P.shares(wrapper_ms),
                              "in_turns": in_turns}}))

    # the entry point a user calls; its launches are the path's count
    K.reset_launch_counts()
    if P.main([str(N_TIME), str(PROBE_ITERS)]) != 0:
        raise AssertionError("the probe's entry point failed")
    torch.cuda.synchronize()
    return rows, {"probe": dict(K.LAUNCHES)}


def probe_kernel_times(dev):
    """The probe's four modes and `bilstm_stream` through their wrappers
    (weights packed once) at N_TIME, in the package on sys.path, and the
    shares. One process a tree: `python3 chip_smoke.py --probe-times
    TREE`."""
    import torch

    from nanosnp_tpu_torch.ops import bilstm as K
    from nanosnp_tpu_torch.ops import build
    from nanosnp_tpu_torch.ops import probe as P

    build.build_all()
    x, w_ih, w_hh, b = P.probe_inputs(N_TIME, dev, seed=SEED)
    row = P.time_modes(x, w_ih, w_hh, b, PROBE_ITERS)
    packed = K.pack_weights(w_ih, w_hh)
    row["bilstm_stream"] = cuda_time(lambda: K.bilstm_stream(
        x, w_ih, w_hh, b, torch.bfloat16, packed), PROBE_ITERS)
    row["shares"] = P.shares(row)
    log("[probe-times] " + json.dumps(row))
    return row


def _call_world(rng, work):
    """A diploid world for `call`: a training and a calling contig with
    phased het and hom SNVs, reads of both haplotypes as one untagged,
    position-sorted BAM of all-match records (built as one numpy array: the
    records have one size), truth VCF and confident-region BED.
    -> (paths, {contig: [DiploidTruth]})."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from bamgen import BGZF_EOF, bgzf_block
    from diploid import make_diploid, truth_vcf_lines

    from nanosnp_tpu_torch.io.fasta import write_fasta

    t0 = time.monotonic()
    acgt = np.frombuffer(b"ACGT", np.uint8)
    contigs = {"chrT": CALL_TRAIN_LEN, "chrC": CALL_LEN}
    genome, truth, records = {}, {}, []
    name_w = 9                      # "r" + 8 digits, then the NUL
    head = np.dtype([
        ("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
        ("l_name", "u1"), ("mapq", "u1"), ("bin", "<u2"), ("n_cigar", "<u2"),
        ("flag", "<u2"), ("l_seq", "<i4"), ("next_ref", "<i4"),
        ("next_pos", "<i4"), ("tlen", "<i4"), ("name", f"S{name_w + 1}"),
        ("cigar", "<u4")])
    rl = CALL_READ_LEN
    rec_len = head.itemsize + rl // 2 + rl
    for ref_id, (name, length) in enumerate(contigs.items()):
        seq = acgt[rng.integers(0, 4, length)].tobytes().decode()
        genome[name] = seq
        truth[name], h1, h2 = make_diploid(
            rng, seq, n_het=length // 150, n_hom=length // 450, spacing=60)
        haps = np.stack([np.searchsorted(acgt, np.frombuffer(
            h.encode(), np.uint8)) for h in (h1, h2)]).astype(np.uint8)
        n = length * CALL_COVERAGE // rl
        start = np.sort(rng.integers(0, length - rl, n, dtype=np.int32))
        idx = start[:, None] + np.arange(rl, dtype=np.int32)[None, :]
        bases = haps[rng.integers(0, 2, n)[:, None], idx]
        wrong = rng.random(bases.shape, dtype=np.float32) < CALL_READ_ERR
        bases[wrong] = rng.integers(0, 4, int(wrong.sum()), dtype=np.uint8)
        nib = (1 << bases).astype(np.uint8)        # A C G T -> 1 2 4 8
        rec = np.zeros((n, rec_len), np.uint8)
        h = rec[:, :head.itemsize].view(head).reshape(n)
        h["block_size"] = rec_len - 4
        h["ref_id"], h["pos"] = ref_id, start
        h["l_name"], h["mapq"] = name_w + 1, rng.integers(30, 60, n)
        h["bin"], h["n_cigar"], h["l_seq"] = 4680, 1, rl
        h["flag"] = np.where(rng.random(n) < 0.5, 16, 0)
        h["next_ref"], h["next_pos"] = -1, -1
        h["name"] = [b"r%08d" % (ref_id * 10_000_000 + i) for i in range(n)]
        h["cigar"] = rl << 4                       # rl M
        rec[:, head.itemsize:head.itemsize + rl // 2] = \
            (nib[:, 0::2] << 4) | nib[:, 1::2]
        rec[:, head.itemsize + rl // 2:] = rng.integers(
            15, 40, (n, rl), dtype=np.uint8)
        records.append(rec.tobytes())
    paths = {k: os.path.join(work, v) for k, v in (
        ("ref", "ref.fa"), ("bam", "sample.bam"), ("truth", "truth.vcf"),
        ("bed", "conf.bed"))}
    write_fasta(paths["ref"], genome)
    hdr = b"BAM\1" + (0).to_bytes(4, "little") \
        + len(contigs).to_bytes(4, "little")
    for name, length in contigs.items():
        nb = name.encode() + b"\0"
        hdr += len(nb).to_bytes(4, "little") + nb \
            + length.to_bytes(4, "little")
    payload = hdr + b"".join(records)
    # zlib releases the interpreter lock: deflate the blocks in threads
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as ex, \
            open(paths["bam"], "wb") as f:
        for block in ex.map(bgzf_block, (payload[i:i + 60000] for i in
                                         range(0, len(payload), 60000))):
            f.write(block)
        f.write(BGZF_EOF)
    lines = []
    for name in contigs:
        rows = truth_vcf_lines(name, truth[name])
        lines += rows if not lines else rows[2:]
    with open(paths["truth"], "w") as f:
        f.writelines(lines)
    with open(paths["bed"], "w") as f:
        f.writelines(f"{name}\t100\t{length - 100}\n"
                     for name, length in contigs.items())
    log(f"[data]  call world: contigs {contigs}, {CALL_COVERAGE}x reads of "
        f"{rl} bp at {CALL_READ_ERR} substitutions a base, BAM "
        f"{os.path.getsize(paths['bam']) / 1e6:.1f} MB "
        f"({time.monotonic() - t0:.1f} s)")
    return paths, truth


def _stage_markers(run_dir):
    """{stage: its .done record} of a `call` output; every stage must have
    written one."""
    out = {}
    for st in CALL_STAGES:
        path = os.path.join(run_dir, ".stages", f"{st}.done")
        if not os.path.exists(path):
            raise AssertionError(f"call: {st} wrote no .done marker")
        with open(path) as f:
            out[st] = dict(json.load(f), mtime_ns=os.stat(path).st_mtime_ns)
    return out


def phase_call(dev):
    """Phase 4: make-train-data -> train-pileup -> `call --phaser native`
    from a BAM, through the CLI on the card at full model width."""
    import numpy as np
    import torch

    from diploid import truth_vcf_lines
    from nanosnp_tpu_torch.config import PipelineConfig
    from nanosnp_tpu_torch.eval import evaluate_calls
    from nanosnp_tpu_torch.models.convert import pileup_checkpoint_from_params
    from nanosnp_tpu_torch.ops import bilstm as K
    from nanosnp_tpu_torch.runtime import cli
    from nanosnp_tpu_torch.runtime import evaluate as E
    from nanosnp_tpu_torch.train.train_pileup import load_checkpoint

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    rng = np.random.default_rng(SEED + 5)
    paths, truth = _call_world(rng, WORK)
    cfg = os.path.join(WORK, "cfg.yaml")
    with open(cfg, "w") as f:
        # label smoothing caps a fitted model's probabilities near 0.9,
        # QUAL 10: under the QUAL 16 that s3 asks of a het it phases
        f.write(f"train:\n  optim:\n    lr: {CALL_TRAIN_LR}\n"
                "    label_smoothing: 0.0\n")
    out = os.path.join(WORK, "out")
    # on the card the device is the CLI's default; a rehearsal on the CPU
    # names it
    dev_args = [] if dev.type == "cuda" else ["--device", "cpu"]
    rows, launches = {}, {}

    def timed(name, argv):
        K.reset_launch_counts()
        t = time.monotonic()
        if cli.main(argv) != 0:
            raise AssertionError(f"{name} failed")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.monotonic() - t
        launches[name] = dict(K.LAUNCHES)
        log(f"[{name}] {dt:.3f} s, launches {launches[name]}")
        return dt

    dt = timed("call: make-train-data", [
        "make-train-data", "--bam", paths["bam"], "--ref", paths["ref"],
        "--truth-vcf", paths["truth"], "--bed", paths["bed"], "--contigs",
        "chrT", "-o", out])
    with np.load(os.path.join(out, "train_data", "chrT.npz")) as z:
        n_rows, n_var = len(z["positions"]), int(z["is_variant"].sum())
    rows["call: make-train-data"] = dict(seconds=dt, rows=n_rows,
                                         variants=n_var)
    if n_var < len(truth["chrT"]) // 2:
        raise AssertionError(f"make-train-data labeled {n_var} variants of "
                             f"{len(truth['chrT'])}")
    dt = timed("call: train-pileup", [
        "train-pileup", "--config", cfg, "--data",
        os.path.join(out, "train_data"), "--epochs", str(CALL_TRAIN_EPOCHS),
        "--batch-size", str(CALL_TRAIN_BATCH), "--val-fraction", "0.1", "-o",
        out] + dev_args)
    recs = _train_records(os.path.join(out, "pileup_train"),
                          CALL_TRAIN_EPOCHS)
    rows["call: train-pileup"] = dict(
        seconds=dt, steps=recs[-1]["step"], batch=CALL_TRAIN_BATCH,
        final_train_loss=recs[-2]["loss"], final_val_loss=recs[-1]["loss"])
    params, _ = load_checkpoint(os.path.join(out, "pileup_train",
                                             "last.ckpt"))
    ckpt = os.path.join(WORK, "pileup.chkpt")
    torch.save(pileup_checkpoint_from_params(params), ckpt)

    run = os.path.join(WORK, "run")
    call = ["call", "--bam", paths["bam"], "--ref", paths["ref"],
            "--pileup-model", ckpt, "--haplotype-model", V6B, "--phaser",
            "native", "--contigs", "chrC"]
    wall = timed("call", call + ["-o", run] + dev_args)
    marks = _stage_markers(run)
    m = {st: marks[st]["metrics"] for st in CALL_STAGES}
    sec = {st: marks[st]["seconds"] for st in CALL_STAGES}
    for name in ("bilstm_stream", "bilstm_center", "bilstm_inproj",
                 "bilstm_cluster"):
        if launches["call"][name] <= 0:
            raise AssertionError(f"call never launched {name}")
    if m["s2_pileup_predict"]["sites"] < CALL_MIN_CANDIDATES:
        raise AssertionError(f"s2 saw {m['s2_pileup_predict']['sites']} "
                             f"candidates, under {CALL_MIN_CANDIDATES}")
    if not m["s3_phasing"]["phased_sites"] > 0:
        raise AssertionError(f"s3 phased nothing: {m['s3_phasing']}")
    if not m["s5_haplotype_predict"]["sites"] > 0:
        raise AssertionError(f"s5 saw no site: {m['s5_haplotype_predict']}")
    merged = _body(os.path.join(run, "merge.vcf"))
    if not merged or any(len(r) != 10 or r[0] != "chrC"
                         or not math.isfinite(float(r[5])) for r in merged):
        raise AssertionError("merge.vcf rows malformed or empty")

    # het SNPs against the world's truth (printed, not asserted): the
    # PASS het rows of merge.vcf scored by the port's eval.f1 on position
    # and alleles
    het_truth = [t for t in truth["chrC"] if not t.hom]

    def het_f1(merged):
        called = ["\t".join(r) + "\n" for r in merged
                  if r[6] == "PASS" and r[9].split(":")[0] in ("0/1", "1/0")]
        return called, evaluate_calls(called, truth_vcf_lines(
            "chrC", het_truth), genotype_aware=False, snv_only=False)

    called, f1 = het_f1(merged)
    if (f1.tp + f1.fp, f1.tp + f1.fn) != (len(called), len(het_truth)):
        raise AssertionError(f"eval.f1 counted {f1.summary()} of "
                             f"{len(called)} calls, {len(het_truth)} hets")
    # compare-failed on the hets the call missed: it keeps those inside
    # the confident BED (all of them are het in the truth)
    alt = {t.pos1: t.alt for t in het_truth}
    hit = {int(r[1]) for r in merged if r[6] == "PASS"
           and r[9].split(":")[0] in ("0/1", "1/0")
           and alt.get(int(r[1])) == r[4]}
    missed = [t.pos1 for t in het_truth if t.pos1 not in hit]
    if len(missed) != f1.fn:
        raise AssertionError(f"{len(missed)} missed hets, eval.f1 {f1.fn}")
    failed = os.path.join(WORK, "missed_hets.tsv")
    with open(failed, "w") as f:
        f.writelines(f"chrC\t{p}\tmissed\n" for p in missed)
    kept_path = os.path.join(WORK, "het_fn.tsv")
    dt = timed("compare-failed", [
        "compare-failed", "--failed", failed, "--ref", paths["ref"],
        "--truth-vcf", paths["truth"], "--bed", paths["bed"], "--out",
        kept_path])
    with open(kept_path) as f:
        kept = f.read().splitlines()
    rows["compare-failed"] = dict(seconds=dt, failed=len(missed),
                                  het_fn=len(kept))
    with open(paths["bed"]) as f:
        lo, hi = next((int(b), int(e)) for c, b, e in (
            line.split() for line in f) if c == "chrC")
    in_bed = [p for p in missed if lo < p <= hi]
    rows["compare-failed"]["in_bed"] = len(in_bed)
    if kept != [f"chrC\t{p}\tmissed" for p in in_bed]:
        raise AssertionError(f"compare-failed kept {len(kept)} of the "
                             f"{len(in_bed)} missed hets inside the BED")
    log("[compare-failed] " + json.dumps(rows["compare-failed"]))
    units = {"s1_pileup_features": ("candidates", m["s1_pileup_features"][
                 "candidates"]),
             "s2_pileup_predict": ("sites", m["s2_pileup_predict"]["sites"]),
             "s3_phasing": ("sites", m["s3_phasing"]["sites"]),
             "s4_haplotype_features": ("groups", m["s4_haplotype_features"][
                 "groups"]),
             "s5_haplotype_predict": ("sites", m["s5_haplotype_predict"][
                 "sites"]),
             "s6_merge": ("rows", len(merged))}
    rows["call"] = dict(
        wall_seconds=wall, stage_seconds=sec,
        stage_share={st: sec[st] / wall for st in CALL_STAGES},
        device_stage_share=(sec["s2_pileup_predict"]
                            + sec["s5_haplotype_predict"]) / wall,
        per_s={st: {units[st][0]: units[st][1],
                    "per_s": units[st][1] / sec[st]} for st in CALL_STAGES},
        pileup_rows_s1=m["s1_pileup_features"]["rows"],
        phased_sites=m["s3_phasing"]["phased_sites"],
        deferred=m["s5_haplotype_predict"].get("deferred"),
        rescued=m["s6_merge"].get("rescued"), merge_rows=len(merged),
        truth_hets=len(het_truth), called_hets=len(called),
        het_recall=f1.recall, het_precision=f1.precision)
    log("[call] " + json.dumps(rows["call"]))

    # evaluate-pileup with the fitted model on its training contig's
    # labeled arrays, every row and the variant rows (--for-evaluate);
    # the variant rows' decisions on the card against the CPU's
    fitted = os.path.join(out, "pileup_train", "last.ckpt")
    ev = ["evaluate-pileup", "--data", os.path.join(out, "train_data"),
          "--model", fitted]
    for name, extra in (("evaluate-pileup", []),
                        ("evaluate-pileup --for-evaluate",
                         ["--for-evaluate"])):
        rows[name], launches[name] = _evaluate(
            name, ev + extra + ["-o", os.path.join(
                WORK, name.replace(" ", "_"))] + dev_args,
            "evaluate_pileup.json", ("lstm_recurrence_infer_f32",))
    rows["evaluate-pileup --for-evaluate"]["card_vs_cpu"] = check_agreement(
        "evaluate-pileup --for-evaluate", *[
            list(E.pileup_scores(PipelineConfig(), fitted, os.path.join(
                out, "train_data"), True, 2000, d))
            for d in (dev, torch.device("cpu"))])

    # `call` once more on the strict-parity route (use_pallas false,
    # use_bf16 false): every stage, the encoders on the f32 kernel and no
    # kernel of the kernel route; its stage seconds and het SNPs beside the
    # default route's
    f32_yaml = os.path.join(WORK, "scan_f32.yaml")
    with open(f32_yaml, "w") as f:
        f.write("inference:\n  use_pallas: false\n  use_bf16: false\n")
    run_f32 = os.path.join(WORK, "run_scan_f32")
    wall_f32 = timed("call scan f32", call + ["-o", run_f32, "--config",
                                              f32_yaml] + dev_args)
    marks_f32 = _stage_markers(run_f32)
    used = {k for k, v in launches["call scan f32"].items() if v}
    if dev.type == "cuda" and used != {"lstm_recurrence_infer_f32"}:
        raise AssertionError(f"call scan f32 launched {sorted(used)}")
    merged_f32 = _body(os.path.join(run_f32, "merge.vcf"))
    _, f1_f32 = het_f1(merged_f32)
    rows["call scan f32"] = dict(
        wall_seconds=wall_f32,
        stage_seconds={st: marks_f32[st]["seconds"] for st in CALL_STAGES},
        merge_rows=len(merged_f32), het_recall=f1_f32.recall,
        het_precision=f1_f32.precision,
        default_route=dict(wall_seconds=wall, stage_seconds=sec,
                           het_recall=f1.recall,
                           het_precision=f1.precision))
    log("[call scan f32] " + json.dumps(rows["call scan f32"]))
    if not merged_f32:
        raise AssertionError("call scan f32: merge.vcf empty")

    # a second call on the same output resumes and runs no stage
    dt = timed("call: resume", call + ["-o", run] + dev_args)
    again = _stage_markers(run)
    if any(again[st]["mtime_ns"] != marks[st]["mtime_ns"]
           for st in CALL_STAGES) or sum(launches["call: resume"].values()):
        raise AssertionError("the second call ran a stage again")
    rows["call: resume"] = dict(seconds=dt)

    # once more into a fresh output under torch.profiler: the card's busy
    # time over the wall time of the whole call (models and kernels warm)
    if dev.type == "cuda":
        run2 = os.path.join(WORK, "run_profiled")
        acts = [torch.profiler.ProfilerActivity.CUDA]
        t = time.monotonic()
        with torch.profiler.profile(activities=acts) as prof:
            if cli.main(call + ["-o", run2]) != 0:
                raise AssertionError("the profiled call failed")
            torch.cuda.synchronize()
        wall2 = time.monotonic() - t
        busy = 0.0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            t_us = getattr(e, "self_device_time_total", None)
            if t_us is None:
                t_us = getattr(e, "self_cuda_time_total", 0)
            busy += t_us / 1e6
        marks2 = _stage_markers(run2)
        rows["call: profiled"] = dict(
            wall_seconds=wall2,
            stage_seconds={st: marks2[st]["seconds"] for st in CALL_STAGES},
            device_busy_seconds=busy if busy else None,
            device_idle_share=1 - busy / wall2 if busy else None)
        log("[call: profiled] " + json.dumps(rows["call: profiled"]))
    # WORK stays: phase 4b runs on this world and this fitted model
    return launches, rows


# a child process of phase 4b: the port's CLI with the given arguments,
# then the kernel launches it made as one JSON line
CHILD = ("import json, sys\n"
         "from nanosnp_tpu_torch.ops import bilstm as K\n"
         "from nanosnp_tpu_torch.runtime import cli\n"
         "rc = cli.main(sys.argv[1:])\n"
         "print(json.dumps({'launches': dict(K.LAUNCHES)}), flush=True)\n"
         "sys.exit(rc)\n")
# the control of phase 4b's training check: ranks that skip the gradient
# average, each training on its half of the batch alone
CHILD_NO_MEAN = ("from nanosnp_tpu_torch.train import train_pileup as T\n"
                 "T.all_reduce_mean = list\n") + CHILD
CHILD_TIMEOUT = 600     # seconds a child of phase 4b may take
# two ranks against one process: |moved_2 - moved_1| / |moved_1|, the L2
# norms over every parameter of how far training moved it from its start.
# The geometric middle of the sound runs' largest reading (4.5e-4) and the
# control's smallest (7.7e-2) on the H100, as PERF.md records.
MOVE_TOL = 6e-3


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _children(label, argvs, envs, code=CHILD):
    """Run the port's CLI in one child process per argv, all at once, each
    with its environment -> (wall seconds of the lot, [launches of each],
    [the train_groups record each printed, or None]). Raises if a child
    fails; kills every child still running on the way out."""
    t = time.monotonic()
    procs = []
    try:
        for argv, env in zip(argvs, envs):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code] + argv, env=env, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=CHILD_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.monotonic() - t
    counts, groups = [], []
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{label}: child {i} exited "
                                 f"{p.returncode}:\n{err[-3000:]}")
        last = [l for l in out.splitlines() if l.startswith('{"launches"')]
        counts.append(json.loads(last[-1])["launches"])
        groups.append(_groups_record(out))
    return wall, counts, groups


def _child_env(extra=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("NSP_")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


def _moved_gap(got, want, init):
    """How far two runs moved the parameters from the same start, held to
    each other: -> (|dg - dw| / |dw| with L2 norms over all parameters,
    the worst leaf's max|dg - dw| / max|dw|), where dg, dw are the runs'
    last.ckpt minus `init`."""
    from nanosnp_tpu_torch.models.convert import flatten_tree
    from nanosnp_tpu_torch.train.train_pileup import load_checkpoint

    start = dict(flatten_tree(init))
    g, w = (dict(flatten_tree(load_checkpoint(p)[0])) for p in (got, want))
    if not g.keys() == w.keys() == start.keys():
        raise AssertionError("checkpoint leaves differ from the start's")
    diff2 = norm2 = worst = 0.0
    for path, x0 in start.items():
        dg, dw = g[path] - x0, w[path] - x0
        diff2 += float(((dg - dw).double() ** 2).sum())
        norm2 += float((dw.double() ** 2).sum())
        if dw.abs().max() > 0:
            worst = max(worst, float((dg - dw).abs().max()
                                     / dw.abs().max()))
    if norm2 == 0:
        raise AssertionError("training moved no parameter")
    return (diff2 / norm2) ** 0.5, worst


def phase_multihost(dev):
    """Phase 4b, on phase 4's world and fitted model: `call --contigs chrT
    chrC` in one process and as two hosts (two child processes on the
    card, gloo over 127.0.0.1), the merged rows held to the one-process
    rows byte for byte; then train-pileup and train-haplotype in one
    process and data-parallel over two ranks on the card, how far each
    moved the parameters held to the other, and a control without the
    gradient average held to fail that check. Two processes share one card here, so
    no time is a claim about several cards."""
    import numpy as np
    import torch

    from nanosnp_tpu_torch.io.fasta import FastaReference
    from nanosnp_tpu_torch.ops import bilstm as K
    from nanosnp_tpu_torch.parallel.launch import plan_contig_shards
    from nanosnp_tpu_torch.runtime import cli

    ckpt = os.path.join(WORK, "pileup.chkpt")
    if not os.path.exists(ckpt):
        raise AssertionError("phase 4b runs on phase 4's world: run "
                             "phase_call first")
    card = _card()
    log(f"[phase 4b] {card}")
    dev_args = [] if dev.type == "cuda" else ["--device", "cpu"]
    launches, rows = {}, {}
    ref = os.path.join(WORK, "ref.fa")
    call = ["call", "--bam", os.path.join(WORK, "sample.bam"), "--ref", ref,
            "--pileup-model", ckpt, "--haplotype-model", V6B, "--phaser",
            "native", "--contigs", "chrT", "chrC"] + dev_args

    def timed(name, argv):
        """-> (wall seconds, a train-* command's group record or None)"""
        K.reset_launch_counts()
        t = time.monotonic()
        rec = None
        if argv[0].startswith("train-"):
            rec = _cli_train(argv)
        elif cli.main(argv) != 0:
            raise AssertionError(f"{name} failed")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.monotonic() - t
        launches[name] = dict(K.LAUNCHES)
        log(f"[{name}] {dt:.3f} s, launches {launches[name]}")
        return dt, rec

    # call: one process, then two hosts on the same card
    single, multi = os.path.join(WORK, "mh_single"), os.path.join(WORK,
                                                                 "mh_multi")
    wall1, _ = timed("call x1", call + ["-o", single])
    port = _free_port()
    wall2, counts, _ = _children("call x2", [
        call + ["-o", multi, "--coordinator", f"127.0.0.1:{port}",
                "--num-hosts", "2", "--host-id", str(h)] for h in range(2)],
        [_child_env()] * 2)
    for h, c in enumerate(counts):
        launches[f"call x2 host{h}"] = c
        log(f"[call x2 host{h}] launches {c}")
    fasta = FastaReference(ref)
    plan = plan_contig_shards({c: fasta.length(c) for c in ("chrT", "chrC")},
                              2)
    if [len(c) for c in plan] != [1, 1]:
        raise AssertionError(f"LPT plan {plan}")
    split = {}
    for h in range(2):
        host = os.path.join(multi, f"host{h}")
        got = sorted({r[0] for r in _body(os.path.join(host, "pileup.vcf"))})
        if got != plan[h]:
            raise AssertionError(f"host {h} called {got}, plan {plan[h]}")
        split[f"host{h}"] = {st: m["seconds"]
                             for st, m in _stage_markers(host).items()}
    same = {}
    for name in ("pileup.vcf", "haplotype.csv", "merge.vcf"):
        want = _body(os.path.join(single, name))
        got = _body(os.path.join(multi, name))
        if not want or got != want:
            diff = next((i for i, (a, b) in enumerate(zip(got, want))
                         if a != b), min(len(got), len(want)))
            raise AssertionError(
                f"call x2 {name}: {len(got)} rows against {len(want)}, "
                f"first difference at row {diff}")
        same[name] = len(want)
    rows["call x2"] = dict(
        card=card, one_process_wall_seconds=wall1,
        one_process_stage_seconds={st: m["seconds"] for st, m in
                                   _stage_markers(single).items()},
        two_hosts_wall_seconds=wall2, host_stage_seconds=split,
        contigs={f"host{h}": plan[h] for h in range(2)},
        byte_identical_rows=same)
    log("[call x2] " + json.dumps(rows["call x2"]))

    # data-parallel training: one process, then two ranks on the card
    rng = np.random.default_rng(SEED + 7)
    hap_work = os.path.join(WORK, "dp_hap")
    os.makedirs(hap_work)
    hap_shards = _haplotype_train_world(rng, hap_work, DP_HAP_SITES)
    cfg = os.path.join(WORK, "dp.yaml")
    # groups of 2 steps: phase 4's arrays give 6 pileup batches an epoch,
    # this world 4 haplotype batches a depth bucket, so each fills two
    # groups or more (eager over two ranks; in one process the first
    # eager, the others graph replays)
    with open(cfg, "w") as f:
        f.write("pileup_model:\n  dropout: 0.0\n"
                "haplotype_model:\n  dropout: 0.0\n"
                "train:\n  steps_per_call: 2\n")
    from nanosnp_tpu_torch.config import load_config
    from nanosnp_tpu_torch.models.haplotype_model import \
        init_haplotype_params
    from nanosnp_tpu_torch.models.pileup_model import init_pileup_params

    # the start both trainers draw from the seed, as the CLI runs them
    dp_cfg = load_config(cfg)
    start = {
        "train-pileup": init_pileup_params(
            torch.Generator().manual_seed(dp_cfg.train.seed),
            dp_cfg.pileup_model),
        "train-haplotype": init_haplotype_params(
            torch.Generator().manual_seed(dp_cfg.train.seed),
            dp_cfg.haplotype_model)}
    for name, argv, epochs, dw in (
            ("train-pileup", [
                "train-pileup", "--data", os.path.join(WORK, "out",
                                                       "train_data"),
                "--batch-size", "2000"], 2, False),
            ("train-haplotype", [
                "train-haplotype", "--shards", hap_shards, "--ref",
                os.path.join(hap_work, "ref.fa"), "--truth-vcf",
                os.path.join(hap_work, "truth.vcf"), "--bed",
                os.path.join(hap_work, "conf.bed"), "--batch-size", "512"],
             1, True)):
        argv = argv + ["--config", cfg, "--epochs", str(epochs),
                       "--val-fraction", "0.1"] + dev_args
        one, two, bad = (os.path.join(WORK, f"{name}_{k}")
                         for k in ("x1", "x2", "x2_no_mean"))
        wall1, one_groups = timed(f"{name} x1", argv + ["-o", one])

        def two_ranks(label, out, code):
            port = _free_port()
            return _children(label, [argv + ["-o", out]] * 2, [
                _child_env({"NSP_COORDINATOR": f"127.0.0.1:{port}",
                            "NSP_NUM_PROCS": "2", "NSP_PROC_ID": str(r)})
                for r in range(2)], code)

        wall2, counts, groups = two_ranks(f"{name} x2", two, CHILD)
        # the control: the same two ranks, each skipping the average (its
        # launches are not the path's)
        two_ranks(f"{name} x2 control", bad, CHILD_NO_MEAN)
        run = name.replace("train-", "") + "_train"
        recs = _train_records(os.path.join(two, run), epochs)
        steps = recs[-1]["step"]
        for other in (one, bad):
            if steps != _train_records(os.path.join(other, run),
                                       epochs)[-1]["step"]:
                raise AssertionError(f"{name}: the runs took other steps")
        want = os.path.join(one, run, "last.ckpt")
        gap, leaf = _moved_gap(os.path.join(two, run, "last.ckpt"), want,
                               start[name])
        bad_gap, bad_leaf = _moved_gap(os.path.join(bad, run, "last.ckpt"),
                                       want, start[name])
        for r, c in enumerate(counts):
            launches[f"{name} x2 rank{r}"] = c
            log(f"[{name} x2 rank{r}] launches {c}")
        rows[f"{name} x2"] = dict(
            card=card, steps=steps, one_process_seconds=wall1,
            two_ranks_seconds=wall2, moved_gap=gap, moved_gap_worst_leaf=leaf,
            control_moved_gap=bad_gap, control_moved_gap_worst_leaf=bad_leaf,
            final_train_loss=recs[-2]["loss"],
            one_process_steps_by_route=one_groups["steps"],
            rank_steps_by_route=[g and g["steps"] for g in groups])
        log(f"[check] {name}: two ranks against one process, "
            f"|moved_2 - moved_1| / |moved_1| over all parameters {gap:.3e} "
            f"(worst leaf max|d| / max|moved_1| {leaf:.3e}); the control "
            f"without the gradient average {bad_gap:.3e} ({bad_leaf:.3e}); "
            f"tol {MOVE_TOL}")
        log(f"[{name} x2] " + json.dumps(rows[f"{name} x2"]))
        if not gap <= MOVE_TOL:
            raise AssertionError(f"{name}: two ranks disagree with one "
                                 f"process: {gap}")
        if not bad_gap > MOVE_TOL:
            raise AssertionError(f"{name}: the check passes ranks that skip "
                                 f"the gradient average: {bad_gap}")
        for r, c in enumerate(counts):
            for k in ("lstm_recurrence_train", "lstm_recurrence_bwd") + (
                    ("lstm_dw_reduce",) if dw else ()):
                if dev.type == "cuda" and c[k] <= 0:
                    raise AssertionError(f"{name} rank {r}: {k} was never "
                                         "launched")
        # each rank ran its full groups as eager steps, the one process
        # (on the card) replayed a graph
        log(f"[check] {name}: steps by route, one process "
            f"{one_groups['steps']}, two ranks "
            f"{[g and g['steps'] for g in groups]}")
        for r, g in enumerate(groups):
            if g is None or g["ranks"] != 2 or g["steps"]["graph"] \
                    or g["steps"]["eager"] <= 0:
                raise AssertionError(f"{name} rank {r}: not the eager group "
                                     f"route: {g}")
        if (one_groups["steps"]["graph"] > 0) != (dev.type == "cuda"):
            raise AssertionError(f"{name} x1: steps by route "
                                 f"{one_groups['steps']}")
    for h in range(2):
        for k in ("bilstm_stream", "bilstm_center", "bilstm_inproj",
                  "bilstm_cluster"):
            if dev.type == "cuda" and launches[f"call x2 host{h}"][k] <= 0:
                raise AssertionError(f"call x2 host {h} never launched {k}")
    shutil.rmtree(WORK, ignore_errors=True)
    return launches, rows


def _train_parts(dev, model, opt, dropout=None):
    """One trainer's parts at full width from the seeded start, as the
    CLI builds them: its state, optimizer and dropout generator (None at
    dropout 0; `dropout` None keeps the configuration's), `single` (the
    package's one-step function, `make_*_train_step`) and, where the
    package groups steps, `step` (the group runner's step function) and
    `host` (a batch as it ships)."""
    import torch

    from nanosnp_tpu_torch.config import (HaplotypeModelConfig,
                                          PileupModelConfig, TrainConfig)
    from nanosnp_tpu_torch.train.optim import build_optimizer
    from nanosnp_tpu_torch.train.train_pileup import init_state

    tcfg = TrainConfig()
    if model == "train-pileup":
        from nanosnp_tpu_torch.models.pileup_model import (
            PileupModel as cls, init_pileup_params as init)
        from nanosnp_tpu_torch.train import train_pileup as T
        mcfg = PileupModelConfig()
        make_single, make_step = "make_pileup_train_step", "make_pileup_step"
    else:
        from nanosnp_tpu_torch.models.haplotype_model import (
            HaplotypeModel as cls, init_haplotype_params as init)
        from nanosnp_tpu_torch.train import train_haplotype as T
        mcfg = HaplotypeModelConfig()
        make_single = "make_haplotype_train_step"
        make_step = "make_haplotype_step"
    if dropout is not None:
        mcfg = replace(mcfg, dropout=dropout)
    tx = build_optimizer(replace(tcfg.optim, type=opt), 100)
    state = init_state(cls(mcfg, init(torch.Generator().manual_seed(SEED),
                                      mcfg)).to(dev), tx)
    gen = (torch.Generator(device=dev).manual_seed(SEED) if mcfg.dropout > 0
           else None)
    parts = SimpleNamespace(state=state, tx=tx, gen=gen, step=None,
                            host=None, single=getattr(T, make_single)(
                                mcfg, tcfg, tx, use_kernels=True))
    if hasattr(T, make_step):
        step = getattr(T, make_step)(mcfg, tcfg, tx, use_kernels=True)
        parts.step = lambda batch, row: step(state, batch, gen, row)
        parts.host = (T._host_batch if model == "train-haplotype"
                      else lambda b: b)
    return parts


def _train_batches(model, arrays, rng):
    """GROUP host batches of a trainer at its CLI batch size: pileup rows of
    `arrays` (taken again from the start where it has fewer), haplotype
    read matrices at depth 64."""
    import numpy as np

    out = []
    for i in range(GROUP):
        if model == "train-pileup":
            idx = (np.arange(2000) + 2000 * i) % len(arrays.matrix)
            out.append({"x": arrays.matrix[idx].astype(np.float32),
                        "gt": arrays.label[idx, :21].argmax(1),
                        "zy": arrays.label[idx, 21:24].argmax(1)})
            continue
        batch = {}
        for pre, seq_len in (("p_", 33), ("h_", 11)):
            view = _read_matrices(rng, 512, 64, seq_len, 0)
            for key, name in (("sequences", "seq"), ("baseq", "baseq"),
                              ("mapq", "mapq"), ("hap", "hap")):
                batch[pre + name] = view[key]
            batch[pre + "ref"] = rng.integers(0, 5, (512, seq_len)).astype(
                np.float32)
        batch["gt"] = rng.integers(0, 10, 512).astype(np.int32)
        batch["zy"] = rng.integers(0, 3, 512).astype(np.int32)
        out.append(batch)
    return out


def _state_gap(a, b):
    """Two training states: (the same bits, the worst max|a - b| / max|b|
    over the leaves of the parameters, the Lookahead slow parameters and
    the optimizer's per-leaf state). Their counts must be equal."""
    import torch

    from nanosnp_tpu_torch.models.convert import flatten_tree

    def leaves(st):
        out = [p for _, p in flatten_tree(st.model.tree())]
        if st.slow is not None:
            out += [p for _, p in flatten_tree(st.slow)]
        return out + [t for k in sorted(st.opt_state)
                      if isinstance(st.opt_state[k], list)
                      for t in st.opt_state[k]]

    if {k: v for k, v in a.opt_state.items() if not isinstance(v, list)} != \
            {k: v for k, v in b.opt_state.items() if not isinstance(v, list)}:
        raise AssertionError("the optimizer counts differ")
    pairs = [(x.detach(), y.detach()) for x, y in zip(leaves(a), leaves(b))]
    same = all(torch.equal(x, y) for x, y in pairs)
    worst = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                for x, y in pairs)
    return same, worst


def check_graph_replay(dev, arrays, rng):
    """Both trainers at full width, Lookahead-Adam and their Ranger flavor,
    dropout 0 and the configuration's: three groups of GROUP batches
    through the group runner at steps_per_call GROUP (the first eager, the
    second captured and replayed, the third replayed) against the same
    batches as single eager steps (steps_per_call 1) from the same seeded
    state. After each group the parameters, Lookahead slow parameters
    and optimizer state must be the same bits, or within REPLAY_TOL of
    each other (printed), and the dropout generators' states equal."""
    import torch

    from nanosnp_tpu_torch.train.group import GroupRunner

    out = {}
    for model, flavor in (("train-pileup", "ranger"),
                          ("train-haplotype", "ranger21")):
        batches = _train_batches(model, arrays, rng)
        for opt in ("lookahead_adam", flavor):
            for dropout in (0.0, None):
                runs = []
                for group in (GROUP, 1):
                    p = _train_parts(dev, model, opt, dropout)
                    runs.append((GroupRunner(p.step, p.tx, p.state, p.gen,
                                             dev, group), p))
                (grouped, a), (single, b) = runs
                host = [a.host(x) for x in batches]
                row = dict(dropout=a.gen is not None, groups=[])
                for g in range(3):
                    grouped.run(host)
                    for x in host:
                        single.run([x])
                    torch.cuda.synchronize()
                    same, worst = _state_gap(a.state, b.state)
                    gen_same = None if a.gen is None else bool(torch.equal(
                        a.gen.get_state(), b.gen.get_state()))
                    row["groups"].append(dict(
                        route="eager" if g == 0 else "graph",
                        same_bits=same, worst_rel=worst,
                        generator_same=gen_same))
                    if not (same or worst <= REPLAY_TOL) or gen_same is False:
                        raise AssertionError(
                            f"{model} {opt}: group {g + 1} of {GROUP} "
                            f"steps differs from single steps: {row}")
                row["steps"], row["graphs"] = grouped.steps, grouped.graphs
                name = f"{model} {opt} dropout {'on' if row['dropout'] else 0}"
                out[name] = row
                log(f"[check] graph replay, {name}: " + "; ".join(
                    f"group {i + 1} ({r['route']}) "
                    + ("same bits" if r["same_bits"] else
                       f"worst max|d|/max|want| {r['worst_rel']:.3e} "
                       f"(tol {REPLAY_TOL})")
                    + ("" if r["generator_same"] is None else
                       ", generator state the same")
                    for i, r in enumerate(row["groups"]))
                    + "; graph capture " + json.dumps(
                        [{k: g[k] for k in ("capture_seconds", "pool_bytes")}
                         for g in grouped.graphs]))
                del runs, grouped, single, a, b
                torch.cuda.empty_cache()
    return out


# the training kernels' names in a profiler trace, by wrapper
KERNEL_NAMES = {"lstm_recurrence_train": "lstm_fwd",
                "lstm_recurrence_bwd": "lstm_bwd",
                "lstm_dw_reduce": "lstm_dw_tc"}


def profile_train_steps(dev, arrays, rng, flavors=True):
    """Steady-state training steps of both models at full width, with
    Lookahead-Adam and (`flavors`) each model's Ranger flavor, apart from
    the CLI's set-up, two ways: single steps (steps_per_call 1, the
    package's one-step function; each step copies its batch to the card
    and reads its metrics) and, where the package groups steps, groups of
    GROUP (the group runner: one CUDA graph replay, batches from pinned
    staging, metrics read once). ms a step on the host clock (device
    synchronised; TIME_RUNS runs of GROUP steps a turn, four turns with
    the order reversed every turn, the upper median kept), then
    torch.profiler over one run of GROUP steps: device busy time a step
    (the sum of device time of every kernel and copy), its share of the
    step, the share of the port's own kernels, the five costliest device
    functions; for a grouped run, its graph's capture seconds and pool
    bytes, and the training kernels' launches by name in the trace
    against the counts the replays added (they must be equal where the
    trace shows them)."""
    import torch

    from nanosnp_tpu_torch.train.train_haplotype import _device_batch

    try:
        from nanosnp_tpu_torch.train.group import GroupRunner
    except ImportError:     # a package that runs single steps only
        GroupRunner = None

    out = {}
    for model, flavor in (("train-pileup", "ranger"),
                          ("train-haplotype", "ranger21")):
        batches = _train_batches(model, arrays, rng)
        runs = {}
        for opt in ("lookahead_adam", flavor)[:2 if flavors else 1]:
            label = model if opt == "lookahead_adam" else f"{model} {opt}"
            p = _train_parts(dev, model, opt)

            def single(p=p):
                for b in batches:
                    if model == "train-pileup":
                        m = p.single(p.state, *(torch.from_numpy(b[k]).to(dev)
                                                for k in ("x", "gt", "zy")),
                                     p.gen, 0.0)
                    else:
                        m = p.single(p.state, _device_batch(b, dev), p.gen,
                                     0.0)
                    float(m["loss"]), m["gt_pred"].cpu(), m["zy_pred"].cpu()

            runs[f"{label} steps_per_call 1"] = (single, None)
            if GroupRunner is not None and p.step is not None:
                q = _train_parts(dev, model, opt)
                runner = GroupRunner(q.step, q.tx, q.state, q.gen, dev, GROUP)
                host = [q.host(b) for b in batches]
                runs[f"{label} steps_per_call {GROUP}"] = (
                    lambda r=runner, h=host: r.run(h), runner)
        for fn, _ in runs.values():
            for _ in range(3):      # the grouped run: eager, capture, replay
                fn()
        turns = {k: [] for k in runs}
        for turn in range(4):
            for k in list(runs)[::1 if turn % 2 == 0 else -1]:
                torch.cuda.synchronize()
                t = time.monotonic()
                for _ in range(TIME_RUNS):
                    runs[k][0]()
                torch.cuda.synchronize()
                turns[k].append((time.monotonic() - t) / (TIME_RUNS * GROUP)
                                * 1e3)
        for name, (fn, runner) in runs.items():
            ms = sorted(turns[name])[len(turns[name]) // 2]
            before = None if runner is None else dict(runner.steps)
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
            # device-side events only (kernels, copies): the host ops that
            # launch them carry the same time again as their own device time
            dev_ms, by_name = {}, {k: 0 for k in KERNEL_NAMES}
            for e in prof.key_averages():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                t_us = getattr(e, "self_device_time_total", None)
                if t_us is None:
                    t_us = getattr(e, "self_cuda_time_total", 0)
                if t_us > 0:
                    dev_ms[e.key] = t_us / 1e3 / GROUP
                for k, frag in KERNEL_NAMES.items():
                    if frag in e.key:
                        by_name[k] += e.count
            busy = sum(dev_ms.values())
            ours = sum(v for k, v in dev_ms.items() if "lstm" in k)
            top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:5]
            row = {
                "ms_per_step": ms, "ms_per_step_turns": turns[name],
                "device_busy_ms_per_step": busy if busy else None,
                "device_busy_share": busy / ms if busy else None,
                "port_kernels_ms_per_step": ours if busy else None,
                "top_device_ms_per_step": [[k[:80], v] for k, v in top]}
            if runner is not None:
                if runner.steps["graph"] - before["graph"] != GROUP:
                    raise AssertionError(f"{name}: the profiled run was not "
                                         "a replay")
                counted = runner.graphs[0]["launches_a_replay"]
                row["graphs"] = [{k: g[k] for k in (
                    "capture_seconds", "pool_bytes")} for g in runner.graphs]
                row["kernel_launches_in_trace"] = by_name if busy else None
                row["kernel_launches_counted"] = counted
                if busy and any(by_name[k] != counted.get(k, 0)
                                for k in KERNEL_NAMES):
                    raise AssertionError(f"{name}: the trace launched "
                                         f"{by_name}, the counts say "
                                         f"{counted}")
            out[name] = row
            log(f"[profile] {name}: {ms:.2f} ms a step, device busy "
                + (f"{busy:.2f} ms ({busy / ms:.0%}), port kernels "
                   f"{ours:.2f} ms" if busy else
                   "not measured (no device time in the trace)")
                + ("" if runner is None else
                   f"; training kernels in the trace {by_name}, counted "
                   f"{counted}; graphs {row['graphs']}"))
    return out


def check_probs(label, got, want):
    for g, w, head in zip(got, want, ("gt", "zy")):
        g = g.float().cpu()
        if not bool(g.isfinite().all()) or g.shape != w.shape:
            raise AssertionError(f"{label} {head}: bad output {g.shape}")
        err = (g - w).abs().max().item()
        agree = (g.argmax(1) == w.argmax(1)).float().mean().item()
        log(f"[check] {label} {head}: card vs CPU max|dp|={err:.3e} "
            f"(tol {PROB_TOL}), argmax agreement {agree:.5f}")
        if not (err <= PROB_TOL and agree >= 0.99):
            raise AssertionError(f"{label} {head}: card disagrees with CPU")


def _card():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args and args[0] in ("--train-times", "--train-turns",
                            "--fused-times", "--fused-turns",
                            "--probe-times", "--probe-turns") \
            and len(args) == 2:
        log(_card())
        if args[0].endswith("-turns"):
            kind = args[0][2:-len("-turns")]
            log(json.dumps({f"{kind}_turns": _turns(kind, args[1])}))
            return 0
        sys.path[:0] = [os.path.abspath(args[1]), ROOT]
        if args[0] == "--fused-times":
            log(json.dumps({"fused_times": fused_kernel_times(
                torch.device("cuda", 0))}))
            return 0
        if args[0] == "--probe-times":
            log(json.dumps({"probe_times": probe_kernel_times(
                torch.device("cuda", 0))}))
            return 0
        log(json.dumps({"train_times": train_kernel_times(
            torch.device("cuda", 0))}))
        return 0
    if args:
        print(f"chip_smoke: unknown arguments {args}", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # the numpy-only world generators beside the tests
    sys.path.insert(1, os.path.join(ROOT, "tests"))
    from nanosnp_tpu_torch.ops import bilstm as K
    from nanosnp_tpu_torch.ops import build

    log(_card())
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc: "
        f"{nvcc.stdout.strip().splitlines()[-1]}")
    dev = torch.device("cuda", 0)
    t0 = time.monotonic()
    reports = build.build_all()
    log(f"[build] {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    from nanosnp_tpu_torch.io import native

    native.get_lib()
    log(f"[build] host engine (g++): {time.monotonic() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill",
                                       "error", "Performance")):
                log(f"[build] {name}: {line.strip()[:160]}")

    t0 = time.monotonic()
    rows = phase_kernels(dev)
    log(f"[phase 1] {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    rows += phase_train_kernels(dev)
    log(f"[phase 1b] {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    rows += phase_new_kernels(dev)
    log(f"[phase 1c] {time.monotonic() - t0:.1f} s")
    launches, stage_rows = {}, {}
    t0 = time.monotonic()
    probe_rows, probe_launches = phase_probe(dev)
    rows += probe_rows
    launches.update(probe_launches)
    log(f"[phase 1d] {time.monotonic() - t0:.1f} s")
    for label, phase in (("2", phase_slice), ("2b", phase_routes),
                         ("2d", phase_scan_route),
                         ("2c", phase_legacy), ("3", phase_train),
                         ("4", phase_call), ("4b", phase_multihost)):
        t0 = time.monotonic()
        phase_launches, phase_rows = phase(dev)
        launches.update(phase_launches)
        stage_rows.update(phase_rows)
        log(f"[phase {label}] {time.monotonic() - t0:.1f} s")

    kernels = []
    for name in REPLACES:
        n_launch = sum(v[name] for v in launches.values())
        if n_launch <= 0:
            raise AssertionError(f"{name} was never launched on the path")
        mine = [r for r in rows if r["name"] == name]
        # headline numbers: the heaviest shape on the path
        top = max(mine, key=lambda r: r["bound_ms"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"nanosnp_tpu_torch/ops/csrc/{SOURCES[name]}",
            "replaces": REPLACES[name], "launches": n_launch,
            "launches_by_stage": {k: v[name] for k, v in launches.items()},
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "at": top["shape"],
            "shapes": mine})
    log(json.dumps({"stages": stage_rows}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
