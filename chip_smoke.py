#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nanosnp_tpu_torch) on one card.

    python3 chip_smoke.py

  setup    prints the card (nvidia-smi name and power limit), torch, CUDA
           and nvcc versions; builds the CUDA kernels from ops/csrc.
  phase 1  holds each kernel against its plain PyTorch version at every
           shape the main path gives it (N not a multiple of the batch
           tile), then times kernel, plain version and cuDNN nn.LSTM
           (a yardstick only: the port never calls it) at N=8192.
  phase 2  drives the slice through its entry points at full model width:
           s2-predict (CLI) on a 100k-candidate columnar shard with seeded
           full-width pileup weights, s5 stage_haplotype_predict on two
           depth buckets with the shipped v6b haplotype weights, s6-merge
           (CLI). Kernel launch counts are zeroed before each stage and
           read after it. The outputs are checked for shape and finite
           values, and the models on the card against their plain versions
           on the CPU on a small input.

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
STREAM_TOL = 1e-2       # bf16 output: two bf16 ulps near 1
CENTER_TOL = 2e-3       # f32 output; the gap is f32 summation order
                        # carried through the bf16 rounding of h_{t-1}
PROB_TOL = 1e-2         # model probabilities, card vs CPU plain versions
CONTIG_LEN = 3_000_000  # a few-Mbp contig at 30x ...
N_CAND = 100_000        # ... gives ~100k candidates: 13 batches of 8192
HAP_SITES = 8000        # haplotype sites in each of two depth buckets


def log(*a):
    print(*a, flush=True)


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
]
REPLACES = {
    "bilstm_stream": "nanosnp_tpu/ops/pallas_lstm.py:423 (_enc_stream_kernel)"
                     ", nanosnp_tpu/ops/pallas_lstm.py:733 "
                     "(_enc_stream_kfused_kernel)",
    "bilstm_center": "nanosnp_tpu/ops/pallas_lstm.py:501 (_enc_center_kernel)",
}


def phase_kernels(dev):
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

    rows = []
    for label, name, seq_len, d_in, hidden in SHAPES:
        kern = getattr(K, name)
        plain = getattr(K, name + "_plain")
        # first layers see counts / statistics, inner layers h in (-1, 1)
        x_scale = 8.0 if d_in in (18, 105) else 1.0
        args = inputs(N_CHECK, seq_len, d_in, hidden, x_scale)
        got = kern(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        err = (got.float() - want.float()).abs().max().item()
        tol = STREAM_TOL if name == "bilstm_stream" else CENTER_TOL
        log(f"[check] {name:14s} {label:16s} N={N_CHECK} L={seq_len} "
            f"D={d_in} H={hidden}: max|d|={err:.3e} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"{name} {label}: max|d| {err} > {tol}")

        args = inputs(N_TIME, seq_len, d_in, hidden, x_scale)
        ms = cuda_time(lambda: kern(*args), 5)
        plain_ms = cuda_time(lambda: plain(*args), 2)
        lstm = torch.nn.LSTM(d_in, hidden, batch_first=True,
                             bidirectional=True, device=dev,
                             dtype=torch.bfloat16)
        with torch.inference_mode():
            library_ms = cuda_time(lambda: lstm(args[0]), 5)
        flop, nbytes = K.layer_cost(N_TIME, seq_len, d_in, hidden,
                                    center=name == "bilstm_center")
        t_ops = flop / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        rows.append(dict(
            name=name, shape=label, L=seq_len, D=d_in, H=hidden,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes"))
        log(f"[time]  {name:14s} {label:16s} N={N_TIME}: kernel {ms:.3f} ms"
            f", plain {plain_ms:.3f} ms, cuDNN {library_ms:.3f} ms, bound "
            f"{rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']})")
    return rows


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


def phase_slice(dev):
    import numpy as np
    import torch

    from nanosnp_tpu_torch import constants as C
    from nanosnp_tpu_torch.config import PipelineConfig
    from nanosnp_tpu_torch.features.haplotype import (haplotype_features,
                                                      ref_position_codes,
                                                      ref_window_codes)
    from nanosnp_tpu_torch.io import bins
    from nanosnp_tpu_torch.io.fasta import FastaReference, write_fasta
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
    t0 = time.monotonic()
    fa = os.path.join(WORK, "ref.fa")
    write_fasta(fa, {contig: np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, length)].tobytes().decode()})
    ref = FastaReference(fa)
    seq = ref.contig(contig)
    flank = 16
    pos = np.sort(rng.choice(np.arange(flank + 1, length - flank), n_cand,
                             replace=False)).astype(np.int64)
    win = pos[:, None] - 1 + np.arange(-flank, flank + 1)[None, :]
    shard = bins.PileupShard(
        contig=contig, positions=pos,
        ref_seqs=seq[win].view(f"S{2 * flank + 1}").reshape(-1),
        alt_info=np.full(n_cand, b"A:1", dtype="S3"),
        columns=_pileup_columns(rng, seq), cand_off=pos - 1, flank=flank)
    shard_dir = os.path.join(WORK, "pileup_shards")
    os.makedirs(shard_dir)
    bins.save_pileup_shard(os.path.join(shard_dir, f"{contig}.npz"), shard)
    gen = torch.Generator().manual_seed(SEED)
    pparams = init_pileup_params(gen, cfg.pileup_model)
    ckpt = os.path.join(WORK, "pileup.chkpt")
    torch.save(pileup_checkpoint_from_params(pparams), ckpt)
    log(f"[data]  pileup world: {length} bp, {n_cand} candidates, "
        f"{len(shard.columns)} columns ({time.monotonic() - t0:.1f} s)")

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from nanosnp_tpu_torch.ops import bilstm as K
    from nanosnp_tpu_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc: "
        f"{nvcc.stdout.strip().splitlines()[-1]}")
    dev = torch.device("cuda", 0)
    t0 = time.monotonic()
    reports = build.build_all()
    log(f"[build] {time.monotonic() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")

    t0 = time.monotonic()
    rows = phase_kernels(dev)
    log(f"[phase 1] {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    launches, stage_rows = phase_slice(dev)
    log(f"[phase 2] {time.monotonic() - t0:.1f} s")

    kernels = []
    for name in ("bilstm_stream", "bilstm_center"):
        n_launch = sum(v[name] for v in launches.values())
        if n_launch <= 0:
            raise AssertionError(f"{name} was never launched on the path")
        mine = [r for r in rows if r["name"] == name]
        # headline numbers: the heaviest shape on the path
        top = max(mine, key=lambda r: r["bound_ms"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "nanosnp_tpu_torch/ops/csrc/bilstm.cu",
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
