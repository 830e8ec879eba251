"""Concrete pipeline stages (the reference's s1..s6), the counterpart of
nanosnp_tpu/runtime/stages.py:

  s1 pileup features     BAM or mpileup(+ref) -> pileup shards
  s2 pileup predict      shards -> pileup.vcf                  [device]
  s3 phasing             pileup.vcf + BAM -> read->HP partition (native
                         read-backed phaser; the external whatshap route
                         is driven from the CLI)
  s4 haplotype features  pileup.vcf + BAM (+HP) -> haplotype shards
  s5 haplotype predict   shards -> haplotype.csv               [device]
  s6 merge               pileup.vcf + haplotype.csv -> merge.vcf
s1, s3, s4 and s6 are host code (C++ engine and numpy), the same code as
in the JAX package. Every stage that uses the device takes `device`
("cuda" unless the caller asks for "cpu"). A failed build of the native
engine raises from the stage that needs it: nothing carries on in pure
Python.
"""
from __future__ import annotations

import io
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import constants as C
from ..config import PipelineConfig
from ..decode.merge import merge_calls
from ..decode.pileup_vcf import (calculate_score, decode_pileup_calls_fast,
                                 write_vcf_header)
from ..device import resolve_device
from ..features.haplotype import (build_groups, chunk_groups, collect_sites,
                                  haplotype_features, ref_position_codes,
                                  ref_window_codes)
from ..features.pileup import (CandidateBatch, assemble_windows,
                               predict_batch)
from ..io import bins
from ..io.fasta import FastaReference
from ..models.convert import load_pileup_checkpoint
from ..models.haplotype_model import HaplotypeModel, haplotype_predict
from ..models.pileup_model import PileupModel, pileup_predict
from ..parallel.inference import BatchedPredictor
from ..utils.profiling import count, session, span

def split_mpileup_by_contig(mpileup_path: str, out_dir: str,
                            contigs: Optional[Sequence[str]] = None) -> List[str]:
    """Split one mpileup stream into per-contig files (the reference's
    DNA_ExtractChrPileupData, extract_chr_pileup_data/main.cpp:21-80).
    Single pass; contig filter optional."""
    os.makedirs(out_dir, exist_ok=True)
    want = set(contigs) if contigs else None
    written: List[str] = []
    cur_name = None
    cur_f = None
    with open(mpileup_path, "rb", buffering=1 << 20) as f:
        for line in f:
            tab = line.find(b"\t")
            name = line[:tab].decode()
            if name != cur_name:
                if cur_f:
                    cur_f.close()
                cur_name = name
                if want is not None and name not in want:
                    cur_f = None
                else:
                    path = os.path.join(out_dir, f"{name}.mpileup")
                    cur_f = open(path, "wb", buffering=1 << 20)
                    written.append(name)
            if cur_f:
                cur_f.write(line)
    if cur_f:
        cur_f.close()
    return written


def _carry_suffix(lines: List[bytes], overlap_rows: int) -> List[bytes]:
    """Trailing lines containing at least `overlap_rows` PARSEABLE rows
    (>= 6 tab fields, integer position — the native parser's keep
    criteria). Counting raw lines would under-carry when malformed lines
    sit near the boundary, truncating a deferred candidate's left flank;
    junk lines inside the suffix are harmless (the parser drops them)."""
    n_ok = 0
    for i in range(len(lines) - 1, -1, -1):
        fields = lines[i].split(b"\t", 2)
        if len(fields) >= 3 and fields[1].isdigit() \
                and lines[i].count(b"\t") >= 5:
            n_ok += 1
            if n_ok >= overlap_rows:
                return lines[i:]
    return list(lines)


def _iter_mpileup_units(path: str, overlap_rows: int,
                        chunk_bytes: int = 32 << 20):
    """Stream a per-contig mpileup file as (unit_lines, n_carry, is_final)
    triples, where each unit = the previous unit's trailing lines covering
    `overlap_rows` parseable rows + one chunk of new complete lines. The
    overlap re-creates the reference's O(window) ring buffer
    (make_candidate_snp_tensor/main.cpp:126-217): every candidate sees its
    full +-flank row context in exactly one unit."""
    carry: List[bytes] = []
    tail = b""
    pending: Optional[List[bytes]] = None
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk_bytes)
            if not block:
                break
            data = tail + block
            nl = data.rfind(b"\n")
            if nl < 0:
                tail = data
                continue
            tail = data[nl + 1:]
            lines = data[: nl + 1].splitlines(keepends=True)
            if pending is not None:
                yield pending, len(carry), False
                carry = _carry_suffix(pending, overlap_rows)
            pending = carry + lines
    if tail:
        last = [tail if tail.endswith(b"\n") else tail + b"\n"]
        pending = (pending or carry) + last if pending is not None \
            else carry + last
    if pending is not None:
        yield pending, len(carry), True


def stage_pileup_features(
    cfg: PipelineConfig,
    ref: FastaReference,
    chr_mpileup_dir: str,
    out_dir: str,
    contigs: Optional[Sequence[str]] = None,
    chunk_bytes: int = 32 << 20,
) -> Dict:
    """s1: per-contig mpileup -> candidate windows -> pileup shards.

    The text is processed in streaming units (O(chunk) memory, not
    O(contig): chr1 at 30x is tens of GB of mpileup text). A candidate is
    emitted by the first unit that contains its full right flank; the
    position bound dedupes across the unit overlap."""
    from ..io.native import parse_mpileup_native

    os.makedirs(out_dir, exist_ok=True)
    contigs = list(contigs) if contigs else sorted(
        (f[:-len(".mpileup")] for f in os.listdir(chr_mpileup_dir)
         if f.endswith(".mpileup")), key=C.contig_sort_key)
    total_rows = 0
    total_cand = 0
    t0 = time.monotonic()
    fc = cfg.pileup_feature
    flank = fc.flanking_bases
    overlap = 2 * flank + 1
    for ctg in contigs:
        path = os.path.join(chr_mpileup_dir, f"{ctg}.mpileup")
        if not os.path.exists(path):
            continue
        seq = ref.contig(ctg)
        flusher = _ShardFlusher(ctg, out_dir, flank)
        prev_bound = 0
        for unit_lines, n_carry, final in _iter_mpileup_units(
                path, overlap, chunk_bytes):
            text = b"".join(unit_lines)
            pile = parse_mpileup_native(
                text, ctg, seq,
                snp_min_af=fc.snp_min_af, indel_min_af=fc.indel_min_af,
                min_coverage=fc.min_depth, max_indel=fc.max_indel_size,
                n_threads=cfg.threads or 0)
            total_rows += len(unit_lines) - n_carry
            if final:
                bound = None
            else:
                # rows in the last `flank` lines lack their right flank in
                # this unit; they re-appear in the next unit's carry
                bound = int(pile.positions[-(flank + 1)]) \
                    if len(pile.positions) > flank else prev_bound
            sub = assemble_windows(pile, seq, flank,
                                   emit_lo=prev_bound, emit_hi=bound)
            if bound is not None:
                prev_bound = max(prev_bound, bound)
            if len(sub) == 0:
                continue
            fsub = predict_batch(sub)
            if len(fsub) == 0:
                continue
            flusher.add(fsub)
        total_cand += flusher.finish()
    dt = time.monotonic() - t0
    return {"rows": total_rows, "candidates": total_cand,
            "rows_per_s": round(total_rows / dt, 1) if dt else 0}


def _slice_candidates(b: CandidateBatch, lo: int, hi: int) -> CandidateBatch:
    """Candidate-row slice sharing the full column store (unreferenced
    columns are harmless — see predict_batch)."""
    return CandidateBatch(b.chrom, b.positions[lo:hi],
                          ref_seqs=b.ref_seqs[lo:hi],
                          alt_info=b.alt_info[lo:hi], depths=b.depths[lo:hi],
                          columns=b.columns, cand_off=b.cand_off[lo:hi],
                          flank=b.flank)


class _ShardFlusher:
    """Bounded columnar accumulation for one contig's s1 output.

    A whole-contig shard would hold every candidate column in RAM at once,
    then again for its npz write and for s2's reload. Parts are written
    every
    NSP_S1_FLUSH_CANDIDATES candidates (default 500k). Every non-final
    part is a multiple of 1000 candidates: the bug-compat decode's
    fallback-alt quirk depends on its 1000-row batch composition
    (reference predict.py batches each contig file from row 0), so
    aligned parts keep every batch window identical to whole-contig
    numbering and the VCF byte-exact. Caps below 1000 (tests) use the
    cap itself as the quantum — alignment, and therefore bug-compat
    byte-parity, then needs bug_compat=False.
    """

    def __init__(self, ctg: str, out_dir: str, flank: int):
        self.ctg, self.out_dir, self.flank = ctg, out_dir, flank
        self.cap = int(os.environ.get("NSP_S1_FLUSH_CANDIDATES", "500000"))
        self.quantum = 1000 if self.cap >= 1000 else max(self.cap, 1)
        self.chunks: List[CandidateBatch] = []
        self.pending = 0
        self.part = 0
        self.total = 0
        # stale parts from a previous run (possibly with a different
        # flush cap) must not survive a rerun
        for f in os.listdir(out_dir):
            if f == f"{ctg}.npz" or (f.startswith(f"{ctg}.part")
                                     and f.endswith(".npz")):
                os.unlink(os.path.join(out_dir, f))

    def add(self, batch: CandidateBatch) -> None:
        self.chunks.append(batch)
        self.pending += len(batch)
        if self.pending >= self.cap:
            self._flush(final=False)

    def finish(self) -> int:
        self._flush(final=True)
        return self.total

    def _flush(self, final: bool) -> None:
        n = self.pending if final else (self.pending
                                        - self.pending % self.quantum)
        if not final and n == 0:
            return
        take: List[CandidateBatch] = []
        rest: List[CandidateBatch] = []
        got = 0
        for b in self.chunks:
            if got >= n:
                rest.append(b)
            elif got + len(b) <= n:
                take.append(b)
                got += len(b)
            else:
                k = n - got
                take.append(_slice_candidates(b, 0, k))
                rest.append(_slice_candidates(b, k, len(b)))
                got = n
        shard = _columnar_shard(self.ctg, take, self.flank)
        if final and self.part == 0:
            name = f"{self.ctg}.npz"
        elif len(shard) or not final:
            name = f"{self.ctg}.part{self.part:04d}.npz"
        else:                       # empty tail after earlier parts
            self.chunks = rest
            self.pending -= n
            return
        bins.save_pileup_shard(os.path.join(self.out_dir, name), shard)
        self.total += len(shard)
        self.chunks = rest
        self.pending -= n
        self.part += 1


def _columnar_shard(ctg: str, chunks: List[CandidateBatch],
                    flank: int) -> bins.PileupShard:
    """Concatenate per-chunk columnar batches into one shard (each chunk's
    cand_off shifts by the columns accumulated before it)."""
    cols_l, offs_l, poss_l, refs_l, alts = [], [], [], [], []
    n_cols = 0
    for b in chunks:
        cols_l.append(b.columns)
        offs_l.append(b.cand_off + n_cols)
        n_cols += len(b.columns)
        poss_l.append(b.positions)
        refs_l.append(b.ref_seqs)
        alts.extend(b.alt_info)
    w = 2 * flank + 1
    return bins.PileupShard(
        contig=ctg,
        positions=(np.concatenate(poss_l) if poss_l
                   else np.zeros(0, np.int64)),
        ref_seqs=(np.concatenate(refs_l).astype(f"S{w}", copy=False)
                  if refs_l else np.zeros(0, dtype=f"S{w}")),
        alt_info=(np.asarray([a.encode() for a in alts], dtype="S")
                  if alts else np.zeros(0, dtype="S")),
        columns=(np.concatenate(cols_l) if cols_l
                 else np.zeros((0, 18), np.int16)),
        cand_off=(np.concatenate(offs_l) if offs_l
                  else np.zeros(0, np.int64)),
        flank=flank,
    )


def stage_pileup_features_from_bam(
    cfg: PipelineConfig,
    ref: FastaReference,
    bam_path: str,
    out_dir: str,
    contigs: Optional[Sequence[str]] = None,
    chunk_size: int = 2_000_000,
) -> Dict:
    """s1 without samtools: direct BAM -> candidate windows -> shards.

    Replaces the reference's mpileup-text round trip (make_predict_data.sh
    steps 1-3) with chunked native pileup; chunks overlap by the window
    flank so candidates near boundaries get full windows, and each
    candidate is emitted by exactly one chunk (center within the chunk)."""
    from ..io.bam import BamFile

    os.makedirs(out_dir, exist_ok=True)
    fc = cfg.pileup_feature
    flank = fc.flanking_bases
    total_rows = 0
    total_cand = 0
    t0 = time.monotonic()
    with BamFile(bam_path) as bam:
        bam_refs = dict(bam.references())
        want = list(contigs) if contigs else sorted(
            (n for n in bam_refs if n in ref.by_name), key=C.contig_sort_key)
        n_workers = max(cfg.threads or (os.cpu_count() or 4), 1)
        for ctg in want:
            if ctg not in bam_refs or ctg not in ref.by_name:
                continue
            seq = ref.contig(ctg)
            length = len(seq)
            piles_rows = 0
            # O(chunk-group) output: part shards via _ShardFlusher
            # (parts sort after each other, so s2's filename-ordered
            # decode keeps ascending positions)
            flusher = _ShardFlusher(ctg, out_dir, flank)

            def one_chunk(s):
                e = min(s + chunk_size, length)
                # the native region call releases the GIL; the open handle
                # is read-only after indexing, so chunks run in parallel
                pile = bam.pileup_region(
                    ctg, max(s - flank, 0), min(e + flank, length), seq,
                    snp_min_af=fc.snp_min_af, indel_min_af=fc.indel_min_af,
                    min_coverage=fc.min_depth, max_indel=fc.max_indel_size,
                    min_mq=fc.mpileup_min_mq,
                    excl_flags=fc.mpileup_excl_flags,
                    max_depth=fc.mpileup_max_depth,
                    depth_mode=fc.depth_mode)
                rows = int(((pile.positions > s) & (pile.positions <= e)).sum())
                batch = assemble_windows(pile, seq, flank,
                                         emit_lo=s, emit_hi=e)
                if len(batch) == 0:
                    return rows, None
                fsub = predict_batch(batch)
                return rows, (fsub if len(fsub) else None)

            starts = list(range(0, length, chunk_size))
            with ThreadPoolExecutor(max_workers=n_workers) as ex:
                for rows, payload in ex.map(one_chunk, starts):
                    piles_rows += rows
                    if payload is not None:
                        flusher.add(payload)
            total_cand += flusher.finish()
            total_rows += piles_rows
    dt = time.monotonic() - t0
    return {"rows": total_rows, "candidates": total_cand,
            "rows_per_s": round(total_rows / dt, 1) if dt else 0}


# ---------------------------------------------------------------------------
# model loading, once a process, and its prewarm threads
# ---------------------------------------------------------------------------

_MODELS: Dict[tuple, torch.nn.Module] = {}
_MODELS_LOCK = threading.Lock()


def _file_key(kind: str, cfg_repr: str, path: str, device) -> tuple:
    st = os.stat(path)
    return (kind, cfg_repr, os.path.abspath(path), st.st_size, st.st_mtime_ns,
            str(device))


def load_pileup_model(cfg: PipelineConfig, model_path: str,
                      device) -> PileupModel:
    """The s2 model of the reference-layout checkpoint at `model_path`, on
    `device`; loaded and uploaded once a process (keyed on the file and the
    model config), so a prewarm thread's work is what the stage finds."""
    device = resolve_device(device)
    key = _file_key("pileup", repr(cfg.pileup_model), model_path, device)
    with _MODELS_LOCK:
        model = _MODELS.get(key)
        if model is None:
            params = load_pileup_checkpoint(model_path,
                                            cfg.pileup_model.n_layers)
            model = _MODELS[key] = PileupModel(cfg.pileup_model,
                                               params).to(device)
    return model


def load_haplotype_model(cfg: PipelineConfig, model_path: str,
                         device) -> HaplotypeModel:
    """The s5 model of the checkpoint (.npz or pickle) at `model_path`, on
    `device`; cached like `load_pileup_model`."""
    from ..train.train_pileup import load_checkpoint

    device = resolve_device(device)
    key = _file_key("haplotype", repr(cfg.haplotype_model), model_path,
                    device)
    with _MODELS_LOCK:
        model = _MODELS.get(key)
        if model is None:
            params, _ = load_checkpoint(model_path)
            model = _MODELS[key] = HaplotypeModel(cfg.haplotype_model,
                                                  params).to(device)
    return model


class PrewarmThread(threading.Thread):
    """Runs `fn` in the background and keeps what it raised: `join_raise`
    waits and re-raises it in the caller."""

    def __init__(self, name: str, fn: Callable[[], None]):
        super().__init__(name=name, daemon=True)
        self._fn = fn
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self._fn()
        except BaseException as e:   # re-raised by join_raise
            self.error = e

    def join_raise(self, timeout: Optional[float] = None) -> None:
        self.join(timeout)
        if self.error is not None:
            err, self.error = self.error, None
            raise err


_PREWARM_THREADS: List[PrewarmThread] = []


def _warm_device(device) -> None:
    """What a first call on the card pays before any model work: the CUDA
    context and the build (nvcc, at most once a checkout) and load of the
    kernels' library."""
    if device.type == "cuda":
        from ..ops.build import library

        torch.zeros(1, device=device)
        library("bilstm")
        torch.cuda.synchronize(device)


def prewarm_pileup_model(cfg: PipelineConfig, model_path: str,
                         device="cuda") -> PrewarmThread:
    """Get s2 ready on a background thread while s1 runs on the host.
    There is no compile to hide here as in the JAX package; what a cold
    s2 pays is the kernels' build and library load, the CUDA context and
    the weights' upload. The caller joins the thread (`join_raise`) before
    s2, which re-raises whatever it raised."""
    device = resolve_device(device)

    def warm():
        _warm_device(device)
        load_pileup_model(cfg, model_path, device)

    t = PrewarmThread("s2-prewarm", warm)
    t.start()
    _PREWARM_THREADS.append(t)
    return t


def prewarm_haplotype_model(cfg: PipelineConfig, model_path: str,
                            device="cuda") -> PrewarmThread:
    """Get s5 ready on a background thread while s1-s4 run; see
    `prewarm_pileup_model`."""
    device = resolve_device(device)

    def warm():
        _warm_device(device)
        load_haplotype_model(cfg, model_path, device)

    t = PrewarmThread("s5-prewarm", warm)
    t.start()
    _PREWARM_THREADS.append(t)
    return t


def join_prewarm_threads(timeout: Optional[float] = None) -> None:
    """Wait for every outstanding prewarm thread and re-raise the first
    error one of them kept."""
    first: Optional[BaseException] = None
    while _PREWARM_THREADS:
        try:
            _PREWARM_THREADS.pop().join_raise(timeout)
        except BaseException as e:
            first = first or e
    if first is not None:
        raise first


# columns per s2 device unit: 4M columns x 18 int16 = 144 MiB per upload
_UNIT_COLUMNS = 1 << 22


def compute_dtype(cfg: PipelineConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.inference.use_bf16 else torch.float32


def resolve_use_pallas(cfg: PipelineConfig, device) -> bool:
    """Whether the encoders take the kernel route (the counterpart of the
    JAX package's _resolve_use_pallas): `auto` exactly on a CUDA device,
    where the JAX package resolves it to its Pallas kernels on the TPU and
    to its lax.scan on the CPU; `true` and `false` stand as given."""
    v = cfg.inference.use_pallas
    if v == "auto":
        return torch.device(device).type == "cuda"
    return bool(v)


def encoder_route(cfg: PipelineConfig, device) -> str:
    """The models' `route` for the serving stages: "kernels" or "scan"."""
    return "kernels" if resolve_use_pallas(cfg, device) else "scan"


def pileup_model_predictor(cfg: PipelineConfig, model: PileupModel,
                           device) -> BatchedPredictor:
    """Dense-window s2 predictor: [B, 33, 18] int16 counts -> (gt, zy)."""
    dtype = compute_dtype(cfg)
    route = encoder_route(cfg, device)

    def fn(x):
        return pileup_predict(model, x.float(), compute_dtype=dtype,
                              route=route)

    return BatchedPredictor(fn, batch_size=cfg.inference.batch_size,
                            device=device)


def pileup_columnar_fn(cfg: PipelineConfig, model: PileupModel, device):
    """(columns [U, 18] int16, idx [B] int64) on the device -> (gt, zy):
    gathers each candidate's 33-wide window from the resident column union
    on the device, then runs the pileup model."""
    dtype = compute_dtype(cfg)
    route = encoder_route(cfg, device)
    flank = (cfg.pileup_model.seq_len - 1) // 2

    def fn(cols, idx):
        offs = torch.arange(-flank, flank + 1, device=cols.device)
        w = cols[idx[:, None] + offs[None, :]]               # [B, 33, 18]
        return pileup_predict(model, w.float(), compute_dtype=dtype,
                              route=route)

    return fn


@torch.inference_mode()
def run_pileup_columnar(cfg: PipelineConfig, model: PileupModel,
                        shard: bins.PileupShard, device
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """s2 device feed for v2 columnar shards: the column union goes to the
    device once per unit, each batch's windows are gathered there, and a
    unit's results are fetched once, one unit behind the launches."""
    device = resolve_device(device)
    fn = pileup_columnar_fn(cfg, model, device)
    bs = cfg.inference.batch_size
    flank = shard.flank
    cand_off = shard.cand_off
    n = len(cand_off)
    gts: List[np.ndarray] = []
    zys: List[np.ndarray] = []
    pending: List = []

    def drain_one():
        gt_d, zy_d = pending.pop(0)
        gts.append(gt_d.cpu().numpy())
        zys.append(zy_d.cpu().numpy())

    i = 0
    while i < n:
        lo = int(cand_off[i]) - flank
        # largest j with cand_off[j-1] + flank < lo + _UNIT_COLUMNS
        j = max(int(np.searchsorted(cand_off, lo + _UNIT_COLUMNS - flank,
                                    side="left")), i + 1)
        hi = int(cand_off[j - 1]) + flank + 1
        cols = torch.from_numpy(np.ascontiguousarray(shard.columns[lo:hi]))
        if device.type == "cuda":
            cols = cols.pin_memory()
        idx = torch.from_numpy(cand_off[i:j] - lo)
        count("nsp.h2d_bytes", cols.nbytes + idx.nbytes)
        cols_dev = cols.to(device, non_blocking=True)
        idx_dev = idx.to(device, non_blocking=True)
        outs = [fn(cols_dev, idx_dev[s: s + bs]) for s in range(0, j - i, bs)]
        pending.append((torch.cat([o[0] for o in outs]),
                        torch.cat([o[1] for o in outs])))
        while len(pending) > 1:
            drain_one()
        i = j
    while pending:
        drain_one()
    if not gts:
        return (np.zeros((0, cfg.pileup_model.gt_num_class), np.float32),
                np.zeros((0, cfg.pileup_model.zy_num_class), np.float32))
    return np.concatenate(gts), np.concatenate(zys)


@session("nsp.s2")
def stage_pileup_predict(
    cfg: PipelineConfig,
    ref: FastaReference,
    shard_dir: str,
    output_vcf: str,
    params=None,
    model_path: Optional[str] = None,
    device="cuda",
) -> Dict:
    """s2: pileup shards -> VCF. `params` is the port's parameter tree;
    without it the reference-layout checkpoint at `model_path` is loaded
    (once a process, see `load_pileup_model`).

    A tracing session (utils/profiling.py), `nsp.s2`: the device worker's
    `nsp.s2.load` and `nsp.s2.infer` a shard, the decode pool's
    `nsp.s2.decode` a task, the main thread's `nsp.s2.write_wait` (for
    a shard's results or a decoded task) and `nsp.s2.write`."""
    device = resolve_device(device)
    if params is None:
        model = load_pileup_model(cfg, model_path, device)
    else:
        model = PileupModel(cfg.pileup_model, params).to(device)
    predictor = pileup_model_predictor(cfg, model, device)

    n_sites = 0
    t0 = time.monotonic()
    paths = bins.list_shards(shard_dir)

    # one worker keeps the device busy a shard ahead; decode fans out over
    # a thread pool into per-shard buffers (numpy string kernels release
    # the GIL); the main thread writes the buffers in shard order
    def infer(path):
        with span("nsp.s2.load"):
            shard = bins.load_pileup_shard(path)
        if len(shard) == 0:
            return None
        with span("nsp.s2.infer"):
            if shard.columns is not None:
                gt, zy = run_pileup_columnar(cfg, model, shard, device)
            else:
                # compact int16 counts go to the device, cast to f32 there
                gt, zy = predictor.run(shard.matrix.astype(np.int16,
                                                           copy=False))
        return shard, gt, zy

    decode_split = 100_000   # rows per decode task

    def decode(res, lo, hi):
        shard, gt, zy = res
        buf = io.StringIO()
        with span("nsp.s2.decode"):
            ref_bases = [r.decode()[16] for r in shard.ref_seqs[lo:hi]]
            decode_pileup_calls_fast(
                shard.contig, shard.positions[lo:hi], ref_bases,
                gt[lo:hi], zy[lo:hi], shard.center_counts[lo:hi], buf,
                batch_size=1000, bug_compat=cfg.inference.bug_compat)
        return hi - lo, buf.getvalue()

    n_dec = max(min((cfg.threads or (os.cpu_count() or 4)) - 1, 4), 1)
    with open(output_vcf, "w") as out, \
            ThreadPoolExecutor(max_workers=1) as ex_dev, \
            ThreadPoolExecutor(max_workers=n_dec) as ex_dec:
        write_vcf_header(ref.fasta_path + ".fai", out)
        infer_q: List = []
        decode_q: List = []
        idx = 0
        while decode_q or infer_q or idx < len(paths):
            while idx < len(paths) and len(infer_q) < 2:
                infer_q.append(ex_dev.submit(infer, paths[idx]))
                idx += 1
            while infer_q and (infer_q[0].done() or len(decode_q) == 0) \
                    and len(decode_q) < 2 * n_dec + 2:
                with span("nsp.s2.write_wait"):
                    res = infer_q.pop(0).result()
                if res is None:
                    continue
                n_rows = len(res[0])
                for lo in range(0, n_rows, decode_split):
                    decode_q.append(ex_dec.submit(
                        decode, res, lo, min(lo + decode_split, n_rows)))
            if not decode_q:
                continue
            with span("nsp.s2.write_wait"):
                n, text = decode_q.pop(0).result()
            with span("nsp.s2.write"):
                out.write(text)
            n_sites += n
    dt = time.monotonic() - t0
    return {"sites": n_sites, "sites_per_s": round(n_sites / dt, 1) if dt else 0}


# Signature: (contig, sub_groups [G,11] positions, pileup window flank)
# -> dict with read matrices, or None to skip the chunk.
ReadMatrixExtractor = Callable[[str, np.ndarray, int], Optional[Dict[str, np.ndarray]]]



def stage_haplotype_features(
    cfg: PipelineConfig,
    ref: FastaReference,
    pileup_vcf: str,
    extractor: ReadMatrixExtractor,
    out_dir: str,
) -> Dict:
    """s4: group selection + read-matrix extraction -> haplotype shards.

    The extractor abstracts BAM access (native htslib-free reader, or any
    source of read matrices). Padding/truncation semantics follow
    write_to_bins.py:15-42: pad depth with -2 to the chunk max, truncate to
    the configured caps keeping the first rows after HP-sort.
    """
    os.makedirs(out_dir, exist_ok=True)
    # clear leftovers from a crashed/partial previous run: shard part
    # counts depend on the flush cap, so stale higher-numbered part files
    # would otherwise survive a rerun and feed s5 duplicate groups
    for old in os.listdir(out_dir):
        if old.endswith(".npz"):
            os.unlink(os.path.join(out_dir, old))
    hf = cfg.haplotype_feature
    with open(pileup_vcf) as f:
        sites = collect_sites(f, hf.low_quality_threshold)
    n_groups = 0
    # one background writer (see the `with` below): the per-contig
    # concat+compress+save overlaps the NEXT contig's extraction
    write_futures = []

    def write_contig(ctg, pools, part):
        n = 0
        for (dpb, dhb), shards in pools.items():
            merged = _concat_haplotype_shards(ctg, shards, dpb, dhb)
            suffix = "" if part == 0 else f"_p{part}"
            bins.save_haplotype_shard(
                os.path.join(out_dir, f"{ctg}_d{dpb}x{dhb}{suffix}.npz"),
                merged)
            n += 1
        return n

    # Cap the groups accumulated in RAM before a flush: without it a whole
    # contig's chunk shards sit in the pools until the single per-contig
    # write. Mid-contig flushes bound s4's working set AND s5's per-file
    # load; s5 batches within each file, so 256k-group files keep its
    # batches full.
    flush_groups = int(os.environ.get("NSP_S4_FLUSH_GROUPS", 262144))

    with ThreadPoolExecutor(max_workers=1) as writer:
        for ctg in sorted(sites, key=C.contig_sort_key):
            groups = build_groups(sites[ctg], hf.adjacent_size,
                                  hf.low_quality_threshold, hf.hete_support_quality)
            if len(groups) == 0:
                continue
            # consolidate extraction chunks into one shard per (contig,
            # depth-bucket pair): depths pad up to the bucket so chunks with
            # similar depth concatenate, giving s5 large batches instead of
            # one <=100-site file per chunk (reference predict_dev.py:33
            # batches 1000 across a whole bin file; we batch 8k+ across the
            # contig). Chunks extract in parallel (the reference fans a
            # multiprocessing.Pool, make_predict_bins.py:157-164; here threads
            # suffice — the native region fetch and numpy slicing release the
            # GIL); pools keep chunk order via the ordered map().
            pools: Dict[tuple, List[bins.HaplotypeShard]] = {}
            chunks = chunk_groups(groups)
            n_workers = max(min(cfg.threads or (os.cpu_count() or 4),
                                len(chunks)), 1)

            def extract_one(chunk):
                try:
                    mats = extractor(ctg, chunk, hf.pileup_flanking_size,
                                     packed=True)
                except TypeError:   # custom extractor without the packed path
                    mats = extractor(ctg, chunk, hf.pileup_flanking_size)
                if mats is None:
                    return None
                # the extractor may drop coverage-failed groups; align the
                # position columns with the groups it actually kept
                return _pack_haplotype_shard(ctg, mats.get("groups", chunk),
                                             mats, hf)

            part = 0
            pool_groups = 0
            with ThreadPoolExecutor(max_workers=n_workers) as ex:
                for shard in ex.map(extract_one, chunks):
                    if shard is None:
                        continue
                    key = (bins.depth_bucket(shard.pileup["sequences"].shape[1]),
                           bins.depth_bucket(shard.haplotype["sequences"].shape[1]))
                    pools.setdefault(key, []).append(shard)
                    n_groups += len(shard)
                    pool_groups += len(shard)
                    if pool_groups >= flush_groups:
                        # backpressure: each queued flush pins a full pool in
                        # RAM, so an unbounded writer backlog would defeat the
                        # cap — block extraction once >2 flushes are pending
                        while sum(not f.done() for f in write_futures) > 2:
                            write_futures[-2].result()
                        write_futures.append(
                            writer.submit(write_contig, ctg, pools, part))
                        pools = {}
                        pool_groups = 0
                        part += 1
            if pools:
                write_futures.append(writer.submit(write_contig, ctg, pools,
                                                   part))
                pools = {}
        n_shards = sum(f.result() for f in write_futures)
    return {"groups": n_groups, "shards": n_shards}


def _concat_haplotype_shards(ctg: str, shards: List[bins.HaplotypeShard],
                             dp_bucket: int, dh_bucket: int) -> bins.HaplotypeShard:
    """Concatenate chunk shards, padding each view's depth (axis 1) up to
    the shared bucket with the -2 pad value."""
    def cat(view: str, bucket: int) -> Dict[str, np.ndarray]:
        out = {}
        for k in bins._KEYS:
            parts = []
            for s in shards:
                a = getattr(s, view)[k]
                if a.shape[1] < bucket:
                    a = np.pad(a, ((0, 0), (0, bucket - a.shape[1]), (0, 0)),
                               constant_values=C.PAD_VALUE)
                parts.append(a)
            out[k] = np.concatenate(parts)
        return out

    return bins.HaplotypeShard(
        contig=ctg,
        candidate_positions=np.concatenate(
            [s.candidate_positions for s in shards]),
        group_positions=np.concatenate([s.group_positions for s in shards]),
        pileup=cat("pileup", dp_bucket),
        haplotype=cat("haplotype", dh_bucket),
    )


def _pack_haplotype_shard(ctg, groups, mats, hf) -> Optional[bins.HaplotypeShard]:
    """Pad per-site ragged read matrices to the chunk max depth with -2 and
    apply depth caps (first rows kept, as the reference truncates after
    HP-sorting)."""
    if "packed" in mats:
        # extractor already produced depth-padded [G, D, L] arrays; only
        # the per-view depth caps remain
        if len(groups) == 0:
            return None
        pk = mats["packed"]

        def capped(view, cap):
            arrs = pk[view]
            d = arrs["sequences"].shape[1]
            dc = max(min(d, cap) if cap is not None else d, 1)
            return {k: np.ascontiguousarray(a[:, :dc])
                    for k, a in arrs.items()}

        return bins.HaplotypeShard(
            contig=ctg,
            candidate_positions=groups[:, groups.shape[1] // 2].astype(
                np.int64),
            group_positions=groups.astype(np.int64),
            pileup=capped("pileup", hf.max_pileup_depth),
            haplotype=capped("haplotype", hf.max_haplotype_depth),
        )

    def pack(key_prefix, cap):
        arrs = mats[key_prefix]  # list of dicts of [d_i, L] arrays
        if not arrs:
            return None
        maxd = max(a["sequences"].shape[0] for a in arrs)
        if cap is not None:
            maxd = min(maxd, cap) if maxd > 0 else maxd
        packed = {}
        for k in bins._KEYS:
            # pack straight into the compact storage dtype (int8/int16,
            # bins._KEY_DTYPE): downstream concat/save/ship then never
            # touch int32-wide copies
            out = np.full((len(arrs), max(maxd, 1), arrs[0][k].shape[1]),
                          C.PAD_VALUE, dtype=bins._KEY_DTYPE[k])
            for i, a in enumerate(arrs):
                d = min(a[k].shape[0], maxd)
                out[i, :d] = a[k][:d]
            packed[k] = out
        return packed

    pileup = pack("pileup", hf.max_pileup_depth)
    haplotype = pack("haplotype", hf.max_haplotype_depth)
    if pileup is None or haplotype is None:
        return None
    return bins.HaplotypeShard(
        contig=ctg,
        candidate_positions=groups[:, groups.shape[1] // 2].astype(np.int64),
        group_positions=groups.astype(np.int64),
        pileup=pileup,
        haplotype=haplotype,
    )



def haplotype_model_predictor(cfg: PipelineConfig, model: HaplotypeModel,
                              device) -> BatchedPredictor:
    """Haplotype model on [B, 33, 105] / [B, 11, 105] features (already on
    the device) -> (gt, zy) probabilities."""
    dtype = compute_dtype(cfg)
    route = encoder_route(cfg, device)

    def fn(xp, xh):
        return haplotype_predict(model, xp, xh, compute_dtype=dtype,
                                 route=route)

    return BatchedPredictor(fn, batch_size=cfg.inference.batch_size,
                            device=device)


def haplotype_featurizer(cfg: PipelineConfig, fs: int,
                         device) -> BatchedPredictor:
    """[B, D, L] int8/int16 read matrices of both views -> [B, L, 105]
    features of both views, on the device, in the compute dtype."""
    dtype = compute_dtype(cfg)

    def fn(seq_p, bq_p, mq_p, hap_p, ref_p, seq_h, bq_h, mq_h, hap_h, ref_h):
        xp = haplotype_features(seq_p, bq_p, mq_p, hap_p, ref_p)
        xh = haplotype_features(seq_h, bq_h, mq_h, hap_h, ref_h)
        return xp.to(dtype), xh.to(dtype)

    return BatchedPredictor(fn, batch_size=fs, device=device)


def _featurize_sub_batch(cfg: PipelineConfig, dp_b: int) -> int:
    """Featurize sub-batch size for a depth bucket: halve until activation
    memory is about the 128-depth reference point; halving keeps it a
    divisor of the model batch."""
    fs = cfg.inference.batch_size
    while fs * dp_b > cfg.inference.batch_size * 128 and fs > 512:
        fs //= 2
    return fs


def _defer_unphased(shard: bins.HaplotypeShard, frac: float):
    """(kept shard, number dropped): drop candidates whose covering reads
    in the haplotype view's candidate column are phased (HP 1/2) below
    `frac` (MergeConfig.defer_unphased_frac). No CSV row is emitted for
    them, so merge keeps the pileup call."""
    col = shard.haplotype["hap"][:, :, shard.haplotype["hap"].shape[2] // 2]
    covering = np.maximum((col != C.PAD_VALUE).sum(axis=1), 1)
    keep = ((col == 1) | (col == 2)).sum(axis=1) / covering >= frac
    n_drop = int((~keep).sum())
    if n_drop:
        shard = bins.HaplotypeShard(
            contig=shard.contig,
            candidate_positions=shard.candidate_positions[keep],
            group_positions=shard.group_positions[keep],
            pileup={k: v[keep] for k, v in shard.pileup.items()},
            haplotype={k: v[keep] for k, v in shard.haplotype.items()})
    return shard, n_drop


@session("nsp.s5")
def stage_haplotype_predict(
    cfg: PipelineConfig,
    ref: FastaReference,
    shard_dir: str,
    output_csv: str,
    params=None,
    device="cuda",
    model_path: Optional[str] = None,
) -> Dict:
    """s5: haplotype shards -> featurize on the device -> model -> calls
    CSV (rows `ctg\\tpos\\tGT\\tqual`, reference predict_dev.py:43-47).

    Raw int8 read matrices are pooled on the host per depth-bucket pair
    and shipped once; the features stay on the device and flow into the
    model; only the (gt, zy) probabilities come back. Deep buckets
    featurize in sub-batches that are concatenated on the device up to the
    model batch. `params` is the port's parameter tree; without it the
    checkpoint at `model_path` is loaded (once a process).

    A tracing session (utils/profiling.py), `nsp.s5`: `nsp.s5.list`
    (each shard opened for its contig), the loader thread's `nsp.s5.load`
    and the main thread's `nsp.s5.load_wait` a shard, `nsp.s5.pool`
    (deferral, padding, casts, reference codes, pooling), `nsp.s5.launch`
    (a pool's concatenation, featurizer and model dispatch),
    `nsp.s5.drain` (a batch's fetch and CSV lines), `nsp.s5.write` (a
    contig's rows sorted and written)."""
    device = resolve_device(device)
    if params is None:
        model = load_haplotype_model(cfg, model_path, device)
    else:
        model = HaplotypeModel(cfg.haplotype_model, params).to(device)
    model_pred = haplotype_model_predictor(cfg, model, device)
    model_bs = model_pred.batch_size
    featurizers: Dict[int, BatchedPredictor] = {}

    pools: Dict[tuple, Dict] = {}
    results: List[tuple] = []   # ((contig_key, pos), csv_line)
    pending: List[tuple] = []   # (meta_chunk, device (gt, zy))
    n_sites = 0
    n_deferred = 0
    t0 = time.monotonic()
    defer_frac = cfg.merge.defer_unphased_frac

    def drain_one():
        with span("nsp.s5.drain"):
            meta, res = pending.pop(0)
            gt = res[0].float().cpu().numpy()
            gt_arg = gt.argmax(axis=1)
            gt_max = gt.max(axis=1)
            for j, (ctg, pos) in enumerate(meta):
                qual = calculate_score(float(gt_max[j]))
                results.append(((C.contig_sort_key(ctg), pos),
                                f"{ctg}\t{pos}\t{C.GT21_LABELS[gt_arg[j]]}\t"
                                f"{qual}\n"))

    def flush(key, final: bool) -> None:
        with span("nsp.s5.launch"):
            pool = pools[key]
            n = len(pool["meta"])
            keep = 0 if final else n % model_bs
            run_n = n - keep
            if run_n == 0:
                return
            args = [np.concatenate([c[i] for c in pool["chunks"]])
                    for i in range(len(pool["chunks"][0]))]
            fs = _featurize_sub_batch(cfg, key[0])
            feat = featurizers.get(fs)
            if feat is None:
                feat = featurizers[fs] = haplotype_featurizer(cfg, fs, device)
            for start in range(0, run_n, model_bs):
                end = min(start + model_bs, run_n)
                parts = [feat.apply(*[a[s: min(s + fs, end)] for a in args])
                         for s in range(start, end, fs)]
                xp = torch.cat([p[0] for p in parts])
                xh = torch.cat([p[1] for p in parts])
                pending.append((pool["meta"][start:end],
                                model_pred.apply(xp, xh)))
                while len(pending) > 2:
                    drain_one()
            pool["meta"] = pool["meta"][run_n:]
            pool["chunks"] = [[a[run_n:] for a in args]] if keep else []

    # contig-grouped iteration: pools and result rows flush and are written
    # at every contig boundary, so host memory is O(contig)
    with span("nsp.s5.list"):
        paths = bins.list_shards(shard_dir)
        contig_of = {p: str(bins.open_npz(p)["contig"]) for p in paths}
        paths.sort(key=lambda p: (C.contig_sort_key(contig_of[p]), p))

    def load(path):
        with span("nsp.s5.load"):
            return bins.load_haplotype_shard(path)

    def flush_contig(out_f):
        for key in list(pools):
            flush(key, final=True)
        while pending:
            drain_one()
        with span("nsp.s5.write"):
            results.sort(key=lambda kv: kv[0])
            for _, line in results:
                out_f.write(line)
            results.clear()
            pools.clear()

    # the next shard loads (zstd/zlib inflate releases the GIL) while the
    # current one is pooled and featurized
    with open(output_csv, "w") as out_f, \
            ThreadPoolExecutor(max_workers=1) as loader:
        fut = loader.submit(load, paths[0]) if paths else None
        cur_contig: Optional[str] = None
        for i in range(len(paths)):
            with span("nsp.s5.load_wait"):
                shard = fut.result()
            fut = (loader.submit(load, paths[i + 1])
                   if i + 1 < len(paths) else None)
            if len(shard) == 0:
                continue
            if cur_contig is not None and shard.contig != cur_contig:
                flush_contig(out_f)
            cur_contig = shard.contig
            with span("nsp.s5.pool"):
                if defer_frac > 0.0:
                    shard, n_drop = _defer_unphased(shard, defer_frac)
                    n_deferred += n_drop
                    n_sites += n_drop   # deferred sites still count as seen
                    if len(shard) == 0:
                        continue
                seq = ref.contig(shard.contig)
                dp_b = bins.depth_bucket(shard.pileup["sequences"].shape[1])
                dh_b = bins.depth_bucket(shard.haplotype["sequences"].shape[1])
                # order matches the featurizer's signature (seq, baseq, mapq,
                # hap), not bins._KEYS, which lists hap second
                args = []
                for view, db in (("pileup", dp_b), ("haplotype", dh_b)):
                    d = getattr(shard, view)
                    n_pad = db - d["sequences"].shape[1]
                    for k in ("sequences", "baseq", "mapq", "hap"):
                        a = d[k] if n_pad == 0 else np.pad(
                            d[k], ((0, 0), (0, n_pad), (0, 0)),
                            constant_values=C.PAD_VALUE)
                        args.append(a.astype(bins._KEY_DTYPE[k], copy=False))
                    if view == "pileup":
                        args.append(ref_window_codes(
                            seq, shard.candidate_positions,
                            cfg.haplotype_feature.pileup_flanking_size
                        ).astype(np.int8))
                    else:
                        args.append(ref_position_codes(
                            seq, shard.group_positions).astype(np.int8))
                key = (dp_b, dh_b)
                pool = pools.setdefault(key, {"chunks": [], "meta": []})
                pool["chunks"].append(args)
                pool["meta"].extend(
                    (shard.contig, int(p)) for p in shard.candidate_positions)
                n_sites += len(shard)
            if len(pool["meta"]) >= model_bs:
                flush(key, final=False)
        flush_contig(out_f)
    dt = time.monotonic() - t0
    m = {"sites": n_sites,
         "sites_per_s": round(n_sites / dt, 1) if dt else 0}
    if defer_frac > 0.0:
        m["deferred"] = n_deferred
    return m


def stage_phase_native(
    cfg: PipelineConfig,
    ref: FastaReference,
    pileup_vcf: str,
    bam_path: str,
    out_dir: str,
    contigs: Optional[Sequence[str]] = None,
    emit_tagged_bams: bool = False,
) -> Dict:
    """s3 without whatshap: native read-backed phasing.

    Selects phasing-input hets exactly like the reference
    (select_high_quality_hetesnps.py, QUAL >= phase_het_quality), phases
    them from the read allele matrix (phase/native_phaser.py), writes a
    whatshap-style phased VCF per contig plus the read->HP partition
    ({contig}.hp.npz: read_ids + hp), which s4 injects in place of BAM HP
    tags — no tagged-BAM round trip."""
    from ..decode.sort import select_phasing_hetesnps
    from ..io.bam import BamFile
    from ..phase.native_phaser import phase_contig, write_phased_vcf

    os.makedirs(out_dir, exist_ok=True)
    hf = cfg.haplotype_feature
    with open(pileup_vcf) as f:
        header, per_contig = select_phasing_hetesnps(f, hf.phase_het_quality)
    want = set(contigs) if contigs else None
    t0 = time.monotonic()
    totals = {"sites": 0, "phased_sites": 0, "blocks": 0, "tagged_reads": 0}

    def one_contig(ctg):
        rows = per_contig[ctg]
        pos, refs, alts = [], [], []
        for row in rows:
            cols = row.split("\t")
            if len(cols[3]) == 1 and len(cols[4].split(",")[0]) == 1:
                pos.append(int(cols[1]))
                refs.append(cols[3])
                alts.append(cols[4].split(",")[0])
        if not pos:
            return None
        result = phase_contig(
            bam, ctg, np.asarray(pos, dtype=np.int64), refs, alts,
            window_bp=hf.phaser_window_bp, overlap_bp=hf.phaser_overlap_bp,
            min_mq=cfg.pileup_feature.mpileup_min_mq,
            min_block_sites=hf.phaser_min_block_sites)
        np.savez_compressed(
            os.path.join(out_dir, f"{ctg}.hp.npz"),
            read_ids=np.array(list(result.read_hp), dtype=np.int64),
            hp=np.array(list(result.read_hp.values()), dtype=np.int8))
        with open(os.path.join(out_dir, f"{ctg}.phased.vcf"), "w") as out:
            out.writelines(header)
            write_phased_vcf(result, rows, out)
        if emit_tagged_bams:
            # whatshap-haplotag's user-visible artifact, via the native
            # BGZF/BAM writer (the pipeline itself injects the partition
            # in-memory; these files serve external tooling / IGV)
            tag_dir = os.path.join(out_dir, "haplotag_out")
            os.makedirs(tag_dir, exist_ok=True)
            bam.write_tagged(os.path.join(tag_dir, f"{ctg}.bam"),
                             result.read_hp, contig=ctg)
        return len(pos), result

    todo = [c for c in sorted(per_contig, key=C.contig_sort_key)
            if want is None or c in want]
    # contig-parallel like the reference's GNU parallel fan-out; the heavy
    # parts (native region fetch, numpy matmuls) release the GIL
    n_workers = max(min(cfg.threads or (os.cpu_count() or 4), len(todo)), 1)
    with BamFile(bam_path) as bam, \
            ThreadPoolExecutor(max_workers=n_workers) as ex:
        for out_item in ex.map(one_contig, todo):
            if out_item is None:
                continue
            n_sites, result = out_item
            totals["sites"] += n_sites
            totals["phased_sites"] += int((result.hap_of_alt != 0).sum())
            totals["blocks"] += result.n_blocks
            totals["tagged_reads"] += len(result.read_hp)
    dt = time.monotonic() - t0
    totals["seconds"] = round(dt, 2)
    return totals


def load_native_phase_overrides(out_dir: str) -> Dict[str, Dict[int, int]]:
    """{contig: {read_id: hp}} from a stage_phase_native output dir."""
    overrides: Dict[str, Dict[int, int]] = {}
    if not os.path.isdir(out_dir):
        return overrides
    for f in os.listdir(out_dir):
        if f.endswith(".hp.npz"):
            z = np.load(os.path.join(out_dir, f))
            overrides[f[: -len(".hp.npz")]] = {
                int(r): int(h) for r, h in zip(z["read_ids"], z["hp"])}
    return overrides



def stage_merge(
    cfg: PipelineConfig,
    pileup_vcf: str,
    haplotype_csv: str,
    output_vcf: str,
) -> Dict:
    """s6: pileup.vcf + haplotype.csv -> merge.vcf."""
    with open(pileup_vcf) as pv, open(haplotype_csv) as hc, \
            open(output_vcf, "w") as out:
        n = merge_calls(pv, hc, out,
                        quality_threshold=cfg.merge.quality,
                        hap_quality=cfg.merge.hap_quality,
                        pileup_rescue_quality=cfg.merge.pileup_rescue_quality)
    return {"rescued": n}
