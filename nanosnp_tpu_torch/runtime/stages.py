"""The device stages of the pipeline: s2 pileup predict, s5 haplotype
predict, and s6 merge, which consumes their outputs.

Counterpart of the same stages in nanosnp_tpu/runtime/stages.py:
  s2 pileup predict     pileup shards -> pileup.vcf            [device]
  s5 haplotype predict  haplotype shards -> haplotype.csv      [device]
  s6 merge              pileup.vcf + haplotype.csv -> merge.vcf
The host stages s1, s3 and s4, which write the shards, are not part of
this package yet. Every stage that uses the device takes `device`
("cuda" unless the caller asks for "cpu").
"""
from __future__ import annotations

import io
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from ..config import PipelineConfig
from ..decode.merge import merge_calls
from ..decode.pileup_vcf import (calculate_score, decode_pileup_calls_fast,
                                 write_vcf_header)
from ..device import resolve_device
from ..features.haplotype import (haplotype_features, ref_position_codes,
                                  ref_window_codes)
from ..io import bins
from ..io.fasta import FastaReference
from ..models.convert import load_pileup_checkpoint
from ..models.haplotype_model import HaplotypeModel, haplotype_predict
from ..models.pileup_model import PileupModel, pileup_predict
from ..parallel.inference import BatchedPredictor

# columns per s2 device unit: 4M columns x 18 int16 = 144 MiB per upload
_UNIT_COLUMNS = 1 << 22


def _compute_dtype(cfg: PipelineConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.inference.use_bf16 else torch.float32


def pileup_model_predictor(cfg: PipelineConfig, model: PileupModel,
                           device) -> BatchedPredictor:
    """Dense-window s2 predictor: [B, 33, 18] int16 counts -> (gt, zy)."""
    dtype = _compute_dtype(cfg)

    def fn(x):
        return pileup_predict(model, x.float(), compute_dtype=dtype)

    return BatchedPredictor(fn, batch_size=cfg.inference.batch_size,
                            device=device)


def pileup_columnar_fn(cfg: PipelineConfig, model: PileupModel):
    """(columns [U, 18] int16, idx [B] int64) on the device -> (gt, zy):
    gathers each candidate's 33-wide window from the resident column union
    on the device, then runs the pileup model."""
    dtype = _compute_dtype(cfg)
    flank = (cfg.pileup_model.seq_len - 1) // 2

    def fn(cols, idx):
        offs = torch.arange(-flank, flank + 1, device=cols.device)
        w = cols[idx[:, None] + offs[None, :]]               # [B, 33, 18]
        return pileup_predict(model, w.float(), compute_dtype=dtype)

    return fn


@torch.inference_mode()
def run_pileup_columnar(cfg: PipelineConfig, model: PileupModel,
                        shard: bins.PileupShard, device
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """s2 device feed for v2 columnar shards: the column union goes to the
    device once per unit, each batch's windows are gathered there, and a
    unit's results are fetched once, one unit behind the launches."""
    device = resolve_device(device)
    fn = pileup_columnar_fn(cfg, model)
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
        cols_dev = cols.to(device, non_blocking=True)
        idx_dev = torch.from_numpy(cand_off[i:j] - lo).to(
            device, non_blocking=True)
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
    without it the reference-layout checkpoint at `model_path` is loaded."""
    device = resolve_device(device)
    if params is None:
        params = load_pileup_checkpoint(model_path, cfg.pileup_model.n_layers)
    model = PileupModel(cfg.pileup_model, params).to(device)
    predictor = pileup_model_predictor(cfg, model, device)

    n_sites = 0
    t0 = time.monotonic()
    paths = bins.list_shards(shard_dir)

    # one worker keeps the device busy a shard ahead; decode fans out over
    # a thread pool into per-shard buffers (numpy string kernels release
    # the GIL); the main thread writes the buffers in shard order
    def infer(path):
        shard = bins.load_pileup_shard(path)
        if len(shard) == 0:
            return None
        if shard.columns is not None:
            gt, zy = run_pileup_columnar(cfg, model, shard, device)
        else:
            # compact int16 counts go to the device, cast to f32 there
            gt, zy = predictor.run(shard.matrix.astype(np.int16, copy=False))
        return shard, gt, zy

    decode_split = 100_000   # rows per decode task

    def decode(res, lo, hi):
        shard, gt, zy = res
        buf = io.StringIO()
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
                res = infer_q.pop(0).result()
                if res is None:
                    continue
                n_rows = len(res[0])
                for lo in range(0, n_rows, decode_split):
                    decode_q.append(ex_dec.submit(
                        decode, res, lo, min(lo + decode_split, n_rows)))
            if not decode_q:
                continue
            n, text = decode_q.pop(0).result()
            out.write(text)
            n_sites += n
    dt = time.monotonic() - t0
    return {"sites": n_sites, "sites_per_s": round(n_sites / dt, 1) if dt else 0}


def haplotype_model_predictor(cfg: PipelineConfig, model: HaplotypeModel,
                              device) -> BatchedPredictor:
    """Haplotype model on [B, 33, 105] / [B, 11, 105] features (already on
    the device) -> (gt, zy) probabilities."""
    dtype = _compute_dtype(cfg)

    def fn(xp, xh):
        return haplotype_predict(model, xp, xh, compute_dtype=dtype)

    return BatchedPredictor(fn, batch_size=cfg.inference.batch_size,
                            device=device)


def haplotype_featurizer(cfg: PipelineConfig, fs: int,
                         device) -> BatchedPredictor:
    """[B, D, L] int8/int16 read matrices of both views -> [B, L, 105]
    features of both views, on the device, in the compute dtype."""
    dtype = _compute_dtype(cfg)

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


def stage_haplotype_predict(
    cfg: PipelineConfig,
    ref: FastaReference,
    shard_dir: str,
    output_csv: str,
    params,
    device="cuda",
) -> Dict:
    """s5: haplotype shards -> featurize on the device -> model -> calls
    CSV (rows `ctg\\tpos\\tGT\\tqual`, reference predict_dev.py:43-47).

    Raw int8 read matrices are pooled on the host per depth-bucket pair
    and shipped once; the features stay on the device and flow into the
    model; only the (gt, zy) probabilities come back. Deep buckets
    featurize in sub-batches that are concatenated on the device up to the
    model batch."""
    device = resolve_device(device)
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
            pending.append((pool["meta"][start:end], model_pred.apply(xp, xh)))
            while len(pending) > 2:
                drain_one()
        pool["meta"] = pool["meta"][run_n:]
        pool["chunks"] = [[a[run_n:] for a in args]] if keep else []

    # contig-grouped iteration: pools and result rows flush and are written
    # at every contig boundary, so host memory is O(contig)
    paths = bins.list_shards(shard_dir)
    contig_of = {p: str(bins.open_npz(p)["contig"]) for p in paths}
    paths.sort(key=lambda p: (C.contig_sort_key(contig_of[p]), p))

    def flush_contig(out_f):
        for key in list(pools):
            flush(key, final=True)
        while pending:
            drain_one()
        results.sort(key=lambda kv: kv[0])
        for _, line in results:
            out_f.write(line)
        results.clear()
        pools.clear()

    # the next shard loads (zstd/zlib inflate releases the GIL) while the
    # current one is pooled and featurized
    with open(output_csv, "w") as out_f, \
            ThreadPoolExecutor(max_workers=1) as loader:
        fut = loader.submit(bins.load_haplotype_shard, paths[0]) \
            if paths else None
        cur_contig: Optional[str] = None
        for i in range(len(paths)):
            shard = fut.result()
            fut = (loader.submit(bins.load_haplotype_shard, paths[i + 1])
                   if i + 1 < len(paths) else None)
            if len(shard) == 0:
                continue
            if cur_contig is not None and shard.contig != cur_contig:
                flush_contig(out_f)
            cur_contig = shard.contig
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
