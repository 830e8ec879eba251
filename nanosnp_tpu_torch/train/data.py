"""Training-data construction.

A copy of nanosnp_tpu/train/data.py (numpy only), so that the port
imports nothing of the JAX package.

Ports of the reference's train-data tooling:
  - split_truth_vcf: truth VCF -> per-contig (pos, ref, alt, gt1, gt2) rows
    with genotype normalization and '*'-allele fixing
    (dna_sv_tensor/src/split_vcf/main.cpp:14-126);
  - extend_bed_intervals: confident-BED extension + overlap merge
    (extend_bed/main.cpp:8-36, BED_EXTENDED_BASES=31);
  - build_pileup_train_arrays: joins candidate windows with truth labels
    (90-dim), subsamples non-variants to <= ratio x variants
    (make_train_data/main.cpp:129-185, default 5.0). The reference shuffles
    within 10k-row streaming batches (main.cpp:349-355); we global-shuffle,
    which strictly dominates;
  - attach_haplotype_labels: candidate_labels [N,3] for haplotype training
    bins (make_train_bins.py:123-127 via get_truth labeling).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .. import constants as C
from ..features.pileup import CandidateBatch
from . import labels as L


@dataclass
class TruthSite:
    pos: int
    ref: str
    alt: str
    gt1: int
    gt2: int


def _extract_genotype(gt_field: str) -> Tuple[int, int]:
    gts = gt_field.split(":")[0].replace("/", "|").replace(".", "0")
    a, b = gts.split("|")[:2]
    t1, t2 = int(a), int(b)
    return min(t1, t2), max(t1, t2)


def split_truth_vcf(vcf_lines: Iterable[str]) -> Dict[str, List[TruthSite]]:
    out: Dict[str, List[TruthSite]] = {}
    for line in vcf_lines:
        if not line.strip() or line[0] == "#":
            continue
        cols = line.strip().split("\t")
        gt1, gt2 = _extract_genotype(cols[-1])
        alt = cols[4]
        if "*" in alt:
            # only the 1|2 two-allele form with one '*' is fixable
            # (split_vcf/main.cpp:28-49)
            if gt1 + gt2 != 3 or alt.count(",") != 1:
                continue
            gt1, gt2 = 0, 1
            alt = alt.replace("*", "")
        out.setdefault(cols[0], []).append(
            TruthSite(int(cols[1]), cols[3], alt, gt1, gt2))
    return out


def extend_bed_intervals(
    intervals: Sequence[Tuple[str, int, int]],
    extend: int = C.BED_EXTENDED_BASES,
) -> List[Tuple[str, int, int]]:
    by_ctg: Dict[str, List[Tuple[int, int]]] = {}
    for ctg, s, e in intervals:
        by_ctg.setdefault(ctg, []).append((max(s - extend, 0), e + extend))
    out = []
    for ctg, ivs in by_ctg.items():
        ivs.sort()
        cur_s, cur_e = ivs[0]
        for s, e in ivs[1:]:
            if s <= cur_e:
                cur_e = max(cur_e, e)
            else:
                out.append((ctg, cur_s, cur_e))
                cur_s, cur_e = s, e
        out.append((ctg, cur_s, cur_e))
    return out


@dataclass
class PileupTrainArrays:
    matrix: np.ndarray       # [N, 33, 18] int32
    label: np.ndarray        # [N, 90] int32
    positions: np.ndarray    # [N] int64
    is_variant: np.ndarray   # [N] bool
    # optional provenance, needed for the reference-layout HDF5 train bins
    # (make_bin_train_data.py position/alt_info columns)
    contig: str = ""
    ref_seqs: Optional[np.ndarray] = None   # [N] S33 window strings
    alt_info: Optional[np.ndarray] = None   # [N] bytes


def build_pileup_train_arrays(
    batch: CandidateBatch,
    truth_sites: Sequence[TruthSite],
    max_non_variant_ratio: float = 5.0,
    rng: Optional[np.random.Generator] = None,
    shuffle: bool = True,
) -> PileupTrainArrays:
    rng = rng or np.random.default_rng()
    truth = {t.pos: t for t in truth_sites}

    rs_arr = np.asarray(batch.ref_seqs, dtype="S")
    width = rs_arr.dtype.itemsize
    if len(rs_arr) and width > 16:
        u8 = np.char.upper(rs_arr).view(np.uint8).reshape(len(rs_arr), width)
        centers_u8 = u8[:, 16]
        mask = ((centers_u8 == ord("A")) | (centers_u8 == ord("C"))
                | (centers_u8 == ord("G")) | (centers_u8 == ord("T")))
    else:
        centers_u8 = np.zeros(len(rs_arr), np.uint8)
        mask = np.zeros(len(rs_arr), dtype=bool)
    keep = np.flatnonzero(mask)
    refs = [chr(c) for c in centers_u8[keep]]
    positions = batch.positions[keep]
    is_var = np.asarray([int(p) in truth for p in positions], dtype=bool)

    n_var = int(is_var.sum())
    n_nonvar = int((~is_var).sum())
    ratio = 1.0
    max_nonvar = int(n_var * max_non_variant_ratio)
    if max_nonvar < n_nonvar:
        ratio = max_nonvar / n_nonvar if n_nonvar else 1.0
    sel = is_var | (rng.random(len(positions)) < ratio)

    keep = keep[sel]
    positions = positions[sel]
    is_var = is_var[sel]
    refs = [refs[i] for i in np.flatnonzero(sel)]

    label = np.zeros((len(positions), 90), dtype=np.int32)
    for j, p in enumerate(positions):
        t = truth.get(int(p))
        if t is not None:
            label[j] = L.y_label_from_truth(t.ref, t.alt, t.gt1, t.gt2)
        else:
            label[j] = L.y_label_from_reference(refs[j])

    matrix = batch.matrix[keep]
    ref_seqs = (rs_arr[keep].astype("S33", copy=False)
                if len(keep) else np.zeros(0, "S33"))
    alt_info = np.asarray([batch.alt_info[i].encode() for i in keep],
                          dtype="S") if len(keep) else np.zeros(0, "S")
    if shuffle:
        perm = rng.permutation(len(positions))
        matrix = matrix[perm]
        label = label[perm]
        positions = positions[perm]
        is_var = is_var[perm]
        ref_seqs = ref_seqs[perm]
        alt_info = alt_info[perm]
    return PileupTrainArrays(matrix.astype(np.int32), label, positions,
                             is_var, contig=batch.chrom,
                             ref_seqs=ref_seqs, alt_info=alt_info)


def train_data_lines(
    batch: CandidateBatch,
    truth_sites: Sequence[TruthSite],
) -> List[str]:
    """Serialize candidate windows + truth labels in the reference `.td`
    text format (make_train_data/main.cpp:328-386) on the deterministic
    path (shuffle off, no non-variant subsampling): row order is tensor
    order with first-occurrence dedup by chrom:pos, rows whose uppercased
    33-mer center is not ACGT are dropped (main.cpp:284-285), and truth
    rows append the `.true_var` line (main.cpp:376-381).

    Line layout (main.cpp:369-382):
      tensor_text \\t 90 space-separated label ints \\t chrom:pos:REF_SEQ
      \\t alt_info(right-stripped) [\\t true_var_line]
    """
    truth = {t.pos: t for t in truth_sites}
    lines: List[str] = []
    seen = set()
    for i in range(len(batch)):
        pos = int(batch.positions[i])
        rs = batch.ref_seqs[i]
        rs = (rs.decode() if isinstance(rs, bytes) else rs).upper()
        if rs[C.FLANKING_BASES] not in "ACGT":
            continue
        key = f"{batch.chrom}:{pos}"
        if key in seen:
            continue
        seen.add(key)
        t = truth.get(pos)
        if t is not None:
            # reference_quirk: the compiled binary clamps variant lengths
            # with min=max=+16 (genotype.cpp:38-42 min_max), pinning every
            # truth row's two length one-hots to index 32 — confirmed by
            # the byte-diff against the real DNA_CreateTrainData
            # (tests/test_train_data_oracle.py)
            label = L.y_label_from_truth(t.ref, t.alt, t.gt1, t.gt2,
                                         reference_quirk=True)
            tv = (f"{batch.chrom}\t{pos}\t{t.ref}\t{t.alt}"
                  f"\t{t.gt1}\t{t.gt2}")
        else:
            label = L.y_label_from_reference(rs[C.FLANKING_BASES])
            tv = None
        tensor_info = "".join(f"{v} " for v in batch.matrix[i].reshape(-1))
        lab = " ".join(str(int(v)) for v in label)
        alt = batch.alt_info[i].rstrip()
        line = f"{tensor_info}\t{lab}\t{key}:{rs}\t{alt}"
        if tv is not None:
            line += "\t" + tv
        lines.append(line)
    return lines


def balance_indices(
    gt: np.ndarray,
    zy: np.ndarray,
    rng: Optional[np.random.Generator] = None,
    n_gt: int = C.NUM_GT21,
    n_zy: int = C.NUM_ZY,
) -> np.ndarray:
    """Per-(gt,zy)-class balancing (reference PileupModel/dataset.py:32-66
    balance_dataset): upsample every non-empty (gt,zy) cell to the largest
    cell's size with replacement, then downsample the pooled indices to
    pool_size / n_nonempty — the expected output size equals the max cell
    size, with (near-)uniform class mass."""
    rng = rng or np.random.default_rng()
    cells = {}
    max_size = 0
    for i in range(n_gt):
        for j in range(n_zy):
            idx = np.flatnonzero((gt == i) & (zy == j))
            max_size = max(max_size, len(idx))
            cells[(i, j)] = idx
    pooled = []
    non_zero = 0
    for key, idx in cells.items():
        if 0 < len(idx) < max_size:
            extra = rng.choice(idx, size=max_size - len(idx), replace=True)
            idx = np.concatenate([idx, extra])
            non_zero += 1
        pooled.append(idx)
    total = np.concatenate(pooled) if pooled else np.zeros(0, np.int64)
    if len(total) == 0 or non_zero == 0:
        return total.astype(np.int64)
    rng.shuffle(total)
    return rng.choice(total, size=max(len(total) // non_zero, 1))


def for_evaluate_indices(zy: np.ndarray) -> np.ndarray:
    """Variant-only filter for evaluation (dataset.py:100-106: keep
    zy > 0, i.e. 1/1 and 0/1)."""
    return np.flatnonzero(zy > 0)


def split_train_val(
    items: Sequence,
    val_fraction: float = 0.1,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[list, list]:
    """90/10 split (reference train.py:176-181 splits bin FILES when no dev
    dir is configured; items may be shard paths or row indices). Always
    leaves at least one item on each side when len >= 2."""
    items = list(items)
    if len(items) < 2 or val_fraction <= 0:
        return items, []
    rng = rng or np.random.default_rng()
    order = rng.permutation(len(items))
    n_val = min(max(int(round(len(items) * val_fraction)), 1), len(items) - 1)
    val = [items[i] for i in order[:n_val]]
    train = [items[i] for i in order[n_val:]]
    return train, val


def decode_90dim_labels(label: np.ndarray) -> Dict[str, np.ndarray]:
    """90-dim one-hots -> class-index arrays (as PileupModel/dataset.py:77-83)."""
    return {
        "gt": label[:, :21].argmax(1).astype(np.int32),
        "zy": label[:, 21:24].argmax(1).astype(np.int32),
        "indel1": label[:, 24:57].argmax(1).astype(np.int32),
        "indel2": label[:, 57:90].argmax(1).astype(np.int32),
    }


def attach_haplotype_labels(
    candidate_positions: np.ndarray,
    truth_array: np.ndarray,   # [contig_len, 3] from labels.truth_arrays
) -> np.ndarray:
    """candidate_labels [N, 3] = (confident-flag, gt21, zygosity) at each
    candidate (make_train_bins.py:123-127)."""
    idx = candidate_positions.astype(np.int64) - 1
    idx = np.clip(idx, 0, len(truth_array) - 1)
    return truth_array[idx].astype(np.int64)


# Sentinel yielded between epochs by iterators running with
# mark_epochs=True; lets the train loops detect epoch boundaries without a
# separate counting pass over the data (round-1 review finding 7).
EPOCH_END = object()


def batch_iterator(
    arrays: PileupTrainArrays,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    epochs: int = 1,
    drop_last: bool = True,
    use_balance: bool = False,
    mark_epochs: bool = False,
):
    """Yields (x, gt, zy) minibatches for train_pileup. With use_balance,
    indices are re-balanced per epoch over (gt,zy) cells (reference
    TrainDataset(use_balance=True), dataset.py:84-89)."""
    rng = rng or np.random.default_rng(0)
    dec = decode_90dim_labels(arrays.label)
    n = len(arrays.positions)
    for _ in range(epochs):
        if use_balance:
            perm = balance_indices(dec["gt"], dec["zy"], rng)
            rng.shuffle(perm)
        else:
            perm = rng.permutation(n)
        end = len(perm) - (len(perm) % batch_size) if drop_last else len(perm)
        if end == 0 and len(perm):
            # fewer rows than one batch (tiny/balanced datasets): tile up to
            # a full static batch so the epoch still trains
            perm = np.tile(perm, -(-batch_size // len(perm)))[:batch_size]
            end = batch_size
        for s in range(0, end, batch_size):
            idx = perm[s: s + batch_size]
            yield (arrays.matrix[idx].astype(np.float32), dec["gt"][idx],
                   dec["zy"][idx])
        if mark_epochs:
            yield EPOCH_END


def save_train_arrays(path: str, arrays: PileupTrainArrays) -> None:
    extra = {}
    if arrays.ref_seqs is not None:
        extra["ref_seqs"] = np.asarray(arrays.ref_seqs, dtype="S")
    if arrays.alt_info is not None:
        extra["alt_info"] = np.asarray(arrays.alt_info, dtype="S")
    np.savez_compressed(path, matrix=arrays.matrix, label=arrays.label,
                        positions=arrays.positions,
                        is_variant=arrays.is_variant,
                        contig=np.array(arrays.contig), **extra)


def load_train_arrays(path: str) -> PileupTrainArrays:
    z = np.load(path)
    return PileupTrainArrays(
        z["matrix"], z["label"], z["positions"], z["is_variant"],
        contig=str(z["contig"]) if "contig" in z.files else "",
        ref_seqs=z["ref_seqs"] if "ref_seqs" in z.files else None,
        alt_info=z["alt_info"] if "alt_info" in z.files else None)


def haplotype_train_iterator(
    shard_paths: Sequence[str],
    labels_by_contig: Dict[str, np.ndarray],   # labels.truth_arrays output
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    epochs: int = 1,
    pn_value: float = 0.7,
    mark_epochs: bool = False,
):
    """Batches for train_haplotype from haplotype shards + truth arrays.

    Mirrors the reference TrainingDataset sampling (dataset_dev.py:190-283):
    keep confident sites with -1 <= zy < 10 and gt < 10; mix refcalls and
    variants at pn_value (variants / refcalls); refcall zy of -1 trains as
    class 0. Featurization happens on device inside the train step, so
    batches carry the raw read matrices, in the shards' own dtypes (int8
    sequences, baseq and hap, int16 mapq; depth padding PAD_VALUE): no
    value is widened or narrowed on the host. The reference codes are f32,
    gt and zy int32, and a tiled remainder batch carries "_n".
    """
    from ..io import bins as _bins
    from ..features.haplotype import ref_position_codes, ref_window_codes
    from .. import constants as _C

    rng = rng or np.random.default_rng(0)

    def shard_samples(path):
        shard = _bins.load_haplotype_shard(path)
        if len(shard) == 0 or shard.contig not in labels_by_contig:
            return None
        lab = attach_haplotype_labels(shard.candidate_positions,
                                      labels_by_contig[shard.contig])
        cf, gt, zy = lab[:, 0], lab[:, 1], lab[:, 2]
        valid = (cf == 1) & (zy >= -1) & (zy < 10) & (gt < 10)
        ref_idx = np.flatnonzero(valid & (zy == -1))
        var_idx = np.flatnonzero(valid & (zy > 0))
        n_ref_keep = int(len(var_idx) / pn_value) if pn_value > 0 else len(ref_idx)
        if len(ref_idx) > n_ref_keep:
            ref_idx = rng.choice(ref_idx, size=n_ref_keep, replace=False)
        sel = np.concatenate([ref_idx, var_idx])
        if len(sel) == 0:
            return None
        rng.shuffle(sel)
        idx = sel
        return {
            "p_seq": shard.pileup["sequences"][idx],
            "p_baseq": shard.pileup["baseq"][idx],
            "p_mapq": shard.pileup["mapq"][idx],
            "p_hap": shard.pileup["hap"][idx],
            "p_ref": _ref_codes_for(shard, idx, _C.FLANKING_BASES, "pileup"),
            "h_seq": shard.haplotype["sequences"][idx],
            "h_baseq": shard.haplotype["baseq"][idx],
            "h_mapq": shard.haplotype["mapq"][idx],
            "h_hap": shard.haplotype["hap"][idx],
            "h_ref": _ref_codes_for(shard, idx, None, "haplotype"),
            "gt": gt[idx].astype(np.int32),
            "zy": np.where(zy[idx] >= 0, zy[idx], 0).astype(np.int32),
        }

    bucket_of = _bins.depth_bucket   # one table shared with s4/s5

    depth_keys = ("p_seq", "p_baseq", "p_mapq", "p_hap",
                  "h_seq", "h_baseq", "h_mapq", "h_hap")

    def pad_depth(batch_part, key, target):
        a = batch_part[key]
        if a.shape[1] < target:
            a = np.pad(a, ((0, 0), (0, target - a.shape[1]), (0, 0)),
                       constant_values=_C.PAD_VALUE)
        return a

    for _ in range(epochs):
        # shards hold at most one group-chunk (~100 sites); pool samples
        # across shards into (pileup-depth, haplotype-depth) buckets so any
        # batch_size works; batches are emitted per bucket.
        pools: Dict[tuple, Dict[str, np.ndarray]] = {}
        order = list(shard_paths)
        rng.shuffle(order)

        def split_batches(key, force=False):
            pool = pools.get(key)
            while pool is not None and (
                    len(pool["gt"]) >= batch_size
                    or (force and len(pool["gt"]) > 0)):
                n_avail = len(pool["gt"])
                if n_avail >= batch_size:
                    yield {k: v[:batch_size] for k, v in pool.items()}
                    pool = {k: v[batch_size:] for k, v in pool.items()}
                else:
                    # remainder: repeat samples up to a full static batch so
                    # every batch shards evenly over the device mesh; "_n"
                    # carries the true row count so metric consumers
                    # (validation, evaluate CLIs) don't double-count the
                    # tiled rows
                    reps = -(-batch_size // n_avail)
                    idx = np.tile(np.arange(n_avail), reps)[:batch_size]
                    out_batch = {k: v[idx] for k, v in pool.items()}
                    out_batch["_n"] = n_avail
                    yield out_batch
                    pool = {k: v[:0] for k, v in pool.items()}
                pools[key] = pool
                if len(pool["gt"]) == 0:
                    del pools[key]
                    pool = None

        for path in order:
            sample = shard_samples(path)
            if sample is None:
                continue
            key = (bucket_of(sample["p_seq"].shape[1]),
                   bucket_of(sample["h_seq"].shape[1]))
            for k in depth_keys:
                sample[k] = pad_depth(sample, k,
                                      key[0] if k.startswith("p") else key[1])
            pool = pools.get(key)
            if pool is None:
                pools[key] = sample
            else:
                pools[key] = {k: np.concatenate([pool[k], sample[k]])
                              for k in pool}
            yield from split_batches(key)
        for key in list(pools):
            yield from split_batches(key, force=True)
        if mark_epochs:
            yield EPOCH_END


def reshard_train_val(
    shard_paths: Sequence[str],
    out_dir: str,
    val_fraction: float = 0.1,
    rng: Optional[np.random.Generator] = None,
    write: bool = True,
) -> Tuple[List[str], List[str]]:
    """Row-level train/val split of haplotype shards.

    The consolidated s4 output is one shard per (contig, depth bucket), so
    a file-level split (reference train.py:176-181) is too coarse — this
    splits every shard's rows 90/10 into <out_dir>/{train,val}/ copies.
    With write=False it draws from `rng` and returns the paths alike but
    writes nothing (the other ranks of a data-parallel run, which read
    rank 0's copies)."""
    import os as _os

    from ..io import bins as _bins

    rng = rng or np.random.default_rng()
    train_dir = _os.path.join(out_dir, "train")
    val_dir = _os.path.join(out_dir, "val")
    if write:
        _os.makedirs(train_dir, exist_ok=True)
        _os.makedirs(val_dir, exist_ok=True)

    def slice_shard(shard, idx):
        return _bins.HaplotypeShard(
            contig=shard.contig,
            candidate_positions=shard.candidate_positions[idx],
            group_positions=shard.group_positions[idx],
            pileup={k: v[idx] for k, v in shard.pileup.items()},
            haplotype={k: v[idx] for k, v in shard.haplotype.items()},
        )

    train_paths, val_paths = [], []
    for p in shard_paths:
        shard = _bins.load_haplotype_shard(p)
        n = len(shard)
        if n == 0:
            continue
        perm = rng.permutation(n)
        n_val = int(round(n * val_fraction))
        if n >= 10:
            n_val = max(n_val, 1)
        name = _os.path.basename(p)
        tp = _os.path.join(train_dir, name)
        if write:
            _bins.save_haplotype_shard(tp, slice_shard(shard, perm[n_val:]))
        train_paths.append(tp)
        if n_val:
            vp = _os.path.join(val_dir, name)
            if write:
                _bins.save_haplotype_shard(vp, slice_shard(shard,
                                                           perm[:n_val]))
            val_paths.append(vp)
    return train_paths, val_paths


_REF_SEQS: Dict[str, np.ndarray] = {}


def set_reference_for_training(contig_seqs: Dict[str, np.ndarray]) -> None:
    """Register contig sequences used by haplotype_train_iterator."""
    _REF_SEQS.clear()
    _REF_SEQS.update(contig_seqs)


def _ref_codes_for(shard, idx, flank, view):
    from ..features.haplotype import ref_position_codes, ref_window_codes

    seq = _REF_SEQS.get(shard.contig)
    if seq is None:
        L = 2 * C.FLANKING_BASES + 1 if view == "pileup" else C.HAPLOTYPE_WINDOW
        return np.zeros((len(idx), L), dtype=np.float32)
    if view == "pileup":
        return ref_window_codes(seq, shard.candidate_positions[idx], flank)
    return ref_position_codes(seq, shard.group_positions[idx])
