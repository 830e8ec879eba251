"""Command-line entry point: `python -m nanosnp_tpu_torch.runtime.cli <command>`.

Commands ported so far (same flags as the JAX package's CLI, plus
`--device`: cuda by default; cpu runs the kernels' plain versions, and the
trainers the f32 path, as the JAX trainer does off the TPU):

  call             the pipeline end to end: s1 pileup features
                   (BAM or mpileup) -> s2 pileup model -> s3 phasing ->
                   s4 haplotype features -> s5 haplotype model -> s6 merge,
                   with `.done` markers for resume
  s1-features      mpileup -> pileup shards
  s2-predict       pileup shards -> pileup.vcf
  s6-merge         pileup.vcf + haplotype.csv -> merge.vcf
  sort-vcf         contig/position sort of a VCF
  split-bam        native BAM splitting per contig or by HP tag
  make-train-data  BAM + truth VCF (+ BED) -> labeled pileup arrays (.npz)
  train-pileup     labeled pileup arrays (.npz) -> pileup_train/ checkpoints
  train-haplotype  haplotype shards + truth VCF + BED -> haplotype_train/
  legacy-make-groups  pileup VCF + BAM(s) -> per-contig legacy bins
  legacy-predict   dual-tag legacy bins + CatModel params -> legacy_calls.tsv
  legacy-eval      the same against truth labels -> legacy_eval.tsv
  legacy-train     dual-tag legacy bins + truth -> catmodel.npz (the
                   port's trainer: groups of steps, the training kernels
                   and a CUDA graph a group on the card)
  legacy-filter-labels  label-noise positions -> filtered_positions.txt
  legacy-heuristic      edge-graph homozygote caller (numpy, no device)
  evaluate-pileup  labeled pileup arrays (.npz) + a checkpoint -> gt/zy
                   confusion, accuracy and macro-F1 (evaluate_pileup.json)
  evaluate-haplotype  labeled haplotype shards + truth -> the same
                   (evaluate_haplotype.json); the featurizer on the device
  compare-failed   failed-site list -> its confident-BED het-truth rows
                   (host only, no --device)

`make-train-data --h5` also writes each contig's reference-layout HDF5
train bin, which needs h5py. `call --num-hosts N --coordinator HOST:PORT
--host-id I` runs one process a host (one a GPU, parallel/launch.py): each
works its LPT share of the contigs in OUT/host{I}, host 0 merges the
outputs into OUT. `train-pileup` and `train-haplotype` train data-parallel
over the ranks that NSP_COORDINATOR / NSP_NUM_PROCS / NSP_PROC_ID describe.
s5 has no subcommand (the JAX CLI has none either): it runs through
`runtime.stages.stage_haplotype_predict`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from ..config import load_config
from ..constants import ALL_CHROMS
from ..device import resolve_device
from ..io.fasta import FastaReference
from . import stages
from .pipeline import PipelineRunner, Stage


def _add_common(p):
    p.add_argument("--config", default=None,
                   help="YAML config overriding defaults")
    p.add_argument("--threads", type=int, default=0)
    p.add_argument("--output", "-o", required=True, help="output directory")


def _add_device(p):
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _run_make_train_data(args, cfg) -> int:
    import numpy as np

    from ..features.pileup import assemble_windows
    from ..io.bam import BamFile
    from ..train import data as D

    if args.h5:
        from ..io.bins import require_h5py

        require_h5py()      # before the first contig's work, not after
    ref = FastaReference(args.ref)
    with open(args.truth_vcf) as f:
        truth = D.split_truth_vcf(f)
    bed_masks = None
    if args.bed:
        with open(args.bed) as f:
            intervals = D.extend_bed_intervals(
                [(c, int(s), int(e)) for c, s, e, *_ in
                 (l.split("\t") for l in f if l.strip())])
        bed_masks = {}
        for ctg, s, e in intervals:
            if ctg not in bed_masks and ctg in ref.by_name:
                bed_masks[ctg] = np.zeros(ref.length(ctg), dtype=bool)
            if ctg in bed_masks:
                bed_masks[ctg][s:e] = True
    rng = np.random.default_rng(cfg.train.seed)
    fc = cfg.pileup_feature
    out_dir = os.path.join(args.output, "train_data")
    os.makedirs(out_dir, exist_ok=True)
    total = {"sites": 0, "variants": 0}
    with BamFile(args.bam) as bam:
        contigs = args.contigs or [c for c, _ in bam.references()
                                   if c in ref.by_name]
        for ctg in contigs:
            seq = ref.contig(ctg)
            pile = bam.pileup_region(
                ctg, 0, len(seq), seq,
                snp_min_af=fc.snp_min_af, indel_min_af=fc.indel_min_af,
                min_coverage=fc.min_depth, max_indel=fc.max_indel_size,
                min_mq=fc.mpileup_min_mq, excl_flags=fc.mpileup_excl_flags,
                max_depth=fc.mpileup_max_depth)
            if bed_masks is not None and ctg in bed_masks:
                keep = bed_masks[ctg][pile.positions - 1]
                pile.positions = pile.positions[keep]
                pile.counts = pile.counts[keep]
                pile.depths = pile.depths[keep]
                pile.is_candidate = pile.is_candidate[keep]
                pile.afs = pile.afs[keep]
                pile.alt_info = [a for a, k in zip(pile.alt_info, keep) if k]
            batch = assemble_windows(pile, seq, fc.flanking_bases)
            arrays = D.build_pileup_train_arrays(
                batch, truth.get(ctg, []), args.max_nonvariant_ratio, rng)
            D.save_train_arrays(os.path.join(out_dir, f"{ctg}.npz"), arrays)
            if args.h5:
                from ..io.bins import save_pileup_train_h5

                save_pileup_train_h5(
                    os.path.join(out_dir, f"{ctg}.bin"), arrays)
            total["sites"] += len(arrays.positions)
            total["variants"] += int(arrays.is_variant.sum())
    print(total)
    return 0


def _run_train_pileup(args, cfg) -> int:
    import numpy as np

    from ..io.bins import list_shards
    from ..train import data as D
    from ..train.train_pileup import train_pileup

    tcfg = cfg.train
    if args.batch_size:
        tcfg.batch_size = args.batch_size
    if args.use_balance:
        tcfg.use_balance = True
    if args.val_fraction is not None:
        tcfg.val_fraction = args.val_fraction
    if args.first_stage is not None:
        tcfg.first_stage = args.first_stage
    epochs = args.epochs or tcfg.epochs
    rng = np.random.default_rng(tcfg.seed)

    # 90/10 split at shard (file) level like the reference when several
    # shards exist (train.py:176-181), else at row level
    paths = list_shards(args.data)
    train_paths, val_paths = D.split_train_val(paths, tcfg.val_fraction, rng)

    def merge(ps):
        arrays = [D.load_train_arrays(p) for p in ps]
        return D.PileupTrainArrays(
            np.concatenate([a.matrix for a in arrays]),
            np.concatenate([a.label for a in arrays]),
            np.concatenate([a.positions for a in arrays]),
            np.concatenate([a.is_variant for a in arrays]))

    if val_paths:
        train_arrays, val_arrays = merge(train_paths), merge(val_paths)
    else:
        all_arrays = merge(paths)
        n = len(all_arrays.positions)
        tr_idx, va_idx = D.split_train_val(range(n), tcfg.val_fraction, rng)

        def take(idx):
            idx = np.asarray(idx)
            return D.PileupTrainArrays(
                all_arrays.matrix[idx], all_arrays.label[idx],
                all_arrays.positions[idx], all_arrays.is_variant[idx])

        train_arrays = take(tr_idx) if va_idx else all_arrays
        val_arrays = take(va_idx) if va_idx else None

    steps_hint = max(len(train_arrays.positions) // tcfg.batch_size, 1)
    val_factory = None
    if val_arrays is not None and len(val_arrays.positions):
        val_factory = lambda: D.batch_iterator(  # noqa: E731
            val_arrays, tcfg.batch_size, np.random.default_rng(0),
            epochs=1, drop_last=False)
    state = train_pileup(
        D.batch_iterator(train_arrays, tcfg.batch_size, rng, epochs=epochs,
                         use_balance=tcfg.use_balance, mark_epochs=True),
        cfg.pileup_model, tcfg, steps_per_epoch=None,
        out_dir=os.path.join(args.output, "pileup_train"),
        device=args.device, resume_from=args.resume,
        val_iter_factory=val_factory, lr_steps_per_epoch=steps_hint)
    print({"steps": state.step, "epochs": state.epoch})
    return 0


def _run_train_haplotype(args, cfg) -> int:
    import numpy as np

    from ..io.bins import list_shards, open_npz
    from ..parallel.launch import barrier, host_plan
    from ..train import data as D
    from ..train.train_haplotype import train_haplotype
    from . import evaluate as E

    ref = FastaReference(args.ref)
    truth_arrays = E.truth_arrays(ref, args.truth_vcf, args.bed)
    D.set_reference_for_training({n: ref.contig(n) for n in ref.names})

    tcfg = cfg.train
    tcfg.batch_size = args.batch_size
    if args.val_fraction is not None:
        tcfg.val_fraction = args.val_fraction
    if args.first_stage is not None:
        tcfg.first_stage = args.first_stage
    epochs = args.epochs or 30
    rng = np.random.default_rng(tcfg.seed)
    paths = list_shards(args.shards)
    # row-level reshard: consolidated s4 shards are one file per
    # (contig, depth bucket), far too coarse for a file-level split. In a
    # data-parallel run rank 0 writes it and the others read its copies.
    rank = host_plan().host_id
    train_paths, val_paths = D.reshard_train_val(
        paths, os.path.join(args.output, "haplotype_split"),
        tcfg.val_fraction, rng, write=rank == 0)
    barrier("nsp_train_split")
    # lr-decay schedule hint: candidate count from shard metadata
    n_sites = sum(len(open_npz(p)["candidate_positions"])
                  for p in train_paths)
    steps_hint = max(n_sites // tcfg.batch_size, 1)
    val_factory = None
    if val_paths:
        val_factory = lambda: D.haplotype_train_iterator(  # noqa: E731
            val_paths, truth_arrays, tcfg.batch_size,
            np.random.default_rng(0), epochs=1, pn_value=args.pn_value)
    state = train_haplotype(
        D.haplotype_train_iterator(train_paths, truth_arrays, tcfg.batch_size,
                                   rng, epochs=epochs, pn_value=args.pn_value,
                                   mark_epochs=True),
        cfg.haplotype_model, tcfg, steps_per_epoch=None,
        out_dir=os.path.join(args.output, "haplotype_train"),
        device=args.device, resume_from=args.resume,
        val_iter_factory=val_factory, lr_steps_per_epoch=steps_hint)
    print({"steps": state.step, "epochs": state.epoch})
    return 0


def _add_eval_parsers(sub) -> None:
    p = sub.add_parser("evaluate-pileup",
                       help="confusion/accuracy/macro-F1 of a pileup "
                            "checkpoint on labeled arrays (reference "
                            "PileupModel eval pass)")
    _add_common(p)
    p.add_argument("--data", required=True, help="dir of labeled .npz arrays")
    p.add_argument("--model", required=True)
    p.add_argument("--for-evaluate", action="store_true",
                   help="variant-only filter (zy>0), reference "
                        "dataset.py:100-106")
    p.add_argument("--batch-size", type=int, default=2000)
    _add_device(p)

    p = sub.add_parser("evaluate-haplotype",
                       help="confusion/accuracy/macro-F1 of a haplotype "
                            "checkpoint on labeled shards (reference "
                            "evaluate_dev.py)")
    _add_common(p)
    p.add_argument("--shards", required=True)
    p.add_argument("--ref", required=True)
    p.add_argument("--truth-vcf", required=True)
    p.add_argument("--bed", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--batch-size", type=int, default=512)
    _add_device(p)

    p = sub.add_parser("compare-failed",
                       help="filter a failed-site list to confident-BED "
                            "het-truth rows (reference compare.py)")
    p.add_argument("--failed", required=True,
                   help="TSV of failed sites, rows start ctg\\tpos")
    p.add_argument("--ref", required=True)
    p.add_argument("--truth-vcf", required=True)
    p.add_argument("--bed", required=True)
    p.add_argument("--out", required=True,
                   help="output file of confirmed het false negatives")


def _run_compare_failed(args) -> int:
    from ..eval.f1 import classify_failed_sites
    from .evaluate import truth_arrays

    truth = truth_arrays(FastaReference(args.ref), args.truth_vcf, args.bed)
    with open(args.failed) as f:
        kept = classify_failed_sites(f, truth)
    with open(args.out, "w") as f:
        f.writelines(kept)
    print({"failed_in": args.failed, "het_fn": len(kept)})
    return 0


def _run_evaluate_pileup(args, cfg) -> int:
    """Reference PileupModel eval pass (train.py eval()/dataset
    for_evaluate): per-class confusion + accuracy + macro-F1 on labeled
    arrays."""
    from .. import constants as Cn
    from . import evaluate as E

    mcfg = cfg.pileup_model
    gt_conf, zy_conf = E.confusions(
        E.pileup_scores(cfg, args.model, args.data, args.for_evaluate,
                        args.batch_size, args.device),
        mcfg.gt_num_class, mcfg.zy_num_class)
    E.write_report(os.path.join(args.output, "evaluate_pileup.json"),
                   gt_conf, zy_conf, Cn.GT21_LABELS)
    return 0


def _run_evaluate_haplotype(args, cfg) -> int:
    """Reference HaplotypeModel/evaluate_dev.py: score a checkpoint on
    labeled haplotype shards (confusion, accuracy, macro-F1)."""
    from .. import constants as Cn
    from ..io.bins import list_shards
    from . import evaluate as E

    ref = FastaReference(args.ref)
    hcfg = cfg.haplotype_model
    gt_conf, zy_conf = E.confusions(
        E.haplotype_scores(cfg, args.model, list_shards(args.shards), ref,
                           E.truth_arrays(ref, args.truth_vcf, args.bed),
                           args.batch_size, args.device),
        hcfg.gt_num_class, hcfg.zy_num_class)
    E.write_report(os.path.join(args.output, "evaluate_haplotype.json"),
                   gt_conf, zy_conf, Cn.GT21_LABELS[:hcfg.gt_num_class])
    return 0


def _legacy_bam_paths(bam_arg, contigs=None):
    """Directory of {contig}.bam files, or one BAM mapped to every contig
    in its header."""
    if os.path.isdir(bam_arg):
        return {f[:-4]: os.path.join(bam_arg, f)
                for f in os.listdir(bam_arg) if f.endswith(".bam")}
    from ..io.bam import BamFile

    with BamFile(bam_arg) as bam:
        names = [c for c, _ in bam.references()]
    if contigs:
        names = [c for c in names if c in contigs]
    return {c: bam_arg for c in names}


def _run_legacy_make_groups(args, cfg) -> int:
    from ..legacy.bins import build_legacy_bins

    written = build_legacy_bins(
        args.pileup_vcf, _legacy_bam_paths(args.bam, args.contigs),
        args.output, max_coverage=args.max_coverage,
        quality_threshold=args.min_quality,
        support_quality=args.support_quality,
        adjacent_size=args.adjacent_size, contigs=args.contigs,
        suffix=".npz" if args.npz else ".bin")
    print({"contigs": len(written), "groups": sum(written.values())})
    return 0


def _align_legacy_bins(b1, b2, min_depth):
    """PredictDataset position alignment (dataset.py:828-853): advancing
    two position-sorted bins, keeping matches whose surrounding depth
    reaches min_depth in both tags."""
    import numpy as np

    d1 = ((b1["surrounding_read_matrix"] != -2).sum(2) > 0).sum(1)
    d2 = ((b2["surrounding_read_matrix"] != -2).sum(2) > 0).sum(1)
    p1 = [int(p.split(":")[1]) for p in b1["position"]]
    p2 = [int(p.split(":")[1]) for p in b2["position"]]
    idx1, idx2 = [], []
    k = j = 0
    while k < len(p1) and j < len(p2):
        if p1[k] == p2[j]:
            if d1[k] >= min_depth and d2[j] >= min_depth:
                idx1.append(k)
                idx2.append(j)
            k += 1
            j += 1
        elif p1[k] < p2[j]:
            k += 1
        else:
            j += 1
    return np.asarray(idx1, dtype=int), np.asarray(idx2, dtype=int)


def _legacy_tag_slices(b, idx, md, key=""):
    return {"read": b[f"{key}read_matrix"][idx, :md],
            "baseq": b[f"{key}base_quality_matrix"][idx, :md],
            "mapq": b[f"{key}mapping_quality_matrix"][idx, :md]}


def _legacy_images(b1, b2, idx1, idx2, md):
    """(g0 surrounding, g1 adjacent-het) stacked-tag images of the aligned
    groups."""
    from ..legacy.catmodel import build_g_images

    g0 = build_g_images(_legacy_tag_slices(b1, idx1, md, "surrounding_"),
                        _legacy_tag_slices(b2, idx2, md, "surrounding_"), md)
    g1 = build_g_images(_legacy_tag_slices(b1, idx1, md),
                        _legacy_tag_slices(b2, idx2, md), md)
    return g0, g1


def _legacy_predictor(args):
    """(model on the device, fn(g0, g1 numpy) -> class probabilities
    numpy). On the card the recurrences run the inference kernel."""
    import torch

    from ..legacy.catmodel import CatModel, catmodel_predict
    from ..train.train_pileup import load_checkpoint

    dev = resolve_device(args.device)
    params, _ = load_checkpoint(args.model)
    model = CatModel(params).to(dev)

    def predict(g0, g1):
        return catmodel_predict(
            model, torch.as_tensor(g0, dtype=torch.float32, device=dev),
            torch.as_tensor(g1, dtype=torch.float32, device=dev)
        ).cpu().numpy()

    return model, predict


def _run_legacy_predict(args, cfg) -> int:
    from .. import constants as C
    from ..decode.pileup_vcf import calculate_score
    from ..legacy.bins import load_legacy_bin

    _, predict = _legacy_predictor(args)
    out_path = os.path.join(args.output, "legacy_calls.tsv")
    n_out = 0
    with open(out_path, "w") as fout:
        names = sorted(set(os.listdir(args.data_tag1))
                       & set(os.listdir(args.data_tag2)))
        for name in names:
            b1 = load_legacy_bin(os.path.join(args.data_tag1, name))
            b2 = load_legacy_bin(os.path.join(args.data_tag2, name))
            idx1, idx2 = _align_legacy_bins(b1, b2, args.min_depth)
            if len(idx1) == 0:
                continue
            g0, g1 = _legacy_images(b1, b2, idx1, idx2, args.max_depth)
            positions = b1["position"][idx1]
            for s in range(0, len(positions), args.batch_size):
                probs = predict(g0[s:s + args.batch_size],
                                g1[s:s + args.batch_size])
                best = probs.argmax(1)
                for pos, cls, pr in zip(positions[s:s + args.batch_size],
                                        best, probs.max(1)):
                    ctg, p = pos.split(":")
                    fout.write(f"{ctg}\t{p}\t{C.GT21_LABELS[cls]}\t"
                               f"{calculate_score(float(pr))}\n")
                    n_out += 1
    print({"sites": n_out, "output": out_path})
    return 0


def _legacy_labeled_bins(args):
    """Shared assembly for the legacy labeled dual-tag commands: align each
    bin pair, join truth labels at the group centers (the reference reads a
    stored `labels` dataset written by make_train_groups; here the labels
    come from the same truth-VCF/BED join, train/labels.py), yield
    (name, b1, b2, idx1, idx2, ctg, centers, labels)."""
    import numpy as np

    from ..legacy.bins import load_legacy_bin
    from ..train import labels as L
    from ..train.data import attach_haplotype_labels

    ref = FastaReference(args.ref)
    contig_seqs = {c: ref.contig(c) for c in ref.names}
    with open(args.bed) as f:
        bed = list(L.parse_bed(f))
    with open(args.truth_vcf) as f:
        truth = L.truth_arrays({c: len(s) for c, s in contig_seqs.items()},
                               contig_seqs, bed, f)

    names = sorted(set(os.listdir(args.data_tag1))
                   & set(os.listdir(args.data_tag2)))
    for name in names:
        b1 = load_legacy_bin(os.path.join(args.data_tag1, name))
        b2 = load_legacy_bin(os.path.join(args.data_tag2, name))
        idx1, idx2 = _align_legacy_bins(b1, b2, args.min_depth)
        if len(idx1) == 0:
            continue
        ctg = b1["position"][idx1[0]].split(":")[0]
        if ctg not in truth:
            continue
        centers = np.array([int(p.split(":")[1])
                            for p in b1["position"][idx1]], dtype=np.int64)
        labels = attach_haplotype_labels(centers, truth[ctg])
        yield name, b1, b2, idx1, idx2, ctg, centers, labels


def _run_legacy_train(args, cfg) -> int:
    """The images of every aligned site built once, as int8; then
    `args.epochs` epochs through the CatModel trainer (legacy/train.py),
    each selecting its sites as the reference does. One record an epoch
    at the end: epoch, mean loss, steps, sites."""
    import numpy as np
    import torch

    from ..legacy.catmodel import init_catmodel_params
    from ..legacy.train import (CatModelTrainer, int8_images,
                                select_training_sites)

    md = args.max_depth
    datasets = []
    for (_name, b1, b2, idx1, idx2, _ctg, _centers,
         labels) in _legacy_labeled_bins(args):
        datasets.append((*map(int8_images, _legacy_images(
            b1, b2, idx1, idx2, md)), labels))
    if not datasets:
        print({"error": "no aligned training sites"})
        return 1

    g0 = np.concatenate([d[0] for d in datasets])
    g1 = np.concatenate([d[1] for d in datasets])
    labels = np.concatenate([d[2] for d in datasets])
    n_cls = args.gt_classes
    # the selection is empty in every epoch or in none: no variant site
    if not len(select_training_sites(labels, np.random.default_rng(0),
                                     n_classes=n_cls)):
        print({"error": "no confident SNV-labeled sites"})
        return 1
    params = init_catmodel_params(torch.Generator().manual_seed(args.seed),
                                  gt_classes=n_cls)
    tr = CatModelTrainer(params, lr=args.lr, batch_size=args.batch_size,
                         seed=args.seed, device=args.device,
                         out_dir=args.output, gt_classes=n_cls)
    tr.fit(tr.feed(g0, g1, labels, np.random.default_rng(args.seed),
                   args.epochs), None, None, None, None)
    for rec in tr.history:
        print(rec)
    return 0


def _run_legacy_eval(args, cfg) -> int:
    """Reference HaplotypeModel/eval.py:29-83: CatModel predictions vs
    truth labels over labeled dual-tag bins; TSV rows
    `ctg pos truth pred qual -/False` plus an accuracy line. Site filter =
    the reference's confident-variant + downsampled-nonvariant selection
    (dataset.py:552-561 via select_training_sites)."""
    import numpy as np

    from .. import constants as C
    from ..decode.pileup_vcf import calculate_score
    from ..legacy.train import select_training_sites

    model, predict = _legacy_predictor(args)
    # class count comes from the loaded head (10-class shipped configs or
    # the 15-class config_prev variant)
    n_cls = model.out.w.shape[-1]
    rng = np.random.default_rng(args.seed)
    out_path = os.path.join(args.output, "legacy_eval.tsv")
    n_total = n_correct = 0
    with open(out_path, "w") as fout:
        fout.write("# Contig\tPos\tTruth\tPred\tQual\tTrue/False\n")
        for (_name, b1, b2, idx1, idx2, ctg, centers,
             labels) in _legacy_labeled_bins(args):
            keep = select_training_sites(labels, rng, n_classes=n_cls)
            if len(keep) == 0:
                continue
            g0, g1 = _legacy_images(b1, b2, idx1[keep], idx2[keep],
                                    args.max_depth)
            gt = labels[keep, 1]
            pos = centers[keep]
            for s in range(0, len(keep), args.batch_size):
                probs = predict(g0[s:s + args.batch_size],
                                g1[s:s + args.batch_size])
                best = probs.argmax(1)
                sub_gt = gt[s:s + args.batch_size]
                n_total += len(best)
                n_correct += int((best == sub_gt).sum())
                for p, cls, pr, y in zip(pos[s:s + args.batch_size], best,
                                         probs.max(1), sub_gt):
                    ok = "-" if cls == y else "False"
                    fout.write(f"{ctg}\t{p}\t{C.GT21_LABELS[y]}\t"
                               f"{C.GT21_LABELS[cls]}\t"
                               f"{calculate_score(float(pr))}\t{ok}\n")
    acc = round(n_correct / n_total, 4) if n_total else 0.0
    print({"sites": n_total, "accuracy": acc, "output": out_path})
    return 0


def _run_legacy_filter_labels(args, cfg) -> int:
    """Reference filter_catmodel_label.py: write positions where both
    tags' read consensus contradicts the truth label (label noise to drop
    before legacy training)."""
    from ..legacy.labelcheck import consensus_label_mismatches

    out_path = os.path.join(args.output, "filtered_positions.txt")
    n_flagged = n_checked = 0
    with open(out_path, "w") as fout:
        for (name, b1, b2, idx1, idx2, ctg, centers,
             labels) in _legacy_labeled_bins(args):
            r1 = b1["read_matrix"][idx1, :args.max_depth]
            r2 = b2["read_matrix"][idx2, :args.max_depth]
            col = args.center_col
            if col is None:
                col = r1.shape[2] // 2
            checked, mism = consensus_label_mismatches(
                r1, r2, labels[:, 1], col, args.threshold)
            # only confidently-labeled SNV sites participate, as in the
            # reference (its bins carry labels only there)
            conf = (labels[:, 0] > 0) & (labels[:, 1] >= 0) \
                & (labels[:, 1] < 10)
            mism &= conf
            n_checked += int((checked & conf).sum())
            n_flagged += int(mism.sum())
            for p in centers[mism]:
                fout.write(f"{ctg}:{p}\n")
            print({"bin": name, "flagged": int(mism.sum()),
                   "kept": int((conf & ~mism).sum())})
    print({"checked": n_checked, "flagged": n_flagged, "output": out_path})
    return 0


def _run_legacy_heuristic(args, cfg) -> int:
    from ..legacy.bins import load_legacy_bin
    from ..legacy.heuristic import run_heuristic

    out_path = os.path.join(args.output, "legacy_homozygous.txt")
    n_out = 0
    with open(out_path, "w") as fout:
        for name in sorted(os.listdir(args.data)):
            b = load_legacy_bin(os.path.join(args.data, name))
            mat = b["pair_route"] if args.pair_route else b["edge_matrix"]
            for pos in run_heuristic(mat, list(b["position"]),
                                     pair_route=args.pair_route):
                fout.write(pos + "\n")
                n_out += 1
    print({"homozygous": n_out, "output": out_path})
    return 0


def _add_legacy_parsers(sub) -> None:
    def tags(p):
        p.add_argument("--data-tag1", required=True, help="bin dir, HP tag 1")
        p.add_argument("--data-tag2", required=True, help="bin dir, HP tag 2")

    def truth(p):
        p.add_argument("--ref", required=True)
        p.add_argument("--truth-vcf", required=True)
        p.add_argument("--bed", required=True)

    p = sub.add_parser("legacy-make-groups",
                       help="legacy cat-model path: pileup VCF + BAM(s) -> "
                            "per-contig edge/read-matrix bins (reference "
                            "make_predict_groups.py)")
    _add_common(p)
    p.add_argument("--pileup-vcf", required=True)
    p.add_argument("--bam", required=True,
                   help="directory of {contig}.bam files, or one BAM used "
                        "for every contig (a per-HP split from split-bam "
                        "--by-tag in the dual-bin flow)")
    p.add_argument("--contigs", nargs="*", default=None)
    p.add_argument("--adjacent-size", type=int, default=5)
    p.add_argument("--min-quality", type=float, default=15.0)
    p.add_argument("--support-quality", type=float, default=19.0)
    p.add_argument("--max-coverage", type=int, default=150)
    p.add_argument("--npz", action="store_true",
                   help="write {contig}.npz numpy archives of the same "
                        "datasets instead of HDF5 {contig}.bin (no h5py "
                        "needed)")

    p = sub.add_parser("legacy-predict",
                       help="legacy CatModel inference over dual-tag bins "
                            "(reference HaplotypeModel/predict.py)")
    _add_common(p)
    tags(p)
    p.add_argument("--model", required=True, help=".npz/.ckpt CatModel params")
    p.add_argument("--batch-size", type=int, default=1000)
    p.add_argument("--max-depth", type=int, default=20)
    p.add_argument("--min-depth", type=int, default=2)
    _add_device(p)

    p = sub.add_parser("legacy-heuristic",
                       help="legacy non-NN homozygote caller over edge "
                            "graphs (reference heuristic.py)")
    _add_common(p)
    p.add_argument("--data", required=True, help="legacy bin dir")
    p.add_argument("--pair-route", action="store_true",
                   help="use the pair-route voting rule "
                        "(heuristic_pair_route.py) instead of the two-path "
                        "walk")

    p = sub.add_parser("legacy-train",
                       help="train the legacy CatModel on dual-tag bins + "
                            "a truth VCF (reference HaplotypeModel/train.py)")
    _add_common(p)
    tags(p)
    truth(p)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--max-depth", type=int, default=20)
    p.add_argument("--min-depth", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gt-classes", type=int, default=10, choices=(10, 15),
                   help="10 = shipped legacy configs (gt_num_class: 10); "
                        "15 = the config_prev cal_label pair space "
                        "(dataset.py:26-57) incl. deletion pairs")
    _add_device(p)

    p = sub.add_parser("legacy-eval",
                       help="legacy CatModel accuracy vs truth labels over "
                            "dual-tag bins (reference HaplotypeModel/eval.py)")
    _add_common(p)
    tags(p)
    p.add_argument("--model", required=True, help=".npz CatModel params")
    truth(p)
    p.add_argument("--batch-size", type=int, default=1000)
    p.add_argument("--max-depth", type=int, default=20)
    p.add_argument("--min-depth", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    _add_device(p)

    p = sub.add_parser("legacy-filter-labels",
                       help="flag label-noise sites where both tags' read "
                            "consensus contradicts the truth label "
                            "(reference filter_catmodel_label.py)")
    _add_common(p)
    tags(p)
    truth(p)
    p.add_argument("--max-depth", type=int, default=20)
    p.add_argument("--min-depth", type=int, default=5)
    p.add_argument("--threshold", type=float, default=0.70)
    p.add_argument("--center-col", type=int, default=None,
                   help="het-matrix column for the consensus check; "
                        "default = true center (adjacent_size). The "
                        "reference tool hardcodes 2")


_LEGACY = {"legacy-make-groups": _run_legacy_make_groups,
           "legacy-predict": _run_legacy_predict,
           "legacy-eval": _run_legacy_eval,
           "legacy-train": _run_legacy_train,
           "legacy-filter-labels": _run_legacy_filter_labels,
           "legacy-heuristic": _run_legacy_heuristic}


def _ensure_mpileup_dir(args, cfg, work_dir=None, contigs=None) -> str:
    if getattr(args, "mpileup_dir", None):
        return args.mpileup_dir
    work_dir = work_dir or args.output
    contigs = contigs if contigs is not None else args.contigs
    out = os.path.join(work_dir, "chr_mpileup")
    if getattr(args, "mpileup", None):
        if not os.path.isdir(out) or not os.listdir(out):
            stages.split_mpileup_by_contig(args.mpileup, out, contigs)
        return out
    if getattr(args, "bam", None):
        from . import external

        mp = os.path.join(work_dir, "pileup_data.mpileup")
        if not os.path.exists(mp):
            fc = cfg.pileup_feature
            external.run_mpileup(args.bam, args.ref, mp,
                                 min_mq=fc.mpileup_min_mq,
                                 max_depth=fc.mpileup_max_depth,
                                 excl_flags=fc.mpileup_excl_flags)
        stages.split_mpileup_by_contig(mp, out, contigs)
        return out
    raise SystemExit("one of --mpileup-dir / --mpileup / --bam is required")


def resolve_contigs(requested, ref) -> list:
    """Contigs the call pipeline works on: the user's --contigs, else the
    reference's major-contig order (run_caller.sh operates chr1..chrX/Y),
    else, when the FASTA uses nonstandard names (synthetic worlds,
    non-human assemblies), every FASTA contig. Never empty for a
    non-empty FASTA: an empty list would silently skip s4/s5."""
    return (list(requested) if requested
            else [c for c in ALL_CHROMS if c in ref.by_name]
            or [e.name for e in ref.entries])


def _run_call(args, cfg) -> int:
    """`call`, as the JAX package's `_run_call`: the stage graph under a
    PipelineRunner with `.done` resume. s2 and s5 run on `--device`; while
    s1 (and s3, s4) run on the host, background threads get the card, the
    kernels' library and the weights ready.

    Across hosts every host computes the same LPT contig plan and runs the
    stages on its own contigs in OUT/host{id} on its own device; then host
    0 merges pileup.vcf, merge.vcf and haplotype.csv into OUT. A host whose
    stage raises fails `call` on every host (parallel/launch.all_hosts)."""
    from ..parallel.launch import (all_hosts, initialize_distributed,
                                   local_device, merge_host_csvs,
                                   merge_host_vcfs, shutdown)

    plan = initialize_distributed(args.coordinator, args.num_hosts,
                                  args.host_id)
    try:
        with all_hosts("nsp_call_gather"):
            runner = _run_call_host(args, cfg, plan, local_device(
                plan, args.device))
        if plan.n_hosts > 1:
            # host 0 gathers the final artifacts in global contig order
            # (reference: file concatenation of per-contig outputs; here
            # sortvcf.py-ordered merge)
            with all_hosts("nsp_call_done"):
                if plan.host_id == 0:
                    host_dirs = [os.path.join(args.output, f"host{h}")
                                 for h in range(plan.n_hosts)]
                    for name, merge_fn in (
                            ("pileup.vcf", merge_host_vcfs),
                            ("merge.vcf", merge_host_vcfs),
                            ("haplotype.csv", merge_host_csvs)):
                        paths = [os.path.join(d, name) for d in host_dirs
                                 if os.path.exists(os.path.join(d, name))]
                        if paths:
                            n = merge_fn(paths, os.path.join(args.output,
                                                             name))
                            runner.log.info("gathered %s: %d rows from %d "
                                            "hosts", name, n, len(paths))
    finally:
        shutdown()
    return 0


def _run_call_host(args, cfg, plan, device) -> PipelineRunner:
    """This host's share of `call`: its contigs, in its work dir."""
    from ..parallel.launch import host_contigs

    ref = FastaReference(args.ref)
    contigs = resolve_contigs(args.contigs, ref)
    work_dir = args.output
    if plan.n_hosts > 1:
        # deterministic LPT contig fan-out over hosts (each host computes
        # the same plan; the reference's GNU-parallel chromosome fan-out at
        # process level, scripts/s3_phasing_long_reads.sh:35-69)
        contigs = host_contigs(plan, {c: ref.length(c) for c in contigs})
        work_dir = os.path.join(args.output, f"host{plan.host_id}")
    os.makedirs(work_dir, exist_ok=True)
    runner = PipelineRunner(work_dir)
    shard_dir = os.path.join(work_dir, "pileup_shards")
    pileup_vcf = os.path.join(work_dir, "pileup.vcf")
    warm = {}

    def s1(**kw):
        if args.bam:
            # native path: direct BAM pileup, no samtools round trip
            return stages.stage_pileup_features_from_bam(
                cfg, ref, args.bam, shard_dir, contigs)
        return stages.stage_pileup_features(
            cfg, ref, _ensure_mpileup_dir(args, cfg, work_dir, contigs),
            shard_dir, contigs)

    def s2(**kw):
        if "s2" in warm:
            warm.pop("s2").join_raise()
        return stages.stage_pileup_predict(
            cfg, ref, shard_dir, pileup_vcf, model_path=args.pileup_model,
            device=device)

    stage_list = [
        Stage("s1_pileup_features", s1, "BAM/mpileup -> candidate windows"),
        Stage("s2_pileup_predict", s2,
              "pileup model inference -> pileup.vcf"),
    ]
    if args.haplotype_model:
        from . import external
        from .extract import NativeBamExtractor

        hap_shards = os.path.join(work_dir, "haplotype_shards")
        hap_csv = os.path.join(work_dir, "haplotype.csv")
        merge_vcf = os.path.join(work_dir, "merge.vcf")
        tag_dir_holder = {}

        phase_native_dir = os.path.join(work_dir, "phase_native")

        def s3(**kw):
            if not args.bam:
                raise SystemExit("stages s3-s5 need --bam")
            mode = args.phaser
            if mode == "auto":
                mode = "whatshap" if external.have("whatshap") else "native"
            if mode == "unphased" or (mode == "whatshap"
                                      and not external.have("whatshap")):
                # No phaser. Unphased reads degrade the haplotype features
                # (every read lands in the 'unphased' group), so this is
                # opt-in; the reference hard-depends on whatshap
                # (scripts/s3_phasing_long_reads.sh:48-69).
                if not args.allow_unphased:
                    raise SystemExit(
                        f"phaser '{mode}' unavailable: install whatshap, "
                        "use --phaser native (built-in), pass "
                        "--allow-unphased to run s4/s5 with every read "
                        "unphased (reduced accuracy), or drop "
                        "--haplotype-model to stop after the pileup stage.")
                tag_dir_holder["paths"] = {c: args.bam for c in contigs}
                return {"phased": 0, "unphased_fallback": True,
                        "note": f"phaser {mode} (--allow-unphased)"}
            if mode == "native":
                m = stages.stage_phase_native(
                    cfg, ref, pileup_vcf, args.bam, phase_native_dir,
                    contigs, emit_tagged_bams=args.emit_tagged_bams)
                tag_dir_holder["paths"] = {c: args.bam for c in contigs}
                tag_dir_holder["hp_overrides"] = \
                    stages.load_native_phase_overrides(phase_native_dir)
                m["engine"] = "native"
                return m
            from ..decode.sort import select_phasing_hetesnps

            work = os.path.join(work_dir, "phase_work")
            os.makedirs(work, exist_ok=True)
            with open(pileup_vcf) as f:
                header, per_contig = select_phasing_hetesnps(
                    f, cfg.haplotype_feature.phase_het_quality)
            split_vcfs = {}
            for ctg, rows in per_contig.items():
                p = os.path.join(work, f"{ctg}.splited.vcf")
                with open(p, "w") as f:
                    f.writelines(header)
                    f.writelines(rows)
                split_vcfs[ctg] = p
            split_bams = external.split_bam_by_contig(
                args.bam, list(split_vcfs), os.path.join(work, "split_bams"),
                threads=cfg.threads or 8)
            tagged = external.phase_and_haplotag(
                split_vcfs, split_bams, args.ref, work,
                threads=cfg.threads or 8)
            tag_dir_holder["paths"] = tagged
            return {"phased": len(tagged)}

        def s4(**kw):
            paths = tag_dir_holder.get("paths")
            hp_overrides = tag_dir_holder.get("hp_overrides")
            if not paths:
                # resumed run: pick up previously haplotagged BAMs or the
                # native phaser's HP partition if present
                tag_dir = os.path.join(work_dir, "phase_work",
                                       "haplotag_out")
                if os.path.isdir(tag_dir) and os.listdir(tag_dir):
                    paths = {f[:-4]: os.path.join(tag_dir, f)
                             for f in os.listdir(tag_dir)
                             if f.endswith(".bam")}
                elif os.path.isdir(phase_native_dir):
                    hp_overrides = stages.load_native_phase_overrides(
                        phase_native_dir)
                    if hp_overrides:
                        paths = {c: args.bam for c in contigs}
            if not paths:
                paths = {c: args.bam for c in contigs}
            extractor = NativeBamExtractor(
                paths, cfg.haplotype_feature.max_coverage,
                hp_overrides=hp_overrides,
                nbase_chunk_drop=cfg.haplotype_feature.nbase_chunk_drop)
            try:
                return stages.stage_haplotype_features(
                    cfg, ref, pileup_vcf, extractor, hap_shards)
            finally:
                extractor.close()

        def s5(**kw):
            if "s5" in warm:
                warm.pop("s5").join_raise()
            return stages.stage_haplotype_predict(
                cfg, ref, hap_shards, hap_csv, device=device,
                model_path=args.haplotype_model)

        # fingerprints: the merge knobs feed s5 (deferral gate drops rows
        # there) and s6; changing them on a resumed run must invalidate
        # the stale artifacts (pipeline.Stage.fingerprint).
        merge_fp = json.dumps(dataclasses.asdict(cfg.merge), sort_keys=True)
        stage_list += [
            Stage("s3_phasing", s3, "whatshap phase + haplotag"),
            Stage("s4_haplotype_features", s4,
                  "group selection + read matrices"),
            Stage("s5_haplotype_predict", s5,
                  "haplotype model inference -> haplotype.csv",
                  fingerprint=f"defer={cfg.merge.defer_unphased_frac}"),
            Stage("s6_merge",
                  lambda **kw: stages.stage_merge(cfg, pileup_vcf, hap_csv,
                                                  merge_vcf),
                  "merge calls", fingerprint=merge_fp),
        ]
        # skipped when s5 is already .done (resume): nothing would use it
        s5_done = os.path.join(work_dir, ".stages",
                               "s5_haplotype_predict.done")
        if args.no_resume or not os.path.exists(s5_done):
            warm["s5"] = stages.prewarm_haplotype_model(
                cfg, args.haplotype_model, device)
    s2_done = os.path.join(work_dir, ".stages", "s2_pileup_predict.done")
    if args.no_resume or not os.path.exists(s2_done):
        warm["s2"] = stages.prewarm_pileup_model(cfg, args.pileup_model,
                                                 device)
    try:
        runner.run(stage_list, resume=not args.no_resume)
    finally:
        # a thread no stage waited for (its stage was skipped, or an
        # earlier one failed) is joined here, before any barrier; its
        # error is re-raised unless one is already on its way up
        stages.join_prewarm_threads()
    return runner


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="nanosnp_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("call", help="run the pipeline end to end")
    _add_common(p)
    p.add_argument("--bam", help="input BAM (read natively; s3-s5 need it)")
    p.add_argument("--mpileup", help="pre-computed whole-genome mpileup file")
    p.add_argument("--mpileup-dir", help="per-contig mpileup directory")
    p.add_argument("--ref", required=True, help="reference FASTA")
    p.add_argument("--pileup-model", required=True)
    p.add_argument("--haplotype-model", default=None)
    p.add_argument("--contigs", nargs="*", default=None)
    p.add_argument("--coverage", type=int, default=30)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--allow-unphased", action="store_true",
                   help="proceed through s4/s5 with untagged reads when "
                        "no phaser is available (degrades haplotype "
                        "features; off by default)")
    p.add_argument("--phaser", default="auto",
                   choices=["auto", "whatshap", "native", "unphased"],
                   help="s3 engine: whatshap (reference parity, external), "
                        "native (built-in read-backed phaser, no external "
                        "deps), auto = whatshap if installed else native")
    p.add_argument("--emit-tagged-bams", action="store_true",
                   help="with --phaser native: also write haplotag_out/"
                        "{contig}.bam copies (whatshap-haplotag's artifact) "
                        "for external tools; the pipeline itself does not "
                        "need them")
    p.add_argument("--defer-unphased-frac", type=float, default=None,
                   help="skip haplotype-model rescue at candidates whose "
                        "covering reads are phased below this fraction "
                        "(merge keeps the pileup call there); 0 = reference "
                        "behavior. See MergeConfig.defer_unphased_frac")
    p.add_argument("--depth-mode", default=None,
                   choices=["column", "push"],
                   help="s1 BAM depth-cap semantics: column = exact "
                        "per-column cap; push = htslib bam_plp_push "
                        "whole-read admission incl. the coverage-spike "
                        "shadow (samtools --max-depth behavior). See "
                        "PileupFeatureConfig.depth_mode")
    p.add_argument("--coordinator", default=None,
                   help="multi-host: coordinator address host:port "
                        "(or env NSP_COORDINATOR)")
    p.add_argument("--num-hosts", type=int, default=None,
                   help="multi-host: total process count (or NSP_NUM_PROCS)")
    p.add_argument("--host-id", type=int, default=None,
                   help="multi-host: this process's id (or NSP_PROC_ID)")
    _add_device(p)

    p = sub.add_parser("s1-features", help="mpileup -> pileup shards")
    _add_common(p)
    p.add_argument("--mpileup", help="whole-genome mpileup file")
    p.add_argument("--mpileup-dir", help="per-contig mpileup directory")
    p.add_argument("--ref", required=True)
    p.add_argument("--contigs", nargs="*", default=None)

    p = sub.add_parser("sort-vcf")
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o", required=True)

    p = sub.add_parser(
        "split-bam",
        help="native BAM splitting (no samtools): per contig and/or by HP "
             "tag into h1/h2 (reference DNA_SplitSam / split_bam_by_tag "
             "roles). Outputs are unindexed BAMs.")
    p.add_argument("--bam", required=True)
    p.add_argument("--output", "-o", required=True, help="output directory")
    p.add_argument("--contigs", nargs="*", default=None,
                   help="write {contig}.bam per contig (default: all)")
    p.add_argument("--by-tag", action="store_true",
                   help="split into h1.bam/h2.bam by HP aux instead "
                        "(untagged reads dropped)")

    p = sub.add_parser("make-train-data",
                       help="labeled pileup training arrays from BAM + truth")
    _add_common(p)
    p.add_argument("--bam", required=True)
    p.add_argument("--ref", required=True)
    p.add_argument("--truth-vcf", required=True)
    p.add_argument("--bed", default=None, help="confident regions BED")
    p.add_argument("--contigs", nargs="*", default=None)
    p.add_argument("--max-nonvariant-ratio", type=float, default=5.0)
    p.add_argument("--h5", action="store_true",
                   help="also write reference-layout HDF5 train bins "
                        "({contig}.bin; needs h5py)")

    p = sub.add_parser("s2-predict", help="pileup shards -> pileup.vcf")
    _add_common(p)
    p.add_argument("--shards", required=True)
    p.add_argument("--ref", required=True)
    p.add_argument("--pileup-model", required=True,
                   help="reference-layout pileup checkpoint")
    _add_device(p)

    p = sub.add_parser("s6-merge",
                       help="pileup.vcf + haplotype.csv -> merge.vcf")
    _add_common(p)
    p.add_argument("--pileup-vcf", required=True)
    p.add_argument("--haplotype-csv", required=True)

    p = sub.add_parser("train-pileup")
    _add_common(p)
    p.add_argument("--data", required=True, help="dir of labeled .npz arrays")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--use-balance", action="store_true",
                   help="per-(gt,zy)-class upsampling per epoch")
    p.add_argument("--val-fraction", type=float, default=None,
                   help="held-out fraction for per-epoch validation "
                        "(default cfg.train.val_fraction)")
    p.add_argument("--first-stage", type=int, default=None,
                   help="freeze encoder params from this epoch on")
    _add_device(p)

    p = sub.add_parser("train-haplotype")
    _add_common(p)
    p.add_argument("--shards", required=True, help="haplotype shard dir")
    p.add_argument("--ref", required=True)
    p.add_argument("--truth-vcf", required=True)
    p.add_argument("--bed", required=True)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--pn-value", type=float, default=0.7)
    p.add_argument("--resume", default=None)
    p.add_argument("--val-fraction", type=float, default=None,
                   help="held-out shard fraction for per-epoch validation")
    p.add_argument("--first-stage", type=int, default=None)
    _add_device(p)
    _add_legacy_parsers(sub)
    _add_eval_parsers(sub)

    args = parser.parse_args(argv)

    if args.cmd == "compare-failed":
        return _run_compare_failed(args)
    if args.cmd == "sort-vcf":
        from ..decode.sort import sort_vcf_lines

        with open(args.input) as f:
            lines = sort_vcf_lines(f)
        with open(args.output, "w") as f:
            f.writelines(lines)
        return 0

    if args.cmd == "split-bam":
        from ..io.bam import BamFile

        os.makedirs(args.output, exist_ok=True)
        with BamFile(args.bam) as bam:
            if args.by_tag:
                n = bam.split_by_tag(os.path.join(args.output, "h1.bam"),
                                     os.path.join(args.output, "h2.bam"))
                print({"records": n})
            else:
                contigs = args.contigs or [c for c, _ in bam.references()]
                total = 0
                for ctg in contigs:
                    total += bam.write_tagged(
                        os.path.join(args.output, f"{ctg}.bam"), {},
                        contig=ctg)
                print({"records": total, "contigs": len(contigs)})
        return 0

    cfg = load_config(args.config)
    if args.threads:
        cfg.threads = args.threads
    if getattr(args, "defer_unphased_frac", None) is not None:
        cfg.merge.defer_unphased_frac = args.defer_unphased_frac
    if getattr(args, "depth_mode", None) is not None:
        cfg.pileup_feature.depth_mode = args.depth_mode
    if getattr(args, "device", None):
        resolve_device(args.device)      # no card: raise before any write
    os.makedirs(args.output, exist_ok=True)

    if args.cmd == "call":
        return _run_call(args, cfg)
    if args.cmd == "make-train-data":
        return _run_make_train_data(args, cfg)
    if args.cmd == "s1-features":
        m = stages.stage_pileup_features(
            cfg, FastaReference(args.ref), _ensure_mpileup_dir(args, cfg),
            os.path.join(args.output, "pileup_shards"), args.contigs)
        print(m)
        return 0
    if args.cmd in ("train-pileup", "train-haplotype"):
        # data-parallel over the ranks that NSP_* describe (the JAX
        # trainers have no flag for it either)
        from ..parallel.launch import initialize_distributed, shutdown

        initialize_distributed()
        try:
            return (_run_train_pileup if args.cmd == "train-pileup"
                    else _run_train_haplotype)(args, cfg)
        finally:
            shutdown()
    if args.cmd in _LEGACY:
        return _LEGACY[args.cmd](args, cfg)
    if args.cmd == "evaluate-pileup":
        return _run_evaluate_pileup(args, cfg)
    if args.cmd == "evaluate-haplotype":
        return _run_evaluate_haplotype(args, cfg)
    if args.cmd == "s2-predict":
        m = stages.stage_pileup_predict(
            cfg, FastaReference(args.ref), args.shards,
            os.path.join(args.output, "pileup.vcf"),
            model_path=args.pileup_model, device=args.device)
    else:
        m = stages.stage_merge(cfg, args.pileup_vcf, args.haplotype_csv,
                               os.path.join(args.output, "merge.vcf"))
    print(m)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
