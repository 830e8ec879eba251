"""Command-line entry point: `python -m nanosnp_tpu_torch.runtime.cli <command>`.

Commands ported so far (same flags as the JAX package's CLI, plus
`--device`: cuda by default; cpu runs the kernels' plain versions, and the
trainers the f32 path, as the JAX trainer does off the TPU):

  s2-predict       pileup shards -> pileup.vcf
  s6-merge         pileup.vcf + haplotype.csv -> merge.vcf
  train-pileup     labeled pileup arrays (.npz) -> pileup_train/ checkpoints
  train-haplotype  haplotype shards + truth VCF + BED -> haplotype_train/
  legacy-predict   dual-tag legacy bins + CatModel params -> legacy_calls.tsv
  legacy-eval      the same against truth labels -> legacy_eval.tsv
  legacy-train     dual-tag legacy bins + truth -> catmodel.npz (the f32
                   recurrence under autograd, as the JAX package trains it)
  legacy-filter-labels  label-noise positions -> filtered_positions.txt
  legacy-heuristic      edge-graph homozygote caller (numpy, no device)

`legacy-make-groups` is not ported yet (it needs the BAM extractor).
s5 has no subcommand (the JAX CLI has none either): it runs through
`runtime.stages.stage_haplotype_predict`.
"""
from __future__ import annotations

import argparse
import os

from ..config import load_config
from ..device import resolve_device
from ..io.fasta import FastaReference
from . import stages


def _add_common(p):
    p.add_argument("--config", default=None,
                   help="YAML config overriding defaults")
    p.add_argument("--threads", type=int, default=0)
    p.add_argument("--output", "-o", required=True, help="output directory")


def _add_device(p):
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


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
    from ..train import data as D
    from ..train import labels as L
    from ..train.train_haplotype import train_haplotype

    ref = FastaReference(args.ref)
    seqs = {name: ref.contig(name) for name in ref.names}
    with open(args.bed) as f:
        bed = L.parse_bed(f)
    with open(args.truth_vcf) as f:
        truth_arrays = L.truth_arrays(
            {n: ref.length(n) for n in ref.names}, seqs, bed, f)
    D.set_reference_for_training(seqs)

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
    # (contig, depth bucket), far too coarse for a file-level split
    train_paths, val_paths = D.reshard_train_val(
        paths, os.path.join(args.output, "haplotype_split"),
        tcfg.val_fraction, rng)
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
    import numpy as np
    import torch

    from ..legacy.catmodel import init_catmodel_params
    from ..legacy.train import select_training_sites, train_catmodel
    from ..models.convert import save_params_npz

    md = args.max_depth
    datasets = []
    for (_name, b1, b2, idx1, idx2, _ctg, _centers,
         labels) in _legacy_labeled_bins(args):
        datasets.append((*_legacy_images(b1, b2, idx1, idx2, md), labels))
    if not datasets:
        print({"error": "no aligned training sites"})
        return 1

    g0 = np.concatenate([d[0] for d in datasets])
    g1 = np.concatenate([d[1] for d in datasets])
    labels = np.concatenate([d[2] for d in datasets])
    rng = np.random.default_rng(args.seed)
    n_cls = args.gt_classes
    params = init_catmodel_params(torch.Generator().manual_seed(args.seed),
                                  gt_classes=n_cls)
    for epoch in range(args.epochs):
        idx = select_training_sites(labels, rng, n_classes=n_cls)
        if len(idx) == 0:
            print({"error": "no confident SNV-labeled sites"})
            return 1

        def batches():
            for s in range(0, len(idx) - args.batch_size + 1,
                           args.batch_size):
                sel = idx[s:s + args.batch_size]
                yield g0[sel], g1[sel], labels[sel, 1]

        params, loss, steps = train_catmodel(
            params, batches(), lr=args.lr, seed=args.seed + epoch,
            device=args.device)
        print({"epoch": epoch + 1, "loss": round(loss, 4),
               "steps": steps, "sites": len(idx)})
        save_params_npz(os.path.join(args.output,
                                     f"catmodel_epoch{epoch + 1}.npz"),
                        params)
    save_params_npz(os.path.join(args.output, "catmodel.npz"), params)
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


_LEGACY = {"legacy-predict": _run_legacy_predict,
           "legacy-eval": _run_legacy_eval,
           "legacy-train": _run_legacy_train,
           "legacy-filter-labels": _run_legacy_filter_labels,
           "legacy-heuristic": _run_legacy_heuristic}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="nanosnp_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

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

    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    if args.threads:
        cfg.threads = args.threads
    if getattr(args, "device", None):
        resolve_device(args.device)      # no card: raise before any write
    os.makedirs(args.output, exist_ok=True)

    if args.cmd == "train-pileup":
        return _run_train_pileup(args, cfg)
    if args.cmd == "train-haplotype":
        return _run_train_haplotype(args, cfg)
    if args.cmd in _LEGACY:
        return _LEGACY[args.cmd](args, cfg)
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
