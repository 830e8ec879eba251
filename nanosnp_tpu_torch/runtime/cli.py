"""Command-line entry point: `python -m nanosnp_tpu_torch.runtime.cli <command>`.

Commands ported so far (same flags as the JAX package's CLI, plus
`--device`: cuda by default; cpu runs the kernels' plain versions, and the
trainers the f32 path, as the JAX trainer does off the TPU):

  s2-predict       pileup shards -> pileup.vcf
  s6-merge         pileup.vcf + haplotype.csv -> merge.vcf
  train-pileup     labeled pileup arrays (.npz) -> pileup_train/ checkpoints
  train-haplotype  haplotype shards + truth VCF + BED -> haplotype_train/

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
