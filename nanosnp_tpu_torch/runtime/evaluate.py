"""The model-scoring commands' device work: `evaluate-pileup` and
`evaluate-haplotype` (counterparts of the JAX CLI's `_run_evaluate_*`).

Each yields the model's probabilities beside the labels, batch by batch,
so that the CLI accumulates its confusion matrices from them and a caller
can hold two devices' decisions against each other on the same inputs.
As the JAX CLI's `_run_evaluate_*`, which call its predict functions with
their defaults, they compute in f32 on the scan route (f32 features, f32
encoders and heads) whatever `inference` says: on the card the encoders
run the f32 inference recurrence kernel, on the CPU its plain version.
"""
from __future__ import annotations

import json
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np

from ..config import PipelineConfig
from ..device import resolve_device
from ..io.fasta import FastaReference
from ..train.metrics import ConfusionAccumulator

# (gt probabilities, zy probabilities, gt labels, zy labels), numpy
Scored = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]

HAPLOTYPE_INPUTS = ("p_seq", "p_baseq", "p_mapq", "p_hap", "p_ref",
                    "h_seq", "h_baseq", "h_mapq", "h_hap", "h_ref")


def truth_arrays(ref: FastaReference, truth_vcf: str, bed: str) -> Dict:
    """The truth VCF's per-contig (confident, gt21, zygosity) arrays
    inside the BED (train.labels.truth_arrays)."""
    from ..train import labels as L

    seqs = {name: ref.contig(name) for name in ref.names}
    with open(bed) as f:
        regions = L.parse_bed(f)
    with open(truth_vcf) as f:
        return L.truth_arrays({n: ref.length(n) for n in ref.names}, seqs,
                              regions, f)


def pileup_scores(cfg: PipelineConfig, model_path: str, data_dir: str,
                  for_evaluate: bool, batch_size: int,
                  device="cuda") -> Iterator[Scored]:
    """The pileup checkpoint at `model_path` over the labeled arrays in
    `data_dir`, one file at a time in list_shards order; `for_evaluate`
    keeps the variant rows only (reference dataset.py:100-106)."""
    from ..io.bins import list_shards
    from ..models.pileup_model import PileupModel, pileup_predict
    from ..parallel.inference import BatchedPredictor
    from ..train import data as D
    from ..train.train_pileup import load_checkpoint

    dev = resolve_device(device)
    params, _ = load_checkpoint(model_path)
    model = PileupModel(cfg.pileup_model, params).to(dev)
    predictor = BatchedPredictor(
        lambda x: pileup_predict(model, x, route="scan"),
        batch_size=batch_size, device=dev)
    for path in list_shards(data_dir):
        arrays = D.load_train_arrays(path)
        dec = D.decode_90dim_labels(arrays.label)
        sel = (D.for_evaluate_indices(dec["zy"]) if for_evaluate
               else np.arange(len(arrays.positions)))
        if len(sel) == 0:
            continue
        gt_p, zy_p = predictor.run(arrays.matrix[sel].astype(np.float32))
        yield gt_p, zy_p, dec["gt"][sel], dec["zy"][sel]


def haplotype_scores(cfg: PipelineConfig, model_path: str,
                     shard_paths: Sequence[str], ref: FastaReference,
                     truth: Dict, batch_size: int,
                     device="cuda") -> Iterator[Scored]:
    """The haplotype checkpoint at `model_path` over labeled shards: the
    trainer's validation batches (every site once, pn_value 1, the tiled
    tail of a shard cut back to its `_n` rows); the read matrices go to
    the device, where the featurizer and the model run."""
    from ..features.haplotype import haplotype_features
    from ..models.haplotype_model import HaplotypeModel, haplotype_predict
    from ..parallel.inference import BatchedPredictor
    from ..train import data as D
    from ..train.train_pileup import load_checkpoint

    dev = resolve_device(device)
    D.set_reference_for_training({n: ref.contig(n) for n in ref.names})
    params, _ = load_checkpoint(model_path)
    model = HaplotypeModel(cfg.haplotype_model, params).to(dev)

    def fn(sp, bp, mp_, hp, rp, sh, bh, mh, hh, rh):
        xp = haplotype_features(sp, bp, mp_, hp, rp)
        xh = haplotype_features(sh, bh, mh, hh, rh)
        return haplotype_predict(model, xp, xh, route="scan")

    predictor = BatchedPredictor(fn, batch_size=batch_size, device=dev)
    for batch in D.haplotype_train_iterator(
            list(shard_paths), truth, batch_size, np.random.default_rng(0),
            epochs=1, pn_value=1.0):
        n = batch.pop("_n", None)
        gt_p, zy_p = predictor.run(*[batch[k] for k in HAPLOTYPE_INPUTS])
        yield gt_p[:n], zy_p[:n], batch["gt"][:n], batch["zy"][:n]


def confusions(scored: Iterator[Scored], n_gt: int, n_zy: int
               ) -> Tuple[ConfusionAccumulator, ConfusionAccumulator]:
    """gt and zy confusion of the argmax decisions."""
    gt_conf, zy_conf = ConfusionAccumulator(n_gt), ConfusionAccumulator(n_zy)
    for gt_p, zy_p, gt, zy in scored:
        gt_conf.update(gt_p.argmax(1), gt)
        zy_conf.update(zy_p.argmax(1), zy)
    return gt_conf, zy_conf


def write_report(path: str, gt_conf: ConfusionAccumulator,
                 zy_conf: ConfusionAccumulator, gt_labels) -> None:
    """The JSON line and both confusion matrices on stdout, the JSON at
    `path`, as the JAX CLI writes them."""
    report = {"n": gt_conf.total}
    report.update(gt_conf.summary("gt_"))
    report.update(zy_conf.summary("zy_"))
    print(json.dumps(report))
    print(gt_conf.format_matrix(gt_labels))
    print(zy_conf.format_matrix(["0/0", "1/1", "0/1"]))
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
