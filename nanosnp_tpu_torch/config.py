"""Unified configuration for the NanoSNP pipeline (PyTorch/CUDA port: a
copy of the JAX package's config, so the same YAML files load).

The reference splits hyperparameters over four mechanisms (YAML + argparse +
bash getopt + hand-rolled C++ flags — see SURVEY.md §5.6). Here everything
lives in typed dataclasses, loadable from one YAML file and overridable from
the CLI.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from . import constants as C


@dataclass
class PileupFeatureConfig:
    flanking_bases: int = C.FLANKING_BASES
    min_af: float = C.MIN_AF
    snp_min_af: float = C.SNP_MIN_AF
    indel_min_af: float = C.INDEL_MIN_AF
    min_depth: int = C.MIN_DEPTH
    max_indel_size: int = C.MAX_INDEL_SIZE
    mpileup_max_depth: int = C.MPILEUP_MAX_DEPTH
    mpileup_min_mq: int = C.MPILEUP_MIN_MQ
    mpileup_excl_flags: int = C.MPILEUP_EXCL_FLAGS
    # "column": per-column cap (default, matches the in-repo simulator);
    # "push": htslib bam_plp_push whole-read admission — samtools'
    # coverage-spike shadow semantics (io/bam.py pileup_region docstring;
    # unverified against a real samtools binary, ROADMAP #3)
    depth_mode: str = "column"

    @property
    def window(self) -> int:
        return 2 * self.flanking_bases + 1


@dataclass
class PileupModelConfig:
    """Matches reference PileupModel/config/ont_pileup.yaml model block."""
    feature_dim: int = 18
    hidden_size: int = 64
    output_size: int = 128
    n_layers: int = 2
    inner_size: int = 256
    gt_num_class: int = C.NUM_GT21
    zy_num_class: int = C.NUM_ZY
    indel1_num_class: int = C.NUM_INDEL_CLASSES
    indel2_num_class: int = C.NUM_INDEL_CLASSES
    dropout: float = 0.3
    seq_len: int = C.PILEUP_WINDOW


@dataclass
class HaplotypeModelConfig:
    """Matches reference HaplotypeModel/config/ont_haplotype.yaml model block."""
    pileup_dim: int = 105
    haplotype_dim: int = 105
    pileup_length: int = C.PILEUP_WINDOW
    haplotype_length: int = C.HAPLOTYPE_WINDOW
    hidden_size: int = 256
    lstm_layers: int = 3
    gt_num_class: int = C.NUM_GT10
    zy_num_class: int = C.NUM_ZY
    dropout: float = 0.1


@dataclass
class HaplotypeFeatureConfig:
    low_quality_threshold: float = C.HAP_LOW_QUAL
    hete_support_quality: float = C.HAP_SUPPORT_QUAL
    adjacent_size: int = C.ADJACENT_SIZE
    pileup_flanking_size: int = C.FLANKING_BASES
    max_coverage: int = C.MAX_COVERAGE
    max_pileup_depth: Optional[int] = None      # prod: 3 * coverage
    max_haplotype_depth: Optional[int] = None   # prod: 3 * coverage
    phase_het_quality: float = C.PHASE_HET_QUAL
    # native phaser (--phaser native): genomic window / overlap; the
    # overlap should exceed a typical read length so boundary-spanning
    # reads link blocks across windows
    phaser_window_bp: int = 50_000
    phaser_overlap_bp: int = 20_000
    # leave phase blocks with fewer sites UNPHASED (whatshap semantics: a
    # het linked to no other het is not phasable; its HP tags would
    # partition reads by that site's own allele — pure noise downstream,
    # and on sparse-het genomes they leak through the merge deferral
    # gate). 1 = phase everything (pre-r3 behavior)
    phaser_min_block_sites: int = 2
    # bug-compat: drop a whole extraction chunk when any read has a
    # non-ACGT base at a requested position (the reference's swallowed
    # base_to_int KeyError poisons its chunk,
    # create_pileup_haplotype.py:122,213); off = keep the sites
    nbase_chunk_drop: bool = False


@dataclass
class MergeConfig:
    quality: float = C.MERGE_QUAL
    hap_quality: float = C.MERGE_HAP_QUAL
    pileup_rescue_quality: float = C.MERGE_PILEUP_RESCUE_QUAL
    # Deferral gate (no reference counterpart, ON by default since r3):
    # candidates whose covering reads are phased below this fraction carry
    # no phasing signal in the hap channel, so the haplotype model is blind
    # there and its rescue is noise; s5 skips emitting such rows so merge
    # falls back to the pileup call (merge.py absent-site rule). At 0.01
    # the gate is self-adjusting: it only ever drops sites with ZERO (or
    # near-zero) phased covering reads, so well-phased worlds are
    # untouched while the sparse-het low-coverage regime (where the v2
    # merge trailed the pileup baseline) recovers — A/B evidence across
    # geometries in docs/evidence/defer_ab.json. Set 0.0 for byte-exact
    # reference s5/s6 behavior (rationale for the decode-time gate rather
    # than a retrain: scripts/train_haplotype_mixed.py v3 negative
    # result). The fraction is computed on the
    # HP-sorted, depth-capped shard rows, so at over-coverage sites it is
    # biased UPWARD (phased rows sort first and survive the cap) — fine at
    # the default 0.01; if ever raised much higher, compute it from
    # uncapped per-group tag counts in s4 instead.
    defer_unphased_frac: float = 0.01


@dataclass
class OptimConfig:
    """Matches the reference optim blocks (LookaheadAdam)."""
    type: str = "lookahead_adam"
    lr: float = 1e-4
    decay_ratio: float = 0.98
    begin_to_adjust_lr: int = 10
    weight_decay: float = 0.0
    max_grad_norm: float = 20.0
    label_smoothing: float = 0.1
    lookahead_sync_period: int = 6
    lookahead_slow_step: float = 0.5
    # ranger21 only: its warmup/warmdown schedule needs the planned total
    # epoch count (reference HaplotypeModel/optim.py:121 num_epochs)
    ranger21_epochs: int = 30


@dataclass
class TrainConfig:
    batch_size: int = 2000
    epochs: int = 200
    seed: int = 2022
    # per-(gt,zy)-class upsampling (reference dataset.py balance_dataset)
    use_balance: bool = False
    # held-out fraction when no explicit dev set (reference train.py:176-181
    # does a 90/10 file split)
    val_fraction: float = 0.1
    # freeze stages: from epoch `first_stage` on, parameters whose top-level
    # key starts with one of `freeze_prefixes` stop updating (reference
    # train.py:223-230 first_stage encoder/forward freeze)
    first_stage: Optional[int] = None
    freeze_prefixes: tuple = ("encoder",)
    # training batches per device dispatch, as in the JAX package: both
    # trainers buffer this many same-shape batches and run them as one
    # group of sequential steps (train/group.py: one CUDA graph replay on
    # the card; 1 gives single steps)
    steps_per_call: int = 8
    optim: OptimConfig = field(default_factory=OptimConfig)


@dataclass
class InferenceConfig:
    batch_size: int = 8192          # device batch per step
    # The compute dtype of s2 and s5: bf16 operands (f32 accumulation) in
    # the heads, the s5 features and the scan route's encoders; False is
    # f32 throughout (with use_pallas false, the strict-parity route). The
    # kernel route's encoder is bf16 whatever this says, as the JAX
    # package's Pallas encoder. evaluate-* compute in f32 regardless.
    use_bf16: bool = True
    # The encoder route of s2 and s5 (runtime/stages.resolve_use_pallas):
    # "auto" takes the BiLSTM kernels on the card and the scan route on the
    # CPU; true the kernels (their plain versions on the CPU); false the
    # scan route in the compute dtype (the inference recurrence kernels on
    # the card). models/bilstm.py has the table.
    use_pallas: str = "auto"
    # Replicate the reference decoder's gt_output[ti] indexing quirk
    # (PileupModel/predict.py:107,119,151,163) for bit-identical VCFs.
    bug_compat: bool = True
    data_axis: str = "data"


@dataclass
class PipelineConfig:
    pileup_feature: PileupFeatureConfig = field(default_factory=PileupFeatureConfig)
    pileup_model: PileupModelConfig = field(default_factory=PileupModelConfig)
    haplotype_feature: HaplotypeFeatureConfig = field(default_factory=HaplotypeFeatureConfig)
    haplotype_model: HaplotypeModelConfig = field(default_factory=HaplotypeModelConfig)
    merge: MergeConfig = field(default_factory=MergeConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    coverage: int = 30
    threads: int = 0                # 0 = os.cpu_count()


def _update(dc, data: dict):
    for k, v in data.items():
        if not hasattr(dc, k):
            raise KeyError(f"unknown config key: {type(dc).__name__}.{k}")
        cur = getattr(dc, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _update(cur, v)
        else:
            setattr(dc, k, v)


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> PipelineConfig:
    cfg = PipelineConfig()
    if path:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        _update(cfg, data)
    if overrides:
        _update(cfg, overrides)
    return cfg


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)
