"""Loader for the reference's historical `config_prev/*.yaml` archives.

The reference keeps 17 retired experiment configs under
`HaplotypeModel/config_prev/` (reference: HaplotypeModel/config_prev/
edges.yaml, cat45.yaml, pileup_length_11.yaml, ...). They describe two
dead model generations that our `legacy/` package re-implements:

- the "edge" family (enc/joint BiLSTM over 25-dim edge features,
  single train/dev/test bin dirs) -> `legacy.catmodel._bilstm_proj`-era
  encoder + the `legacy.edges` featurizer;
- the "cat" family (CatModel over g0/g1 pileup+haplotype images,
  paired train1/train2 tag dirs, 10- or 15-class gt heads) ->
  `legacy.catmodel`.

This module parses either schema into one typed record and maps the
training/optim blocks onto our `TrainConfig`/`OptimConfig`, so a user
holding an old experiment yaml can re-run it against `legacy-train`
without hand-translating fields. Cluster-specific data paths are kept
verbatim (they point at the original author's filesystem and are the
user's job to remap).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..config import OptimConfig, TrainConfig

# reference optim.py dispatches on these exact strings (HaplotypeModel/
# optim.py Optimizer.__init__); ours are lowercase snake in train/optim.py.
# NOTE: the archive is HaplotypeModel-scoped, and that optim.py routes
# type 'Ranger' to the Ranger21 class (HaplotypeModel/optim.py:104-105 —
# warmup/warmdown schedule, AGC, norm-loss), NOT the PileupModel-era
# lessw2020 Ranger (GC+RAdam+Lookahead). Map it accordingly.
_OPTIM_NAMES = {
    "lookaheadadam": "lookahead_adam",
    "ranger": "ranger21",
    "ranger21": "ranger21",
    "adam": "adam",
    "sgd": "sgd",
    "adadelta": "adadelta",
}


@dataclass
class LegacyArchiveConfig:
    """One parsed config_prev yaml."""
    configname: str
    family: str                      # "edge" | "cat"
    data: Dict[str, str]             # verbatim bin-dir paths
    gt_classes: int = 10
    zy_classes: int = 3
    # cat family: which g-image inputs the run used (cat45.yaml model.use_g*)
    use_g: Dict[str, bool] = field(default_factory=dict)
    pileup_length: Optional[int] = None
    haplotype_length: Optional[int] = None
    # edge family: encoder geometry (edges.yaml model.enc/joint)
    enc_hidden: Optional[int] = None
    enc_output: Optional[int] = None
    enc_layers: Optional[int] = None
    joint_inner: Optional[int] = None
    feature_dim: Optional[int] = None
    dropout: float = 0.0
    train: TrainConfig = field(default_factory=TrainConfig)
    save_model: Optional[str] = None
    # keys we recognized but deliberately drop (visualization, num_gpu, ...)
    ignored: Dict[str, Any] = field(default_factory=dict)

    def catmodel_init_kwargs(self) -> Dict[str, Any]:
        """kwargs for legacy.catmodel.init_catmodel_params."""
        if self.family != "cat":
            raise ValueError(
                f"{self.configname} is an {self.family}-family config; "
                "CatModel init only applies to the cat family")
        return {"gt_classes": self.gt_classes}


def _map_optim(block: Dict[str, Any], training: Dict[str, Any],
               ignored: Dict[str, Any]) -> OptimConfig:
    o = OptimConfig()
    raw_type = str(block.get("type", "LookaheadAdam"))
    key = raw_type.replace("_", "").replace("-", "").lower()
    if key not in _OPTIM_NAMES:
        raise ValueError(
            f"unknown optimizer type {raw_type!r} in archive config; "
            f"known: {sorted(set(_OPTIM_NAMES.values()))}")
    o.type = _OPTIM_NAMES[key]
    o.lr = float(block.get("lr", o.lr))
    o.decay_ratio = float(block.get("decay_ratio", o.decay_ratio))
    o.begin_to_adjust_lr = int(block.get("begin_to_adjust_lr",
                                         o.begin_to_adjust_lr))
    o.weight_decay = float(block.get("weight_decay", o.weight_decay))
    # the reference keeps max_grad_norm under training:, not optim:
    if "max_grad_norm" in training:
        o.max_grad_norm = float(training["max_grad_norm"])
    # momentum/nesterov exist in every archive yaml but only feed the SGD
    # branch of the reference Optimizer; record them as ignored otherwise
    for k in ("momentum", "nesterov"):
        if k in block and o.type != "sgd":
            ignored[f"optim.{k}"] = block[k]
    return o


def parse_archive_config(doc: Dict[str, Any],
                         name: str = "<archive>") -> LegacyArchiveConfig:
    """Parse one already-YAML-loaded config_prev document."""
    if not isinstance(doc, dict) or "model" not in doc:
        raise ValueError(f"{name}: not a config_prev document "
                         "(missing model: block)")
    model = doc.get("model") or {}
    training = doc.get("training") or {}
    optim = doc.get("optim") or {}
    data = {k: str(v) for k, v in (doc.get("data") or {}).items()}

    family = "edge" if "enc" in model else "cat"
    ignored: Dict[str, Any] = {}
    cfg = LegacyArchiveConfig(
        configname=str(doc.get("configname", name)),
        family=family,
        data=data,
        gt_classes=int(model.get("gt_num_class", 10)),
        zy_classes=int(model.get("zy_num_class", 3)),
        dropout=float(model.get("dropout", 0.0)),
        save_model=training.get("save_model"),
        ignored=ignored,
    )
    if family == "cat":
        cfg.use_g = {k: bool(v) for k, v in model.items()
                     if k.startswith("use_g")}
        if "pileup_length" in model:
            cfg.pileup_length = int(model["pileup_length"])
        if "haplotype_length" in model:
            cfg.haplotype_length = int(model["haplotype_length"])
    else:
        enc = model.get("enc") or {}
        cfg.enc_hidden = int(enc.get("hidden_size", 64))
        cfg.enc_output = int(enc.get("output_size", 128))
        cfg.enc_layers = int(enc.get("n_layers", 2))
        cfg.joint_inner = int((model.get("joint") or {}).get("inner_size",
                                                             256))
        cfg.feature_dim = int(model.get("feature_dim", 25))

    t = cfg.train
    t.batch_size = int(training.get("batch_size", t.batch_size))
    t.epochs = int(training.get("epochs", t.epochs))
    t.seed = int(training.get("seed", t.seed))
    fs = training.get("first_stage", None)
    t.first_stage = None if fs in (None, -1) else int(fs)
    t.optim = _map_optim(optim, training, ignored)
    for k in ("visualization", "num_gpu", "show_interval", "eval_or_not",
              "load_model", "load_encoder", "load_forward_layer"):
        if k in training:
            ignored[f"training.{k}"] = training[k]
    return cfg


def load_archive_config(path: str) -> LegacyArchiveConfig:
    """Load one `config_prev/*.yaml` file."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    return parse_archive_config(doc, name=path)
