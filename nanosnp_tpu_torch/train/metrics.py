"""Training observability: confusion matrices, per-class F1, scalar history.

A copy of nanosnp_tpu/train/metrics.py (numpy only), so that the port
imports nothing of the JAX package.

Replaces the reference's torchmetrics Accuracy/F1Score/ConfusionMatrix
(PileupModel/train.py:33-38), torchnet ConfusionMeter
(HaplotypeModel/train_dev.py:87), and tensorboardX scalar logging
(train.py:79-81,214-218; train_dev.py:244-248). Scalars append to a
`scalars.jsonl` file — one JSON object per (epoch, split) — greppable and
plottable without a tensorboard dependency.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class ConfusionAccumulator:
    """Streaming confusion matrix over int class predictions."""

    def __init__(self, n_classes: int):
        self.n = n_classes
        self.matrix = np.zeros((n_classes, n_classes), dtype=np.int64)

    def update(self, preds: np.ndarray, labels: np.ndarray) -> None:
        preds = np.asarray(preds).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        np.add.at(self.matrix, (labels, preds), 1)

    def reset(self) -> None:
        self.matrix[:] = 0

    @property
    def total(self) -> int:
        return int(self.matrix.sum())

    def accuracy(self) -> float:
        t = self.total
        return float(np.trace(self.matrix) / t) if t else 0.0

    def per_class_f1(self) -> np.ndarray:
        tp = np.diag(self.matrix).astype(np.float64)
        fp = self.matrix.sum(axis=0) - tp
        fn = self.matrix.sum(axis=1) - tp
        denom = 2 * tp + fp + fn
        with np.errstate(invalid="ignore", divide="ignore"):
            f1 = np.where(denom > 0, 2 * tp / np.maximum(denom, 1e-12), np.nan)
        return f1

    def macro_f1(self) -> float:
        """Mean F1 over classes that appear in labels or predictions
        (absent classes excluded, like torchmetrics' macro average over
        present classes)."""
        f1 = self.per_class_f1()
        present = (self.matrix.sum(axis=0) + self.matrix.sum(axis=1)) > 0
        if not present.any():
            return 0.0
        return float(np.nanmean(np.where(present, f1, np.nan)))

    def summary(self, prefix: str = "") -> Dict[str, float]:
        return {
            f"{prefix}acc": round(self.accuracy(), 5),
            f"{prefix}macro_f1": round(self.macro_f1(), 5),
        }

    def format_matrix(self, labels=None, max_classes: int = 25) -> str:
        """Text confusion dump (the reference prints the raw meter,
        train_dev.py:252,269-270)."""
        n = min(self.n, max_classes)
        rows = []
        if labels is not None:
            rows.append("true\\pred " + " ".join(f"{l:>6}" for l in labels[:n]))
        for i in range(n):
            name = labels[i] if labels is not None else str(i)
            rows.append(f"{name:>9} " + " ".join(
                f"{self.matrix[i, j]:>6}" for j in range(n)))
        return "\n".join(rows)


class MetricsLogger:
    """Append-only scalar history (tensorboardX SummaryWriter equivalent)."""

    def __init__(self, out_dir: str, filename: str = "scalars.jsonl"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, filename)

    def log(self, epoch: int, split: str, scalars: Dict[str, float],
            step: Optional[int] = None) -> None:
        rec = {"epoch": epoch, "split": split, "time": round(time.time(), 3)}
        if step is not None:
            rec["step"] = step
        rec.update({k: (float(v) if isinstance(v, (int, float, np.floating))
                        else v) for k, v in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def read(self):
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(l) for l in f if l.strip()]
