"""The numbers that decide `correct`, each a gap between what the timed
path produced and what the reference makes of the same inputs.

Served calls (s2 VCF rows, s5 CSV rows), in the manner of a served
token's logit gap:

  decision_gap   the widest gap, in nats of the reference's log
                 probabilities, between the reference's best class and
                 the one the program's row implies (s5: the row's GT
                 class; s2: the cheapest gt and zy classes whose row is
                 the program's row, `s2_gaps`): a flip at a near-tie
                 reads small, a wrong answer reads large. A row that one
                 side has and the other has not is a decision like any
                 other; a row at no candidate reads inf.
  qual_gap       the widest |QUAL - QUAL_ref| over rows whose decisions
                 agree: QUAL is 10 + 10 log10(p / (1 - p)) of the top
                 probability, a scaled logit. Both are read capped at
                 QUAL_CAP: above it 1 - p is within a few hundred f32
                 ulps of nothing (at p = 1 in f32 QUAL jumps to 3010),
                 so what is left is the output's f32 rounding, not the
                 model's arithmetic. An s2 row's QUAL is held against
                 the QUAL of the classes that gave its row.

Training, the first steps (by the worst leaf, against the reference's
norm of that leaf or of the median leaf, whichever is larger):

  loss_gap       the widest |loss - loss_ref| / |loss_ref| over the steps;
  loss_gap_first the same of the first step alone (before any update, so
                 Adam's sign-like first steps, which move a weight by lr
                 whatever the size of its gradient, cannot turn round-off
                 into a different loss);
  grad_gap       |norm(g) - norm(g_ref)| of step 1's gradient as the
                 optimizer gets it;
  delta_gap      |norm(d) - norm(d_ref)| of the parameters' change over
                 the steps;
  delta_median_gap  the same gap of the median leaf, not the worst: over
                 a group of steps the worst leaf swings from seed to seed
                 (Adam's first steps move a weight by about lr whatever
                 its gradient, so round-off where a gradient all but
                 cancels becomes a step of its own, and the seeded
                 haplotype model's loss amplifies it), while a wrong
                 batch or update moves every leaf.

Leaves whose reference gradient is under a thousandth of the median
leaf's (the unused indel heads of the pileup model) move by round-off
alone and are left out of grad_gap and delta_gap.
"""
from __future__ import annotations

import math
from statistics import median
from typing import Dict, Iterable

import numpy as np

QUIET = 1e-3
QUAL_CAP = 50.0     # p = 1 - 1e-4
QUAL_TIE = 0.5      # a matching row's QUAL this near needs no search


def qual_diff(a: float, b: float) -> float:
    return abs(min(a, QUAL_CAP) - min(b, QUAL_CAP))


def margins(logp: np.ndarray) -> np.ndarray:
    """Top-1 minus top-2 log probability of each row."""
    part = np.partition(logp, -2, axis=1)
    return part[:, -1] - part[:, -2]


def s2_gaps(prog: Dict[int, tuple], ref: Dict[int, tuple],
            positions: np.ndarray, gt_logp: np.ndarray,
            zy_logp: np.ndarray, batch_heads: np.ndarray,
            rows_of) -> Dict[str, float]:
    """prog {pos: (fields, qual)}, ref {pos: (fields, qual, fallback)};
    the reference's log probabilities in candidate order; batch_heads
    [n] the least gt margin of the decode batch rows a fallback reads;
    rows_of(combos) decode.site_rows over the reference's probabilities.

    A row whose fields and QUAL match the reference's reads no decision
    gap. Any other site reads the cheapest pair of gt and zy classes that
    gives the program's row, its QUAL within QUAL_TIE, or its absence
    (failing that, the cheapest that gives its fields), the cost the
    reference's log probability below the best of each head; the row's
    QUAL is held against that pair's. A fallback row's alt is read from
    the batch's first rows: where only another alt would match, the cost
    adds the least margin of those rows."""
    index = {int(p): i for i, p in enumerate(positions)}
    dec, qual, n_diff = 0.0, 0.0, 0
    look = {}
    for pos in set(prog) | set(ref):
        i = index.get(pos)
        if i is None:
            return {"decision_gap": math.inf, "qual_gap": math.inf,
                    "rows_differ": len(prog)}
        p, r = prog.get(pos), ref.get(pos)
        if p is not None and r is not None and p[0] == r[0] \
                and qual_diff(p[1], r[1]) <= QUAL_TIE:
            qual = max(qual, qual_diff(p[1], r[1]))
        else:
            look[i] = p
    pairs = [(c, z) for c in range(gt_logp.shape[1])
             for z in range(zy_logp.shape[1])]
    best = {}
    for i, (c, z), row in rows_of({i: pairs for i in look}):
        p = look[i]
        cost = float(gt_logp[i].max() - gt_logp[i][c]
                     + zy_logp[i].max() - zy_logp[i][z])
        if p is None or row is None:
            if p is not None or row is not None:
                continue
            qd = 0.0
        elif row[0] == p[0]:
            qd = qual_diff(p[1], row[1])
        elif row[2] and row[0][:1] + row[0][2:] == p[0][:1] + p[0][2:]:
            cost += float(batch_heads[i])
            qd = qual_diff(p[1], row[1])
        else:
            continue
        # a pair whose QUAL is the row's too explains it before any other
        got = (qd > QUAL_TIE, cost, qd)
        best[i] = min(best.get(i, got), got)
    for i in look:
        _, cost, qd = best.get(i, (True, math.inf, 0.0))
        n_diff += cost > 0
        dec = max(dec, cost)
        qual = max(qual, qd)
    return {"decision_gap": dec, "qual_gap": qual, "rows_differ": n_diff}


def s5_gaps(prog: Dict[int, tuple], ref: Dict[int, tuple],
            positions: np.ndarray, gt_logp: np.ndarray,
            labels) -> Dict[str, float]:
    """prog {pos: (GT label, qual)}, ref {pos: (GT label, qual)} of the
    kept sites; the reference's gt log probabilities in site order."""
    if set(prog) != set(ref):
        return {"decision_gap": math.inf, "qual_gap": math.inf,
                "rows_differ": len(set(prog) ^ set(ref))}
    index = {int(p): i for i, p in enumerate(positions)}
    cls = {lab: k for k, lab in enumerate(labels)}
    dec, qual, n_diff = 0.0, 0.0, 0
    for pos, (lab, q) in prog.items():
        i = index[pos]
        k = cls.get(lab)
        if k is None:
            return {"decision_gap": math.inf, "qual_gap": math.inf,
                    "rows_differ": len(prog)}
        row = gt_logp[i]
        gap = float(row.max() - row[k])
        if lab == ref[pos][0]:
            qual = max(qual, qual_diff(q, ref[pos][1]))
        else:
            n_diff += 1
        dec = max(dec, gap)
    return {"decision_gap": dec, "qual_gap": qual, "rows_differ": n_diff}


def _leaf_gaps(got: Dict, want: Dict, keep: Iterable) -> list:
    keep = list(keep)
    floor = median(want[k] for k in keep)
    return [abs(got[k] - want[k]) / max(want[k], floor) for k in keep]


def train_gaps(prog: Dict[str, object], ref: Dict[str, object]
               ) -> Dict[str, float]:
    """prog and ref as reference.train.first_steps returns them."""
    med = median(ref["grad"].values())
    keep = [k for k, v in ref["grad"].items() if v >= QUIET * med]
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"])]
    return {"loss_gap": max(losses) if losses else math.inf,
            "loss_gap_first": losses[0] if losses else math.inf,
            "grad_gap": max(_leaf_gaps(prog["grad"], ref["grad"], keep)),
            "delta_gap": max(_leaf_gaps(prog["delta"], ref["delta"], keep)),
            "delta_median_gap": median(_leaf_gaps(prog["delta"],
                                                  ref["delta"], keep))}
