"""s5, the haplotype stage: `runtime.stages.stage_haplotype_predict` pass
after pass over one shard directory (one shard a depth bucket), each pass
writing its CSV to the same path, over the stage's own device featurizer
and the s5 deferral. Traffic keys: `contig`, `contig_bp`,
`sites_per_bucket`, `depths`, `untagged_frac`.

The check draws one pass's CSV from the seed, as stage_s2 does, and holds
every row against the reference: its own deferral (the set of rows must
be the same), its own features, the model in the configuration's
precision.
"""
from __future__ import annotations

import os

import numpy as np
import torch

import reference.decode as RD
import reference.features as RF
from _port import (BLOCK, free, keep_one, log_softmax_np, port_config,
                   timed_passes)
from reference.compare import s5_gaps
from reference.models import haplotype_logits
from reference.precision import PRECISIONS
from worlds import haplotype as W
from worlds.weights import make_params, normalise

FLANK = 16


class Driver:
    def __init__(self, cell, seed, device, work, fault=None):
        self.cell, self.seed, self.device, self.work = cell, seed, device, work
        self.fault = fault
        self.traffic = cell["traffic"]

    def setup(self):
        from nanosnp_tpu_torch.io import bins, fasta
        from nanosnp_tpu_torch.runtime import stages

        t = self.traffic
        rng = np.random.default_rng([self.seed, 2])
        self.world = W.hap_world(rng, t["contig_bp"], t["sites_per_bucket"],
                                 tuple(t["depths"]), t["untagged_frac"])
        fa, self.shards = W.write_hap_world(self.world, self.work,
                                            t["contig"], bins, fasta)
        self.cfg = port_config(self.cell)
        b = self.world.buckets[0]
        xp, xh = self._features(b, np.arange(min(512, len(b.centers))))
        self.params = make_params(self.cell["config_data"]["model"],
                                  self.seed, self.device)
        normalise(self.params, "haplotype", (xp, xh))
        self.ref = fasta.FastaReference(fa)
        self.stages = stages
        self.out = os.path.join(self.work, "haplotype.csv")
        self.kept = os.path.join(self.work, "haplotype.kept.csv")
        if self.fault:
            self._plant(self.fault)
        self._pass()
        os.replace(self.out, self.kept)

    def _features(self, b, i):
        """The reference's f32 features of bucket b's sites i, both views,
        on the device."""
        win = b.centers[i, None] + np.arange(-FLANK, FLANK + 1)
        out = []
        for view, pos in (("pileup", win), ("haplotype", b.groups[i])):
            d = getattr(b, view)
            out.append(RF.features(*[
                torch.from_numpy(d[k][i]).to(self.device)
                for k in ("sequences", "baseq", "mapq", "hap")],
                torch.from_numpy(RF.codes(self.world.seq, pos)).to(
                    self.device)))
        return out

    def _plant(self, fault):
        """`answer` alters the calls where the model produces them,
        `half` computes half of each batch and copies its answers."""
        make = self.stages.haplotype_model_predictor

        def broken(cfg, model, device):
            pred = make(cfg, model, device)
            apply = pred.apply

            def run(xp, xh):
                if fault == "half":
                    h = max(len(xp) // 2, 1)
                    gt, zy = apply(xp[:h], xh[:h])
                    rep = torch.arange(len(xp), device=xp.device) % h
                    return gt[rep], zy[rep]
                gt, zy = apply(xp, xh)
                return gt.roll(1, dims=1), zy.roll(1, dims=1)
            pred.apply = run
            return pred

        self.stages.haplotype_model_predictor = broken

    def _pass(self):
        self.stages.stage_haplotype_predict(self.cfg, self.ref, self.shards,
                                            self.out, params=self.params,
                                            device=self.device)

    def _kept_counts(self):
        frac = self.cfg.merge.defer_unphased_frac
        return [int(RF.kept(b.haplotype["hap"], frac).sum())
                for b in self.world.buckets]

    def window(self, seconds):
        r = timed_passes(self.device, seconds, self._pass,
                         keep_one(self.seed, self.out, self.kept))
        m = self.cell["config_data"]["model"]
        bs = self.cfg.inference.batch_size
        H = m["hidden_size"]
        calls = []
        kept = self._kept_counts()
        for k in kept:
            for s in range(0, k, bs):
                n = min(bs, k - s)
                for L, D in ((m["pileup_length"], m["pileup_dim"]),
                             (m["haplotype_length"], m["haplotype_dim"])):
                    for i in range(m["lstm_layers"]):
                        last = i == m["lstm_layers"] - 1
                        calls.append({"op": "bilstm_layer", "n": n, "L": L,
                                      "D": D if i == 0 else 2 * H, "H": H,
                                      "center": last, "last": last,
                                      "count": r["passes"]})
        n = sum(len(b.centers) for b in self.world.buckets)
        # every site goes through the stage; the deferred ones never reach
        # the model
        return {"work": r["passes"] * n, "attempted": r["passes"] * n,
                "wall_s": r["wall_s"], "passes": r["passes"],
                "sites": r["passes"] * n,
                "model_rows": r["passes"] * sum(kept), "calls": calls}

    def release(self):
        self.stages = self.ref = None
        free(self.device)

    # -- the check ---------------------------------------------------------

    def reference_logp(self, precision: str):
        """(positions, gt log probabilities) of the kept sites, and the
        reference's rows {pos: (GT label, QUAL)}."""
        p = PRECISIONS[precision]
        frac = self.cfg.merge.defer_unphased_frac
        pos_all, lp_all = [], []
        with torch.no_grad():
            for b in self.world.buckets:
                keep = np.flatnonzero(RF.kept(b.haplotype["hap"], frac))
                for s in range(0, len(keep), BLOCK):
                    i = keep[s:s + BLOCK]
                    xp, xh = self._features(b, i)
                    gt, _ = haplotype_logits(self.params, xp, xh, p)
                    lp_all.append(log_softmax_np(gt))
                    pos_all.append(b.centers[i])
        pos, lp = np.concatenate(pos_all), np.concatenate(lp_all)
        rows = {int(q): (RD.GT21[int(r.argmax())], RD.phred(float(np.exp(r.max()))))
                for q, r in zip(pos, lp)}
        return pos, lp, rows

    def gaps(self, prog_rows):
        pos, lp, ref = self.reference_logp("infer")
        return s5_gaps(prog_rows, ref, pos, lp, RD.GT21[:10])

    def _control_rows(self):
        """The control's rows: the reference in fp8 in the program's
        place."""
        return self.reference_logp("fp8")[2]

    def check(self, control=False):
        """The numbers compared, each beside its limit; with `control`, the
        control's."""
        g = self.gaps(self._control_rows() if control
                      else RD.parse_csv(self.kept))
        self.detail = g
        return [{"name": k, "value": g[k], "limit": v}
                for k, v in self.cell["limits"].items()]
