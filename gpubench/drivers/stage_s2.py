"""s2, the pileup stage: `runtime.stages.stage_pileup_predict` pass after
pass over one columnar shard directory, each pass writing its VCF to the
same path. Traffic keys: `contig`, `contig_bp`, `candidates`.

The check takes the output of one pass drawn from the seed (each pass's
VCF is moved aside with the reservoir rule, so every pass is as likely to
be the one compared) and holds every row of it against the rows that the
reference's model, in the configuration's precision, and the frozen
decode give for the same shard.
"""
from __future__ import annotations

import os

import numpy as np
import torch

import reference.decode as RD
from _port import (BLOCK, free, keep_one, log_softmax_np, port_config,
                   timed_passes)
from reference.compare import margins, s2_gaps
from reference.models import pileup_logits
from reference.precision import PRECISIONS
from worlds import pileup as W
from worlds.weights import make_params, normalise


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
        self.world = W.pileup_world(rng, t["contig_bp"], t["candidates"])
        fa, self.shards = W.write_pileup_world(self.world, self.work,
                                               t["contig"], bins, fasta)
        self.cfg = port_config(self.cell)
        sample = self._windows(np.arange(min(512, t["candidates"])))
        self.params = make_params(self.cell["config_data"]["model"],
                                  self.seed, self.device)
        normalise(self.params, "pileup", sample)
        self.ref = fasta.FastaReference(fa)
        self.stages = stages
        self.out = os.path.join(self.work, "pileup.vcf")
        self.kept = os.path.join(self.work, "pileup.kept.vcf")
        if self.fault:
            self._plant(self.fault)
        self._pass()
        os.replace(self.out, self.kept)

    def _windows(self, i):
        """The [len(i), 33, 18] windows of candidates i, f32 on the device."""
        off = self.world.positions[i] - 1
        idx = off[:, None] + np.arange(-W.FLANK, W.FLANK + 1)
        return torch.from_numpy(self.world.columns[idx]).to(
            self.device).float()

    def _plant(self, fault):
        """Break the timed path underneath (tests): `answer` alters the
        calls where the model produces them, `half` computes half of
        each batch and copies its answers to the other half."""
        make = self.stages.pileup_columnar_fn

        def broken(cfg, model, device):
            fn = make(cfg, model, device)

            def run(cols, idx):
                if fault == "half":
                    h = max(len(idx) // 2, 1)
                    gt, zy = fn(cols, idx[:h])
                    rep = torch.arange(len(idx), device=idx.device) % h
                    return gt[rep], zy[rep]
                gt, zy = fn(cols, idx)
                return gt.roll(1, dims=1), zy.roll(1, dims=1)
            return run

        self.stages.pileup_columnar_fn = broken

    def _pass(self):
        self.stages.stage_pileup_predict(self.cfg, self.ref, self.shards,
                                         self.out, params=self.params,
                                         device=self.device)

    def window(self, seconds):
        r = timed_passes(self.device, seconds, self._pass,
                         keep_one(self.seed, self.out, self.kept))
        n = len(self.world.positions)
        bs = self.cfg.inference.batch_size
        sizes = [min(bs, n - s) for s in range(0, n, bs)]
        m = self.cell["config_data"]["model"]
        calls = []
        for size in sizes:
            for layer in range(2):
                calls.append({"op": "bilstm_layer", "n": size, "L": 33,
                              "D": (m["feature_dim"] if layer == 0
                                    else 2 * m["hidden_size"]),
                              "H": m["hidden_size"], "center": layer == 1,
                              "last": layer == 1, "count": r["passes"]})
        return {"work": r["passes"] * n, "attempted": r["passes"] * n,
                "wall_s": r["wall_s"], "passes": r["passes"],
                "sites": r["passes"] * n, "model_rows": r["passes"] * n,
                "calls": calls}

    def release(self):
        self.stages = self.ref = None
        free(self.device)

    # -- the check ---------------------------------------------------------

    def reference_logp(self, precision: str):
        """The reference's gt and zy log probabilities of every candidate,
        in blocks, on the device."""
        p = PRECISIONS[precision]
        n = len(self.world.positions)
        gts, zys = [], []
        with torch.no_grad():
            for s in range(0, n, BLOCK):
                x = self._windows(np.arange(s, min(s + BLOCK, n)))
                gt, zy = pileup_logits(self.params, x, p)
                gts.append(log_softmax_np(gt))
                zys.append(log_softmax_np(zy))
        return np.concatenate(gts), np.concatenate(zys)

    def _rows(self, gt_lp, zy_lp, combos=None):
        pos = self.world.positions
        args = (pos, self.world.seq[pos - 1].tobytes().decode(),
                np.exp(gt_lp), np.exp(zy_lp), self.world.columns[pos - 1])
        if combos is None:
            return RD.pileup_rows(*args)
        return RD.site_rows(*args, combos=combos)

    def _heads(self, gt_lp):
        """Each site's least gt margin over the batch rows 0..9 of its
        decode batch (the rows a fallback alt reads)."""
        m = margins(gt_lp)
        out = np.empty(len(m))
        n = len(m)
        for c0 in range(0, n, RD.DECODE_CHUNK):
            c1 = min(c0 + RD.DECODE_CHUNK, n)
            for b0 in range(c0, c1, RD.DECODE_BATCH):
                b1 = min(b0 + RD.DECODE_BATCH, c1)
                out[b0:b1] = m[b0:min(b0 + 10, b1)].min()
        return out

    def gaps(self, prog_rows):
        gt, zy = self.reference_logp("infer")
        ref = self._rows(gt, zy)
        return s2_gaps(prog_rows, ref, self.world.positions, gt, zy,
                       self._heads(gt),
                       lambda combos: self._rows(gt, zy, combos))

    def _control_rows(self):
        """The control's rows: the reference in fp8 in the program's
        place."""
        gt, zy = self.reference_logp("fp8")
        return {k: v[:2] for k, v in self._rows(gt, zy).items()}

    def check(self, control=False):
        """The numbers compared, each beside its limit; with `control`, the
        control's."""
        g = self.gaps(self._control_rows() if control
                      else RD.parse_vcf(self.kept))
        self.detail = g
        return [{"name": k, "value": g[k], "limit": v}
                for k, v in self.cell["limits"].items()]
