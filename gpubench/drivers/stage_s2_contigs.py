"""s2 over many short contigs: `runtime.stages.stage_pileup_predict` pass
after pass over a shard directory of one columnar shard a contig
(worlds/contigs.py), each pass writing its VCF to the same path. Traffic
keys: `contigs`, `contig_bp`, `candidates_per_contig`. Each contig's
candidates are fewer than an inference batch, so every contig is one
partial batch: the cell measures what s2 pays a shard and a unit.

The check is drivers/stage_s2.py's, contig by contig: one pass's VCF,
drawn from the seed, each contig's rows against the rows the reference
gives for that contig's shard; the gaps are the widest over the contigs.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

import harness
from _port import keep_one, port_config, timed_passes
from worlds import contigs as CW
from worlds.weights import make_params, normalise

S2 = harness.load_module("drivers", "stage_s2")


def parse_vcf_by_contig(path: str) -> Dict[str, dict]:
    """{contig: {position: (decision fields, QUAL)}} of a pileup VCF's
    rows (reference.decode.parse_vcf's fields, a contig at a time)."""
    out: Dict[str, dict] = {}
    with open(path) as f:
        for line in f:
            if line[0] == "#":
                continue
            c = line.rstrip("\n").split("\t")
            fmt = c[9].split(":")
            out.setdefault(c[0], {})[int(c[1])] = (
                (c[3], c[4], c[6], fmt[0], fmt[2], fmt[3]), float(c[5]))
    return out


class Driver(S2.Driver):
    def setup(self):
        from nanosnp_tpu_torch.io import bins, fasta
        from nanosnp_tpu_torch.runtime import stages

        t = self.traffic
        rng = np.random.default_rng([self.seed, 2])
        self.worlds = CW.contig_worlds(rng, t["contigs"], t["contig_bp"],
                                       t["candidates_per_contig"])
        self.names = CW.contig_names(t["contigs"])
        fa, self.shards = CW.write_contigs(self.worlds, self.work, bins,
                                           fasta)
        self.cfg = port_config(self.cell)
        self.world = self.worlds[0]
        sample = self._windows(np.arange(min(512, len(self.world.positions))))
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

    def window(self, seconds):
        r = timed_passes(self.device, seconds, self._pass,
                         keep_one(self.seed, self.out, self.kept))
        bs = self.cfg.inference.batch_size
        m = self.cell["config_data"]["model"]
        calls = []
        for w in self.worlds:
            n = len(w.positions)
            for size in (min(bs, n - s) for s in range(0, n, bs)):
                for layer in range(2):
                    calls.append({"op": "bilstm_layer", "n": size, "L": 33,
                                  "D": (m["feature_dim"] if layer == 0
                                        else 2 * m["hidden_size"]),
                                  "H": m["hidden_size"],
                                  "center": layer == 1, "last": layer == 1,
                                  "count": r["passes"]})
        n = sum(len(w.positions) for w in self.worlds)
        return {"work": r["passes"] * n, "attempted": r["passes"] * n,
                "wall_s": r["wall_s"], "passes": r["passes"],
                "sites": r["passes"] * n, "model_rows": r["passes"] * n,
                "calls": calls}

    def _each_contig(self, rows_of):
        """stage_s2's gaps of each contig, rows_of(contig index) giving
        the program's (or the control's) rows there -> the widest."""
        out = {"decision_gap": 0.0, "qual_gap": 0.0, "rows_differ": 0}
        for i, w in enumerate(self.worlds):
            self.world = w
            g = super().gaps(rows_of(i))
            out["decision_gap"] = max(out["decision_gap"], g["decision_gap"])
            out["qual_gap"] = max(out["qual_gap"], g["qual_gap"])
            out["rows_differ"] += g["rows_differ"]
        self.world = self.worlds[0]
        return out

    def check(self, control=False):
        """The numbers compared, each beside its limit; with `control`,
        the control's (the reference in fp8 in the program's place)."""
        if control:
            g = self._each_contig(lambda i: self._control_of(i))
        else:
            prog = parse_vcf_by_contig(self.kept)
            g = self._each_contig(lambda i: prog.get(self.names[i], {}))
        self.detail = g
        return [{"name": k, "value": g[k], "limit": v}
                for k, v in self.cell["limits"].items()]

    def _control_of(self, i):
        self.world = self.worlds[i]
        return self._control_rows()
