"""Grouped training: `Trainer.fit` of the port's pileup or haplotype
trainer, `steps_per_call` batches a group (one CUDA graph replay a group
on the card), fed by the port's own iterator (`train/data.batch_iterator`
over labelled windows, or `haplotype_train_iterator` over shards that the
set-up writes), the pool cycled with no epoch end in the window. Traffic
keys: `model` ("pileup" or "haplotype"), and `rows` or `contig`,
`contig_bp`, `sites_per_bucket`, `depths`.

Set-up builds one trainer from the seeded weights and keeps a copy of its
whole state (parameters, the Lookahead slow weights, optimizer
state and counts, the dropout generator). It warms every batch shape up
to a captured graph, puts the seeded state back in place (the graphs
read and write those same tensors), and reads the check from the path
the window times: the first full group of one batch shape, G steps in
one call, by graph replay on the card. Its readings: each step's loss
and the parameters' change over the group (Lookahead's sync at step 6
inside it). Step 1's gradient as the optimizer holds it (Adam's first
moment / (1 - b1)) comes from one step of the same call on the first
batch alone, from the same seeded state, before the group. The window
goes on from the state the group leaves, with the same trainer.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from _port import free, port_config, span, sync
import reference.decode as RD
from reference.compare import train_gaps
from reference.features import codes
from reference.precision import PRECISIONS
from reference.train import first_steps
from trace_reduce import WINDOW_SPAN
from worlds import haplotype as HW
from worlds import pileup as PW
from worlds.weights import leaves, make_params, normalise

B1 = 0.9           # Adam's first-moment decay (the configurations' optax)


class Driver:
    def __init__(self, cell, seed, device, work, fault=None):
        self.cell, self.seed, self.device, self.work = cell, seed, device, work
        self.fault = fault
        self.traffic = cell["traffic"]
        self.model_cfg = cell["config_data"]["model"]

    # -- the feed ----------------------------------------------------------

    def _world(self, rng):
        from nanosnp_tpu_torch.io import bins, fasta
        from nanosnp_tpu_torch.runtime import evaluate as E
        from nanosnp_tpu_torch.train import data as D

        t = self.traffic
        if t["model"] == "pileup":
            w = PW.pileup_train_arrays(rng, t["rows"])
            self.pool = w
            arrays = D.PileupTrainArrays(
                w.matrix, w.label, np.arange(len(w.matrix), dtype=np.int64),
                w.label[:, 22:24].any(1))
            self.lr_steps = max(len(w.matrix) // self.batch, 1)

            def epoch(r):
                return D.batch_iterator(arrays, self.batch, r, epochs=1,
                                        mark_epochs=True)
            return epoch
        w = HW.hap_world(rng, t["contig_bp"], t["sites_per_bucket"],
                         tuple(t["depths"]), 0.0)
        self.pool = w
        fa, shard_dir = HW.write_hap_world(w, self.work, t["contig"], bins,
                                           fasta, name="hap_train_shards")
        vcf, bed, self.truth = HW.truth_files(rng, w, self.work, t["contig"])
        ref = fasta.FastaReference(fa)
        truth = E.truth_arrays(ref, vcf, bed)
        D.set_reference_for_training({n: ref.contig(n) for n in ref.names})
        paths = bins.list_shards(shard_dir)
        self.lr_steps = max(sum(len(b.centers) for b in w.buckets)
                            // self.batch, 1)

        def epoch(r):
            return D.haplotype_train_iterator(paths, truth, self.batch, r,
                                              epochs=1, mark_epochs=True)
        return epoch

    def _feed(self, epoch, rng):
        """The iterator's batches, epoch after epoch, without the epoch
        marks: a real epoch is millions of sites, so none ends here."""
        from nanosnp_tpu_torch.train.data import EPOCH_END

        while True:
            for item in epoch(rng):
                if item is not EPOCH_END:
                    yield self._mislabel(item) if self.fault == "label" \
                        else item

    @staticmethod
    def _mislabel(item):
        """The `label` fault: each batch's first row under the next gt
        class."""
        if isinstance(item, tuple):
            x, gt, zy = item
            gt = np.array(gt)
            gt[0] = (gt[0] + 1) % 21
            return x, gt, zy
        item = dict(item)
        item["gt"] = np.array(item["gt"])
        item["gt"][0] = (item["gt"][0] + 1) % 10
        return item

    # -- set-up ------------------------------------------------------------

    def setup(self):
        from nanosnp_tpu_torch.models.convert import flatten_tree
        from nanosnp_tpu_torch.train import train_haplotype as TH
        from nanosnp_tpu_torch.train import train_pileup as TP

        self.flatten = flatten_tree
        self.cfg = port_config(self.cell)
        tcfg = self.cfg.train
        self.batch = tcfg.batch_size
        tcfg.seed = self.seed
        rng = np.random.default_rng([self.seed, 2])
        epoch = self._world(rng)
        self.feed = self._feed(epoch, rng)
        self._seed_weights()
        cls, mcfg = ((TP._PileupTrainer, self.cfg.pileup_model)
                     if self.traffic["model"] == "pileup"
                     else (TH._HaplotypeTrainer, self.cfg.haplotype_model))
        out = os.path.join(self.work, "train_out")
        # the kernels (their plain versions on the CPU): the recurrence in
        # the precision the configuration states
        self.trainer = tr = cls(mcfg, tcfg, self.params, self.device, True,
                                None, self.lr_steps, out, None, 10 ** 9)
        if self.fault:
            self._plant(self.fault)
        seeded = self._snapshot()
        self._warm()
        self._restore(seeded)
        self.first = self._first_group()
        got = {}
        run = tr.groups.run

        def keep(batches, freeze_on=0.0):
            got["m"] = run(batches, freeze_on)
            return got["m"]
        tr.groups.run = keep
        tr.run_group(self.first[:1])
        grad = {path: float(m.double().norm()) / (1 - B1)
                for (path, _), m in zip(self._leaves(),
                                        tr.state.opt_state["mu"])}
        self._restore(seeded)
        routes = dict(tr.groups.steps)
        tr.run_group(self.first)
        tr.groups.run = run
        self.first_route = [k for k in routes
                            if tr.groups.steps[k] != routes[k]]
        init = dict(leaves(self.params))
        delta = {path: float((p.detach().double()
                              - init[path].double()).norm())
                 for path, p in self._leaves()}
        self.readings = {"losses": [float(x) for x in got["m"]["loss"]],
                         "grad": grad, "delta": delta}

    def _seed_weights(self, n=512):
        """Seeded weights normalised on the pool's first rows (read
        matrices as the feed ships them, clipped to int8)."""
        self.params = make_params(self.model_cfg, self.seed, self.device)
        if self.traffic["model"] == "pileup":
            x = torch.from_numpy(self.pool.matrix[:n]).to(self.device).float()
            normalise(self.params, "pileup", x)
            return
        from reference.features import features

        b = self.pool.buckets[0]
        i = np.arange(min(n, len(b.centers)))
        xs = []
        for view, pos in (("pileup", b.centers[i, None] + np.arange(-16, 17)),
                          ("haplotype", b.groups[i])):
            d = getattr(b, view)
            xs.append(features(*[
                torch.from_numpy(np.clip(d[k][i], -128, 127)).to(self.device)
                for k in ("sequences", "baseq", "mapq", "hap")],
                torch.from_numpy(codes(self.pool.seq, pos)).to(self.device)))
        normalise(self.params, "haplotype", xs)

    def _leaves(self):
        return self.flatten(self.trainer.state.model.tree())

    def _state_tensors(self):
        st = self.trainer.state
        out = [p for _, p in self._leaves()]
        if st.slow is not None:
            out += [p for _, p in self.flatten(st.slow)]
        for v in st.opt_state.values():
            if isinstance(v, list):
                out += v
        return out

    def _snapshot(self):
        tr = self.trainer
        counts = {k: v for k, v in tr.state.opt_state.items()
                  if not isinstance(v, list)}
        return ([t.detach().clone() for t in self._state_tensors()], counts,
                tr.state.step, tr.generator.get_state())

    def _restore(self, snap):
        """The snapshot put back into the trainer's own tensors, in place:
        a captured graph reads and writes those tensors."""
        tr = self.trainer
        tensors, counts, step, gen = snap
        sync(self.device)
        with torch.no_grad():
            for t, v in zip(self._state_tensors(), tensors):
                t.copy_(v)
        tr.state.opt_state.update(counts)
        tr.state.step = step
        tr.generator.set_state(gen)
        sync(self.device)

    def _first_group(self):
        """The feed's first full group of one batch shape, as the
        trainer's buffers would hold it."""
        tr = self.trainer
        bufs = {}
        while True:
            key, item = tr.buffer_key(next(self.feed))
            bufs.setdefault(key, []).append(item)
            if len(bufs[key]) == tr.groups.group:
                return bufs[key]

    def _plant(self, fault):
        """Break the timed path underneath (tests): `unchanged` makes every
        update leave the state as it was; `half` leaves out the second half
        of each batch (its rows replaced by the first half's, so that the
        loss is the mean over the first half); `label` (planted in the
        feed, `_feed`) trains a wrong label."""
        tr = self.trainer
        if fault == "unchanged":
            tr.tx.update = lambda *a, **k: None
        elif fault == "half":
            step = tr.train_step

            def half(batch, row):
                n = next(iter(batch.values())).shape[0]
                keep = torch.arange(n, device=row.device) % max(n // 2, 1)
                return step({k: v[keep] for k, v in batch.items()}, row)
            tr.train_step = half
            tr.groups.step_fn = half

    def _warm(self):
        """Full groups through the trainer's own buffering until every
        batch shape has its graph captured (and replayed once)."""
        tr = self.trainer
        bufs = {}
        for _ in range(10_000):
            key, item = tr.buffer_key(next(self.feed))
            bufs.setdefault(key, []).append(item)
            if len(bufs[key]) >= tr.groups.group:
                tr.run_group(bufs.pop(key))
            slots = tr.groups.slots.values()
            if not tr.groups.use_graphs:
                if tr.groups.steps["eager"] >= 2 * tr.groups.group:
                    break
            elif slots and all(s.graph is not None for s in slots):
                break
        sync(self.device)

    # -- the window ----------------------------------------------------------

    def window(self, seconds):
        tr = self.trainer
        before = dict(tr.groups.steps)
        step0 = tr.state.step
        marks = {}

        def until():
            for item in self.feed:
                yield item
                if time.monotonic() - marks["t0"] >= seconds:
                    return

        def finish():
            sync(self.device)
            marks["t1"] = time.monotonic()
            return tr.state

        # fit calls finish() once its loop and the groups left in its
        # buffers have run: the window ends there, before any checkpoint
        tr.finish = finish
        with span(WINDOW_SPAN):
            sync(self.device)
            marks["t0"] = time.monotonic()
            tr.fit(until(), None, None, None, None)
        steps = tr.state.step - step0
        by = {k: tr.groups.steps[k] - before[k] for k in before}
        calls = self._calls(steps)
        return {"work": steps * self.batch, "attempted": steps * self.batch,
                "wall_s": marks["t1"] - marks["t0"], "steps": steps,
                "samples": steps * self.batch, "model_rows": steps * self.batch,
                "steps_by_route": by, "checked_group_route": self.first_route,
                "calls": calls}

    def _calls(self, steps):
        """The training layer calls of `steps` steps, at the batch's rows."""
        m, n = self.model_cfg, self.batch
        if self.traffic["model"] == "pileup":
            shapes = [(m["seq_len"], m["hidden_size"])] * m["n_layers"]
        else:
            shapes = ([(m["pileup_length"], m["hidden_size"])]
                      * m["lstm_layers"]
                      + [(m["haplotype_length"], m["hidden_size"])]
                      * m["lstm_layers"])
        return [{"op": "lstm_train", "n": n, "L": L, "H": H, "count": steps}
                for L, H in shapes]

    def release(self):
        self.trainer = None
        free(self.device)

    # -- the check ---------------------------------------------------------

    def feed_errors(self) -> int:
        """Rows of the checked group that are not the world's rows with
        their labels (for the haplotype feed: read matrices and reference
        codes at one of the world's sites, and the gt and zygosity classes
        of the world's truth there, a reference call training as zygosity
        0)."""
        bad = 0
        if self.traffic["model"] == "pileup":
            index = {r.tobytes(): i for i, r in enumerate(self.pool.matrix)}
            for b in self.first:
                x, gt, zy = b
                for r, g, z in zip(np.asarray(x), gt, zy):
                    i = index.get(r.astype(np.int32).tobytes())
                    if i is None or g != self.pool.label[i, :21].argmax() \
                            or z != self.pool.label[i, 21:24].argmax():
                        bad += 1
            return bad
        seq = self.pool.seq

        def label(pos):
            ref = chr(seq[pos - 1])
            pair, zy = self.truth.get(int(pos), (ref + ref, 0))
            return RD.GT21.index(pair), zy
        for bk in self.pool.buckets:
            index = {r.tobytes(): i
                     for i, r in enumerate(bk.pileup["sequences"])}
            for b in self.first:
                if b["p_seq"].shape[1] != bk.depth:
                    continue
                for j, r in enumerate(b["p_seq"].astype(np.int8)):
                    i = index.get(r.tobytes())
                    win = bk.centers[i] + np.arange(-16, 17) if i is not None \
                        else None
                    if i is None or not (
                            np.array_equal(b["p_ref"][j], codes(seq, win))
                            and np.array_equal(b["h_ref"][j],
                                               codes(seq, bk.groups[i]))
                            and np.array_equal(b["h_seq"][j].astype(np.int8),
                                               bk.haplotype["sequences"][i])
                            and (int(b["gt"][j]), int(b["zy"][j]))
                            == label(bk.centers[i])):
                        bad += 1
        return bad

    def reference(self, precision: str):
        c = self.cell["config_data"]
        batches = [dict(zip(("x", "gt", "zy"), b)) if isinstance(b, tuple)
                   else b for b in self.first]
        return first_steps(self.traffic["model"], self.params, batches,
                           PRECISIONS[precision], c["train"],
                           self.model_cfg["dropout"], self.seed, self.device)

    def gaps(self, readings):
        g = train_gaps(readings, self.reference("train"))
        g["feed_rows_wrong"] = float(self.feed_errors())
        return g

    def check(self, control=False):
        """The numbers compared, each beside its limit; with `control`, the
        control's: the reference one step down (TF32) in the program's
        place."""
        g = self.gaps(self.reference("tf32") if control else self.readings)
        self.detail = g
        return [{"name": k, "value": g[k], "limit": v}
                for k, v in self.cell["limits"].items()]
