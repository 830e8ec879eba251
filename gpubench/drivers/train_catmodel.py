"""CatModel training: `Trainer.fit` of the port's CatModel trainer
(legacy/train.py), `steps_per_call` batches a group (one CUDA graph
replay a group on the card), over a seeded legacy world
(worlds/legacy.py) whose images set-up builds once, as legacy-train
does. Its own feed (`CatModelTrainer.feed`) selects and shuffles each
epoch's sites, so epoch ends, their partial groups and their
checkpoints fall inside the window. Traffic keys: `groups`, `depth`
(each tag's least and most reads), `variant_frac`, `het_frac`.

Set-up, as the other trainer cells' (drivers/train.py, whose helpers it
uses): one trainer from the seeded weights, a copy of its whole state
(weights, BatchNorm running statistics, Adam's state and counts, the
dropout generator), the batch shape warmed up to a captured graph, the
state put back, then the check's readings from the path the window
times: the first full group of the feed, by graph replay on the card.
Its readings: each step's loss, the weights' change over the group, the
BatchNorm running statistics after it, and step 1's gradient (Adam's
first moment / (1 - b1)) from one step of the same call on the first
batch alone, from the same seeded state.
"""
from __future__ import annotations

import os

import numpy as np

import harness
from _port import sync
from reference import catmodel as RC
from reference.compare import train_gaps
from reference.precision import PRECISIONS
from worlds import legacy as LW

TD = harness.load_module("drivers", "train")
B1 = TD.B1


class Driver(TD.Driver):
    def __init__(self, cell, seed, device, work, fault=None):
        super().__init__(cell, seed, device, work, fault)
        self.train_cfg = cell["config_data"]["train"]

    def setup(self):
        from nanosnp_tpu_torch.legacy.catmodel import build_g_images
        from nanosnp_tpu_torch.legacy.train import (CatModelTrainer,
                                                    int8_images)
        from nanosnp_tpu_torch.models.convert import flatten_tree

        self.flatten = flatten_tree
        m, t = self.model_cfg, self.traffic
        self.batch = self.train_cfg["batch_size"]
        rng = np.random.default_rng([self.seed, 2])
        w = LW.legacy_world(rng, t["groups"], tuple(t["depth"]),
                            m["max_depth"], t["variant_frac"],
                            t["het_frac"])
        self.g0, self.g1 = (int8_images(build_g_images(
            *w.views[v], m["max_depth"])) for v in ("surrounding", "het"))
        self.labels = w.labels
        self.params = LW.catmodel_params(m, self.seed, self.device)
        opt = self.train_cfg["optim"]
        self.trainer = tr = CatModelTrainer(
            self.params, lr=opt["lr"], batch_size=self.batch,
            seed=self.seed, steps_per_call=self.train_cfg["steps_per_call"],
            device=self.device, use_kernels=True, dropout=True,
            out_dir=os.path.join(self.work, "train_out"), log_every=10 ** 9,
            gt_classes=m["gt_num_class"])
        self.feed = self._marked(tr.feed(self.g0, self.g1, self.labels, rng,
                                         10 ** 9))
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
        weights = [path for path, p in self._leaves() if p.requires_grad]
        grad = {path: float(mu.double().norm()) / (1 - B1)
                for path, mu in zip(weights, tr.state.opt_state["mu"])}
        self._restore(seeded)
        routes = dict(tr.groups.steps)
        tr.run_group(self.first)
        tr.groups.run = run
        self.first_route = [k for k in routes
                            if tr.groups.steps[k] != routes[k]]
        init = dict(self.flatten(self.params))
        delta = {path: float((p.detach().double()
                              - init[path].double()).norm())
                 for path, p in self._leaves() if p.requires_grad}
        stats = {path: p.detach().clone() for path, p in self._leaves()
                 if RC.is_stat(path)}
        self.readings = {"losses": [float(x) for x in got["m"]["loss"]],
                         "grad": grad, "delta": delta, "stats": stats}

    def _marked(self, items):
        """The trainer's feed, with the `label` fault planted."""
        for item in items:
            yield self._mislabel(item) if self.fault == "label" and \
                isinstance(item, dict) else item

    @staticmethod
    def _mislabel(item):
        item = dict(item)
        item["y"] = np.array(item["y"])
        item["y"][0] = (item["y"][0] + 1) % 10
        return item

    def _batches(self):
        """The feed's batches, past its epoch marks."""
        from nanosnp_tpu_torch.train.data import EPOCH_END

        for item in self.feed:
            if item is not EPOCH_END:
                yield item

    def _first_group(self):
        tr = self.trainer
        batches = self._batches()
        return [tr.buffer_key(next(batches))[1]
                for _ in range(tr.groups.group)]

    def _warm(self):
        """Full groups until the batch shape's graph is captured and
        replayed once (eager groups alone where there is no graph
        route), then an epoch's partial group, eagerly."""
        tr = self.trainer
        batches = self._batches()
        for _ in range(3 if tr.groups.use_graphs else 2):
            tr.run_group([tr.buffer_key(next(batches))[1]
                          for _ in range(tr.groups.group)])
        tr.run_group([tr.buffer_key(next(batches))[1]])
        sync(self.device)

    def _calls(self, steps):
        """The window's training calls at the batch's rows: five BiLSTM
        layers' recurrences (L 11, H 256) and the conv tower."""
        m, n = self.model_cfg, self.batch
        layers = m["percentage_layers"] + m["crnn_layers"]
        return ([{"op": "lstm_train", "n": n, "L": m["positions"],
                  "H": m["hidden_size"], "count": steps}] * layers
                + [{"op": "conv_tower", "n": n, "count": steps}])

    def release(self):
        self.trainer.wait_for_writes()
        super().release()

    # -- the check ---------------------------------------------------------

    def feed_errors(self) -> int:
        """Rows of the checked group that are not the world's images with
        their gt classes."""
        index = {r.tobytes(): i for i, r in enumerate(self.g0)}
        bad = 0
        for b in self.first:
            for g0, g1, y in zip(b["g0"], b["g1"], b["y"]):
                i = index.get(np.asarray(g0, np.int8).tobytes())
                if i is None or not np.array_equal(g1, self.g1[i]) \
                        or int(y) != int(self.labels[i, 1]):
                    bad += 1
        return bad

    def reference(self, precision: str):
        opt = self.train_cfg["optim"]
        return RC.first_steps(self.params, self.first, PRECISIONS[precision],
                              opt["lr"], opt["label_smoothing"], self.seed,
                              self.device)

    def gaps(self, readings):
        ref = self.reference("train")
        g = train_gaps(readings, ref)
        g["stats_gap"] = RC.stats_gap(readings["stats"], ref["stats"])
        g["feed_rows_wrong"] = float(self.feed_errors())
        return g

    def check(self, control=False):
        """The numbers compared, each beside its limit; with `control`,
        the control's: the reference with every other product's and
        convolution's operands in TF32 in the program's place."""
        g = self.gaps(self.reference("tf32") if control else self.readings)
        self.detail = g
        return [{"name": k, "value": g[k], "limit": v}
                for k, v in self.cell["limits"].items()]
