"""deferred_fetch.train: the share of the groups counted deferred among
those the group runner counted, None without a recorder or without
counts, and listed for the three trainer cells alone."""
import pytest

import harness


class Ctx:
    trace, window = None, {}


def test_deferred_share_from_the_counters(monkeypatch):
    from nanosnp_tpu_torch.utils import profiling

    read = harness.load_module("metrics", "deferred_fetch.train").read
    counters = {"nsp.group.deferred": 57, "nsp.group.drained": 3}
    monkeypatch.setattr(profiling, "snapshot",
                        lambda: {"counters": counters})
    assert read(Ctx()) == pytest.approx(95.0)
    counters.pop("nsp.group.deferred")
    assert read(Ctx()) == 0.0
    counters.clear()
    assert read(Ctx()) is None
    monkeypatch.delattr(profiling, "snapshot")     # a program without it
    assert read(Ctx()) is None


def test_listed_for_the_trainer_cells():
    (m,) = [m for m in harness.benchmark()["per_layer"]
            if m["name"] == "deferred_fetch.train"]
    assert m["workloads"] == ["haplotype.train", "pileup.train",
                              "catmodel.train"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) \
        == ("%", "higher", "program_counter", "group runner",
            "train_samples_s")
    for name in m["workloads"]:
        assert any(x["name"] == m["name"]
                   for x in harness.load_cell(name)["per_layer"])
    assert not any(x["name"] == m["name"]
                   for x in harness.load_cell("haplotype.s5")["per_layer"])
