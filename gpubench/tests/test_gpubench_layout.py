"""BENCHMARK.json against the shapes its readers accept, and the harness finding
every configuration, cell, driver, per-layer metric and work family by
the file name that an entry gives."""
import json
import os
import re

import pytest

import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert NAME.match(c["name"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))


def test_bounds_and_setup():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_is_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c["config"] in {x["name"] for x in BENCH["configs"]}
    assert c["why"] == next(w["why"] for w in BENCH["workloads"]
                            if w["name"] == cell)
    drv = harness.load_module("drivers", c["driver"])
    assert hasattr(drv.Driver, "window") and hasattr(drv.Driver, "check")
    assert c["per_layer"], "every cell reports a per-layer metric"
    for m in c["per_layer"]:
        assert m["moves"] == c["metric"]
        assert callable(harness.load_module("metrics", m["name"]).read)
    assert set(c["limits"])


def test_per_layer_metrics_and_layers():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)


def test_every_work_family_loads():
    fams = harness.work_families()
    assert {"bilstm_fused", "bilstm_split", "lstm_fwd", "lstm_bwd",
            "lstm_dw", "pileup_model", "haplotype_model"} <= set(fams)


def test_result_line_schema():
    from conftest import tiny_cell

    cell = tiny_cell("pileup.train")
    res = harness.run_cell(cell, 2 ** 31 + 9, 0.2, False, "cpu",
                           log=lambda m: None)
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"train_samples_s", "setup_s"}
    e2e = {m["name"]: m["unit"] for m in BENCH["end_to_end"]}
    for k, v in line["metrics"].items():
        assert v["unit"] == e2e[k] and v["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    for k, v in line["checks"].items():
        assert set(v) == {"value", "limit"} and k in cell["limits"]
