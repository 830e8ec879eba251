"""The benchmark's harness: finds a cell's files by name, runs set-up, the
measured window and the correctness check through the cell's driver, reads
the per-layer metrics from the traced window, and builds the result line.

Everything that belongs to one configuration, traffic mix, driver,
per-layer metric or kernel-work family sits in a file of its own under
this folder and is found by the name that BENCHMARK.json, the workload
file or the config file gives:

  configs/<config>.json      one model configuration (widths, precision)
  workloads/<cell>.json      one cell: config, driver, traffic, limits
  drivers/<driver>.py        one kind of traffic: set-up, window, check
  metrics/<metric>.py        one per-layer metric: read(ctx) -> number
  work/<family>.py           one kernel family's or model's work
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "nanosnp_tpu")
CACHE = os.path.join(HERE, ".cache")
# a traced run profiles a window this long at most: a training window's
# trace holds some twenty thousand kernels a second, and saving and
# reading back a full one would take most of a run's time
TRACE_SECONDS = 10.0
for _d in (HERE, os.path.join(HERE, "drivers"), os.path.join(HERE, "work"),
           os.path.join(HERE, "metrics")):
    if _d not in sys.path:
        sys.path.insert(0, _d)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """gpubench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    key = f"gpubench_{kind}_{name.replace('.', '_')}"
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def work_families() -> Dict[str, object]:
    """Every file of work/, by name."""
    names = sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "work"))
                   if f.endswith(".py") and not f.startswith("_"))
    return {n: load_module("work", n) for n in names}


def benchmark() -> dict:
    return read_json(os.path.join(ROOT, "BENCHMARK.json"))


def load_cell(name: str) -> dict:
    """The workload file of `name` with its config, and the per-layer
    metrics that BENCHMARK.json has this cell report."""
    cell = read_json(os.path.join(HERE, "workloads", name + ".json"))
    cell["name"] = name
    cell["config_data"] = read_json(
        os.path.join(HERE, "configs", cell["config"] + ".json"))
    bench = benchmark()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cell["per_layer"] = [
        m for m in bench["per_layer"]
        if (name in m["workloads"] if "workloads" in m
            else m["moves"] == cell["metric"])]
    cell["unit"] = e2e[cell["metric"]]["unit"]
    return cell


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds and compiles; JAX kept out of any
    library that would load it by itself."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or `names`) whose top-level name is one of
    FORBIDDEN, compared whole (nanosnp_tpu_torch is not nanosnp_tpu)."""
    tops = {m.split(".", 1)[0] for m in (names or list(sys.modules))}
    return sorted(t for t in tops if t in FORBIDDEN)


def workdir() -> str:
    """A run's scratch directory under TMPDIR, fixed by the process id
    only for its data, never for a cache."""
    base = os.environ.get("TMPDIR") or "/tmp"
    d = os.path.join(base, f"gpubench-{os.getpid()}")
    os.makedirs(d, exist_ok=True)
    return d


def cleanup() -> None:
    """Remove this run's scratch directory."""
    import shutil

    shutil.rmtree(workdir(), ignore_errors=True)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


class Context:
    """What a metric reader sees: the cell, the window's work and
    counters, and the reduced trace."""

    def __init__(self, cell, window, trace):
        self.cell, self.window, self.trace = cell, window, trace
        self.config = cell["config_data"]


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: Optional[float] = None,
             fault: Optional[str] = None, control: bool = False,
             log=print) -> dict:
    """One run: set-up, the window, the check -> the result object (the
    last line's keys). `fault` plants one of the cell driver's faults in
    the timed path; `control` checks the control (the reference one
    precision down) in the program's place. Both are for the readings
    that set the limits, and for tests: the benchmark's runs use
    neither."""
    import torch

    t0 = time.monotonic() if t0 is None else t0
    cuda = device == "cuda"
    drv_mod = load_module("drivers", cell["driver"])
    drv = drv_mod.Driver(cell, seed, device, workdir(), fault=fault)
    drv.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    log(f"[gpubench] {cell['name']} seed {seed}: set-up {setup_s:.3f} s")
    if trace:
        from trace_reduce import start_profiler, stop_profiler
        start_profiler(cuda)
    window = drv.window(min(seconds, TRACE_SECONDS) if trace else seconds)
    red = stop_profiler(cuda, workdir()) if trace else None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    metrics = {}
    out_dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name() if cuda else "cpu",
               "count": 1, "memory_peak_bytes": int(peak)}
    if cuda:
        out_dev["power_limit"] = power_limit()
    breakdown = None
    if trace:
        ctx = Context(cell, window, red)
        for m in cell["per_layer"]:
            v = load_module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out_dev["busy_s"] = red.busy_s
        out_dev["window_s"] = red.window_s
        breakdown = {"device_ops": red.top_ops(10),
                     "idle_gaps": red.idle_gaps(10)}
    else:
        metrics[cell["metric"]] = {"value": window["work"] / window["wall_s"],
                                   "unit": cell["unit"]}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    drv.release()
    checks = drv.check(control)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"[gpubench] forbidden modules loaded: {found}")
    correct = all(c["value"] <= c["limit"] for c in checks)
    failed = sum(c["value"] > c["limit"] for c in checks)
    for c in checks:
        print(f"[gpubench] check {c['name']}: {c['value']!r} "
              f"(limit {c['limit']!r})", file=sys.stderr)
    res = {"correct": correct, "attempted": int(window["attempted"]),
           "failed": int(failed),
           "metrics": metrics, "device": out_dev}
    if breakdown is not None:
        res["breakdown"] = breakdown
    res["window"] = {k: v for k, v in window.items() if k != "calls"}
    res["readings"] = drv.detail
    cleanup()
    res["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return res
