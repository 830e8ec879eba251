"""What the drivers share: the port's configuration from a config file,
the device's synchronisation, the window's span, and the helpers that
run the reference over a cell's rows in blocks."""
from __future__ import annotations

import os
import time
from contextlib import contextmanager

import numpy as np
import torch

from trace_reduce import WINDOW_SPAN

BLOCK = 8192        # rows the reference computes at once


def port_config(cell: dict):
    """The port's PipelineConfig with every number of the config file
    stated explicitly (the port's own loader and field names)."""
    from nanosnp_tpu_torch.config import load_config

    c = cell["config_data"]
    model = {k: v for k, v in c["model"].items() if k != "kind"}
    over = {("pileup_model" if c["model"]["kind"] == "pileup"
             else "haplotype_model"): model,
            "train": {k: v for k, v in c["train"].items() if k != "optim"},
            "inference": c["inference"]}
    if "merge" in c:
        over["merge"] = c["merge"]
    cfg = load_config(None, over)
    for k, v in c["train"]["optim"].items():
        setattr(cfg.train.optim, k, v)
    return cfg


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextmanager
def span(name: str):
    with torch.profiler.record_function(name):
        yield


def keep_one(seed: int, out: str, kept: str):
    """-> after(n): moves the n-th pass's output `out` to `kept` with
    chance 1/n (the reservoir rule), so that the file kept at the end is
    any one pass's, drawn from the seed."""
    pick = np.random.default_rng([seed, 3])

    def after(n: int) -> None:
        if pick.random() < 1.0 / n:
            os.replace(out, kept)
    return after


def timed_passes(device, seconds: float, one_pass, after=None) -> dict:
    """Passes back to back until `seconds` have passed; the last one
    finishes; `after(n)` runs after the n-th. -> {"passes", "wall_s"}."""
    n = 0
    with span(WINDOW_SPAN):
        sync(device)
        t0 = time.monotonic()
        while True:
            with span("gpubench.pass"):
                one_pass()
            sync(device)
            n += 1
            if after is not None:
                after(n)
            if time.monotonic() - t0 >= seconds:
                break
        wall = time.monotonic() - t0
    return {"passes": n, "wall_s": wall}


def log_softmax_np(logits: torch.Tensor) -> np.ndarray:
    return torch.log_softmax(logits.double(), dim=-1).cpu().numpy()


def free(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
