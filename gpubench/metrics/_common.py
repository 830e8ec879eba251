"""What the per-layer readers share."""
from __future__ import annotations

import harness

BF16_PEAK = 989e12      # FLOP/s, one H100 SXM, dense bf16 (work/_peaks.py)


def roofline(ctx):
    """Sum of the bounds of the window's calls over the device time of the
    kernels that cover them, in per cent: each work family whose kernels
    ran in the traced window counts the calls it claims (its `bound` is
    None for the others) and the time of its kernels. A family whose
    kernels did not run counts nothing, so a kernel that replaces another
    under a new name needs a new work file and no other edit. None where
    no family counts."""
    calls = ctx.window.get("calls") or []
    bound, names = 0.0, set()
    for fam in harness.work_families().values():
        kernels = getattr(fam, "KERNELS", ())
        if not kernels or ctx.trace.kernel_seconds(kernels)[1] == 0:
            continue
        mine = [(i, fam.bound(c)) for i, c in enumerate(calls)]
        mine = [(i, b) for i, b in mine if b is not None]
        if not mine:
            continue
        bound += sum(b * calls[i]["count"] for i, b in mine)
        names.update(kernels)
    if not names:
        return None
    t, n = ctx.trace.kernel_seconds(sorted(names))
    if n == 0 or t <= 0:
        return None
    return 100.0 * bound / t


def mfu(ctx, train: bool):
    """The model's FLOP over the window (forward FLOP a row, three times
    that a training sample, times the rows that ran the model) over the
    window's seconds at the bf16 peak."""
    model = ctx.config["model"]
    fam = harness.load_module("work", model["kind"] + "_model")
    per = fam.forward_flop(model, train) * (3 if train else 1)
    rows = ctx.window["model_rows"]
    if not rows:
        return None
    return 100.0 * per * rows / (ctx.window["wall_s"] * BF16_PEAK)
