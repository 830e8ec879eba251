"""Where a step of the cluster training kernels goes: clock64 stamps.

    python -m nanosnp_tpu_torch.ops.step_stamps [--no-stores] [--seq-len L]

On the card only. Builds an instrumented copy of csrc/lstm_train.cu into
ops/build/ (the source in the package is not touched): thread 0 of the
first CTA of the cluster path's forward and sweep writes clock64() at the
phase boundaries of every step (the forward's template stamps its
inference instantiations too; only the training ones run here). Runs both
kernels at the haplotype model's training shape (N=512, H=256) and
prints one JSON line: the kernel's time (CUDA events), SM cycles a step,
and the mean cycles of each phase over the steady steps (the first and,
in the sweep, the last left out). A stamp is taken where thread 0 gets
to, so a phase holds thread 0's own work plus its waits at the barriers
that close it. `--no-stores` is a knock-out: it drops the kernels' stores
of hs, cs and dxp to device memory, to show their share (the outputs are
then wrong).
"""
from __future__ import annotations

import argparse
import ctypes
import json

import torch

from . import build
from . import lstm_train as T

# (the phase from stamp k to stamp k + 1, or to the next step's first; the
# anchor in the kernel's source where stamp k is taken; before it rather
# than after it)
FWD_PHASES = [
    ("gate product, next xp loads",
     "    cluster_wait();\n    float acc[4][4][4];", False),
    ("cell, hs and cs out, h_t into the tile",
     "    __nv_bfloat16* h_next = s_h + ((s + 1) & 1)", True),
    ("h_t slice to the peers",
     "__syncthreads();  // this CTA's slice of h_t is whole ...", False),
    ("cluster barrier", "    cluster_arrive();\n  }", True),
]
BWD_PHASES = [
    ("gate product, the cell's loads",
     "    const int t = time_of(s);\n    float acc[4][4][4];", False),
    ("cell, dxp out",
     "__syncthreads();  // every read of h_{t-1} done: the tile takes dgates",
     False),
    ("dh product, next h loads",
     "__syncthreads();  // all of bf16(dgates) is in the tile", False),
    ("wait: the peers' slots free",
     "    cluster_wait();  // every peer has read its slots", True),
    ("partials to the peers",
     "cluster_wait();  // every peer has read its slots (the last sum)", False),
    ("arrive: partials out",
     "    cluster_arrive();  // this CTA's partials are out", True),
    ("wait: every partial in",
     "cluster_arrive();  // this CTA's partials are out", False),
    ("next h_{t-1} into the tile",
     "cluster_wait();    // every partial is in; every read of dgates done",
     False),
    ("sum of the partials",
     "store_h(hv);\n    // dh_{t-1} of this CTA's units: the four partials in "
     "rank order", False),
    ("arrive: slots read",
     "    cluster_arrive();  // this CTA's slots are read", True),
    ("__syncthreads", "cluster_arrive();  // this CTA's slots are read", False),
    ("to the next step", "__syncthreads();  // bf16 h_{t-1} whole", False),
]
STORE_GUARDS = [
    ("        if (row < n) {\n          const size_t o =\n",
     "        if (row < n && h[0] == 12345.0f) {\n          const size_t o =\n"),
    ("        if (row < n) {\n          float* dst",
     "        if (row < n && dq[0][0] == 12345.0f) {\n          float* dst"),
]
MAX_STEPS = 64


def _stamp(step_var: str, k: int) -> str:
    return ("\n    if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0)"
            f" g_stamps[({step_var}) * 16 + {k}] = clock64();\n")


def _insert(src: str, anchor: str, code: str, before: bool) -> str:
    if src.count(anchor) != 1:
        raise ValueError(f"stamp anchor found {src.count(anchor)} times: "
                         f"{anchor!r}")
    i = src.index(anchor)
    at = i if before else i + len(anchor)
    return src[:at] + code + src[at:]


def instrument(src: str, no_stores: bool = False) -> str:
    """csrc/lstm_train.cu with the stamps (and, with no_stores, without the
    cluster kernels' stores of hs, cs and dxp) and `nsp_stamps(out)`, which
    copies the int64 [MAX_STEPS, 16] stamps to a host buffer."""
    fwd = src.index("lstm_fwd_cluster_kernel(const XpT*")
    bwd = src.index("lstm_bwd_cluster_kernel(const float*")
    end = src.index("int fwd_cluster_bytes()")
    head, f, b, tail = src[:fwd], src[fwd:bwd], src[bwd:end], src[end:]
    for k, (_, anchor, before) in enumerate(FWD_PHASES):
        f = _insert(f, anchor, _stamp("s", k), before)
    for k, (_, anchor, before) in enumerate(BWD_PHASES):
        b = _insert(b, anchor, _stamp("i", k), before)
    if no_stores:
        f = f.replace(*STORE_GUARDS[0])
        b = b.replace(*STORE_GUARDS[1])
        if "12345" not in f or "12345" not in b:
            raise ValueError("store guards not found")
    head = head.replace("namespace {", "__device__ long long g_stamps["
                        f"{MAX_STEPS} * 16];\nnamespace {{", 1)
    return (head + f + b + tail + '\nextern "C" int nsp_stamps(void* out) {'
            " return (int)cudaMemcpyFromSymbol(out, g_stamps, "
            "sizeof(g_stamps)); }\n")


def _phases(stamps, names, steps):
    """Mean cycles a step and of each phase over the steady steps."""
    import numpy as np

    a = np.asarray(stamps[:steps * 16], np.float64).reshape(steps, 16)
    a = a[:, :len(names)]
    steady = a[1:-1]
    out = {"cycles_a_step": float(np.diff(steady[:, 0]).mean())}
    # phase k runs from stamp k to stamp k + 1 (the last to the next step)
    nxt = np.concatenate([steady[:, 1:], a[2:, :1]], axis=1)
    for k, name in enumerate(names):
        out[f"{k} {name}"] = float((nxt[:, k] - steady[:, k]).mean())
    return out


def main(argv=None) -> int:
    import numpy as np

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-stores", action="store_true")
    ap.add_argument("--seq-len", type=int, default=33)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_stamps runs on the card: CUDA is not available")
    if not 3 <= args.seq_len <= MAX_STEPS:
        raise SystemExit(f"--seq-len from 3 to {MAX_STEPS}")
    src = (build.CSRC / "lstm_train.cu").read_text()
    tag = "nostores" if args.no_stores else "stamps"
    lib = build.build_variants(
        "lstm_train", {tag: instrument(src, args.no_stores)})[tag]
    lib.nsp_stamps.argtypes = [ctypes.c_void_p]

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    n, seq_len, hidden = 512, args.seq_len, 256

    def u(*shape, scale=1.0):
        return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * scale

    xp = u(n, seq_len, 2, 4 * hidden, scale=3.0)
    w = u(2, hidden, 4 * hidden, scale=hidden ** -0.5).bfloat16()
    g = u(n, seq_len, 2, hidden)
    hs, cs = T.lstm_recurrence_train(xp, w)
    hs2, cs2, dxp = torch.empty_like(hs), torch.empty_like(cs), \
        torch.empty_like(xp)
    plan = T.plan_train(n, seq_len, hidden)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = {
        "forward": lambda: lib.nsp_lstm_fwd_cluster(
            xp.data_ptr(), w.data_ptr(), hs2.data_ptr(), cs2.data_ptr(), n,
            seq_len, hidden, plan.cluster, plan.bn, plan.fwd_smem,
            plan.grid[0], stream),
        "sweep": lambda: lib.nsp_lstm_bwd_cluster(
            xp.data_ptr(), w.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            g.data_ptr(), dxp.data_ptr(), n, seq_len, hidden, plan.cluster,
            plan.bn, plan.bwd_smem, plan.grid[0], stream)}
    out = {"card": torch.cuda.get_device_name(0), "no_stores": args.no_stores,
           "N": n, "L": seq_len, "H": hidden}
    stamps = np.zeros(MAX_STEPS * 16, np.int64)
    for name, run in launch.items():
        for _ in range(3):
            err = run()
            if err:
                raise RuntimeError(f"{name} launch failed: {err}")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            run()
        end.record()
        torch.cuda.synchronize()
        lib.nsp_stamps(stamps.ctypes.data)
        names = [p[0] for p in (FWD_PHASES if name == "forward"
                                else BWD_PHASES)]
        out[name] = {"ms": start.elapsed_time(end) / 20,
                     **_phases(stamps, names, seq_len)}
    print(json.dumps({"step_stamps": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
