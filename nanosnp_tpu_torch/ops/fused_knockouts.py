"""What holds `bilstm2_center` above the two per-layer kernels it fuses:
its kernel with a layer knocked out.

    python -m nanosnp_tpu_torch.ops.fused_knockouts

On the card only. Builds copies of csrc/bilstm_fused.cu into ops/build/
(the source in the package is not touched), each with a part of the
two-layer kernel changed, and times `nsp_bilstm2_center` of each at the
pileup encoder's shape (N=8192, L=33, D=18, H=64) with `plan_two_layer`'s
plan, beside `bilstm_stream` (layer 1) and `bilstm_center` (layer 2) alone
with their own plans. Every variant still copies both layers' weights and
meets its peer at the cluster barrier. Each is timed twice, the second
pass in reverse order (CUDA events, 20 launches after 3). Prints one JSON
line. A knocked-out variant's output is wrong; `all` is the kernel as it
is and is checked against `bilstm2_center_plain`.

  all             the kernel (both layer loops unrolled one k-tile deep)
  layer1          without layer 2
  layer2          without layer 1: layer 2 on the scratch `all` wrote
  unroll4         both layers unrolled four k-tiles deep, as bilstm.cu's
                  kernels are (ptxas spills)
  layer1_unroll4  layer 1 alone, unrolled four deep
  layer2_unroll4  layer 2 alone, unrolled four deep
"""
from __future__ import annotations

import json

import torch

from . import bilstm as K
from . import bilstm_fused as F
from . import build

KERNEL = "constexpr int kTwoLayerUnroll"
END = "// Center layer + head."
LAYER1 = ("    fused_layer<false, true, __nv_bfloat16, kTwoLayerUnroll>(\n"
          "        x, s.w1, b1 + dir * 4 * hidden, mid, s.x1, s.h, n, "
          "seq_len, d_x,\n"
          "        hidden, bn, dir, (blockIdx.x >> 1) * bn);\n", "")
LAYER2 = ("    fused_layer<true, true, float, kTwoLayerUnroll>(\n"
          "        mid, s.w2, b2 + dir * 4 * hidden, out, s.x2, s.h, n, "
          "seq_len,\n"
          "        2 * hidden, hidden, bn, dir, (blockIdx.x >> 1) * bn);\n",
          "")
UNROLL4 = ("constexpr int kTwoLayerUnroll = 1;",
           "constexpr int kTwoLayerUnroll = 4;")
VARIANTS = {"all": [], "layer1": [LAYER2], "layer2": [LAYER1],
            "unroll4": [UNROLL4], "layer1_unroll4": [LAYER2, UNROLL4],
            "layer2_unroll4": [LAYER1, UNROLL4]}
N, SEQ_LEN, D_IN, HIDDEN = 8192, 33, 18, 64
TOL = 2e-3      # chip_smoke.py's CENTER_TOL


def knock_out(src: str, parts) -> str:
    """csrc/bilstm_fused.cu with `parts` replaced in the two-layer kernel
    and its constants, each found there exactly once."""
    return build.knock_out(src, KERNEL, END, parts)


def _ms(run) -> float:
    for _ in range(3):
        if run():
            raise RuntimeError("launch failed")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 20


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("fused_knockouts runs on the card: CUDA is not "
                         "available")
    src = (build.CSRC / "bilstm_fused.cu").read_text()
    libs = build.build_variants(
        "bilstm_fused", {f"ko_{name}": knock_out(src, parts)
                         for name, parts in VARIANTS.items()})

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def u(*shape, scale=1.0):
        return (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) * scale

    def layer(d_in):
        k = HIDDEN ** -0.5
        return (u(2, d_in, 4 * HIDDEN, scale=k).bfloat16(),
                u(2, HIDDEN, 4 * HIDDEN, scale=k).bfloat16(),
                u(2, 4 * HIDDEN, scale=2 * k))

    x = u(N, SEQ_LEN, D_IN, scale=8.0).bfloat16()
    l1, l2 = layer(D_IN), layer(2 * HIDDEN)
    wpk1, wpk2 = K.pack_weights(*l1[:2]), K.pack_weights(*l2[:2])
    mid = torch.empty(N, SEQ_LEN, 2 * HIDDEN, dtype=torch.bfloat16,
                      device=dev)
    ctr = torch.empty(N, 2 * HIDDEN, device=dev)
    out = torch.empty(N, 2 * HIDDEN, device=dev)
    plan = F.plan_two_layer(N, SEQ_LEN, D_IN, HIDDEN)
    p1 = K.plan_layer(N, SEQ_LEN, D_IN, HIDDEN, False)
    p2 = K.plan_layer(N, SEQ_LEN, 2 * HIDDEN, HIDDEN, True)
    runs = {name: (lambda lib=libs[f"ko_{name}"]: lib.nsp_bilstm2_center(
        x.data_ptr(), wpk1.data_ptr(), l1[2].data_ptr(), wpk2.data_ptr(),
        l2[2].data_ptr(), mid.data_ptr(), out.data_ptr(), N, SEQ_LEN,
        plan.d_x, HIDDEN, plan.bn, plan.smem, plan.grid[0], stream))
        for name in VARIANTS}
    kernels = build.library("bilstm")
    runs["bilstm_stream"] = lambda: kernels.nsp_bilstm_stream(
        x.data_ptr(), wpk1.data_ptr(), l1[2].data_ptr(), mid.data_ptr(), 0,
        N, SEQ_LEN, p1.d_x, HIDDEN, p1.bn, p1.smem, p1.grid[0], stream)
    runs["bilstm_center"] = lambda: kernels.nsp_bilstm_center(
        mid.data_ptr(), wpk2.data_ptr(), l2[2].data_ptr(), ctr.data_ptr(), N,
        SEQ_LEN, p2.d_x, HIDDEN, p2.bn, p2.smem, p2.grid[0], stream)

    if runs["all"]():
        raise RuntimeError("all: launch failed")
    want = F.bilstm2_center_plain(x, *l1, *l2)
    err = (out - want).abs().max().item()
    if not err <= TOL:
        raise AssertionError(f"bilstm2_center off by {err}")
    names = list(runs)
    ms = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            ms[name].append(_ms(runs[name]))
    print(json.dumps({"fused_knockouts": {
        "card": torch.cuda.get_device_name(0), "N": N, "bn": plan.bn,
        "bn_stream": p1.bn, "bn_center": p2.bn, "max_abs_err": err,
        "ms": ms}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
