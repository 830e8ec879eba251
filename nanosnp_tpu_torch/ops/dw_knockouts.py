"""What bounds `lstm_dw_reduce`: its kernel with parts knocked out.

    python -m nanosnp_tpu_torch.ops.dw_knockouts

On the card only. Builds copies of csrc/lstm_train.cu into ops/build/
(the source in the package is not touched), each with a part of the dW
kernel removed, and times `nsp_lstm_dw` of each at the haplotype
trainer's shapes (N=512, H=256, L=33 and 11) with `plan_dw`'s plan.
Prints one JSON line: ms of each variant and shape (CUDA events, 20
launches after 3). A knocked-out variant's output is wrong; `all` is the
kernel as it is and is checked against `lstm_dw_reduce_plain`.

  all          the kernel
  no_products  without the wgmma products: the copies and the split
  copies       without the products and the split: the copies alone
  no_copies    without the copies (the split reads what the ring holds):
               the split and the products
  products     without the copies and the split: the products alone
"""
from __future__ import annotations

import json

import torch

from . import build
from . import lstm_train as T

KERNEL = "lstm_dw_tc_kernel(const float*"
END = "bool dw_plan_ok("
# (the text in the dW kernel, what takes its place)
PRODUCTS = ("      wgmma_m64n128k16(acc, ah[ks], dw_desc(bh));\n"
            "      wgmma_m64n128k16(acc, ah[ks], dw_desc(bh + kDwTileB));\n"
            "      wgmma_m64n128k16(acc, al[ks], dw_desc(bh));\n", "\n")
SPLIT = ("      split(c + 1);\n", "\n")
COPIES = ("    if (c < chunks) {\n      float* st",
          "    if (c < chunks && n < 0) {\n      float* st")
VARIANTS = {"all": [], "no_products": [PRODUCTS],
            "copies": [PRODUCTS, SPLIT], "no_copies": [COPIES],
            "products": [SPLIT, COPIES]}
SHAPES = [(512, 33, 256), (512, 11, 256)]


def knock_out(src: str, parts) -> str:
    """csrc/lstm_train.cu with `parts` replaced in the dW kernel, each
    found there exactly once."""
    return build.knock_out(src, KERNEL, END, parts)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("dw_knockouts runs on the card: CUDA is not "
                         "available")
    src = (build.CSRC / "lstm_train.cu").read_text()
    libs = build.build_variants(
        "lstm_train", {f"dw_{name}": knock_out(src, parts)
                       for name, parts in VARIANTS.items()})
    libs = {name[len("dw_"):]: lib for name, lib in libs.items()}

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {"card": torch.cuda.get_device_name(0), "ms": {}}
    for n, seq_len, hidden in SHAPES:
        hs = torch.rand(n, seq_len, 2, hidden, device=dev, generator=gen) \
            * 2 - 1
        dxp = (torch.rand(n, seq_len, 2, 4 * hidden, device=dev,
                          generator=gen) * 2 - 1) * 0.1
        plan = T.plan_dw(n, seq_len, hidden)
        part = torch.empty(plan.splits, 2, hidden, 4 * hidden, device=dev)
        dw = torch.empty(2, hidden, 4 * hidden, device=dev,
                         dtype=torch.bfloat16)
        for name, lib in libs.items():
            def run(lib=lib):
                return lib.nsp_lstm_dw(
                    dxp.data_ptr(), hs.data_ptr(), part.data_ptr(),
                    dw.data_ptr(), n, seq_len, hidden, plan.rows,
                    plan.splits, plan.smem, plan.grid[0], stream)

            if run() != 0:
                raise RuntimeError(f"{name}: launch failed")
            if name == "all":  # within chip_smoke.py's DW_TOL (1e-2)
                want = T.lstm_dw_reduce_plain(dxp, hs).float()
                err = ((dw.float() - want).abs().max()
                       / want.abs().max()).item()
                if not err <= 1e-2:
                    raise AssertionError(f"dW off by {err}")
            for _ in range(3):
                run()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                run()
            end.record()
            torch.cuda.synchronize()
            out["ms"][f"{name} L={seq_len}"] = start.elapsed_time(end) / 20
    print(json.dumps({"dw_knockouts": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
