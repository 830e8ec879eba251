"""The CatModel's ResCRNN conv tower in training: each of its 18
convolutions (six ResBlocks: two 3x3 and a 1x1 shortcut) forward
(fprop), its input gradient (dgrad; none for block 1's first 3x3 and
its shortcut, which read the images: they take no gradient) and its
weight gradient (wgrad), f32 with TF32 off. Not a family of
work_families(): the BiLSTM roofline counts none of it;
`conv_roofline.train` and `conv_share.train` read it.

A call is {"op": "conv_tower", "n": rows, "count": steps}. Each product
is 2 FLOP a multiply-add on the CUDA cores (FFMA, 67 TFLOP/s); its bytes
are its two f32 operands read once and its f32 result written once.
KERNELS are the kernels that cuDNN launched for these products on the
H100 (torch 2.11, CUDA 12.8) at batch 512, read from each convolution
run alone under the profiler: implicit-GEMM, FFT and Winograd kernels,
their transforms and layout changes, and two real f32 GEMMs that run
weight gradients, named down to their tiles because the model's linear
layers use GEMMs of other tiles. A third, `cutlass_80_simt_sgemm_64x64_
8x5_nt_align1` (the weight gradient of block 3's 64 -> 128 3x3
convolution, 0.13 ms a step of the tower's 17.7), also runs the linear layers' backward, so it is not
named: its time is left out of the tower's and its bound stays in
(conv_roofline.train reads that much high). The test
`test_no_kernel_but_the_towers_bears_its_names` checks on the card that
no kernel of a step without the tower matches these names.
"""
from typing import List, Optional

from _peaks import HBM_BYTES, FP32_FFMA_FLOPS

KERNELS = ("fprop_implicit_gemm", "dgrad_implicit_gemm", "wgrad_alg0_engine",
           "dgrad_engine", "implicit_convolve_sgemm", "convolve_common_engine",
           "fft2d_", "region_transform_ABC", "flip_filter", "_gemm_cf32cf32_",
           "winograd", "cudnn::",
           "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8_stage3_"
           "warpsize1x2x1",
           "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize64x64x8_stage3_"
           "warpsize1x4x1")


def convs(model: dict, n: int = 1) -> List[dict]:
    """Each product of a training step at `n` rows: {"pass", "flop",
    "bytes"}."""
    h, w = 2 * model["max_depth"], model["positions"]
    pools = {int(k): v for k, v in model["pools"].items()}
    out = []
    for i, (c_in, c_out) in enumerate(model["res_blocks"]):
        hw = h * w
        for ci, co, k, on_images in ((c_in, c_out, 3, i == 0),
                                     (c_out, c_out, 3, False),
                                     (c_in, c_out, 1, i == 0)):
            flop = 2 * n * hw * co * ci * k * k
            x, y, wt = 4 * n * ci * hw, 4 * n * co * hw, 4 * co * ci * k * k
            out.append({"pass": "fprop", "flop": flop, "bytes": x + wt + y})
            if not on_images:
                out.append({"pass": "dgrad", "flop": flop,
                            "bytes": y + wt + x})
            out.append({"pass": "wgrad", "flop": flop, "bytes": x + y + wt})
        if i in pools:
            (kh, kw), (sh, sw) = pools[i]
            h = (h - kh) // sh + 1
            w = (w + 2 * (kw // 2) - kw) // sw + 1
    return out


def bound(call: dict, model: dict) -> Optional[float]:
    """The least seconds of a call's products: each the larger of its
    FLOP at the FFMA peak and its bytes at HBM bandwidth."""
    if call["op"] != "conv_tower":
        return None
    return call["count"] * sum(
        max(c["flop"] / FP32_FFMA_FLOPS, c["bytes"] / HBM_BYTES)
        for c in convs(model, call["n"]))


def window_bound(ctx) -> Optional[float]:
    """The tower's bound over the window's calls; None without any."""
    got = [bound(c, ctx.config["model"]) for c in ctx.window.get("calls")
           or []]
    got = [b for b in got if b is not None]
    return sum(got) if got else None


def device_seconds(ctx) -> Optional[float]:
    """The device time of the tower's kernels in the traced window; None
    where none ran."""
    t, n = ctx.trace.kernel_seconds(KERNELS)
    return t if n and t > 0 else None
