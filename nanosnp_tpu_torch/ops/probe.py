"""Knock-out probe of the fused BiLSTM layer kernel.

`bilstm_probe` runs the pileup model's first layer (the shape of
`bilstm_stream` in s2: L 33, D 18, H 64, bf16 out) in one of four modes,
each with one part of the per-step cost removed, so that timing them
against each other says where a step's time sits. It replaces the Pallas
kernel `_variant_kernel` (scripts/kernel_probe.py:36, launched by
`_run_variant` :117); its CUDA kernel is `csrc/bilstm_probe.cu`, which
builds the device code `bilstm_stream` runs (`csrc/bilstm_layer.cuh`
`fused_layer`) with a knock-out parameter, on `bilstm_stream`'s plan
(`probe_plan`: `plan_layer(..., center=False)`, the fused path only).

  full    the layer itself: the same code and plan as
          `bilstm_stream(..., out_dtype=bf16)`, the same bits on the card;
          its plain version is `bilstm_stream_plain`;
  nogate  the SFU gate math (`sigmoid4`, `tanh2` in `cell_update`)
          replaced by a linear combine, c = 0.5 c + 0.25 (g_i + g_f),
          h = 0.5 c + 0.125 (g_g + g_o): wrong math, same products and
          memory traffic;
  nomm    no W_hh . h product (gates = W_ih x_t + b); h is still rounded,
          written to the shared h tile and output;
  nodma   x staged once: every step uses the slab of the direction's
          first step (x[0] for direction 0, x[L-1] for direction 1), and
          no step starts or waits for a copy of x. The TPU probe knocked
          out its DMA; on the card the per-step cp.async of x_t stands in
          for it.

Contract as in `ops/bilstm.py`: x [N, L, D] bf16, w_ih [2, D, 4H] bf16,
w_hh [2, H, 4H] bf16, b [2, 4H] f32; output [N, L, 2H] bf16. A shape off
the fused path raises ValueError (the knock-outs exist only there). A CPU
tensor takes `probe_plain`; a CUDA tensor launches the kernel or raises.

Entry point, the counterpart of `python scripts/kernel_probe.py`:

    python -m nanosnp_tpu_torch.ops.probe [N] [iters] [--device cpu]

times each mode (CUDA events around `iters` launches with the weights
packed once), prints the three shares and the production 2-layer
center-only encoder for reference.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from typing import Dict, Optional

import torch

from .bilstm import (LAUNCHES, LayerPlan, _check, _contiguous, _ERRORS,
                     _kernel_x, _packed, bilstm_stream_plain, pack_weights,
                     plan_layer)

MODES = ("full", "nogate", "nomm", "nodma")


def probe_plain(x, w_ih, w_hh, b, mode: str) -> torch.Tensor:
    """Step loop with the kernel's cast sites: bf16 operands, f32
    accumulation, h rounded to bf16 before the recurrent product, f32 gate
    and cell math, bf16 output."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "full":
        return bilstm_stream_plain(x, w_ih, w_hh, b, torch.bfloat16)
    n, seq_len, _ = x.shape
    hidden = w_hh.shape[1]
    out = torch.empty(n, seq_len, 2, hidden, dtype=torch.bfloat16,
                      device=x.device)
    for d in (0, 1):
        xp = x.float() @ w_ih[d].float()               # [N, L, 4H]
        wh = w_hh[d].float()
        h = torch.zeros(n, hidden, dtype=torch.float32, device=x.device)
        c = torch.zeros_like(h)
        first = 0 if d == 0 else seq_len - 1
        for s in range(seq_len):
            t = s if d == 0 else seq_len - 1 - s
            gates = xp[:, first if mode == "nodma" else t] + b[d]
            if mode != "nomm":
                gates = gates + h.bfloat16().float() @ wh
            gi, gf, gg, go = gates.split(hidden, dim=1)
            if mode == "nogate":
                c = 0.5 * c + 0.25 * (gi + gf)
                h = 0.5 * c + 0.125 * (gg + go)
            else:
                c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
                h = torch.sigmoid(go) * torch.tanh(c)
            out[:, t, d] = h.bfloat16()
    return out.reshape(n, seq_len, 2 * hidden)


def probe_plan(n: int, seq_len: int, d_in: int, hidden: int) -> LayerPlan:
    """`bilstm_stream`'s plan at this shape, `plan_layer(..., center=False)`;
    ValueError where it is not the fused path."""
    plan = plan_layer(n, seq_len, d_in, hidden, False)
    if plan.path != "fused":
        raise ValueError(f"the probe takes the fused layer path only; N={n},"
                         f" L={seq_len}, D={d_in}, H={hidden} takes the "
                         f"{plan.path} path")
    return plan


def bilstm_probe(x, w_ih, w_hh, b, mode: str,
                 packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [N, L, D] -> [N, L, 2H] bf16 in `mode`. `packed` is
    `pack_weights(w_ih, w_hh)` made ahead, so that a timing loop measures
    the kernel and not the packing."""
    _check(x, w_ih, w_hh, b)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    n, seq_len, d_in = x.shape
    hidden = w_hh.shape[1]
    plan = probe_plan(max(n, 1), seq_len, d_in, hidden)
    if x.device.type == "cpu":
        return probe_plain(x, w_ih, w_hh, b, mode)
    from .build import library

    _contiguous(x, w_ih, w_hh, b)
    out = torch.empty(n, seq_len, 2 * hidden, dtype=torch.bfloat16,
                      device=x.device)
    if not n:
        return out
    wpk = _packed(w_ih, w_hh, packed)
    xk = _kernel_x(x, plan.d_x)
    with torch.cuda.device(x.device):
        err = library("bilstm_probe").nsp_bilstm_probe(
            xk.data_ptr(), wpk.data_ptr(), b.data_ptr(), out.data_ptr(), n,
            seq_len, plan.d_x, hidden, plan.bn, plan.smem, plan.grid[0],
            MODES.index(mode), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"nsp_bilstm_probe ({mode}) failed: "
                           f"{_ERRORS.get(err, f'cudaError {err}')} (N={n}, "
                           f"L={seq_len}, D={d_in}, H={hidden})")
    LAUNCHES["bilstm_probe"] += 1
    return out


def shares(ms: Dict[str, float]) -> Dict[str, float]:
    """The three shares of the full kernel's time that each knock-out
    removes. A negative share is a finding, not an error."""
    full = ms["full"]
    return {"gate transcendental": (full - ms["nogate"]) / full,
            "hidden-matmul": (full - ms["nomm"]) / full,
            "input-load": (full - ms["nodma"]) / full}


def probe_inputs(n: int, device, seq_len: int = 33, d_in: int = 18,
                 hidden: int = 64, seed: int = 0):
    """Seeded layer weights and x at the probe's shape, as kernel inputs."""
    from ..models.bilstm import init_bilstm_params

    gen = torch.Generator().manual_seed(seed)
    layer = init_bilstm_params(gen, d_in, hidden, 1)[0]
    x = torch.randn(n, seq_len, d_in, generator=gen)
    return (x.bfloat16().to(device),
            layer["w_ih"].bfloat16().contiguous().to(device),
            layer["w_hh"].bfloat16().contiguous().to(device),
            layer["b"].float().contiguous().to(device))


def time_ms(fn, iters: int, device: torch.device) -> float:
    """Mean ms of `fn()` over `iters` calls after one warm-up: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def time_modes(x, w_ih, w_hh, b, iters: int) -> Dict[str, float]:
    packed = pack_weights(w_ih, w_hh) if x.is_cuda else None
    return {mode: time_ms(lambda: bilstm_probe(x, w_ih, w_hh, b, mode,
                                               packed), iters, x.device)
            for mode in MODES}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def main(argv=None) -> int:
    from ..device import resolve_device, set_matmul_precision
    from ..models.bilstm import (BiLSTM, bilstm_encoder_fused,
                                 init_bilstm_params)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=8192)
    ap.add_argument("iters", nargs="?", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_matmul_precision()
    seq_len, d_in, hidden = 33, 18, 64
    if device.type == "cuda":
        print(card_line())
    else:
        print("cpu: plain versions, the times say nothing about the card")
    print(f"N={args.n} L={seq_len} D={d_in} H={hidden} device={device}")

    x, w_ih, w_hh, b = probe_inputs(args.n, device, seq_len, d_in, hidden)
    ms = time_modes(x, w_ih, w_hh, b, args.iters)
    for mode in MODES:
        print(f"{mode:8s} {ms[mode] * 1e3:9.1f} us/layer "
              f"({args.n / ms[mode] / 1e3:7.2f} M rows/s)")
    print()
    for name, share in shares(ms).items():
        print(f"{name + ' share':26s} ~ {share:.0%}")

    # production path for reference
    gen = torch.Generator().manual_seed(0)
    enc = BiLSTM(init_bilstm_params(gen, d_in, hidden, 2)).to(device)
    xf = x.float()
    dt = time_ms(lambda: bilstm_encoder_fused(enc.layers, xf,
                                              center_only=True),
                 args.iters, device)
    print(f"\nproduction 2-layer encoder (center_only): {dt * 1e3:9.1f} us "
          f"({args.n / dt / 1e3:7.2f} M sites/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
