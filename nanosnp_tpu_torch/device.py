"""Device selection for the port's entry points.

Entry points run on the card (`"cuda"`) unless the caller asks for the CPU.
Asking for the card where there is none raises: nothing quietly carries on
on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def set_matmul_precision() -> None:
    """Full f32 for f32 products and convolutions on the card. TF32 keeps
    about three decimal digits; the f32 reference paths (the models' f32
    encoder, the heads with use_bf16=False, the kernels' plain versions)
    must agree with the JAX package's f32 results. PyTorch defaults TF32
    off for matmuls but on for cuDNN, so both are set."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
