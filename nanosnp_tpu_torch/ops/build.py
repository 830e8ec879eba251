"""Build and load the port's CUDA kernels.

Each source in `csrc/` compiles with `nvcc` into its own shared library
with a plain C interface, loaded with ctypes. Nothing is built when a
module is imported: the first call of a kernel wrapper builds its library
into `ops/build/` (listed in .gitignore) under a name that carries the
hash of the source and of the headers in `csrc/`, so an edited source is
rebuilt and an unchanged one is reused within a checkout. `build_all()`
starts one `nvcc` per source, all at once, and waits for them together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# source stem -> C functions and their ctypes signatures
_P, _I = ctypes.c_void_p, ctypes.c_int
SOURCES: Dict[str, Dict[str, List]] = {
    "bilstm": {
        # x, packed weights, b, out, out_f32, n, seq_len, d_x, hidden, bn,
        # smem, grid_x, stream
        "nsp_bilstm_stream": [_P] * 4 + [_I] * 8 + [_P],
        # x, packed weights, b, out, n, seq_len, d_x, hidden, bn, smem,
        # grid_x, stream
        "nsp_bilstm_center": [_P] * 4 + [_I] * 7 + [_P],
        # x, packed weights, b, xp, n, seq_len, d_x, hidden, kp_tiles,
        # n_pad, steps_t, t0_count, t1_lo, smem, grid x/y/z, stream
        "nsp_bilstm_inproj": [_P] * 4 + [_I] * 13 + [_P],
        # xp, packed weights, out, center, out_f32, n, seq_len, hidden,
        # kp_tiles, w_kt0, n_pad, steps_t, t1_lo, cluster, bn, smem, grid_x,
        # stream
        "nsp_bilstm_cluster": [_P] * 3 + [_I] * 14 + [_P],
        # cluster, bn, hidden, smem
        "nsp_bilstm_cluster_occupancy": [_I] * 4,
    },
    "bilstm_probe": {
        # x, packed weights, b, out, n, seq_len, d_x, hidden, bn, smem,
        # grid_x, mode, stream
        "nsp_bilstm_probe": [_P] * 4 + [_I] * 8 + [_P],
    },
    "bilstm_fused": {
        # x, packed weights, b, packed wp, bp, packed wd, bd, packed wh, bh,
        # out, n, seq_len, d_x, hidden, p, q, r (padded), n_out, bn, smem,
        # grid_x, stream
        "nsp_bilstm_center_head": [_P] * 10 + [_I] * 11 + [_P],
        # x, packed l1 weights, b1, packed l2 weights, b2, mid scratch, out,
        # n, seq_len, d_x, hidden, bn, smem, grid_x, stream
        "nsp_bilstm2_center": [_P] * 7 + [_I] * 7 + [_P],
        # head, d_x, hidden, p, q, bn, smem
        "nsp_bilstm_fused_occupancy": [_I] * 7,
    },
    "lstm_train": {
        # xp, xp_bf16, packed w_hh^T, hs, n, seq_len, hidden, stream
        "nsp_lstm_infer": [_P, _I, _P, _P, _I, _I, _I, _P],
        # xp, packed w_hh^T, hs, cs, n, seq_len, hidden, stream
        "nsp_lstm_fwd": [_P, _P, _P, _P, _I, _I, _I, _P],
        # xp, packed w_hh^T, packed w_hh, hs, cs, g, dxp, n, seq_len,
        # hidden, stream
        "nsp_lstm_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        # dxp, hs, split scratch, dw, n, seq_len, hidden, rows, splits,
        # smem, grid_x, stream
        "nsp_lstm_dw": [_P] * 4 + [_I] * 7 + [_P],
        # the smem path: xp, w_hh, hs, cs, n, seq_len, hidden, bn, smem,
        # grid_x, stream
        "nsp_lstm_fwd_smem": [_P] * 4 + [_I] * 6 + [_P],
        # xp, w_hh, hs, cs, g, dxp, dW partials, dw, with_dw, n, seq_len,
        # hidden, bn, smem, grid_x, stream
        "nsp_lstm_bwd_smem": [_P] * 8 + [_I] * 7 + [_P],
        # the cluster path: xp, w_hh, hs, cs, n, seq_len, hidden, cluster,
        # bn, smem, grid_x, stream
        "nsp_lstm_fwd_cluster": [_P] * 4 + [_I] * 7 + [_P],
        # xp, w_hh, hs, cs, g, dxp, n, seq_len, hidden, cluster, bn, smem,
        # grid_x, stream
        "nsp_lstm_bwd_cluster": [_P] * 6 + [_I] * 7 + [_P],
        # xp, xp_bf16, w_hh, hs, n, seq_len, hidden, cluster, bn, smem,
        # grid_x, stream
        "nsp_lstm_infer_cluster": [_P, _I, _P, _P] + [_I] * 7 + [_P],
        # the smem path: xp, xp_bf16, w_hh, hs, n, seq_len, hidden, bn, smem,
        # grid_x, stream
        "nsp_lstm_infer_smem": [_P, _I, _P, _P] + [_I] * 6 + [_P],
        # xp_bf16, smem
        "nsp_lstm_infer_smem_occupancy": [_I] * 2,
        # the f32 recurrence: xp, w_hh, hs, n, seq_len, hidden, bn, smem,
        # grid_x, stream
        "nsp_lstm_infer_f32": [_P] * 3 + [_I] * 6 + [_P],
        # hidden, smem
        "nsp_lstm_infer_f32_occupancy": [_I] * 2,
        # sweep, smem
        "nsp_lstm_cluster_occupancy": [_I] * 2,
    },
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels "
                           "are built on a machine with the CUDA toolkit")
    return path


def _target(name: str) -> Tuple[Path, Path]:
    """The source and its library, named by the hash of the source and of
    the headers beside it (`csrc/*.cuh`, which sources include)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest = digest.hexdigest()[:12]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def build_all() -> Dict[str, str]:
    """Compile every source that has no current library, one nvcc process
    each, started together. Returns {name: ptxas report} for the sources
    built in this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    for name in SOURCES:
        src, lib = _target(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, lib))
    reports = {}
    failed = []
    for name, proc, tmp, lib in jobs:
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)   # atomic: a reader never sees a partial file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def knock_out(src: str, start: str, end: str, parts) -> str:
    """`src` with each (old, new) of `parts` replaced in its text from
    `start` to `end`, where each old is found exactly once."""
    k0 = src.index(start)
    k1 = src.index(end, k0)
    body = src[k0:k1]
    for old, new in parts:
        if body.count(old) != 1:
            raise ValueError(f"anchor found {body.count(old)} times: "
                             f"{old!r}")
        body = body.replace(old, new)
    return src[:k0] + body + src[k1:]


def build_variants(name: str, texts: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    """Edited copies of csrc/{name}.cu ({variant: source text}), each
    compiled into ops/build/{name}_{variant}.so, one nvcc each, started
    together, and loaded with the C signatures of `name`. For the card's
    measurement tools; the sources in csrc/ are not touched."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for variant, text in texts.items():
        cu = BUILD_DIR / f"{name}_{variant}.cu"
        cu.write_text(text)
        procs[variant] = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for variant, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {variant}:\n"
                               f"{log[-3000:]}")
        lib = ctypes.CDLL(str(BUILD_DIR / f"{name}_{variant}.so"))
        for fn, argtypes in SOURCES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[variant] = lib
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/{name}.cu, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        _, path = _target(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SOURCES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
        return lib
