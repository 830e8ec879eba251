"""ctypes bindings for the native host kernels (io/native/*.cpp).

The shared library is compiled at first use with g++ -O3 -fopenmp into
`io/native/build/` (listed in .gitignore) under a name that carries the
hash of the sources and the build mode, so edited sources are rebuilt and
unchanged ones are reused within a checkout. A failed build raises
NativeUnavailable; callers that want the NumPy oracle path
(features/pileup.py) catch it themselves. The pipeline stages do not.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
_SRCS = [
    os.path.join(_NATIVE_DIR, "pileup_core.cpp"),
    os.path.join(_NATIVE_DIR, "bam_core.cpp"),
]
_HDRS = [os.path.join(_NATIVE_DIR, "pileup_common.hpp")]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    pass


def _asan_enabled() -> bool:
    return os.environ.get("NSP_NATIVE_ASAN", "").lower() in ("1", "true", "yes")


def _lib_path() -> str:
    # one library per (sources, build mode): an edited source or a toggled
    # NSP_NATIVE_ASAN always loads the matching build
    digest = hashlib.sha256()
    for p in _SRCS + _HDRS:
        with open(p, "rb") as f:
            digest.update(f.read())
    stem = "libnanosnp_asan" if _asan_enabled() else "libnanosnp"
    return os.path.join(_BUILD_DIR, f"{stem}_{digest.hexdigest()[:12]}.so")


def _build(lib_path: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-fopenmp", "-shared",
        "-fPIC", "-o", tmp, *_SRCS, "-lz",
    ]
    if _asan_enabled():
        # the reference's asan_makefile equivalent. Loading an ASan .so into
        # an uninstrumented python needs the shared runtime preloaded:
        #   LD_PRELOAD=$(g++ -print-file-name=libasan.so) NSP_NATIVE_ASAN=1 ...
        # (gcc links libasan.so dynamically for -shared by default;
        # clang's -shared-libasan spelling is not a gcc option)
        cmd = [c for c in cmd if c != "-O3"]
        cmd[1:1] = ["-O1", "-g", "-fsanitize=address",
                    "-fno-omit-frame-pointer"]
    # the ASan workflow preloads libasan.so into *this* process; the g++
    # child must not inherit that (LeakSanitizer reports g++'s own internal
    # leaks and fails the build with a non-zero exit)
    env = dict(os.environ)
    env.pop("LD_PRELOAD", None)
    env["ASAN_OPTIONS"] = "detect_leaks=0"
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       env=env)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        msg = getattr(e, "stderr", str(e))
        raise NativeUnavailable(f"native build failed: {msg}") from e
    os.replace(tmp, lib_path)   # atomic: a reader never sees a partial file


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib_path = _lib_path()
        if not os.path.exists(lib_path):
            _build(lib_path)
        lib = ctypes.CDLL(lib_path)
        lib.nsp_count_rows.restype = ctypes.c_int64
        lib.nsp_count_rows.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.c_int]
        lib.nsp_parse_mpileup.restype = ctypes.c_int64
        lib.nsp_parse_mpileup.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,          # buf
            ctypes.c_void_p, ctypes.c_int64,          # ref (uint8 array)
            ctypes.c_double, ctypes.c_double,         # afs
            ctypes.c_int, ctypes.c_int,               # min_cov, max_indel
            ctypes.c_void_p, ctypes.c_void_p,         # bed masks
            ctypes.c_int,                             # threads
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # pos/counts/depths
            ctypes.c_void_p, ctypes.c_void_p,         # cand/afs
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,   # alt buf/cap/off
        ]
        _lib = lib
        return lib


def _ptr(a: Optional[np.ndarray]):
    return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None


def parse_mpileup_native(
    text: bytes,
    chrom: str,
    chr_seq: np.ndarray,
    snp_min_af: float = 0.12,
    indel_min_af: float = 0.12,
    min_coverage: int = 6,
    max_indel: int = 60,
    bed_mask: Optional[np.ndarray] = None,
    confident_mask: Optional[np.ndarray] = None,
    n_threads: int = 0,
):
    """Parse one chromosome's mpileup text with the native kernel.

    Returns a features.pileup.ChromPileup (import deferred to avoid a cycle).
    """
    from ..features.pileup import ChromPileup

    lib = get_lib()
    n = lib.nsp_count_rows(text, len(text), n_threads)
    # np.empty, not zeros: the kernel writes every kept row and the caller
    # slices to [:m]; zeroing ~70 MB/Mrow of outputs was measurable serial
    # wall on the s1 critical path
    positions = np.empty(n, dtype=np.int64)
    counts = np.empty((n, 18), dtype=np.int32)
    depths = np.empty(n, dtype=np.int32)
    cand = np.empty(n, dtype=np.uint8)
    afs = np.empty(n, dtype=np.float64)
    alt_off = np.empty(2 * n, dtype=np.int64)
    # zero-copy when chr_seq is already a contiguous uint8 array (the
    # FastaReference.contig layout); .tobytes() copied the whole contig
    ref_arr = np.ascontiguousarray(chr_seq.view(np.uint8)
                                   if chr_seq.dtype == np.uint8 else
                                   np.frombuffer(chr_seq.tobytes(), np.uint8))
    bed8 = bed_mask.astype(np.uint8) if bed_mask is not None else None
    conf8 = confident_mask.astype(np.uint8) if confident_mask is not None else None

    alt_cap = max(1 << 16, 64 * n)
    for _ in range(3):
        alt_buf = np.empty(alt_cap, dtype=np.uint8)
        ret = lib.nsp_parse_mpileup(
            text, len(text), _ptr(ref_arr), len(ref_arr),
            snp_min_af, indel_min_af, min_coverage, max_indel,
            _ptr(bed8), _ptr(conf8), n_threads,
            _ptr(positions), _ptr(counts), _ptr(depths), _ptr(cand),
            _ptr(afs), _ptr(alt_buf), alt_cap, _ptr(alt_off))
        if ret >= 0:
            break
        alt_cap = -ret
    else:
        raise RuntimeError("alt_info buffer negotiation failed")

    m = int(ret)
    # lazy alt decode (candidate rows only, sliced from the numpy buffer —
    # a whole-buffer .tobytes() memcpy'd 64 B/row of mostly-unused
    # capacity) and views instead of copies: see BamFile.pileup_region
    alt_info: List[str] = [""] * m
    for i in np.flatnonzero(cand[:m]):
        alt_info[i] = (alt_buf[alt_off[2 * i]: alt_off[2 * i + 1]]
                       .tobytes().decode())
    return ChromPileup(
        chrom=chrom,
        positions=positions[:m],
        counts=counts[:m],
        depths=depths[:m],
        is_candidate=cand[:m].astype(bool),
        alt_info=alt_info,
        afs=afs[:m],
    )
