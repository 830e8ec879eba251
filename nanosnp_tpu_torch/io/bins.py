"""Feature-shard storage: the JAX package's io/bins.py, copied so that
both packages read and write the same files.

Shards are .npz: zstd-wrapped where the `zstandard` module is installed,
plain deflate zip where it is not or under NSP_SHARD_CODEC=deflate (see
`shard_codec`). For interop with the reference tooling the HDF5 helpers
write and read plain-HDF5 files with the reference's dataset names and
string layouts:
  - pileup predict bins (make_bin_predict_data.py:79-109): position_matrix
    [N,33,18] int32, position [N,1] S83 "chr:pos:refseq33", alt_info [N,1]
    S5000;
  - pileup train bins (make_bin_train_data.py:100-105): the same and
    label [N,90] int32;
  - haplotype bins (write_to_bins.py:44-63): {pileup,haplotype}_{sequences,
    hap,baseq,mapq} [N,D,L] int32, candidate_positions [N,1] S,
    haplotype_positions [N,11] S.
They need h5py, imported when one of them is called (`require_h5py`);
where it is not installed they raise ImportError.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import importlib.util
import io
import math
import os
import struct
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
from numpy.lib import format as npformat


# ---------------------------------------------------------------------------
# pileup predict shards
# ---------------------------------------------------------------------------


class PileupShard:
    """s1 candidate shard.

    v2 shards store the COLUMN union (columns [M,18] int16 + per-candidate
    center offsets cand_off [N]) instead of dense [N,33,18] windows:
    adjacent candidates share window columns, so the dense tensor is ~3x
    redundant — raw bytes drive the npz deflate/inflate time and the
    host->device transfer, both of which were s1/s2 bottlenecks at contig
    scale. `.matrix` materializes the dense view lazily for consumers that
    need it (HDF5 interop, verify, training); the s2 predictor gathers
    windows ON DEVICE from the columns. v1 (dense `matrix` key) shards
    still load."""

    def __init__(self, contig: str, positions=None, matrix=None,
                 ref_seqs=None, alt_info=None, *, columns=None,
                 cand_off=None, flank: int = 16):
        self.contig = contig
        self.positions = positions   # [N] int64
        self.ref_seqs = ref_seqs     # [N] S33 bytes
        self.alt_info = alt_info     # [N] bytes
        self.columns = columns       # [M, 18] int16 or None (v1)
        self.cand_off = cand_off     # [N] int64 or None (v1)
        self.flank = flank
        self._matrix = matrix
        if matrix is None and columns is None:
            raise ValueError("PileupShard needs matrix or columns")

    @property
    def matrix(self) -> np.ndarray:
        """Dense [N, 2*flank+1, 18] windows (materialized lazily)."""
        if self._matrix is None:
            gather = self.cand_off[:, None] + np.arange(
                -self.flank, self.flank + 1)[None, :]
            self._matrix = self.columns[gather]
        return self._matrix

    @property
    def center_counts(self) -> np.ndarray:
        """[N, 18] center-column counts without materializing windows."""
        if self._matrix is not None:
            return self._matrix[:, self._matrix.shape[1] // 2, :]
        if getattr(self, "_centers", None) is None:
            self._centers = self.columns[self.cand_off]
        return self._centers

    def __len__(self):
        return len(self.positions)


_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def shard_codec() -> str:
    """The container new shards are written in: "zstd" or "deflate".
    NSP_SHARD_CODEC decides when set (asking for zstd without the
    `zstandard` module raises); unset, it is zstd where that module is
    installed and deflate where it is not. Readers sniff the magic, so
    either kind loads wherever its codec exists."""
    have = importlib.util.find_spec("zstandard") is not None
    asked = os.environ.get("NSP_SHARD_CODEC")
    if asked is None:
        return "zstd" if have else "deflate"
    if asked == "zstd" and not have:
        raise RuntimeError("NSP_SHARD_CODEC=zstd but the zstandard module "
                           "is not installed")
    return "zstd" if asked == "zstd" else "deflate"


def _savez_fast(path: str, arrays, compresslevel: int = 1) -> None:
    """Shard writer. Default container (r5): a whole-file zstd frame
    around a STORED .npz — zstd level 3 matches deflate-6 ratios at ~5x
    the compression speed (and compresses MULTITHREADED), and inflates
    ~20x faster than zlib, which was the s5 stage's actual bottleneck
    (one 255k-group consolidated shard cost 31 s of single-threaded
    zlib inflate per load). `open_npz` sniffs the magic, so historic
    deflate shards keep loading and the filename stays `.npz`.
    NSP_SHARD_CODEC=deflate restores the plain np.load-able container
    (interop with external numpy tooling)."""
    import io as _io
    import zipfile

    from numpy.lib import format as npformat

    if not path.endswith(".npz"):
        path += ".npz"
    if shard_codec() == "zstd":
        import zstandard as zstd

        raw = _io.BytesIO()
        with zipfile.ZipFile(raw, "w", zipfile.ZIP_STORED) as zf:
            for name, arr in arrays.items():
                buf = _io.BytesIO()
                npformat.write_array(buf, np.asanyarray(arr))
                zf.writestr(f"{name}.npy", buf.getvalue())
        comp = zstd.ZstdCompressor(level=3, threads=-1)
        with open(path, "wb") as f:
            f.write(comp.compress(raw.getbuffer()))
        return
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED,
                         compresslevel=compresslevel) as zf:
        for name, arr in arrays.items():
            buf = _io.BytesIO()
            npformat.write_array(buf, np.asanyarray(arr))
            zf.writestr(f"{name}.npy", buf.getvalue())


def _zstd_payload(data: bytes, path: str) -> bytes:
    """The STORED zip inside a zstd-wrapped shard, decompressed in one
    call into a buffer that the frame header sizes (streamed where the
    header leaves the size out)."""
    if importlib.util.find_spec("zstandard") is None:
        raise RuntimeError(f"{path} is zstd-compressed but the zstandard "
                           "module is not installed")
    import zstandard as zstd

    dctx = zstd.ZstdDecompressor()
    if zstd.frame_content_size(data) < 0:
        return dctx.stream_reader(io.BytesIO(data)).read()
    return dctx.decompress(data)


def open_npz(path: str):
    """np.load for shard files, transparent to the container codec:
    plain zip npz (historic shards, NSP_SHARD_CODEC=deflate) or the r5
    zstd-wrapped npz. Lazy on a deflate zip: a key reads its member
    alone. For whole shards `_read_npz` is the faster reader."""
    with open(path, "rb") as f:
        head = f.read(4)
        if head != _ZSTD_MAGIC:
            return np.load(path)
        return np.load(io.BytesIO(_zstd_payload(head + f.read(), path)))


# Compressed bytes a member's inflate reads from the file at a time: a
# shard's load holds its arrays and one such piece per member in flight.
_PIECE = 1 << 20


class _ZStream(ctypes.Structure):
    """zlib.h's z_stream."""
    _fields_ = [("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_uint),
                ("total_in", ctypes.c_ulong), ("next_out", ctypes.c_void_p),
                ("avail_out", ctypes.c_uint), ("total_out", ctypes.c_ulong),
                ("msg", ctypes.c_char_p), ("state", ctypes.c_void_p),
                ("zalloc", ctypes.c_void_p), ("zfree", ctypes.c_void_p),
                ("opaque", ctypes.c_void_p), ("data_type", ctypes.c_int),
                ("adler", ctypes.c_ulong), ("reserved", ctypes.c_ulong)]


_libz = None


def _zlib() -> ctypes.CDLL:
    """The system zlib (which the native engine also links), for inflate
    into memory the caller owns; ctypes drops the GIL while it runs."""
    global _libz
    if _libz is None:
        z = ctypes.CDLL(ctypes.util.find_library("z") or "libz.so.1")
        z.zlibVersion.restype = ctypes.c_char_p
        stream = ctypes.POINTER(_ZStream)
        z.inflateInit2_.argtypes = [stream, ctypes.c_int, ctypes.c_char_p,
                                    ctypes.c_int]
        z.inflate.argtypes = [stream, ctypes.c_int]
        z.inflateEnd.argtypes = [stream]
        _libz = z
    return _libz


def _inflate_into(fd: int, at: int, size: int, out: np.ndarray,
                  name: str) -> None:
    """Inflates the raw deflate stream of `size` bytes at file offset `at`
    into `out`, which it must fill exactly."""
    z, s = _zlib(), _ZStream()
    if z.inflateInit2_(ctypes.byref(s), -15, z.zlibVersion(),
                       ctypes.sizeof(s)) != 0:
        raise MemoryError(f"{name}: inflateInit2 failed")
    piece = bytearray(max(1, min(_PIECE, size)))
    piece_at = ctypes.addressof(ctypes.c_char.from_buffer(piece))
    end, put, rc = at + size, 0, 0
    try:
        while True:
            if s.avail_in == 0 and at < end:
                n = os.preadv(fd, [memoryview(piece)[:end - at]], at)
                if n <= 0:
                    break
                at += n
                s.next_in, s.avail_in = piece_at, n
            if s.avail_out == 0 and put < out.nbytes:
                n = min(out.nbytes - put, 1 << 30)     # avail_out is 32-bit
                s.next_out, s.avail_out = out.ctypes.data + put, n
                put += n
            rc = z.inflate(ctypes.byref(s), 0)          # Z_NO_FLUSH
            if rc == 1:                                 # Z_STREAM_END
                break
            if rc != 0 and not (rc == -5 and s.avail_in == 0 and at < end):
                raise zipfile.BadZipFile(f"{name}: inflate error {rc}")
    finally:
        z.inflateEnd(ctypes.byref(s))
    if rc != 1 or s.total_out != out.nbytes:
        raise zipfile.BadZipFile(f"{name}: truncated or oversized member")


def _npy_view(img: np.ndarray) -> np.ndarray:
    """The array of a .npy image, in place: np.load's dtype, shape and
    order, writable. Anything but a plain array under format 1.0 or 2.0
    goes through numpy's own reader (a copy; it refuses object arrays)."""
    fp = io.BytesIO(img[:1 << 16].tobytes())
    read_header = {(1, 0): npformat.read_array_header_1_0,
                   (2, 0): npformat.read_array_header_2_0
                   }.get(npformat.read_magic(fp))
    if read_header is not None:
        shape, fortran, dtype = read_header(fp)
        if not dtype.hasobject:
            flat = np.frombuffer(img, dtype, math.prod(shape), fp.tell())
            return (flat.reshape(shape[::-1]).T if fortran
                    else flat.reshape(shape))
    return npformat.read_array(io.BytesIO(img))


def _member(fd: int, info: zipfile.ZipInfo) -> np.ndarray:
    """One member of a zip shard: its bytes after the local header read
    (STORED) or inflated (deflate) straight into one buffer of its raw
    size, checked against the central directory's CRC-32 as zipfile
    checks it, and its .npy image viewed as the array."""
    head = os.pread(fd, 30, info.header_offset)
    if (len(head) < 30 or head[:4] != b"PK\x03\x04"
            or info.flag_bits & 0x1):
        raise zipfile.BadZipFile(f"{info.filename}: bad or encrypted "
                                 "local header")
    name_len, extra_len = struct.unpack_from("<HH", head, 26)
    at = info.header_offset + 30 + name_len + extra_len
    img = np.empty(info.file_size, np.uint8)
    if info.compress_type == zipfile.ZIP_DEFLATED:
        _inflate_into(fd, at, info.compress_size, img, info.filename)
    elif info.compress_type == zipfile.ZIP_STORED:
        got = 0
        while got < img.nbytes:
            n = os.preadv(fd, [img[got:]], at + got)
            if n <= 0:
                raise zipfile.BadZipFile(f"{info.filename}: truncated")
            got += n
    else:
        raise zipfile.BadZipFile(f"{info.filename}: compression "
                                 f"{info.compress_type} is not supported")
    if zlib.crc32(img) != info.CRC:
        raise zipfile.BadZipFile(f"Bad CRC-32 for file {info.filename!r}")
    return _npy_view(img)


def _cores() -> int:
    """The CPUs this process may run on (its affinity, where the OS
    says)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def _read_npz(path: str) -> Dict[str, np.ndarray]:
    """Every array of a shard file, as np.load returns them (writable).
    A deflate zip's members are independent streams: each is inflated in
    one pass into its own buffer, concurrently on a thread pool as wide
    as the smaller of their number and this process's CPUs (zlib runs
    outside the GIL). A zstd-wrapped shard is one frame: it is
    decompressed in one call and its members are read on the calling
    thread. Counts nsp.shard.members_parallel and
    nsp.shard.members_inline."""
    from ..utils.profiling import count

    with open(path, "rb") as f:
        wrapped = f.read(4) == _ZSTD_MAGIC
    if wrapped:
        with open_npz(path) as z:
            arrays = {k: z[k] for k in z.files}
        count("nsp.shard.members_inline", len(arrays))
        return arrays
    with zipfile.ZipFile(path) as zf:
        infos = zf.infolist()
    count("nsp.shard.members_parallel", len(infos))
    _zlib()
    fd = os.open(path, os.O_RDONLY)
    try:
        with ThreadPoolExecutor(max(1, min(len(infos), _cores()))) as pool:
            got = pool.map(lambda i: _member(fd, i), infos)
            return {i.filename.removesuffix(".npy"): a
                    for i, a in zip(infos, got)}
    finally:
        os.close(fd)


def save_pileup_shard(path: str, shard: PileupShard) -> None:
    # channel counts fit int16 (|value| <= 4*max_depth(144) = 576 after the
    # ref-negation trick): half the bytes of int32 to compress/decompress
    arrays = dict(
        contig=np.array(shard.contig),
        positions=shard.positions,
        ref_seqs=np.asarray(shard.ref_seqs, dtype="S"),
        alt_info=np.asarray(shard.alt_info, dtype="S"),
    )
    if shard.columns is not None:
        arrays["columns"] = shard.columns.astype(np.int16, copy=False)
        arrays["cand_off"] = shard.cand_off.astype(np.int64, copy=False)
        arrays["flank"] = np.int64(shard.flank)
    else:
        arrays["matrix"] = shard.matrix.astype(np.int16, copy=False)
    _savez_fast(path, arrays)


def load_pileup_shard(path: str) -> PileupShard:
    z = open_npz(path)
    if "columns" in z.files:
        return PileupShard(
            contig=str(z["contig"]),
            positions=z["positions"],
            ref_seqs=z["ref_seqs"],
            alt_info=z["alt_info"],
            columns=z["columns"],
            cand_off=z["cand_off"],
            flank=int(z["flank"]),
        )
    return PileupShard(
        contig=str(z["contig"]),
        positions=z["positions"],
        matrix=z["matrix"],
        ref_seqs=z["ref_seqs"],
        alt_info=z["alt_info"],
    )


def require_h5py():
    """The h5py module, which the HDF5 helpers need and the rest of the
    package does not."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "the reference-layout HDF5 bins need h5py, which is not "
            "installed; the .npz shards and train arrays need no h5py") from e
    return h5py


def save_pileup_shard_h5(path: str, shard: PileupShard) -> None:
    """Reference-layout HDF5 (readable by the reference PredictDataset)."""
    h5py = require_h5py()

    n = len(shard)
    position = np.array(
        [f"{shard.contig}:{int(p)}:{r.decode()}".encode()
         for p, r in zip(shard.positions, np.asarray(shard.ref_seqs, dtype="S"))],
        dtype="S83").reshape(n, 1)
    with h5py.File(path, "w") as f:
        f.create_dataset("position_matrix", data=shard.matrix.astype(np.int32))
        f.create_dataset("position", data=position)
        f.create_dataset("alt_info",
                         data=np.asarray(shard.alt_info, dtype="S5000").reshape(n, 1))


def load_pileup_shard_h5(path: str) -> PileupShard:
    h5py = require_h5py()

    with h5py.File(path, "r") as f:
        matrix = np.asarray(f["position_matrix"])
        position = np.asarray(f["position"]).reshape(-1)
        alt_info = np.asarray(f["alt_info"]).reshape(-1)
    contigs, positions, refs = [], [], []
    for item in position:
        ctg, pos, seq = item.decode().strip().split(":")
        contigs.append(ctg)
        positions.append(int(pos))
        refs.append(seq.encode())
    return PileupShard(
        contig=contigs[0] if contigs else "",
        positions=np.asarray(positions, dtype=np.int64),
        matrix=matrix,
        ref_seqs=np.asarray(refs, dtype="S"),
        alt_info=alt_info,
    )


def save_pileup_train_h5(path: str, arrays) -> None:
    """Reference-layout HDF5 TRAIN bin (make_bin_train_data.py:100-105):
    position_matrix [N,33,18] int32, position [N,1] S83, label [N,90]
    int32, alt_info [N,1] S5000. Readable by the reference TrainDataset
    (PileupModel/dataset.py:73-96) for cross-stack train-data diffing.
    `arrays` is a train.data.PileupTrainArrays with ref_seqs/alt_info set."""
    h5py = require_h5py()

    if arrays.ref_seqs is None or arrays.alt_info is None:
        raise ValueError("train arrays lack ref_seqs/alt_info provenance "
                         "(rebuild with build_pileup_train_arrays)")
    n = len(arrays.positions)
    position = np.array(
        [f"{arrays.contig}:{int(p)}:{r.decode()}".encode()
         for p, r in zip(arrays.positions,
                         np.asarray(arrays.ref_seqs, dtype="S"))],
        dtype="S83").reshape(n, 1)
    with h5py.File(path, "w") as f:
        f.create_dataset("position_matrix",
                         data=arrays.matrix.astype(np.int32))
        f.create_dataset("position", data=position)
        f.create_dataset("label", data=arrays.label.astype(np.int32))
        f.create_dataset("alt_info",
                         data=np.asarray(arrays.alt_info,
                                         dtype="S5000").reshape(n, 1))


def load_pileup_train_h5(path: str):
    """Read a reference-layout train bin back into PileupTrainArrays."""
    h5py = require_h5py()

    from ..train.data import PileupTrainArrays

    with h5py.File(path, "r") as f:
        matrix = np.asarray(f["position_matrix"])
        label = np.asarray(f["label"])
        position = np.asarray(f["position"]).reshape(-1)
        alt_info = np.asarray(f["alt_info"]).reshape(-1)
    contigs, positions, refs = [], [], []
    for item in position:
        ctg, pos, seqs = item.decode().strip().split(":")
        contigs.append(ctg)
        positions.append(int(pos))
        refs.append(seqs.encode())
    # zygosity class > 0 (1/1 or 0/1) marks a variant; gt alone cannot
    # (hom-ref sites carry their ref base's gt21 class)
    zy = label[:, 21:24].argmax(1) if len(label) else np.zeros(0, np.int64)
    return PileupTrainArrays(
        matrix=matrix, label=label,
        positions=np.asarray(positions, dtype=np.int64),
        is_variant=zy > 0,
        contig=contigs[0] if contigs else "",
        ref_seqs=np.asarray(refs, dtype="S33") if refs
        else np.zeros(0, "S33"),
        alt_info=alt_info)


# ---------------------------------------------------------------------------
# haplotype shards
# ---------------------------------------------------------------------------


@dataclass
class HaplotypeShard:
    contig: str
    candidate_positions: np.ndarray    # [N] int64
    group_positions: np.ndarray        # [N, 11] int64 (het group positions)
    pileup: Dict[str, np.ndarray]      # sequences/hap/baseq/mapq [N, Dp, 33] int32
    haplotype: Dict[str, np.ndarray]   # sequences/hap/baseq/mapq [N, Dh, 11] int32

    def __len__(self):
        return len(self.candidate_positions)


_KEYS = ("sequences", "hap", "baseq", "mapq")

# Depth buckets shared by s4 packing, s5 inference pooling, and the
# training iterator — train and serve MUST pad to the same depths.
DEPTH_BUCKETS = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def depth_bucket(d: int) -> int:
    for b in DEPTH_BUCKETS:
        if d <= b:
            return b
    return ((d + 127) // 128) * 128


# value ranges (pad -2): sequences -2..4, baseq -2..93, hap -2..3 -> int8;
# mapq -2..254 (BAM uint8) -> int16. Compact dtypes cut shard decompress
# time ~3x and device transfer 4x vs int32, and int16 mapq ships losslessly
# (the old int32->int8 transfer clip saturated mapq>127).
_KEY_DTYPE = {"sequences": np.int8, "baseq": np.int8, "hap": np.int8,
              "mapq": np.int16}


def save_haplotype_shard(path: str, shard: HaplotypeShard) -> None:
    arrays = {
        "contig": np.array(shard.contig),
        "candidate_positions": shard.candidate_positions,
        "group_positions": shard.group_positions,
    }
    for k in _KEYS:
        arrays[f"pileup_{k}"] = shard.pileup[k].astype(_KEY_DTYPE[k],
                                                       copy=False)
        arrays[f"haplotype_{k}"] = shard.haplotype[k].astype(_KEY_DTYPE[k],
                                                             copy=False)
    _savez_fast(path, arrays)


def load_haplotype_shard(path: str) -> HaplotypeShard:
    z = _read_npz(path)
    return HaplotypeShard(
        contig=str(z["contig"]),
        candidate_positions=z["candidate_positions"],
        group_positions=z["group_positions"],
        pileup={k: z[f"pileup_{k}"] for k in _KEYS},
        haplotype={k: z[f"haplotype_{k}"] for k in _KEYS},
    )


def save_haplotype_shard_h5(path: str, shard: HaplotypeShard,
                            candidate_labels: Optional[np.ndarray] = None
                            ) -> None:
    """Reference-layout HDF5 (write_to_bins.py dataset names). Passing
    `candidate_labels` [N,3] (confident-flag, gt21, zygosity — the
    train.data.attach_haplotype_labels output) produces the TRAIN-bin
    layout (make_train_bins.py:123-127,258) readable by the reference
    TrainingDataset."""
    h5py = require_h5py()

    n = len(shard)
    adj = shard.group_positions.shape[1]
    cand = np.array([f"{shard.contig}:{int(p)}".encode()
                     for p in shard.candidate_positions],
                    dtype=f"S{30 * (adj - 1)}").reshape(n, 1)
    hpos = np.array([[f"{shard.contig}:{int(p)}".encode() for p in row]
                     for row in shard.group_positions],
                    dtype=f"S{30 * (adj - 1)}")
    with h5py.File(path, "w") as f:
        for k in _KEYS:
            f.create_dataset(f"pileup_{k}", data=shard.pileup[k].astype(np.int32))
            f.create_dataset(f"haplotype_{k}", data=shard.haplotype[k].astype(np.int32))
        f.create_dataset("candidate_positions", data=cand)
        f.create_dataset("haplotype_positions", data=hpos)
        if candidate_labels is not None:
            f.create_dataset("candidate_labels",
                             data=np.asarray(candidate_labels,
                                             dtype=np.int32).reshape(n, 3))


def load_haplotype_shard_h5(path: str) -> HaplotypeShard:
    h5py = require_h5py()

    with h5py.File(path, "r") as f:
        data = {k: np.asarray(f[k]) for k in f.keys()}
    cand_raw = data["candidate_positions"].reshape(-1)
    contig = cand_raw[0].decode().split(":")[0] if len(cand_raw) else ""
    cand = np.array([int(v.decode().split(":")[1]) for v in cand_raw],
                    dtype=np.int64)
    hpos = np.array(
        [[int(v.decode().split(":")[1]) for v in row]
         for row in data["haplotype_positions"]], dtype=np.int64)
    return HaplotypeShard(
        contig=contig,
        candidate_positions=cand,
        group_positions=hpos,
        pileup={k: data[f"pileup_{k}"] for k in _KEYS},
        haplotype={k: data[f"haplotype_{k}"] for k in _KEYS},
    )


def list_shards(directory: str, suffix: str = ".npz") -> List[str]:
    return sorted(
        os.path.join(directory, f) for f in os.listdir(directory)
        if f.endswith(suffix))
