"""The port's haplotype shard reader (nanosnp_tpu_torch/io/bins.py:
`load_haplotype_shard` over `_read_npz`) against np.load of the same
file: both containers, the benchmark world's read matrices at depths 64
and 96, a zero-site shard, Fortran-ordered arrays and a shard the JAX
package wrote; a corrupt member; the pool's counters; the memory a load
holds beside its arrays; `open_npz`'s lazy single-member read."""
import importlib.util
import io
import os
import zipfile
import zlib

import numpy as np
import pytest

from nanosnp_tpu.io import bins as jax_bins
from nanosnp_tpu_torch.io import bins
from nanosnp_tpu_torch.utils import profiling as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _world():
    """gpubench/worlds/haplotype.py, the benchmark's seeded read matrices."""
    path = os.path.join(ROOT, "gpubench", "worlds", "haplotype.py")
    spec = importlib.util.spec_from_file_location("_hap_world", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_shard(n, depth, seed=0, fortran=False):
    """A haplotype shard of n sites at `depth` from the benchmark world's
    read_matrices (the first quarter untagged)."""
    rng = np.random.default_rng(seed)
    world = _world()
    c = np.sort(rng.choice(np.arange(500, 500 + 100 * max(n, 1)), n,
                           replace=False)).astype(np.int64)
    views = [world.read_matrices(rng, n, depth, L, n // 4) for L in (33, 11)]
    groups = c[:, None] + np.arange(-5, 6)[None, :] * world.GROUP_STEP
    if fortran:
        views = [{k: np.asfortranarray(v) for k, v in d.items()}
                 for d in views]
        groups = np.asfortranarray(groups)
    return bins.HaplotypeShard(contig="chr20", candidate_positions=c,
                               group_positions=groups, pileup=views[0],
                               haplotype=views[1])


def reference_npz(path):
    """np.load of the file (deflate) or of the zip inside its zstd frame,
    every member read."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == b"\x28\xb5\x2f\xfd":
        import zstandard

        data = zstandard.ZstdDecompressor().stream_reader(
            io.BytesIO(data)).read()
    with np.load(io.BytesIO(data)) as z:
        return {k: z[k] for k in z.files}


SHARDS = {
    "depth64": lambda: make_shard(800, 64, seed=1),
    "depth96": lambda: make_shard(200, 96, seed=2),
    "zero_sites": lambda: make_shard(0, 64, seed=3),
    "fortran": lambda: make_shard(48, 64, seed=4, fortran=True),
}


@pytest.mark.parametrize("shard", [*SHARDS, "jax_writer"])
@pytest.mark.parametrize("codec", ["deflate", "zstd"])
def test_reader_returns_np_load_arrays(tmp_path, monkeypatch, codec, shard):
    if codec == "zstd":
        pytest.importorskip("zstandard")
    monkeypatch.setenv("NSP_SHARD_CODEC", codec)
    path = str(tmp_path / "s.npz")
    if shard == "jax_writer":
        src = make_shard(100, 64, seed=5)
        jax_bins.save_haplotype_shard(path, jax_bins.HaplotypeShard(
            contig=src.contig, candidate_positions=src.candidate_positions,
            group_positions=src.group_positions, pileup=src.pileup,
            haplotype=src.haplotype))
    else:
        bins.save_haplotype_shard(path, SHARDS[shard]())
    with open(path, "rb") as f:
        assert (f.read(4) == b"\x28\xb5\x2f\xfd") == (codec == "zstd")
    ref = reference_npz(path)
    got = bins.load_haplotype_shard(path)
    assert got.contig == str(ref["contig"])
    arrays = {"candidate_positions": got.candidate_positions,
              "group_positions": got.group_positions,
              **{f"pileup_{k}": v for k, v in got.pileup.items()},
              **{f"haplotype_{k}": v for k, v in got.haplotype.items()}}
    assert set(arrays) | {"contig"} == set(ref)
    for k, a in arrays.items():
        r = ref[k]
        assert a.dtype == r.dtype and a.shape == r.shape, k
        assert a.flags.c_contiguous == r.flags.c_contiguous, k
        assert a.flags.f_contiguous == r.flags.f_contiguous, k
        assert np.array_equal(a, r), k
        assert a.flags.writeable and r.flags.writeable, k
        assert a.flags.aligned and r.flags.aligned, k


def test_stored_members_read_as_np_load(tmp_path):
    """An uncompressed npz (np.savez, STORED members) of a shard's arrays
    loads as np.load reads it."""
    src = make_shard(64, 64, seed=10)
    path = str(tmp_path / "s.npz")
    np.savez(path, contig=np.array(src.contig),
             candidate_positions=src.candidate_positions,
             group_positions=src.group_positions,
             **{f"pileup_{k}": v for k, v in src.pileup.items()},
             **{f"haplotype_{k}": v for k, v in src.haplotype.items()})
    with zipfile.ZipFile(path) as zf:
        assert {i.compress_type for i in zf.infolist()} == {zipfile.ZIP_STORED}
    ref = reference_npz(path)
    got = bins._read_npz(path)
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert got[k].dtype == r.dtype and got[k].shape == r.shape, k
        assert np.array_equal(got[k], r) and got[k].flags.writeable, k


def test_zstd_frame_without_content_size_loads(tmp_path, monkeypatch):
    """A zstd-wrapped shard whose frame header leaves out the content size
    (a streaming writer's) loads as the one-call frame does."""
    zstandard = pytest.importorskip("zstandard")
    monkeypatch.setenv("NSP_SHARD_CODEC", "zstd")
    path = tmp_path / "s.npz"
    bins.save_haplotype_shard(str(path), make_shard(32, 64, seed=11))
    raw = zstandard.ZstdDecompressor().decompress(path.read_bytes())
    out = io.BytesIO()
    with zstandard.ZstdCompressor().stream_writer(out, closefd=False) as w:
        w.write(raw)
    assert zstandard.frame_content_size(out.getvalue()) == -1
    streamed = tmp_path / "streamed.npz"
    streamed.write_bytes(out.getvalue())
    ref = bins._read_npz(str(path))
    got = bins._read_npz(str(streamed))
    assert set(got) == set(ref)
    assert all(np.array_equal(got[k], ref[k]) for k in ref)


@pytest.mark.parametrize("member", ["pileup_mapq", "haplotype_hap"])
def test_corrupt_deflate_member_raises(tmp_path, monkeypatch, member):
    monkeypatch.setenv("NSP_SHARD_CODEC", "deflate")
    path = tmp_path / "s.npz"
    bins.save_haplotype_shard(str(path), make_shard(800, 64, seed=6))
    data = bytearray(path.read_bytes())
    info = zipfile.ZipFile(io.BytesIO(bytes(data))).getinfo(member + ".npy")
    at = info.header_offset + 30 + len(info.filename) + len(info.extra)
    data[at + info.compress_size // 2] ^= 0x5A
    path.write_bytes(bytes(data))
    with pytest.raises((zipfile.BadZipFile, zlib.error)):
        bins.load_haplotype_shard(str(path))


@pytest.mark.parametrize("codec, parallel, inline",
                         [("deflate", 11, 0), ("zstd", 0, 11)])
def test_members_count_as_parallel_or_inline(tmp_path, monkeypatch, codec,
                                             parallel, inline):
    """A deflate shard's eleven members are read on the pool; a zstd
    shard is one frame, its members read on the calling thread."""
    from torch.autograd import profiler

    if codec == "zstd":
        pytest.importorskip("zstandard")
    monkeypatch.setenv("NSP_SHARD_CODEC", codec)
    path = str(tmp_path / "s.npz")
    bins.save_haplotype_shard(path, make_shard(8, 64, seed=7))
    with P.session("nsp.test.reset"):
        pass
    try:
        with profiler.profile(use_kineto=True):
            with P.session("nsp.test.root"):
                bins.load_haplotype_shard(path)
        counters = P.snapshot()["counters"]
    finally:
        P._clear()      # the recorder is the process's: leave it empty
    assert counters.get("nsp.shard.members_parallel", 0) == parallel
    assert counters.get("nsp.shard.members_inline", 0) == inline


def test_load_holds_its_arrays_and_a_piece_a_member(tmp_path, monkeypatch):
    """Beside the arrays it returns, a deflate load holds one piece of
    compressed input for each member in flight, not whole inflated
    members nor the file: traced peak against that bound, on two pool
    threads and pieces far smaller than the members."""
    import tracemalloc

    monkeypatch.setenv("NSP_SHARD_CODEC", "deflate")
    monkeypatch.setattr(bins, "_PIECE", 64 << 10)
    monkeypatch.setattr(bins, "_cores", lambda: 2)
    path = str(tmp_path / "s.npz")
    bins.save_haplotype_shard(path, make_shard(1500, 64, seed=9))
    tracemalloc.start()
    try:
        got = bins._read_npz(path)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    raw = sum(a.nbytes for a in got.values())
    assert raw > 20e6 and max(a.nbytes for a in got.values()) > 6e6
    # a piece and a 64 KiB header copy a member in flight, and slack
    assert peak < raw + 2 * (bins._PIECE + (64 << 10)) + (1 << 20)


def test_open_npz_reads_contig_alone(tmp_path, monkeypatch):
    monkeypatch.setenv("NSP_SHARD_CODEC", "deflate")
    path = str(tmp_path / "s.npz")
    bins.save_haplotype_shard(path, make_shard(160, 64, seed=8))
    opened = []
    real = zipfile.ZipFile.open

    def record(self, name, *a, **kw):
        opened.append(name if isinstance(name, str) else name.filename)
        return real(self, name, *a, **kw)

    monkeypatch.setattr(zipfile.ZipFile, "open", record)
    assert str(bins.open_npz(path)["contig"]) == "chr20"
    assert set(opened) == {"contig.npy"}
