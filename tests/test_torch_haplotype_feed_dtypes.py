"""The haplotype training feed in the shards' dtypes: the iterator yields
int8 sequences, baseq and hap and int16 mapq, and the trainer's
`_host_batch` ships int8 arrays as they come and clips and narrows only
what is wider. The bytes staged for the card are those of the f32 path
(every read matrix widened to f32 on the host, then clipped to
[-128, 127] and narrowed), whatever the batch."""
import numpy as np
import pytest

from nanosnp_tpu_torch import constants as C
from nanosnp_tpu_torch.io import bins
from nanosnp_tpu_torch.train import data as D
from nanosnp_tpu_torch.train import labels as L
from nanosnp_tpu_torch.train.train_haplotype import _host_batch
from nanosnp_tpu_torch.utils import profiling as P

READS = ("p_seq", "p_baseq", "p_mapq", "p_hap",
         "h_seq", "h_baseq", "h_mapq", "h_hap")
BATCH = 16


def _f32_path(batch):
    """The feed before it kept the shards' dtypes: read matrices widened
    to f32, then every non-label array clipped and narrowed to int8."""
    return {k: np.clip(v.astype(np.float32) if k in READS else v,
                       -128, 127).astype(np.int8)
            if k not in ("gt", "zy") else v for k, v in batch.items()}


def _world(tmp_path):
    """Three shards: depths 20 and 32 share the bucket 32 (the depth-20
    rows are padded, and the two pool together), depth 64 is a bucket of
    its own; 24 samples a shard, so bucket 64 ends in a tiled remainder.
    mapq runs over 0..254, past int8."""
    rng = np.random.default_rng(31)
    length, per = 4000, 36
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, length)]
    pos = np.sort(rng.choice(np.arange(50, length - 50), 3 * per,
                             replace=False)).astype(np.int64)
    paths = []
    for i, depth in enumerate((20, 32, 64)):
        c = pos[i * per:(i + 1) * per]
        views = []
        for seq_len in (33, 11):
            s = rng.integers(-2, 5, (len(c), depth, seq_len)).astype(np.int8)
            views.append({
                "sequences": s,
                "hap": np.where(s == -2, -2, rng.integers(
                    1, 4, s.shape)).astype(np.int8),
                "baseq": rng.integers(0, 94, s.shape).astype(np.int8),
                "mapq": rng.integers(0, 255, s.shape).astype(np.int16)})
        paths.append(str(tmp_path / f"chr1_d{depth}.npz"))
        bins.save_haplotype_shard(paths[-1], bins.HaplotypeShard(
            contig="chr1", candidate_positions=c,
            group_positions=c[:, None] + np.arange(-5, 6)[None, :],
            pileup=views[0], haplotype=views[1]))
    vcf = [f"chr1\t{p}\t.\t{chr(seq[p - 1])}\t"
           f"{'ACGT'[('ACGT'.index(chr(seq[p - 1])) + 1) % 4]}\t50\tPASS\t."
           f"\tGT\t{'0|1' if p % 2 else '1|1'}" for p in pos[::3]]
    seqs = {"chr1": seq}
    truth = L.truth_arrays({"chr1": length}, seqs, [("chr1", 0, length)],
                           vcf)
    return paths, truth, seqs


@pytest.mark.parametrize("seed", [6, 2 ** 31 + 11])
def test_feed_keeps_shard_dtypes_and_stages_the_f32_paths_bytes(tmp_path,
                                                               seed):
    paths, truth, seqs = _world(tmp_path)
    D.set_reference_for_training(seqs)
    try:
        items = list(D.haplotype_train_iterator(
            paths, truth, BATCH, np.random.default_rng(seed), epochs=2,
            mark_epochs=True))
    finally:
        D.set_reference_for_training({})
    assert sum(it is D.EPOCH_END for it in items) == 2
    batches = [it for it in items if it is not D.EPOCH_END]
    assert {b["p_seq"].shape[1] for b in batches} == {32, 64}
    assert any("_n" in b for b in batches)
    padded = clipped = False
    for batch in batches:
        batch = dict(batch)
        batch.pop("_n", None)
        for k in READS:
            assert batch[k].dtype == (np.int16 if k.endswith("mapq")
                                      else np.int8), k
        got = _host_batch(batch)
        widened = _host_batch({k: v.astype(np.float32) if k in READS else v
                               for k, v in batch.items()})
        want = _f32_path(batch)
        assert sorted(got) == sorted(widened) == sorted(want)
        for k in got:
            for other in (widened, want):
                assert got[k].dtype == other[k].dtype, k
                assert got[k].shape == other[k].shape, k
                assert got[k].tobytes() == other[k].tobytes(), k
        if batch["p_seq"].shape[1] == 32:
            pad = (batch["p_seq"][:, 20:] == C.PAD_VALUE).all(axis=(1, 2))
            padded |= bool(pad.any())
        over = batch["p_mapq"] > 127
        clipped |= bool(over.any())
        assert (got["p_mapq"][over] == 127).all()
    assert padded and clipped


def _known_batch():
    rng = np.random.default_rng(3)
    return {"p_seq": rng.integers(-2, 5, (4, 8, 33)).astype(np.int8),
            "p_mapq": rng.integers(0, 255, (4, 8, 33)).astype(np.int16),
            "p_ref": rng.integers(0, 5, (4, 33)).astype(np.float32),
            "h_hap": rng.integers(-2, 4, (4, 8, 11)).astype(np.int8),
            "gt": rng.integers(0, 10, 4).astype(np.int32),
            "zy": rng.integers(0, 3, 4).astype(np.int32)}


def test_int8_ships_without_a_copy_and_the_rest_as_before():
    batch = _known_batch()
    got = _host_batch(batch)
    for k in ("p_seq", "h_hap", "gt", "zy"):
        assert np.shares_memory(got[k], batch[k]), k
    for k in ("p_mapq", "p_ref"):
        assert not np.shares_memory(got[k], batch[k]), k
        assert got[k].dtype == np.int8, k
    want = _f32_path(batch)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_kept_and_narrowed_bytes_count_in_a_traced_session():
    from torch.autograd import profiler

    batch = _known_batch()
    with P.session("nsp.test.reset"):
        pass
    try:
        with profiler.profile(use_kineto=True):
            with P.session("nsp.test.root"):
                _host_batch(batch)
        counters = P.snapshot()["counters"]
        P._clear()
        _host_batch(batch)          # no session open: nothing records
        outside = P.snapshot()["counters"]
    finally:
        P._clear()      # the recorder is the process's: leave it empty
    assert counters["nsp.train.kept_bytes"] == (batch["p_seq"].nbytes
                                                + batch["h_hap"].nbytes)
    assert counters["nsp.train.narrowed_bytes"] == (batch["p_mapq"].size
                                                    + batch["p_ref"].size)
    assert "nsp.train.kept_bytes" not in outside
    assert "nsp.train.narrowed_bytes" not in outside
