"""The host stages of the port (s1 pileup features, s3 native phasing, s4
haplotype features) against the JAX package's, on the small diploid world
of tests/test_native_phaser.py. These stages are the same C++ engine and
numpy code in both packages, so every artifact must be identical: shard
arrays compare with np.array_equal (no tolerance), text files byte for
byte, and a shard written by one package loads in the other."""
import os

import numpy as np
import pytest

from bamgen import simulate_mpileup, write_bam
from diploid import diploid_reads, make_diploid
from synth import random_genome

from nanosnp_tpu import config as jconfig
from nanosnp_tpu.io import bins as jbins
from nanosnp_tpu.io.fasta import FastaReference as JaxFasta
from nanosnp_tpu.io.fasta import write_fasta
from nanosnp_tpu.runtime import stages as jstages
from nanosnp_tpu.runtime.extract import NativeBamExtractor as JaxExtractor
from nanosnp_tpu_torch import config as tconfig
from nanosnp_tpu_torch.decode.pileup_vcf import write_vcf_header
from nanosnp_tpu_torch.io import bins as tbins
from nanosnp_tpu_torch.io import native as tnative
from nanosnp_tpu_torch.io.fasta import FastaReference
from nanosnp_tpu_torch.runtime import stages as tstages
from nanosnp_tpu_torch.runtime.extract import NativeBamExtractor

CONTIG = "chrP"
SMALL = "chrM"


def synth_pileup_vcf(path, fai, contig, truth, rng):
    """A pileup.vcf as s2 writes it, made from the world's truth: hets as
    0/1 and homs as 1/1 with QUAL drawn over [2, 40), so that some rows fall
    on each side of every s3/s4 threshold."""
    with open(path, "w") as out:
        write_vcf_header(fai, out)
        for t in sorted(truth, key=lambda t: t.pos1):
            gt = "1/1" if t.hom else "0/1"
            qual = round(float(rng.uniform(2, 40)), 2)
            out.write(f"{contig}\t{t.pos1}\t.\t{t.ref}\t{t.alt}\t{qual}\t"
                      f"PASS\t.\tGT:GQ:DP:AF\t{gt}:{int(qual)}:30:0.5\n")


def cfg_pair(**pileup_feature):
    """The two packages' configs with the same settings."""
    cfgs = jconfig.PipelineConfig(), tconfig.PipelineConfig()
    for c in cfgs:
        c.threads = 2
        for k, v in pileup_feature.items():
            setattr(c.pileup_feature, k, v)
    return cfgs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("host_stages")
    rng = np.random.default_rng(33)
    genome = random_genome(rng, {CONTIG: 40_000, SMALL: 6_000})
    genome = {k: v.replace("N", "C") for k, v in genome.items()}
    fasta = tmp / "ref.fa"
    write_fasta(str(fasta), genome)
    truth, h1, h2 = make_diploid(rng, genome[CONTIG], n_het=500, n_hom=100,
                                 spacing=50)
    reads = diploid_reads(rng, h1, h2, 0, n_reads=3_000, read_len=420,
                          err=0.04, tag_rate=0.0)
    _, m1, m2 = make_diploid(rng, genome[SMALL], n_het=60, n_hom=20,
                             spacing=50)
    small_reads = diploid_reads(rng, m1, m2, 1, n_reads=300, read_len=300,
                                err=0.05, tag_rate=0.0)
    bam = tmp / "untagged.bam"
    write_bam(str(bam), [(CONTIG, 40_000), (SMALL, 6_000)],
              reads + small_reads)
    mp_dir = tmp / "chr_mpileup"
    mp_dir.mkdir()
    lines = simulate_mpileup({SMALL: genome[SMALL]}, {SMALL: small_reads})
    (mp_dir / f"{SMALL}.mpileup").write_text("\n".join(lines) + "\n")
    vcf = tmp / "pileup.vcf"
    synth_pileup_vcf(str(vcf), str(fasta) + ".fai", CONTIG, truth,
                     np.random.default_rng(5))
    return dict(tmp=tmp, fasta=str(fasta), bam=str(bam), mp_dir=str(mp_dir),
                vcf=str(vcf), jref=JaxFasta(str(fasta)),
                tref=FastaReference(str(fasta)))


def npz_arrays(path):
    z = jbins.open_npz(path)
    return {k: z[k] for k in z.files}


def assert_same_npz_dirs(got_dir, want_dir):
    """Same file names, and every array of every file np.array_equal."""
    got, want = sorted(os.listdir(got_dir)), sorted(os.listdir(want_dir))
    assert got == want and got
    for name in got:
        a = npz_arrays(os.path.join(got_dir, name))
        b = npz_arrays(os.path.join(want_dir, name))
        assert sorted(a) == sorted(b), name
        for k in a:
            assert a[k].dtype == b[k].dtype, (name, k)
            assert np.array_equal(a[k], b[k]), (name, k)
    return got


def test_native_library_builds_outside_the_sources():
    """The port compiles its engine into the ignored build directory under
    a name that carries the sources' hash, not next to the sources."""
    tnative.get_lib()
    path = tnative._lib_path()
    assert os.path.dirname(path) == tnative._BUILD_DIR
    assert os.path.exists(path)
    assert not [f for f in os.listdir(tnative._NATIVE_DIR)
                if f.endswith(".so")]


def test_s1_from_bam_shards_equal_with_aligned_parts(world, monkeypatch):
    """s1 from the BAM. A low candidate threshold and a flush cap of 1000
    make several parts: every part but the last holds a multiple of 1000
    candidates (the bug_compat alignment), and all arrays are equal."""
    monkeypatch.setenv("NSP_S1_FLUSH_CANDIDATES", "1000")
    jcfg, tcfg = cfg_pair(snp_min_af=0.06)
    tmp = world["tmp"]
    jm = jstages.stage_pileup_features_from_bam(
        jcfg, world["jref"], world["bam"], str(tmp / "s1_jax"), [CONTIG],
        chunk_size=15_000)
    tm = tstages.stage_pileup_features_from_bam(
        tcfg, world["tref"], world["bam"], str(tmp / "s1_torch"), [CONTIG],
        chunk_size=15_000)
    assert tm["rows"] == jm["rows"] and tm["candidates"] == jm["candidates"]
    names = assert_same_npz_dirs(str(tmp / "s1_torch"), str(tmp / "s1_jax"))
    assert len(names) >= 3 and tm["candidates"] > 2000
    sizes = [len(tbins.load_pileup_shard(str(tmp / "s1_torch" / n)))
             for n in names]
    assert all(s % 1000 == 0 and s > 0 for s in sizes[:-1]), sizes
    assert sum(sizes) == tm["candidates"]


def test_s1_from_mpileup_text_shards_equal(world):
    """s1 from per-contig mpileup text, streamed in small units so that the
    unit overlap and the emit bounds are exercised."""
    jcfg, tcfg = cfg_pair()
    tmp = world["tmp"]
    jm = jstages.stage_pileup_features(
        jcfg, world["jref"], world["mp_dir"], str(tmp / "s1t_jax"),
        chunk_bytes=64 << 10)
    tm = tstages.stage_pileup_features(
        tcfg, world["tref"], world["mp_dir"], str(tmp / "s1t_torch"),
        chunk_bytes=64 << 10)
    assert tm["rows"] == jm["rows"] > 5000
    assert tm["candidates"] == jm["candidates"] > 20
    assert_same_npz_dirs(str(tmp / "s1t_torch"), str(tmp / "s1t_jax"))


def test_shards_cross_load(world):
    """A pileup shard written by one package loads in the other, with the
    same arrays and the same dense windows."""
    tmp = world["tmp"]
    jcfg, tcfg = cfg_pair()
    for d in ("xl_jax", "xl_torch"):
        (tmp / d).mkdir()
    jstages.stage_pileup_features_from_bam(
        jcfg, world["jref"], world["bam"], str(tmp / "xl_jax"), [SMALL])
    tstages.stage_pileup_features_from_bam(
        tcfg, world["tref"], world["bam"], str(tmp / "xl_torch"), [SMALL])
    a = tbins.load_pileup_shard(str(tmp / "xl_jax" / f"{SMALL}.npz"))
    b = jbins.load_pileup_shard(str(tmp / "xl_torch" / f"{SMALL}.npz"))
    assert len(a) == len(b) > 0
    assert np.array_equal(a.matrix, b.matrix)
    assert np.array_equal(a.positions, b.positions)
    assert np.array_equal(a.ref_seqs, b.ref_seqs)


@pytest.fixture(scope="module")
def phased(world):
    """s3 of both packages on the one given pileup.vcf."""
    jcfg, tcfg = cfg_pair()
    tmp = world["tmp"]
    jm = jstages.stage_phase_native(jcfg, world["jref"], world["vcf"],
                                    world["bam"], str(tmp / "s3_jax"),
                                    [CONTIG])
    tm = tstages.stage_phase_native(tcfg, world["tref"], world["vcf"],
                                    world["bam"], str(tmp / "s3_torch"),
                                    [CONTIG])
    return jm, tm


def test_s3_phased_vcf_and_hp_overrides_identical(world, phased):
    jm, tm = phased
    tmp = world["tmp"]
    for k in ("sites", "phased_sites", "blocks", "tagged_reads"):
        assert tm[k] == jm[k], k
    assert tm["phased_sites"] > 100 and tm["tagged_reads"] > 500
    name = f"{CONTIG}.phased.vcf"
    got = (tmp / "s3_torch" / name).read_bytes()
    assert got == (tmp / "s3_jax" / name).read_bytes()
    assert b"|" in got
    t_over = tstages.load_native_phase_overrides(str(tmp / "s3_torch"))
    j_over = jstages.load_native_phase_overrides(str(tmp / "s3_jax"))
    assert t_over == j_over and len(t_over[CONTIG]) == tm["tagged_reads"]


def test_s4_haplotype_shards_identical(world, phased, monkeypatch):
    """s4 with the native phaser's HP partition, flushed in small parts:
    the same shard files, equal over both views and all four keys; a shard
    of one package loads in the other."""
    monkeypatch.setenv("NSP_S4_FLUSH_GROUPS", "64")
    jcfg, tcfg = cfg_pair()
    tmp = world["tmp"]
    over = tstages.load_native_phase_overrides(str(tmp / "s3_torch"))
    paths = {CONTIG: world["bam"]}
    jex = JaxExtractor(paths, jcfg.haplotype_feature.max_coverage,
                       hp_overrides=over)
    tex = NativeBamExtractor(paths, tcfg.haplotype_feature.max_coverage,
                             hp_overrides=over)
    try:
        jm = jstages.stage_haplotype_features(
            jcfg, world["jref"], world["vcf"], jex, str(tmp / "s4_jax"))
        tm = tstages.stage_haplotype_features(
            tcfg, world["tref"], world["vcf"], tex, str(tmp / "s4_torch"))
    finally:
        jex.close()
        tex.close()
    assert tm == jm and tm["groups"] > 64 and tm["shards"] >= 2
    names = assert_same_npz_dirs(str(tmp / "s4_torch"), str(tmp / "s4_jax"))
    a = jbins.load_haplotype_shard(str(tmp / "s4_torch" / names[0]))
    b = tbins.load_haplotype_shard(str(tmp / "s4_jax" / names[0]))
    for view in ("pileup", "haplotype"):
        for k in tbins._KEYS:
            assert np.array_equal(getattr(a, view)[k], getattr(b, view)[k])
    haps = a.pileup["hap"]
    assert (haps == 1).any() and (haps == 2).any()


def test_extractor_packed_and_list_contracts(world, phased):
    """NativeBamExtractor: the packed [G, D, L] contract of s4 and the
    per-group list contract of the legacy consumers, each equal to the JAX
    package's, and consistent with one another."""
    from nanosnp_tpu.features.haplotype import (build_groups, chunk_groups,
                                                collect_sites)
    from nanosnp_tpu_torch.features import haplotype as thap

    with open(world["vcf"]) as f:
        jsites = collect_sites(f)
    with open(world["vcf"]) as f:
        tsites = thap.collect_sites(f)
    jgroups = build_groups(jsites[CONTIG])
    tgroups = thap.build_groups(tsites[CONTIG])
    assert np.array_equal(jgroups, tgroups) and len(tgroups) > 20
    jchunks, tchunks = chunk_groups(jgroups), thap.chunk_groups(tgroups)
    assert len(jchunks) == len(tchunks)
    assert all(np.array_equal(a, b) for a, b in zip(jchunks, tchunks))
    chunk = tchunks[0]

    over = tstages.load_native_phase_overrides(
        str(world["tmp"] / "s3_torch"))
    paths = {CONTIG: world["bam"]}
    jex = JaxExtractor(paths, hp_overrides=over)
    tex = NativeBamExtractor(paths, hp_overrides=over)
    try:
        jp, tp = jex(CONTIG, chunk, 16, packed=True), \
            tex(CONTIG, chunk, 16, packed=True)
        jl, tl = jex(CONTIG, chunk, 5), tex(CONTIG, chunk, 5)
    finally:
        jex.close()
        tex.close()
    assert np.array_equal(tp["groups"], jp["groups"])
    for view in ("pileup", "haplotype"):
        for k in tbins._KEYS:
            assert np.array_equal(tp["packed"][view][k],
                                  jp["packed"][view][k]), (view, k)
        assert len(tl[view]) == len(jl[view]) == len(tl["groups"])
        for a, b in zip(tl[view], jl[view]):
            for k in tbins._KEYS:
                assert np.array_equal(a[k], b[k]), (view, k)
    # the haplotype view does not depend on the window flank: the packed
    # rows, cut to each group's depth, are the list contract's matrices
    assert np.array_equal(tl["groups"], tp["groups"])
    for g, mats in enumerate(tl["haplotype"]):
        d = mats["sequences"].shape[0]
        for k in tbins._KEYS:
            assert np.array_equal(tp["packed"]["haplotype"][k][g, :d],
                                  mats[k]), k


def test_shard_codec_is_chosen_openly(monkeypatch, tmp_path):
    """zstd where the module exists, deflate where it does not or on
    request; asking for zstd without the module raises."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.delenv("NSP_SHARD_CODEC", raising=False)
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda n, *a: None if n == "zstandard" else real(n, *a))
    assert tbins.shard_codec() == "deflate"
    shard = tbins.PileupShard(
        contig="c", positions=np.arange(3, dtype=np.int64),
        matrix=np.zeros((3, 33, 18), np.int16),
        ref_seqs=np.array([b"A" * 33] * 3), alt_info=np.array([b""] * 3))
    tbins.save_pileup_shard(str(tmp_path / "c.npz"), shard)
    assert (tmp_path / "c.npz").read_bytes()[:2] == b"PK"
    assert len(np.load(str(tmp_path / "c.npz"))["positions"]) == 3
    monkeypatch.setenv("NSP_SHARD_CODEC", "zstd")
    with pytest.raises(RuntimeError, match="zstandard"):
        tbins.shard_codec()
    monkeypatch.setattr(importlib.util, "find_spec", real)
    if real("zstandard") is not None:
        assert tbins.shard_codec() == "zstd"
        monkeypatch.setenv("NSP_SHARD_CODEC", "deflate")
        assert tbins.shard_codec() == "deflate"


def test_legacy_make_groups_bins_equal_the_jax_cli(world, capsys):
    """`legacy-make-groups` through both CLIs on the world's pileup.vcf and
    BAM: every dataset of the HDF5 bins is equal, and the port's `--npz`
    archive holds the same datasets."""
    pytest.importorskip("h5py")
    from nanosnp_tpu.legacy.bins import load_legacy_bin as jload
    from nanosnp_tpu.runtime.cli import main as jax_main
    from nanosnp_tpu_torch.legacy.bins import load_legacy_bin as tload
    from nanosnp_tpu_torch.runtime.cli import main as torch_main

    tmp = world["tmp"]
    args = ["legacy-make-groups", "--pileup-vcf", world["vcf"], "--bam",
            world["bam"], "--contigs", CONTIG]
    assert jax_main(args + ["-o", str(tmp / "lg_jax")]) == 0
    assert torch_main(args + ["-o", str(tmp / "lg_torch")]) == 0
    assert torch_main(args + ["--npz", "-o", str(tmp / "lg_npz")]) == 0
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[0] == printed[1] == printed[2]
    want = jload(str(tmp / "lg_jax" / f"{CONTIG}.bin"))
    assert len(want["position"]) > 50
    for got in (tload(str(tmp / "lg_torch" / f"{CONTIG}.bin")),
                tload(str(tmp / "lg_npz" / f"{CONTIG}.npz")),
                jload(str(tmp / "lg_torch" / f"{CONTIG}.bin"))):
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
