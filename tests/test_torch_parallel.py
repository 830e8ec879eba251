"""The port's parallel/launch.py and parallel/mesh.py against the JAX
package's: the LPT contig plan, the host gathers (byte for byte), padding,
the rows P("data") gives each device, and what the functions do with no
process group."""
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from nanosnp_tpu.parallel import launch as jlaunch
from nanosnp_tpu.parallel import mesh as jmesh
from nanosnp_tpu_torch.constants import ALL_CHROMS
from nanosnp_tpu_torch.parallel import launch, mesh

# names in and out of the reference's contig order, lengths with ties
NAMES = ALL_CHROMS[:12] + ["chrUn_1", "ctg7", "ctg10", "chrM"]


def _lengths(seed):
    rng = np.random.default_rng(seed)
    names = rng.choice(NAMES, rng.integers(1, len(NAMES) + 1), replace=False)
    return {str(n): int(rng.choice([500, 1000, 1000, 2500, 7000,
                                    rng.integers(1, 9000)]))
            for n in names}


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 4, 5])
def test_contig_plan_and_host_shares_are_the_jax_ones(n_hosts):
    for seed in range(40):
        lengths = _lengths(seed)
        want = jlaunch.plan_contig_shards(lengths, n_hosts)
        assert launch.plan_contig_shards(lengths, n_hosts) == want
        # the same plan whatever order the lengths come in
        assert launch.plan_contig_shards(
            dict(reversed(list(lengths.items()))), n_hosts) == want
        for h in range(n_hosts):
            assert launch.host_contigs(
                launch.HostPlan(h, n_hosts), lengths) == \
                jlaunch.host_contigs(jlaunch.HostPlan(h, n_hosts, []),
                                     lengths)


def test_tied_lengths_go_by_contig_order():
    lengths = {"chr2": 10, "chr10": 10, "chr1": 10, "chrX": 10}
    assert launch.plan_contig_shards(lengths, 3) == \
        jlaunch.plan_contig_shards(lengths, 3) == \
        [["chr1", "chrX"], ["chr2"], ["chr10"]]


def _host_files(tmp_path, rng):
    """Three hosts' VCFs (header, rows of disjoint contigs in no order) and
    CSVs, host 2's CSV absent."""
    contigs = [["chr3", "chr1"], ["chr10", "chrX"], ["chr2"]]
    vcfs, csvs = [], []
    for h, cs in enumerate(contigs):
        rows = [f"{c}\t{p}\t.\tA\tG\t{q:.2f}\tPASS\tP\tGT:GQ\t0/1:{q:.0f}\n"
                for c in cs for p, q in zip(rng.integers(1, 5000, 6),
                                            rng.random(6) * 60)]
        rng.shuffle(rows)
        vcf = tmp_path / f"host{h}.vcf"
        vcf.write_text("##fileformat=VCFv4.2\n##contig=<ID=chr1>\n"
                       "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\t"
                       "FORMAT\tS\n" + "".join(rows))
        vcfs.append(str(vcf))
        csv = tmp_path / f"host{h}.csv"
        if h < 2:
            csv.write_text("".join(
                f"{c}\t{p}\tA{'ACGT'[p % 4]}\t{p / 7:.1f}\n" for c in cs
                for p in rng.integers(1, 5000, 5)) + "\n")
        csvs.append(str(csv))
    return vcfs, csvs


def test_host_gathers_write_the_jax_bytes(tmp_path):
    vcfs, csvs = _host_files(tmp_path, np.random.default_rng(9))
    for name, port_fn, jax_fn, paths in (
            ("vcf", launch.merge_host_vcfs, jlaunch.merge_host_vcfs,
             vcfs[::-1]),
            ("csv", launch.merge_host_csvs, jlaunch.merge_host_csvs, csvs),
            ("shards", launch.gather_vcf_shards, jlaunch.gather_vcf_shards,
             vcfs)):
        got, want = tmp_path / f"port.{name}", tmp_path / f"jax.{name}"
        n = port_fn(paths, str(got))
        assert n == jax_fn(paths, str(want)) and n > 0
        assert got.read_bytes() == want.read_bytes(), name
    assert not os.path.exists(csvs[2])
    assert launch.merge_host_csvs(csvs, str(tmp_path / "m.csv")) == 20


@pytest.mark.parametrize("shape,multiple,axis", [
    ((7, 3), 4, 0), ((8, 3), 4, 0), ((0, 2), 8, 0), ((5, 6, 2), 4, 1),
    ((1,), 8192, 0)])
def test_pad_to_multiple_is_the_jax_one(shape, multiple, axis):
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape) + 1
    got, n = mesh.pad_to_multiple(x, multiple, axis)
    want, m = jmesh.pad_to_multiple(x, multiple, axis)
    assert n == m and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_shard_rows_are_the_rows_p_data_gives_each_device(world):
    n = 24
    devices = jax.devices("cpu")[:world]
    sharded = jax.device_put(np.arange(n), NamedSharding(
        jmesh.make_mesh(devices), P("data")))
    by_device = {s.device: np.asarray(s.data) for s in
                 sharded.addressable_shards}
    for rank, d in enumerate(devices):
        np.testing.assert_array_equal(
            np.arange(n)[mesh.shard_rows(n, rank, world)], by_device[d])


def test_shard_rows_raises_on_a_batch_the_ranks_cannot_split():
    with pytest.raises(ValueError, match="not divisible by 2"):
        mesh.shard_rows(7, 0, 2)
    with pytest.raises(ValueError, match="not divisible by 3"):
        mesh.shard_rows(512, 1, 3)


def test_unconfigured_initialize_is_one_host_and_starts_no_group(
        monkeypatch):
    for k in ("NSP_COORDINATOR", "NSP_NUM_PROCS", "NSP_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    plan = launch.initialize_distributed()
    want = jlaunch.initialize_distributed()
    assert (plan.host_id, plan.n_hosts) == (want.host_id, want.n_hosts) \
        == (0, 1) and want.contigs == []
    assert launch.host_plan() == plan and mesh.rank() == 0
    assert not dist.is_initialized()
    # one host named explicitly starts no group either
    assert launch.initialize_distributed("127.0.0.1:1", 1, 0).n_hosts == 1
    assert not dist.is_initialized()
    launch.barrier("nothing to wait for")
    launch.shutdown()
    assert launch.local_device(plan, "cpu") == torch.device("cpu")


def test_several_hosts_need_a_coordinator_and_an_id(monkeypatch):
    for k in ("NSP_COORDINATOR", "NSP_NUM_PROCS", "NSP_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        launch.initialize_distributed(None, 2, 0)
    monkeypatch.setenv("NSP_NUM_PROCS", "2")
    monkeypatch.setenv("NSP_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="host id"):
        launch.initialize_distributed()
    assert not dist.is_initialized()


def test_without_a_group_the_collectives_leave_tensors_as_they_are():
    ts = [torch.arange(6.0).reshape(2, 3), torch.ones(4)]
    assert mesh.world() == 1
    for fn in (mesh.all_reduce_sum, mesh.all_reduce_mean):
        out = fn(ts)
        assert all(o is t for o, t in zip(out, ts))
    mesh.broadcast_params(ts)
    assert torch.equal(ts[0], torch.arange(6.0).reshape(2, 3))


def test_all_hosts_reraises_on_one_host():
    with launch.all_hosts("step"):
        pass
    with pytest.raises(KeyError):
        with launch.all_hosts("step"):
            raise KeyError("x")
