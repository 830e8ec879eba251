"""Multi-host launch and work partitioning on torch.distributed.

Counterpart of nanosnp_tpu/parallel/launch.py. The JAX package runs one
process a host over a mesh of the host's chips; the port runs one process
a GPU: rank r of the process group is a "host" in the JAX sense and works
on cuda:(r % local device count), or on the CPU under `--device cpu`. The
backend is gloo with TCP rendezvous at the coordinator's host:port: it
runs two ranks on one GPU (NCCL refuses that), and takes CUDA tensors in
`all_reduce` and `broadcast`; every other collective here works on CPU
tensors.

  - a deterministic contig -> host assignment balanced by contig length
    (longest-processing-time greedy), so every host computes the same
    plan without communication (the reference's GNU-parallel contig
    fan-out, scripts/s3_phasing_long_reads.sh:35-69);
  - the final VCF is a host gather: each host writes its own outputs,
    host 0 merges them in contig order (decode/sort ordering).
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..constants import contig_sort_key
from ..device import resolve_device
from .mesh import rank, world

# a collective waits this long for its peers before it raises: longer than
# a host's share of a genome takes, so only a dead peer reaches it
TIMEOUT = timedelta(hours=6)


@dataclass
class HostPlan:
    host_id: int
    n_hosts: int


def plan_contig_shards(
    contig_lengths: Dict[str, int],
    n_hosts: int,
) -> List[List[str]]:
    """LPT-greedy assignment of contigs to hosts, deterministic across
    hosts (ties broken by contig order)."""
    items = sorted(contig_lengths.items(),
                   key=lambda kv: (-kv[1], contig_sort_key(kv[0])))
    loads = [0] * n_hosts
    shards: List[List[str]] = [[] for _ in range(n_hosts)]
    for name, length in items:
        h = min(range(n_hosts), key=lambda i: (loads[i], i))
        loads[h] += length
        shards[h].append(name)
    for s in shards:
        s.sort(key=contig_sort_key)
    return shards


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> HostPlan:
    """Join the gloo process group (nothing on a single host) -> this
    process's HostPlan. Arguments left None come from the environment, as
    in production launchers: NSP_COORDINATOR (host:port), NSP_NUM_PROCS,
    NSP_PROC_ID. A group already joined is kept."""
    if dist.is_initialized():
        return host_plan()
    coordinator_address = coordinator_address or os.environ.get(
        "NSP_COORDINATOR")
    num_processes = num_processes or int(
        os.environ.get("NSP_NUM_PROCS", "0")) or 1
    process_id = (process_id if process_id is not None
                  else int(os.environ.get("NSP_PROC_ID", "-1")))
    if num_processes <= 1:
        return HostPlan(0, 1)
    if not coordinator_address or not 0 <= process_id < num_processes:
        raise ValueError(
            f"{num_processes} hosts need a coordinator host:port and a host "
            f"id in [0, {num_processes}) (--coordinator / --host-id, or "
            f"NSP_COORDINATOR / NSP_PROC_ID); got {coordinator_address!r}, "
            f"{process_id}")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    return HostPlan(process_id, num_processes)


def host_plan() -> HostPlan:
    """This process's HostPlan in the group already joined (HostPlan(0, 1)
    without one)."""
    return HostPlan(rank(), world())


def shutdown() -> None:
    """Leave the process group (nothing if none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_device(plan: HostPlan, device="cuda") -> torch.device:
    """This rank's device: cuda:(rank % local GPU count) for "cuda" across
    several hosts (made the current device), else `device` as
    device.resolve_device reads it; raises on "cuda" without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and plan.n_hosts > 1 \
            and torch.cuda.is_available():
        dev = torch.device("cuda", plan.host_id % torch.cuda.device_count())
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def host_contigs(plan: HostPlan, contig_lengths: Dict[str, int]) -> List[str]:
    shards = plan_contig_shards(contig_lengths, plan.n_hosts)
    return shards[plan.host_id]


def barrier(name: str = "nsp_barrier") -> None:
    """Cross-host synchronization point (no-op single host): the
    reference's implicit barrier of `wait`-ing for GNU parallel jobs
    (scripts/s3_phasing_long_reads.sh:35-69). A peer that never comes
    raises after TIMEOUT, with the barrier's name."""
    if world() > 1:
        try:
            dist.barrier()
        except RuntimeError as e:
            raise RuntimeError(f"{name}: {e}") from e


def _failed_hosts(ok: bool) -> List[int]:
    """Each host passes whether its own work succeeded and gets the ids of
    the hosts whose work did not: an all_gather of one flag a host (on CPU
    tensors, as gloo asks), so a barrier too."""
    flags = [torch.zeros(1, dtype=torch.int32) for _ in range(world())]
    dist.all_gather(flags, torch.tensor([0 if ok else 1], dtype=torch.int32))
    return [h for h, f in enumerate(flags) if int(f)]


@contextmanager
def all_hosts(name: str):
    """Run the block on every host, then wait for all of them. A host whose
    block raised tells its peers and re-raises; the others raise
    RuntimeError naming it. So one host's failure fails every host at
    once (it does not leave them waiting until TIMEOUT), and none goes on
    past this point alone. Nothing more than the block on a single host."""
    if world() <= 1:
        yield
        return
    try:
        yield
    except BaseException:
        _failed_hosts(False)
        raise
    bad = _failed_hosts(True)
    if bad:
        raise RuntimeError(f"{name}: host(s) {bad} failed")


def merge_host_vcfs(host_paths: Sequence[str], output_path: str) -> int:
    """Merge per-host VCFs (disjoint contig sets) into one contig-ordered
    VCF. Host files may arrive in any order; rows are re-sorted by
    (contig order, position), the reference's sortvcf.py semantics.
    Returns body row count."""
    from ..decode.sort import sort_vcf_lines

    lines: list = []
    for path in host_paths:
        with open(path) as f:
            lines.extend(f)
    out_lines = sort_vcf_lines(lines)
    with open(output_path, "w") as out:
        out.writelines(out_lines)
    return sum(1 for l in out_lines if not l.startswith("#"))


def merge_host_csvs(host_paths: Sequence[str], output_path: str) -> int:
    """Merge per-host haplotype CSVs (`ctg\\tpos\\t...` rows, no header)
    into contig order; a host file that is absent is skipped."""
    rows = []
    for path in host_paths:
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                cols = line.split("\t", 2)
                rows.append(((contig_sort_key(cols[0]), int(cols[1])), line))
    rows.sort(key=lambda kv: kv[0])
    with open(output_path, "w") as out:
        for _, line in rows:
            out.write(line)
    return len(rows)


def gather_vcf_shards(
    shard_paths: Sequence[str],
    output_path: str,
    header_from: Optional[str] = None,
) -> int:
    """Concatenate per-contig VCF shards in contig order, keeping one
    header. Returns total body rows."""
    rows = 0
    wrote_header = False
    with open(output_path, "w") as out:
        for path in shard_paths:
            with open(path) as f:
                for line in f:
                    if line.startswith("#"):
                        if not wrote_header:
                            out.write(line)
                        continue
                    out.write(line)
                    rows += 1
            wrote_header = True
    return rows
