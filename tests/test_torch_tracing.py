"""The port's tracing (nanosnp_tpu_torch/utils/profiling.py) on the CPU:
spans and counters recorded only inside a session under a profiler, the
main thread's spans in the trace as `user_annotation` events, worker
threads' spans on the trace's clock, and the bytes the group runner
stages. The profiler is the benchmark's: torch.autograd.profiler.profile
with kineto."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from nanosnp_tpu_torch.config import (HaplotypeModelConfig, OptimConfig,
                                      PileupModelConfig, PipelineConfig,
                                      TrainConfig)
from nanosnp_tpu_torch.io import bins, fasta
from nanosnp_tpu_torch.models.haplotype_model import init_haplotype_params
from nanosnp_tpu_torch.runtime import stages
from nanosnp_tpu_torch.train.group import GroupRunner
from nanosnp_tpu_torch.train.optim import build_optimizer
from nanosnp_tpu_torch.train.train_haplotype import train_haplotype
from nanosnp_tpu_torch.train.train_pileup import train_pileup
from nanosnp_tpu_torch.utils import profiling as P

OPT = dict(lr=1e-4, max_grad_norm=0.2, begin_to_adjust_lr=1,
           decay_ratio=0.5)


@pytest.fixture(autouse=True)
def untraced_before():
    """A session without a profiler first: the next traced one starts
    afresh."""
    with P.session("nsp.test.reset"):
        pass


def traced(tmp_path, fn):
    """fn() under the benchmark's profiler -> (its trace's events, the
    trace's baseTimeNanoseconds)."""
    from torch.autograd import profiler

    with profiler.profile(use_kineto=True) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    return data["traceEvents"], int(data.get("baseTimeNanoseconds", 0))


def annotations(events, prefix="nsp."):
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("ph") == "X" and e["name"].startswith(prefix)]


def contains(event, base, start_ns, end_ns, slack_ns=1_000_000):
    """A trace event (us, from baseTimeNanoseconds) holds [start_ns,
    end_ns] on time.time_ns's clock, give or take `slack_ns`."""
    lo = event["ts"] * 1e3 + base
    return lo - slack_ns <= start_ns and end_ns <= lo + event["dur"] * 1e3 \
        + slack_ns


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_tracing_off_records_nothing_and_calls_no_record_function(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with P.session("nsp.test.root"):
        assert P.span("nsp.test.a") is P.span("nsp.test.b")  # shared, no-op
        with P.span("nsp.test.a"):
            P.count("nsp.test.n", 5)
    snap = P.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}
    assert snap["dropped"] == 0


def _pileup_fit(tmp_path):
    rng = np.random.default_rng(3)
    batches = [(rng.integers(-15, 15, (8, 33, 18)).astype(np.float32),
                rng.integers(0, 21, 8), rng.integers(0, 3, 8))
               for _ in range(5)]
    train_pileup(iter(batches),
                 PileupModelConfig(hidden_size=8, output_size=16,
                                   inner_size=16, n_layers=2, dropout=0.0),
                 TrainConfig(optim=OptimConfig(**OPT), batch_size=8,
                             steps_per_call=2),
                 None, str(tmp_path / "out"), device="cpu",
                 lr_steps_per_epoch=10)
    return len(batches), 3


def _hap_batch(rng, n, depth):
    b = {}
    for pre, seq_len in (("p_", 33), ("h_", 11)):
        for k in ("seq", "baseq", "mapq", "hap"):
            b[pre + k] = rng.integers(-2, 5, (n, depth, seq_len)
                                      ).astype(np.int8)
        b[pre + "ref"] = rng.integers(0, 5, (n, seq_len)).astype(np.int8)
    b["gt"] = rng.integers(0, 10, n).astype(np.int32)
    b["zy"] = rng.integers(0, 3, n).astype(np.int32)
    return b


def _haplotype_fit(tmp_path):
    rng = np.random.default_rng(4)
    batches = [_hap_batch(rng, 8, d) for d in (6, 6, 8, 6, 8)]
    train_haplotype(iter(batches),
                    HaplotypeModelConfig(hidden_size=8, lstm_layers=2,
                                         dropout=0.0),
                    TrainConfig(optim=OptimConfig(**OPT), batch_size=8,
                                steps_per_call=2),
                    None, str(tmp_path / "out"), device="cpu",
                    lr_steps_per_epoch=10)
    return len(batches), 3      # groups: 6 6 | 8 8 | 6 at the end


@pytest.mark.parametrize("fit", [_pileup_fit, _haplotype_fit],
                         ids=["pileup", "haplotype"])
def test_fit_spans_nest_and_land_in_the_trace(tmp_path, fit):
    got = {}
    events, base = traced(tmp_path,
                          lambda: got.update(n=fit(tmp_path)))
    n_batches, n_groups = got["n"]
    snap = P.snapshot()
    spans = snap["spans"]
    names = by_name(spans)
    main = threading.get_native_id()
    assert {s["thread"] for s in spans} == {main} and snap["dropped"] == 0
    (root,) = names["nsp.train.fit"]
    assert root["parent"] is None
    ids = {s["id"]: s for s in spans}
    # one feed a batch and one more that finds the iterator's end
    assert len(names["nsp.train.feed"]) == n_batches + 1
    for top in ("nsp.train.feed", "nsp.train.convert", "nsp.group.run",
                "nsp.train.meter"):
        assert all(s["parent"] == root["id"] for s in names[top]), top
    assert len(names["nsp.group.run"]) == n_groups
    # the host waits for a group's metrics where it meters them, a group
    # late (train/group.py, GroupMetrics)
    for child, parent in (("nsp.group.stage", "nsp.group.run"),
                          ("nsp.group.launch", "nsp.group.run"),
                          ("nsp.group.fetch", "nsp.train.meter")):
        assert len(names[child]) == n_groups
        assert all(ids[s["parent"]]["name"] == parent
                   for s in names[child]), child
    # self time: the duration less the children's, exactly
    kids = {}
    for s in spans:
        if s["parent"] is not None:
            kids[s["parent"]] = kids.get(s["parent"], 0) \
                + s["end_ns"] - s["start_ns"]
    for s in spans:
        assert s["self_ns"] == s["end_ns"] - s["start_ns"] - kids.get(
            s["id"], 0)
    # each span is in the trace, in order, on the trace's clock: its
    # record_function opens before and closes after the recorder's reads
    ann = annotations(events)
    assert sorted(e["name"] for e in ann) == sorted(s["name"] for s in spans)
    for name, mine in names.items():
        theirs = sorted((e for e in ann if e["name"] == name),
                        key=lambda e: e["ts"])
        for s, e in zip(sorted(mine, key=lambda s: s["start_ns"]), theirs):
            assert e["tid"] == main
            assert contains(e, base, s["start_ns"], s["end_ns"])


def _hap_shard_world(tmp_path, rng):
    """A contig and two all-tagged shards at depths 20 and 64 (buckets 32
    and 64) -> (reference, shard dir, expected staged bytes)."""
    length, contig = 4000, "chr7"
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, length))
    fa = str(tmp_path / "ref.fa")
    fasta.write_fasta(fa, {contig: seq})
    shard_dir = tmp_path / "shards"
    shard_dir.mkdir()
    staged = 0
    for depth, n in ((20, 30), (64, 20)):
        pos = np.sort(rng.choice(np.arange(100, length - 100), n,
                                 replace=False)).astype(np.int64)

        def view(seq_len):
            s = rng.integers(0, 5, (n, depth, seq_len)).astype(np.int8)
            return {"sequences": s, "baseq": (s * 7).astype(np.int8),
                    "mapq": (s * 11).astype(np.int16),
                    "hap": (s % 2 + 1).astype(np.int8)}
        bins.save_haplotype_shard(
            str(shard_dir / f"{contig}_d{depth}.npz"),
            bins.HaplotypeShard(contig, pos,
                                pos[:, None] + np.arange(-5, 6)[None] * 3,
                                view(33), view(11)))
        db = bins.depth_bucket(depth)
        # seq, baseq, hap int8 and mapq int16 a padded read, and the codes
        staged += n * (db * 33 * 5 + 33 + db * 11 * 5 + 11)
    return fasta.FastaReference(fa), str(shard_dir), staged


def test_s5_spans_threads_and_staged_bytes(tmp_path, monkeypatch):
    monkeypatch.setenv("NSP_SHARD_CODEC", "deflate")
    rng = np.random.default_rng(8)
    ref, shard_dir, staged = _hap_shard_world(tmp_path, rng)
    cfg = PipelineConfig()
    cfg.haplotype_model = HaplotypeModelConfig(hidden_size=8, lstm_layers=2)
    cfg.inference.batch_size = 16
    cfg.inference.use_bf16 = False
    params = init_haplotype_params(torch.Generator().manual_seed(1),
                                   cfg.haplotype_model)
    out = tmp_path / "out.csv"
    got = {}
    events, _ = traced(tmp_path, lambda: got.update(m=(
        stages.stage_haplotype_predict(cfg, ref, shard_dir, str(out),
                                       params=params, device="cpu"))))
    assert got["m"]["sites"] == 50 and got["m"].get("deferred", 0) == 0
    snap = P.snapshot()
    names = by_name(snap["spans"])
    main = threading.get_native_id()
    (root,) = names["nsp.s5"]
    assert root["parent"] is None and root["thread"] == main
    assert len(names["nsp.s5.load"]) == len(names["nsp.s5.load_wait"]) == 2
    assert len(names["nsp.s5.pool"]) == 2
    assert len(names["nsp.s5.list"]) == len(names["nsp.s5.write"]) == 1
    # 30 + 20 sites at batch 16: a launch a full pool and one a pool left
    assert len(names["nsp.s5.drain"]) == 4 and names["nsp.s5.launch"]
    for s in names["nsp.s5.load"]:      # the loader thread, under the root
        assert s["thread"] != main and s["parent"] == root["id"]
    for name, ss in names.items():
        if name != "nsp.s5.load":
            assert all(s["thread"] == main for s in ss), name
    # the profiler sees the main thread only
    ann = by_name([{"name": e["name"]} for e in annotations(events)])
    assert "nsp.s5.load" not in ann
    assert {k: len(v) for k, v in ann.items()} == {
        k: len(v) for k, v in names.items() if k != "nsp.s5.load"}
    # two deflate shards of 11 members each, read on the reader's pool
    assert snap["counters"] == {"nsp.h2d_bytes": staged,
                                "nsp.shard.members_parallel": 22}


def test_worker_span_lies_on_the_trace_clock(tmp_path, monkeypatch):
    """A worker thread's span, put on the trace's clock through its
    baseTimeNanoseconds, lies within 1 ms inside a main-thread
    record_function that is open all through it, and holds, within 1
    ms, one opened while it is open; maybe_profile writes it into the
    trace it exports."""
    opened, closed = threading.Event(), threading.Event()

    def worker(inner):
        if inner:                       # inside the main thread's mark
            opened.wait()
        with P.span(f"nsp.test.{'inner' if inner else 'outer'}"):
            if inner:
                time.sleep(0.02)
            else:
                opened.set()
                closed.wait()
        if inner:
            closed.set()

    def mark(inner):
        t = threading.Thread(target=worker, args=(inner,),
                             name="nsp-test-worker")
        t.start()
        if not inner:
            opened.wait()
        with torch.profiler.record_function(f"test.{inner}"):
            if inner:
                opened.set()
                closed.wait()
            else:
                time.sleep(0.02)
        if not inner:
            closed.set()
        t.join()
        opened.clear()
        closed.clear()

    def both():
        with P.session("nsp.test.root"):
            mark(True)
            mark(False)

    events, base = traced(tmp_path, both)
    marks = {e["name"]: e for e in events
             if e.get("name", "").startswith("test.")}
    ws = {s["name"]: s for s in P.snapshot()["spans"]}
    w = ws["nsp.test.inner"]
    assert contains(marks["test.True"], base, w["start_ns"], w["end_ns"])
    w, m = ws["nsp.test.outer"], marks["test.False"]
    lo = m["ts"] * 1e3 + base
    assert contains({"ts": (w["start_ns"] - base) / 1e3,
                     "dur": (w["end_ns"] - w["start_ns"]) / 1e3}, base,
                    lo, lo + m["dur"] * 1e3)
    assert not {"nsp.test.inner", "nsp.test.outer"} & {
        e.get("name") for e in events}

    monkeypatch.setenv("NSP_PROFILE_DIR", str(tmp_path / "prof"))
    with P.maybe_profile("stage"):
        both()
    data = json.loads((tmp_path / "prof" / "stage.trace.json").read_text())
    base = int(data.get("baseTimeNanoseconds", 0))
    found = {e.get("name"): e for e in data["traceEvents"]}
    m, w = found["test.True"], found["nsp.test.inner"]
    assert w["tid"] != m["tid"]
    assert contains(m, base, w["ts"] * 1e3 + base,
                    (w["ts"] + w["dur"]) * 1e3 + base)
    assert {"ph": "M", "name": "thread_name", "pid": w["pid"],
            "tid": w["tid"], "args": {"name": "nsp-test-worker"}} \
        in data["traceEvents"]


def test_group_counts_the_bytes_it_stages(tmp_path):
    tx = build_optimizer(OptimConfig(type="adam"))
    w = torch.zeros(5)
    state = type("S", (), {"opt_state": tx.init([w])})()

    def step(batch, row):
        tx.update([w], [batch["x"].sum(0)], state.opt_state, row)
        return {"loss": batch["x"].sum()}

    runner = GroupRunner(step, tx, state, None, torch.device("cpu"), 4)
    batches = [{"x": np.full((3, 5), i, np.float32),
                "y": np.arange(3, dtype=np.int64)} for i in range(3)]

    def group():
        with P.session("nsp.test.root"):
            runner.run(batches)

    traced(tmp_path, group)
    rows = 3 * (batches[0]["x"].nbytes + batches[0]["y"].nbytes)
    assert P.snapshot()["counters"] == {
        "nsp.h2d_bytes": rows + 3 * tx.n_scalars * 4}
