"""The readers of the program's spans and counters on synthetic traces:
a device idle share inside the named spans, exact, and None where the
spans or the counter are absent."""
import pytest

import harness
from trace_reduce import WINDOW_SPAN, Reduced

IDLE = {"feed_idle.train": ["nsp.train.feed"],
        "staging_idle.train": ["nsp.train.convert", "nsp.group.stage"],
        "load_idle.infer": ["nsp.s5.load_wait"],
        "host_idle.infer": ["nsp.s5.list", "nsp.s5.pool", "nsp.s5.drain",
                            "nsp.s5.write"]}
COUNTED = {"h2d_bytes.train": "samples", "h2d_bytes.infer": "model_rows"}


class Ctx:
    def __init__(self, trace, window=None):
        self.trace, self.window = trace, window or {}


def trace(spans):
    """A 100-s window with the device busy over 10..20 and 30..60, and
    `spans` [(name, start, end)] on the host; a span beyond the window
    counts only inside it."""
    device = [("k1", 10.0, 20.0), ("k2", 30.0, 50.0), ("k3", 45.0, 60.0)]
    host = [(WINDOW_SPAN, 0.0, 100.0), ("aten::copy_", 5.0, 95.0)] + spans
    return Reduced(device, host, (0.0, 100.0))


@pytest.mark.parametrize("metric", sorted(IDLE))
def test_idle_share_inside_the_spans(metric):
    read = harness.load_module("metrics", metric).read
    names = IDLE[metric]
    # the first name over 0..15 and 55..70, the last over 12..40 and
    # 90..110 (the same name where there is one): their union 0..40,
    # 55..70, 90..100 is idle for 20 + 10 + 10 s of the 100
    spans = [(names[0], 0.0, 15.0), (names[0], 55.0, 70.0),
             (names[-1], 12.0, 40.0), (names[-1], 90.0, 110.0),
             ("nsp.other", 60.0, 100.0)]
    assert read(Ctx(trace(spans))) == pytest.approx(40.0)
    assert read(Ctx(trace([("nsp.other", 0.0, 100.0)]))) is None


def test_idle_share_of_overlapping_names_counts_once():
    read = harness.load_module("metrics", "host_idle.infer").read
    spans = [("nsp.s5.pool", 0.0, 30.0), ("nsp.s5.drain", 5.0, 35.0)]
    # 0..35 less busy 10..20 and 30..35
    assert read(Ctx(trace(spans))) == pytest.approx(20.0)


@pytest.mark.parametrize("metric", sorted(COUNTED))
def test_bytes_a_row_from_the_counter(metric, monkeypatch):
    from nanosnp_tpu_torch.utils import profiling

    read = harness.load_module("metrics", metric).read
    ctx = Ctx(trace([]), {COUNTED[metric]: 4000, "samples": 4000,
                          "model_rows": 4000})
    monkeypatch.setattr(profiling, "snapshot", lambda: {
        "counters": {"nsp.h2d_bytes": 9_520_000}})
    assert read(ctx) == 2380.0
    monkeypatch.setattr(profiling, "snapshot", lambda: {"counters": {}})
    assert read(ctx) is None
    monkeypatch.delattr(profiling, "snapshot")     # a program without it
    assert read(ctx) is None
