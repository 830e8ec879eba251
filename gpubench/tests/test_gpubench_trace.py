"""The device-idle share as a union of intervals, on a synthetic trace
with two streams whose kernels overlap."""
import pytest

from trace_reduce import WINDOW_SPAN, reduce_events, union


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_union_merges_overlaps():
    assert union([(0, 2), (1, 3), (5, 6), (6, 7)]) == [(0, 3), (5, 7)]


def test_overlapping_streams_count_once():
    events = [ev("user_annotation", WINDOW_SPAN, 0, 1000),
              ev("kernel", "a_kernel", 100, 200),        # stream 1
              ev("kernel", "b_kernel", 200, 200),        # stream 2, overlaps
              ev("gpu_memcpy", "Memcpy HtoD", 600, 100),
              ev("kernel", "c_kernel", 950, 200),        # runs past the end
              ev("cpu_op", "aten::copy_", 700, 250)]
    red = reduce_events(events)
    assert red.window_s == pytest.approx(1000e-6)
    # busy: 100..400, 600..700, 950..1000 -> 450 us of 1000
    assert red.busy_s == pytest.approx(450e-6)
    assert red.idle_share() == pytest.approx(55.0)
    t, n = red.kernel_seconds(["a_kernel", "b_kernel"])
    assert n == 2 and t == pytest.approx(400e-6)
    gaps = red.idle_gaps(2)
    assert gaps[0][0] == "aten::copy_"              # 700..950 under a copy
    assert gaps[0][1] == pytest.approx(250e-6)
    assert gaps[1] == ["no host event", pytest.approx(200e-6)]   # 400..600


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(RuntimeError):
        reduce_events([ev("kernel", "a_kernel", 0, 10)])
