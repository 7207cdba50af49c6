"""The device block's arithmetic on synthetic Chrome traces."""

import json

import pytest

from benchmark.harness import trace


def ev(name, cat, ts, dur, tid=1, **kw):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid, **kw}


def window(ts=100.0, dur=1000.0):
    return ev(trace.WINDOW_RANGE, "user_annotation", ts, dur, tid=7)


def test_union_of_two_threads_and_overlapping_streams():
    events = [
        window(),
        # kernels launched from two host threads, on two streams that overlap
        ev("k_a", "kernel", 200, 100, tid=11, args={"stream": 7}),
        ev("k_b", "kernel", 250, 100, tid=22, args={"stream": 13}),
        ev("copy", "gpu_memcpy", 500, 50, tid=11),
        ev("set", "gpu_memset", 540, 20, tid=22),
    ]
    sl = trace.device_slice(events)
    assert sl.window_s == pytest.approx(1000e-6)
    # [200, 350] + [500, 560]
    assert sl.busy_s == pytest.approx(210e-6)
    assert len(sl.events) == 4


def test_events_straddling_both_edges_are_clipped():
    events = [window(100, 1000), ev("early", "kernel", 50, 100), ev("late", "kernel", 1050, 200),
              ev("outside", "kernel", 2000, 10)]
    sl = trace.device_slice(events)
    # [100, 150] and [1050, 1100]
    assert sl.busy_s == pytest.approx(100e-6)
    assert all(sl.start_us <= s < e <= sl.end_us for s, e, _ in sl.events)


def test_user_annotations_on_the_device_are_left_out():
    events = [window(0, 1000), ev(trace.WINDOW_RANGE, "gpu_user_annotation", 0, 1000),
              ev("Optimizer.step#Adam.step", "gpu_user_annotation", 100, 800), ev("k", "kernel", 300, 100)]
    sl = trace.device_slice(events)
    assert sl.busy_s == pytest.approx(100e-6)
    assert sl.busy_s <= sl.window_s


def test_missing_window_range_raises():
    with pytest.raises(ValueError):
        trace.device_slice([ev("k", "kernel", 0, 10)])


def test_breakdown_names_gaps_by_the_innermost_host_op(tmp_path):
    events = [window(0, 1000), ev("aten::conv", "cpu_op", 0, 900, tid=3), ev("aten::item", "cpu_op", 400, 200, tid=3),
              ev("k1", "kernel", 0, 100), ev("k2", "kernel", 700, 300), ev("k1", "kernel", 100, 50)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    sl = trace.device_slice(trace.load_events(str(path)))
    b = sl.breakdown()
    assert b["device_ops"][0][0] == "k2" and b["device_ops"][1] == ["k1", pytest.approx(150e-6)]
    assert b["idle_gaps"][0] == ["aten::item", pytest.approx(550e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
