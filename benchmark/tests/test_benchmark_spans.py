"""The readers of the train step's phase spans, on a synthetic slice and a
synthetic span list."""

from types import SimpleNamespace

import pytest

from benchmark.harness import phases, registry
from benchmark.harness.trace import DeviceSlice

IDLE = ["train.render_idle_ms_per_step", "train.g_idle_ms_per_step", "train.d_idle_ms_per_step",
        "train.optim_idle_ms_per_step"]
DEVICE = {"train.g_ms_per_step": ("train.g_forward", "train.g_grads"), "train.d_ms_per_step": ("train.d_grads",),
          "train.optim_ms_per_step": ("train.d_adam", "train.g_adam", "train.ema")}


def read(name, **numbers):
    return registry.reader(name)(SimpleNamespace(get=lambda k, d=None: numbers.get(k, d)))


def step_ops(t0, cuts):
    """One step's host ranges from ``t0``: the phases back to back with
    the durations ``cuts`` (render, G forward, D, D's Adam, G, G's Adam,
    EMA), inside a ``train.step`` range."""
    names = ["train.render", "train.g_forward", "train.d_grads", "train.d_adam", "train.g_grads",
             "train.g_adam", "train.ema"]
    ops, t = [], t0
    for name, d in zip(names, cuts):
        ops.append((t, t + d, name))
        t += d
    return [(t0, t, "train.step")] + ops, t


def two_step_slice():
    """Two steps from 100 to 1500 us in a window of 0 to 2000, with
    aten ops inside the phases and device events that leave gaps across
    phase edges, before the first step and after the last."""
    ops1, end1 = step_ops(100, [50, 100, 200, 30, 200, 30, 20])  # ends at 730
    ops2, end2 = step_ops(800, [50, 100, 200, 30, 200, 30, 20])  # ends at 1430
    host = ops1 + ops2 + [(160, 240, "aten::conv"), (900, 950, "aten::empty_strided")]
    events = [(120, 140, "k"), (200, 400, "k"), (380, 600, "k2"), (640, 700, "k"), (820, 900, "k"),
              (1000, 1200, "k"), (1300, 1450, "k"), (1600, 1700, "memcpy")]
    return DeviceSlice(0.0, 2000.0, events=events, host_ops=host), (end1, end2)


def test_idle_readers_and_the_remainder_sum_to_the_idle_time():
    sl, _ = two_step_slice()
    per_step = [read(name, slice=sl) for name in IDLE]
    got = phases.idle_us_by_phase(sl)
    assert got["steps"] == 2 and all(v is not None and v >= 0 for v in per_step)
    idle_s = sum(per_step) * 2 / 1e3 + got["remainder"] / 1e6
    assert idle_s == pytest.approx(sl.window_s - sl.busy_s, abs=1e-9)


def test_a_gap_across_two_phases_is_split_between_them():
    # One step: render [0, 100), G forward [100, 300), D [300, 600), the
    # rest 10 us each; one idle gap from 50 to 450 crosses three phases.
    ops, end = step_ops(0, [100, 200, 300, 10, 10, 10, 10])
    sl = DeviceSlice(0.0, float(end), events=[(0, 50, "k"), (450, end, "k")], host_ops=ops)
    assert read("train.render_idle_ms_per_step", slice=sl) == pytest.approx(50e-3)
    assert read("train.g_idle_ms_per_step", slice=sl) == pytest.approx(200e-3)
    assert read("train.d_idle_ms_per_step", slice=sl) == pytest.approx(150e-3)
    assert read("train.optim_idle_ms_per_step", slice=sl) == 0.0
    assert phases.idle_us_by_phase(sl)["remainder"] == pytest.approx(0.0)


def test_idle_before_after_and_between_steps_is_the_remainder():
    sl, (end1, end2) = two_step_slice()
    got = phases.idle_us_by_phase(sl)
    # Outside the steps: [0, 100) before, [730, 800) between (gap from 700
    # to 820: 730-800 outside), [1450, 1600) and [1700, 2000) after.
    assert got["remainder"] == pytest.approx(100 + (800 - end1) + 150 + 300)


def span(name, ms=None, mallocs=None):
    return SimpleNamespace(name=name, device_ms=ms, counters={} if mallocs is None else {"cuda_mallocs": mallocs})


def test_device_time_readers_divide_by_the_steps(monkeypatch):
    from gif_tpu_torch.utils import profiling

    recs = []
    for i in range(4):
        recs += [span("train.step", 100.0, mallocs=i), span("train.render", 1.0), span("train.g_forward", 10.0),
                 span("train.d_grads", 30.0 if i else 90.0), span("train.d_adam", 2.0)]
        recs += [span("train.g_grads", 20.0), span("train.g_adam", 2.0), span("train.ema", 1.0)] * (2 if i else 1)
    monkeypatch.setattr(profiling, "spans", lambda: list(recs))
    assert read("train.g_ms_per_step") == pytest.approx((10 * 4 + 20 * 7) / 4)
    assert read("train.d_ms_per_step") == pytest.approx((90 + 30 * 3) / 4)
    assert read("train.optim_ms_per_step") == pytest.approx((2 * 4 + 3 * 7) / 4)
    assert read("train.cuda_mallocs_per_step") == pytest.approx(1.5)


@pytest.mark.parametrize("name", sorted(DEVICE) + ["train.cuda_mallocs_per_step"] + IDLE)
def test_readers_give_none_without_spans(name, monkeypatch):
    from gif_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: [])
    bare = DeviceSlice(0.0, 100.0, events=[(10, 20, "k")], host_ops=[(0, 100, "aten::mm")])
    assert read(name, slice=bare) is None and read(name) is None
    # A program that records no device times (the CPU) or has no span
    # function at all (an earlier version).
    monkeypatch.setattr(profiling, "spans", lambda: [span("train.step"), span("train.g_forward"),
                                                     span("train.d_grads"), span("train.d_adam")])
    if name in DEVICE or name == "train.cuda_mallocs_per_step":
        assert read(name) is None
    monkeypatch.delattr(profiling, "spans")
    assert read(name, slice=bare) is None
