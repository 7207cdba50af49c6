"""The result line's self-check refuses what the contract refuses."""

import copy

import pytest

from benchmark.harness import lastline

UNITS = {"a": "ms"}


def good(traced=True):
    line = {"correct": True, "attempted": 10, "failed": 0, "metrics": {"a": {"value": 1.5, "unit": "ms"}},
            "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1, "memory_peak_bytes": 10}}
    if traced:
        line["device"].update(busy_s=0.5, window_s=1.0)
        line["device_events"] = 3
        line["breakdown"] = {"device_ops": [["k", 0.1]], "idle_gaps": [["aten::item", 0.01]]}
    line["checks"] = {"x": {"value": 0.0, "limit": 1.0}}
    return line


def check(line, traced=True):
    lastline.check(line, ["a"], UNITS, traced, 1)


def test_a_good_line_passes():
    check(good())
    check(good(False), traced=False)


@pytest.mark.parametrize("busy", [0.0, -1.0, 1.5, float("nan"), None])
def test_busy_outside_zero_to_window_is_refused(busy):
    line = good()
    line["device"]["busy_s"] = busy
    with pytest.raises(lastline.LineError):
        check(line)


@pytest.mark.parametrize("mutate", [
    lambda l: l["device"].update(window_s=0.0),
    lambda l: l.update(device_events=0),
    lambda l: l["metrics"].pop("a"),
    lambda l: l["metrics"]["a"].update(unit="s"),
    lambda l: l["metrics"]["a"].update(value=float("inf")),
    lambda l: l["device"].update(count=4),
    lambda l: l["device"].update(platform="cpu"),
    lambda l: l.update(correct="yes"),
    lambda l: l.update(checks=l.pop("checks"), extra=1),
    lambda l: l["breakdown"].update(device_ops=[["k", 1.0]] * 11),
])
def test_other_breaches_are_refused(mutate):
    line = copy.deepcopy(good())
    mutate(line)
    with pytest.raises(lastline.LineError):
        check(line)
