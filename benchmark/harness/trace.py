"""Reduce a profiler's Chrome trace to the device block and the breakdown.

The traced slice of a run is marked by a ``record_function`` range that
the harness opens and closes in its own thread (:data:`WINDOW_RANGE`).
Its duration on the trace's own clock is ``window_s``.  ``busy_s`` is the
length of the union of every device activity of the process -- the
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events of every stream,
whichever host thread launched them -- clipped to that range.  The
``gpu_user_annotation`` ranges the profiler also lays on the device
timeline span kernels that have events of their own and are left out.
"""

from __future__ import annotations

import gzip
import json
from dataclasses import dataclass, field

WINDOW_RANGE = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclass
class DeviceSlice:
    """What the traced slice holds: its clock range (microseconds) and its
    device events as (start, end, name), clipped to it."""

    start_us: float
    end_us: float
    events: list = field(default_factory=list)
    host_ops: list = field(default_factory=list)  # (start, end, name) of host ops

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device events' intervals, as sorted disjoint
        (start, end) pairs."""
        out = []
        for s, e, _ in sorted(self.events):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(iv) for iv in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def time_of(self, match) -> float:
        """Seconds of device time of the events whose name ``match``
        accepts (summed, overlaps counted twice)."""
        return sum(e - s for s, e, name in self.events if match(name)) / 1e6

    def breakdown(self) -> dict:
        """The device ops that took most time, and the longest idle gaps
        named by the innermost host op that spans each gap's middle."""
        by_op = {}
        for s, e, name in self.events:
            by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        gaps, prev = [], self.start_us
        for s, e in self.busy_intervals() + [(self.end_us, self.end_us)]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        idle = []
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            spans = [(e - s, name) for s, e, name in self.host_ops if s <= mid <= e]
            label = min(spans)[1] if spans else "host outside profiled ops"
            idle.append([label, (g1 - g0) / 1e6])
        return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": idle}


def load_events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def device_slice(events: list, window_name: str = WINDOW_RANGE) -> DeviceSlice:
    """The slice marked by the host range ``window_name`` (the first one
    in the trace), with every device event clipped to it.  Raises when the
    range is missing."""
    marks = [e for e in events if e.get("ph") == "X" and e.get("name") == window_name
             and e.get("cat") != "gpu_user_annotation"]
    if not marks:
        raise ValueError(f"the trace holds no host range {window_name!r}")
    mark = min(marks, key=lambda e: float(e["ts"]))
    t0 = float(mark["ts"])
    t1 = t0 + float(mark["dur"])
    sl = DeviceSlice(t0, t1)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            s, t = max(s, t0), min(t, t1)
            if t > s:
                sl.events.append((s, t, e.get("name", "?")))
        elif cat in ("cpu_op", "user_annotation", "python_function") and e is not mark:
            if t > t0 and s < t1:
                sl.host_ops.append((s, t, e.get("name", "?")))
    return sl
