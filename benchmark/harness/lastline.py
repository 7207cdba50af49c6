"""The result line: built, checked against the contract, printed.

A run prints one JSON object as the last line of its standard output.
Before it does, :func:`check` holds the line to the contract; a line that
fails is never printed: the run exits non-zero with the reason.  The
numbers that decided ``correct`` are printed beside their limits as the
last lines of standard error, and in the line under ``checks``, its last
key.
"""

from __future__ import annotations

import json
import math
import sys


class LineError(ValueError):
    """The result line breaks the contract."""


def _number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool) and math.isfinite(x)


def check(line: dict, names: list, units: dict, traced: bool, count: int) -> None:
    """Raise :class:`LineError` unless ``line`` holds ``correct``,
    ``attempted``, ``failed``, every metric in ``names`` with a finite
    value and its unit, and a device block whose count (the GPUs the driver
    used) is the cell's ``count`` -- with, in a
    traced run, ``window_s`` > 0, ``0 < busy_s <= window_s`` and at least
    one device event in the slice."""
    if not isinstance(line.get("correct"), bool):
        raise LineError("correct is not a boolean")
    for key in ("attempted", "failed"):
        if not isinstance(line.get(key), int) or line[key] < 0:
            raise LineError(f"{key} is not a count")
    metrics = line.get("metrics", {})
    for name in names:
        m = metrics.get(name)
        if not isinstance(m, dict) or not _number(m.get("value")) or m.get("unit") != units[name]:
            raise LineError(f"metric {name} has no finite value with unit {units[name]!r}: {m!r}")
    extra = set(metrics) - set(names)
    if extra:
        raise LineError(f"metrics not defined for this run: {sorted(extra)}")
    dev = line.get("device", {})
    if dev.get("platform") != "gpu" or not dev.get("kind") or dev.get("count") != count:
        raise LineError(f"device block names no {count} GPU(s): {dev!r}")
    if not isinstance(dev.get("memory_peak_bytes"), int) or dev["memory_peak_bytes"] <= 0:
        raise LineError("memory_peak_bytes is not a positive count")
    if traced:
        w, b = dev.get("window_s"), dev.get("busy_s")
        if not (_number(w) and w > 0):
            raise LineError(f"window_s is not above 0: {w!r}")
        if not (_number(b) and 0 < b <= w):
            raise LineError(f"busy_s {b!r} is not above 0 and at most window_s {w!r}")
        if not line.get("device_events"):
            raise LineError("the traced slice holds no device event")
        for key in ("device_ops", "idle_gaps"):
            rows = line.get("breakdown", {}).get(key, [])
            if len(rows) > 10 or any(not (isinstance(r[0], str) and _number(r[1])) for r in rows):
                raise LineError(f"breakdown.{key} is not at most 10 [name, seconds] rows")
    checks = line.get("checks")
    if not checks or list(line)[-1] != "checks":
        raise LineError("the compared numbers are not the line's last key")


def emit(line: dict) -> None:
    """Print the compared numbers to standard error, then the line."""
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
