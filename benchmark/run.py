"""Run one cell of the benchmark once:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, on a machine
with the GPUs the cell asks for.  Set-up (the program's build, weights,
warm-up) counts as ``setup_s``; then the window runs for ``--seconds``.
With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the device block's ``busy_s`` and
``window_s`` read from the profiler's trace of a slice after the window.
Once the window has closed, the program's outputs are compared with the
plain reference, which decides ``correct``.

The last line of standard output is one JSON object; a line that breaks
the contract is never printed (the run exits non-zero with the reason).
Without the GPUs, or with JAX, Flax or the JAX package loaded in the
process, the run exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402

from benchmark.harness import env, lastline, registry  # noqa: E402


class Context:
    """What a per-layer metric's reader reads: the run's numbers (spans,
    counters, the traced slice, the FLOP counts) as the driver left them."""

    def __init__(self, numbers: dict):
        self.__dict__.update(numbers)

    def get(self, key, default=None):
        return self.__dict__.get(key, default)


def result_line(cell, numbers: dict, traced: bool, kind: str) -> dict:
    """The line of one run: with ``traced`` the per-layer metrics, each from
    its reader; else the end-to-end ones, as the driver took them.  The
    device count is that of the GPUs the driver used."""
    metrics = {}
    for m in cell.metrics(traced):
        if traced:
            value = registry.reader(m["name"])(Context(numbers))
        else:
            value = numbers["end_to_end"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    line = {
        "correct": bool(numbers["correct"]),
        "attempted": int(numbers["attempted"]),
        "failed": int(numbers["failed"]),
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": kind, "count": int(numbers["devices"]),
                   "memory_peak_bytes": int(numbers["memory_peak_bytes"])},
        "card": env.card_power_limit(),
    }
    if traced:
        sl = numbers["slice"]
        line["device"]["busy_s"] = sl.busy_s
        line["device"]["window_s"] = sl.window_s
        line["device_events"] = len(sl.events)
        line["breakdown"] = sl.breakdown()
    line["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in numbers["checks"].items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    env.pin_caches()
    cell = registry.cell(a.workload)
    count = int(cell.workload["chips"])
    try:
        env.require_cards(count)
    except env.NoCard as e:
        print(f"benchmark: no run: {e}", file=sys.stderr)
        return 3
    import torch

    try:
        numbers = registry.driver(cell.traffic["kind"]).run(cell, a.seed, a.seconds, bool(a.trace), T_START)
    except registry.Refused as e:
        print(f"benchmark: no run: {e}", file=sys.stderr)
        return 6
    found = env.forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {found}; no result", file=sys.stderr)
        return 4
    print("benchmark: " + ", ".join(f"{k} {numbers[k]!r}" for k in (
        "setup_s", "window_s", "attempted", "failed", "reference_s", "setup_marks", "cycle_ends")
        if k in numbers), file=sys.stderr)
    for name, c in numbers["checks"].items():
        print(f"compared {name}: {c['value']!r} at {c['where']} (limit {c['limit']!r})", file=sys.stderr)
    line = result_line(cell, numbers, bool(a.trace), torch.cuda.get_device_name(0))
    names = [m["name"] for m in cell.metrics(bool(a.trace))]
    units = {m["name"]: m["unit"] for m in cell.metrics(bool(a.trace))}
    try:
        lastline.check(line, names, units, bool(a.trace), count)
    except lastline.LineError as e:
        print(f"benchmark: the result line breaks the contract: {e}", file=sys.stderr)
        print(f"benchmark: refused line: {line}", file=sys.stderr)
        return 5
    lastline.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
