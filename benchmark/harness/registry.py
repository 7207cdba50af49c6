"""Cells, configurations, traffic mixes, limits and per-layer metrics, found
by name.

``BENCHMARK.json`` at the root of the checkout lists the cells.  Whatever
belongs to one configuration, traffic mix, cell or metric is a file of its
own, found by the name ``BENCHMARK.json`` gives it:

- ``benchmark/configs/<config>.json``: the configuration as it is run;
- ``benchmark/traffic/<traffic>.json``: the traffic mix's parameters;
- ``benchmark/limits/<workload>.json``: the limits of the numbers that
  decide ``correct`` in the cell;
- ``benchmark/metrics/<metric>.py``: a per-layer metric's reader, whose
  ``read(ctx)`` returns the value or None where the run has nothing for it
  to read;
- ``benchmark/harness/<kind>.py``: the driver of every traffic file whose
  ``kind`` it is.

A later cell, configuration, metric or driver is added by adding files
and entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # benchmark/
ROOT = HERE.parent


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metrics(self, traced: bool) -> list:
        return self.per_layer if traced else self.end_to_end


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, with its files
    read.  Raises ``KeyError`` for a name it does not list."""
    bench = load_benchmark(root)
    here = root / "benchmark"
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"BENCHMARK.json lists no workload {name!r}; it has {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(
        workload=w,
        config=_load_json(root / conf["file"]),
        traffic=_load_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(here / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def driver(kind: str):
    """The driver module of a traffic file's ``kind``:
    ``benchmark/harness/<kind>.py``, whose ``run(cell, seed, seconds,
    traced, t_start)`` returns the run's numbers.  A driver for a new kind
    (ranks on several GPUs, say) is a new file there."""
    if not kind.isidentifier():
        raise KeyError(f"no driver for traffic kind {kind!r}")
    mod = importlib.import_module(f"benchmark.harness.{kind}")
    if not callable(getattr(mod, "run", None)):
        raise KeyError(f"benchmark.harness.{kind} is no driver: it has no run()")
    return mod


class Refused(ValueError):
    """A driver cannot run the cell as ``BENCHMARK.json`` states it (on the
    GPUs it asks for, say)."""


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def listing(root: Path = ROOT) -> dict:
    """The names of the configurations, traffic mixes, limit sets and
    metric readers under ``root/benchmark``."""
    here = root / "benchmark"
    return {
        "configs": sorted(p.stem for p in (here / "configs").glob("*.json")),
        "traffic": sorted(p.stem for p in (here / "traffic").glob("*.json")),
        "limits": sorted(p.stem for p in (here / "limits").glob("*.json")),
        "metrics": sorted(p.stem for p in (here / "metrics").glob("*.py")),
    }
