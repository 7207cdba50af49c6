"""The harness is driven by data: a cell, a configuration, a traffic mix,
a limit set and a per-layer metric are files found by name, and
BENCHMARK.json keeps to the contract's shape."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import registry

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_has_the_contract_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s", "train_images_per_s"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_finds_its_files_and_metrics():
    b = bench()
    readers = set(registry.listing()["metrics"])
    for w in b["workloads"]:
        cell = registry.cell(w["name"])
        assert callable(registry.driver(cell.traffic["kind"]).run)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer and {m["name"] for m in cell.per_layer} <= readers
        for m in cell.per_layer:
            assert m["moves"] in names


def test_a_new_cell_is_files_and_entries_only(tmp_path):
    """In a copy of the benchmark: one new configuration, traffic mix,
    limit set and metric, and a cell naming them; the harness finds them
    and no file that was there changed."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    conf = json.loads((ROOT / "benchmark/configs/gif-run8-ffhq256.json").read_text())
    conf["train_config"]["batch_size"] = 32
    (tmp_path / "benchmark/configs/gif-run8-b32.json").write_text(json.dumps(conf))
    spec = json.loads((ROOT / "benchmark/traffic/train-b16.json").read_text())
    (tmp_path / "benchmark/traffic/train-b32.json").write_text(json.dumps(dict(spec, batch=32)))
    (tmp_path / "benchmark/limits/r8-train-b32.json").write_text('{"loss_gap": 1, "grad_gap": 1, "change_gap": 1}')
    (tmp_path / "benchmark/metrics/train.steps.py").write_text("def read(ctx):\n    return ctx.get('steps')\n")
    b["configs"].append({"name": "gif-run8-b32", "source": "x", "file": "benchmark/configs/gif-run8-b32.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "r8-train-b32", "config": "gif-run8-b32", "traffic": "train-b32", "chips": 1,
                           "why": "x"})
    for m in b["end_to_end"]:
        if "workloads" in m and m["name"] == "train_images_per_s":
            m["workloads"].append("r8-train-b32")
    b["per_layer"].append({"name": "train.steps", "unit": "1", "better": "higher", "source": "program_counter",
                           "layer": "x", "moves": "train_images_per_s", "workloads": ["r8-train-b32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    found = registry.listing(tmp_path)
    assert "gif-run8-b32" in found["configs"] and "train-b32" in found["traffic"]
    assert "r8-train-b32" in found["limits"] and "train.steps" in found["metrics"]
    cell = registry.cell("r8-train-b32", tmp_path)
    assert cell.config["train_config"]["batch_size"] == 32 and cell.traffic["batch"] == 32
    assert [m["name"] for m in cell.end_to_end] == ["train_images_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer if m["name"] == "train.steps"] == ["train.steps"]
    assert registry.reader("train.steps", tmp_path)(type("C", (), {"get": lambda self, k: 7})()) == 7
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_an_unknown_workload_or_kind_is_refused():
    with pytest.raises(KeyError):
        registry.cell("no-such-cell")
    for kind in ("no_such_kind", "compare", "../train"):
        with pytest.raises((KeyError, ModuleNotFoundError)):
            registry.driver(kind)


NEW_DRIVER = '''"""A driver of a kind the benchmark did not have: it uses the GPUs the
cell asks for."""


def run(cell, seed, seconds, traced, t_start):
    return {"devices": int(cell.workload["chips"]), "kind": "ranks"}
'''

PROBE = """
import json, time
from benchmark.harness import registry
out = {}
for name in ("r8-train-dp4-b64", "r8-train-b64-on-4"):
    cell = registry.cell(name)
    try:
        out[name] = registry.driver(cell.traffic["kind"]).run(cell, 1, 0.0, False, time.perf_counter())
    except registry.Refused as e:
        out[name] = "refused: " + str(e)
print(json.dumps(out))
"""


def test_a_new_kind_is_a_driver_file_and_the_train_driver_refuses_four_chips(tmp_path):
    """In a copy of the benchmark: a four-chip cell of a new kind, whose
    driver is one new file, runs through it; a four-chip cell of kind
    ``train`` is refused by the train driver, which uses one GPU, before
    any work."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    (tmp_path / "benchmark/harness/ranks.py").write_text(NEW_DRIVER)
    spec = json.loads((ROOT / "benchmark/traffic/train-b16.json").read_text())
    (tmp_path / "benchmark/traffic/train-dp4-b64.json").write_text(json.dumps(dict(spec, kind="ranks")))
    for name in ("r8-train-dp4-b64", "r8-train-b64-on-4"):
        (tmp_path / f"benchmark/limits/{name}.json").write_text("{}")
    b["workloads"] += [
        {"name": "r8-train-dp4-b64", "config": "gif-run8-ffhq256", "traffic": "train-dp4-b64", "chips": 4, "why": "x"},
        {"name": "r8-train-b64-on-4", "config": "gif-run8-ffhq256", "traffic": "train-b16", "chips": 4, "why": "x"},
    ]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["r8-train-dp4-b64"] == {"devices": 4, "kind": "ranks"}
    assert got["r8-train-b64-on-4"].startswith("refused: ") and "asks for 4 GPUs" in got["r8-train-b64-on-4"]
