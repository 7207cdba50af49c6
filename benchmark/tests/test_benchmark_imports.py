"""Nothing the benchmark runs loads JAX, Flax or the JAX package
(compared by whole top-level name: ``gif_tpu_torch`` is not ``gif_tpu``),
and the reference loads nothing of the measured program."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "gif_tpu"}

RUN_ALL = """
import importlib, pkgutil, sys, time
import torch
torch.set_num_threads(2)
import benchmark, benchmark.harness, benchmark.reference
for pkg in (benchmark, benchmark.harness, benchmark.reference):
    for m in pkgutil.iter_modules(pkg.__path__):
        if m.name != "tests":
            importlib.import_module(pkg.__name__ + "." + m.name)
from benchmark.harness import registry
for name in registry.listing()["metrics"]:
    registry.reader(name)
TINY = dict(max_size=32, init_size=32, render_image_size=32, max_channels=16, nmlp_for_z_to_w=2,
            compute_dtype="bfloat16", embedding_vocab_size=16)
MESH = {"seed": 1, "n_vertices": 503}
cell = registry.cell("r0-train-b16")
cell.traffic = dict(cell.traffic, batch=4, ring=2)
registry.driver(cell.traffic["kind"]).run(cell, 5, 0.5, False, time.perf_counter(), device="cpu", overrides=TINY,
                                          mesh=MESH)
print(sorted({m.split(".", 1)[0] for m in sys.modules}))
"""

REFERENCE_ONLY = """
import json, sys
import torch
torch.set_num_threads(2)
from benchmark.reference import resources, train
from benchmark.harness import traffic
from benchmark.harness.weights import module_shapes, seeded_weights
cfg = dict(json.load(open("benchmark/configs/gif-run0-ffhq256.json"))["train_config"], max_size=32, init_size=32,
           render_image_size=32, max_channels=16, nmlp_for_z_to_w=2, embedding_vocab_size=16)
res = resources.synthetic_flame_resources(seed=1, n_vertices=503)
g, d = seeded_weights(*(module_shapes(m) for m in train.build_models(cfg)), 3, "cpu")
spec = dict(json.load(open("benchmark/traffic/train-b16.json")), batch=4, ring=1)
entry = traffic.train_ring(spec, 3, "cpu", 32, 16, True)[0]
train.ReferenceTrainer(cfg, res, g, d, "cpu").step(entry["batch"], entry["draws"], cfg["r1_interval"] - 1)
print(sorted({m.split(".", 1)[0] for m in sys.modules}))
"""


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = loaded(RUN_ALL)
    assert "gif_tpu_torch" in mods and "benchmark" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = loaded(REFERENCE_ONLY)
    assert not mods & (FORBIDDEN | {"gif_tpu_torch"})


def test_the_reference_sources_import_no_program_module():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".", 1)[0] not in FORBIDDEN | {"gif_tpu_torch"}, f"{path.name} imports {n}"
