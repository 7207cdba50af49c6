"""One short traced run of each cell on the card, through the command the
driver runs; skips without a card (the hand-written kernels have no CPU
mode).  On the card:

    python3 -m pytest -q -p no:cacheprovider benchmark/tests/test_benchmark_card.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
                                      if w["chips"] == 1])
def test_a_traced_run_prints_a_sound_line(card, workload):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", str(2**33 + 1),
                          "--seconds", "3", "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    dev = line["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
