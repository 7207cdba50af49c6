"""The traffic generator: the same seed gives the same traffic, another
seed other traffic."""

import json
from pathlib import Path

import numpy as np
import torch

from benchmark.harness import traffic

HERE = Path(__file__).resolve().parents[1]


def spec(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def ring(seed, interp=True):
    s = dict(spec("train-b16"), ring=3, batch=6)
    return traffic.train_ring(s, seed, "cpu", 16, 100, interp)


def flat(r):
    return [t.numpy() if torch.is_tensor(t) else np.asarray(t)
            for e in r for part in (e["batch"], e["draws"]) for t in part.values()]


def test_train_ring_is_deterministic_per_seed():
    for a, b in zip(flat(ring(2**40 + 1)), flat(ring(2**40 + 1))):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(flat(ring(1)), flat(ring(2))))


def test_train_rows_all_differ_and_follow_the_spec():
    r = ring(5)
    flame = torch.cat([e["batch"]["flame"] for e in r])
    assert len({tuple(row.tolist()) for row in flame}) == flame.shape[0]
    assert torch.all(flame[:, 156] == 8.0) and torch.all(flame[:, 209:212] == 3.0)
    assert torch.all(flame[:, 100:150] == 0.0)
    for e in r:
        assert 0.0 <= e["draws"]["interp_t"] < 1.0
        assert len(e["draws"]["interp_pairs"]) == 5


def test_half_rows_keep_the_first_rows():
    s = dict(spec("train-b16"), ring=2, batch=6)
    full = traffic.train_ring(s, 9, "cpu", 16, 100, False)
    half = traffic.train_ring(s, 9, "cpu", 16, 100, False, rows=slice(0, 3))
    torch.testing.assert_close(half[1]["batch"]["flame"], full[1]["batch"]["flame"][:3])
