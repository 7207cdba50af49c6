"""The port's training CLI, ``python -m gif_tpu_torch.train``, run in a
subprocess on the CPU at the ``--debug`` size (32 px, 32 channels, batch
8): 3 steps, a metrics row every step, FID with the random InceptionV3 at
step 0 and step 2 (the full Fréchet distance, 2048-d square root
included), a final checkpoint."""

import csv
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*args, cwd):
    # Two threads a pool: the tier-1 run shares the machine between six
    # test processes (the 2048-d sqrtm gains little from more).
    threads = {k: "2" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")}
    env = {**os.environ, **threads, "PYTHONPATH": ROOT}
    return subprocess.run(
        [sys.executable, "-m", "gif_tpu_torch.train", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600,
    )


def test_cli_debug_run_on_cpu(tmp_path):
    out = tmp_path / "runs"
    p = _cli("--debug", "--device", "cpu", "--total_iters", "3", "--inception_weights", "random",
             "--fid_every", "2", "--log_every", "1", "--fid_n_samples", "8", "--fid_real_samples", "8",
             "--out_dir", str(out), cwd=tmp_path)
    assert p.returncode == 0, p.stdout + p.stderr
    run = out / "0"  # --run_id defaults to 0, the flagship preset
    with open(run / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["step"] for r in rows] == ["1", "2", "3"]
    for r in rows:
        assert all(np.isfinite(float(r[k])) for k in ("d_loss", "g_loss", "g_total", "interp", "fid")), r
    assert rows[0]["fid"] == rows[1]["fid"] != rows[2]["fid"]
    assert sorted(g[:6] for g in os.listdir(run / "sample" / "0")) == ["000000", "000002"]
    assert os.listdir(run / "checkpoint") == ["000000003.pt"]
    assert os.listdir(out / "fid_stats") == ["ffhq_32X32_fid_stats.npz"]


def test_cli_missing_inception_weights_exits_loudly(tmp_path):
    p = _cli("--debug", "--device", "cpu", "--inception_weights", str(tmp_path / "nope.npz"), cwd=tmp_path)
    assert p.returncode != 0 and "does not exist" in p.stderr
