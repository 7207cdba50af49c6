"""The port's training CLI, ``python -m gif_tpu_torch.train``, run in a
subprocess on the CPU at the ``--debug`` size (32 px, 32 channels, batch
8): 3 steps, a metrics row every step, FID with the random InceptionV3 at
step 0 and step 2 (the full Fréchet distance, 2048-d square root
included), a final checkpoint, the architecture reports; and the warm
start from a converted checkpoint (``--converted_ckpt``)."""

import csv
import os
import pickle
import subprocess
import sys

import numpy as np
import torch

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
    for net in ("generator", "discriminator"):
        text = (out / f"{net}_run0.txt").read_text()
        assert text.startswith(("StyledGenerator: ", "Discriminator: ")) and "(root)" in text
        assert (out / f"{net}_run0.html").exists()


def test_cli_converted_ckpt_warm_start(tmp_path):
    """``--converted_ckpt`` with a pickle of the JAX package's trees at the
    debug config: the run (0 steps: the final checkpoint holds the state
    it starts from) carries the converted weights, G, EMA and D."""
    import jax

    from gif_tpu.train import get_config as j_get_config
    from gif_tpu.train.state import create_train_state as j_create_train_state
    from gif_tpu_torch.tools.convert_params import convert_discriminator_params, convert_generator_params

    jcfg = j_get_config(0, embedding_vocab_size=64, max_size=32, init_size=32, render_image_size=32,
                        batch_size=8, max_channels=32, nmlp_for_z_to_w=2, compute_dtype="float32")
    jstate = j_create_train_state(jcfg, jax.random.PRNGKey(5))
    trees = {k: jax.tree_util.tree_map(np.asarray, getattr(jstate, k))
             for k in ("g_params", "g_ema_params", "d_params", "buffers")}
    with open(tmp_path / "trees.pkl", "wb") as f:
        pickle.dump(trees, f)
    out = tmp_path / "runs"
    p = _cli("--debug", "--device", "cpu", "--total_iters", "0", "--converted_ckpt", str(tmp_path / "trees.pkl"),
             "--out_dir", str(out), cwd=tmp_path)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "warm-started params from" in p.stdout
    sd = torch.load(out / "0" / "checkpoint" / "000000000.pt", weights_only=True)
    want = {
        "generator": convert_generator_params(trees["g_params"], trees["buffers"]),
        "g_ema": convert_generator_params(trees["g_ema_params"], trees["buffers"]),
        "discriminator": convert_discriminator_params(trees["d_params"]),
    }
    for key, w in want.items():
        assert sorted(sd[key]) == sorted(w)
        for name, t in w.items():
            assert torch.equal(sd[key][name], t), (key, name)
    assert sd["step"] == 0 and sd["used_samples"] == 0


def test_cli_missing_inception_weights_exits_loudly(tmp_path):
    p = _cli("--debug", "--device", "cpu", "--inception_weights", str(tmp_path / "nope.npz"), cwd=tmp_path)
    assert p.returncode != 0 and "does not exist" in p.stderr
    p = _cli("--debug", "--device", "cpu", "--converted_ckpt", str(tmp_path / "nope.pkl"), cwd=tmp_path)
    assert p.returncode != 0 and "--converted_ckpt" in p.stderr and "does not exist" in p.stderr
