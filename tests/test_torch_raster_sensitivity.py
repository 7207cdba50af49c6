"""The renderer's rasterizer switch and the renderer-numerics experiment
(``gif_tpu_torch.scripts.raster_sensitivity``) on the CPU.

- ``render_tex_and_normal(raster_backend="plain")`` equals ``"auto"`` bit
  for bit on CPU tensors, values and gradients; ``"cuda"`` on CPU tensors
  and unknown values raise, also through ``GIF_TPU_TORCH_RASTER``, which
  overrides the argument.
- ``read_losses`` / ``mean_abs_diff`` equal JAX's on fixture CSVs.
- The arms: their commands (deterministic, with cuBLAS's workspace set
  for the child), each arm's ``GIF_TPU_TORCH_RASTER``, the
  reuse of completed arms and ``--max_ratio``, with the trainer replaced
  by a writer of fixture CSVs; then one real run of the three arms
  (``--debug --iters 2 --log_every 1 --device cpu``), whose divergence is
  exactly 0: both seed-s arms run the plain rasterizer on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from gif_tpu_torch.render.renderer import render_tex_and_normal
from gif_tpu_torch.scripts import raster_sensitivity as rs
from torch_port_common import cpu_threads


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Six test processes share the machine under tier-1: cap each one's
    # thread pools (torch_port_common.cpu_threads).
    with cpu_threads():
        yield


@pytest.fixture(scope="module")
def render_inputs():
    from gif_tpu_torch.data.pipeline import sample_flame_params
    from gif_tpu_torch.flame.resources import synthetic_flame_resources

    res = synthetic_flame_resources(seed=1, n_vertices=503)
    f = torch.as_tensor(sample_flame_params(np.random.default_rng(0), 2))
    return res, (f[:, 0:100], f[:, 100:150], f[:, 150:156], f[:, 159:209], f[:, 209:236], f[:, 156:159])


def _render(render_inputs, **kw):
    res, codes = render_inputs
    return render_tex_and_normal(res, *codes, image_size=64, **kw)


def test_plain_backend_equals_auto_on_cpu(render_inputs):
    auto, plain = _render(render_inputs), _render(render_inputs, raster_backend="plain")
    for name, a, b in zip(auto._fields, auto, plain):
        assert torch.equal(a, b), name
    assert bool(auto.mask.any())
    # The same attribute VJP: gradients w.r.t. the light and texture codes.
    grads = []
    for backend in ("auto", "plain"):
        res, codes = render_inputs
        tex, lit = codes[3].clone().requires_grad_(), codes[4].clone().requires_grad_()
        maps = render_tex_and_normal(res, *codes[:3], tex, lit, codes[5], image_size=64, raster_backend=backend)
        grads.append(torch.autograd.grad(maps.textured.sum(), (tex, lit)))
    for a, b in zip(*grads):
        assert torch.equal(a, b) and bool(a.abs().max() > 0)


def test_unavailable_or_unknown_backends_raise(render_inputs, monkeypatch):
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _render(render_inputs, raster_backend="cuda")
    with pytest.raises(ValueError, match="must be one of"):
        _render(render_inputs, raster_backend="xla")
    # The environment variable overrides the argument, both ways.
    monkeypatch.setenv("GIF_TPU_TORCH_RASTER", "cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _render(render_inputs, raster_backend="plain")
    monkeypatch.setenv("GIF_TPU_TORCH_RASTER", "pallas")
    with pytest.raises(ValueError, match="must be one of"):
        _render(render_inputs)
    monkeypatch.setenv("GIF_TPU_TORCH_RASTER", "plain")
    assert torch.equal(_render(render_inputs, raster_backend="cuda").textured, _render(render_inputs).textured)


def _write_metrics(path, losses):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("step,d_loss,g_loss,r1,g_total,render_overflow,imgs_per_sec,fid,ema_recon\n")
        for i, (d, g) in enumerate(losses):
            f.write(f"{i + 1},{d!r},{g!r},0.0,{g!r},0.0,10.0,nan,nan\n")


def test_read_losses_and_mean_abs_diff_equal_jax(tmp_path):
    from scripts import raster_sensitivity as jrs

    rng = np.random.default_rng(0)
    tables = [rng.uniform(0, 3, (n, 2)).tolist() for n in (5, 4)]
    paths = [str(tmp_path / f"{i}" / "metrics.csv") for i in range(2)]
    for p, t in zip(paths, tables):
        _write_metrics(p, t)
    a, b = (rs.read_losses(p) for p in paths)
    assert a == jrs.read_losses(paths[0]) and b == jrs.read_losses(paths[1])
    assert rs.mean_abs_diff(a, b) == jrs.mean_abs_diff(a, b) > 0
    assert rs.mean_abs_diff(a, a) == 0.0
    with pytest.raises(SystemExit, match="no logged rows"):
        rs.mean_abs_diff(a, [])


class FakeTrainer:
    """``subprocess.run`` for the arms: notes each command and its
    ``GIF_TPU_TORCH_RASTER``, writes the arm's metrics.csv from ``losses``
    (by seed)."""

    def __init__(self, losses):
        self.losses, self.calls = losses, []

    def __call__(self, cmd, env, cwd):
        out, seed = cmd[cmd.index("--out_dir") + 1], int(cmd[cmd.index("--seed") + 1])
        assert env["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"  # set before the child starts
        self.calls.append((os.path.basename(out), env["GIF_TPU_TORCH_RASTER"], cmd, cwd))
        n = int(cmd[cmd.index("--total_iters") + 1]) // int(cmd[cmd.index("--log_every") + 1])
        _write_metrics(os.path.join(out, cmd[cmd.index("--run_id") + 1], "metrics.csv"), self.losses[seed][:n])

        class Done:
            returncode = 0

        return Done()


def test_arms_commands_reuse_and_max_ratio(tmp_path, monkeypatch, capsys):
    fake = FakeTrainer({100: [(1.0, 2.0), (1.5, 2.5)], 101: [(1.2, 2.0), (1.5, 3.0)]})
    monkeypatch.setattr(rs.subprocess, "run", fake)
    out = str(tmp_path / "rs")
    argv = ["--iters", "4", "--log_every", "2", "--out_dir", out, "--device", "cpu"]
    result = rs.main(argv)
    assert [c[:2] for c in fake.calls] == [("plain", "plain"), ("cuda", "auto"), ("plain_reseed", "plain")]
    tag, _, cmd, cwd = fake.calls[0]
    assert cmd[1:3] == ["-m", "gif_tpu_torch.train"] and "--no_mesh" in cmd and "--debug" not in cmd
    assert "--deterministic" in cmd
    assert cmd[cmd.index("--device") + 1] == "cpu" and os.path.isdir(os.path.join(cwd, "gif_tpu_torch"))
    assert result == {"divergence": 0.0, "noise_floor": pytest.approx(0.175), "iters": 4, "rows": 2, "ratio": 0.0}
    with open(os.path.join(out, "raster_sensitivity.json")) as f:
        assert json.load(f) == result
    # Completed arms are reused; a ratio past --max_ratio fails the run.
    fake.calls.clear()
    _write_metrics(os.path.join(out, "cuda", "8", "metrics.csv"), [(3.0, 2.0), (1.5, 2.5)])
    with pytest.raises(SystemExit, match="exceeds 1.5x the seed noise floor"):
        rs.main([*argv, "--max_ratio", "1.5"])
    assert fake.calls == []
    assert capsys.readouterr().out.count("complete, skipping") == 3


def test_three_arms_on_the_cpu_diverge_by_exactly_zero(tmp_path, monkeypatch):
    # The arms' processes start their pools as wide as this one's.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        monkeypatch.setenv(var, "2")
    result = rs.main(["--debug", "--iters", "2", "--log_every", "1", "--device", "cpu",
                      "--out_dir", str(tmp_path / "rs")])
    assert result["divergence"] == 0.0 and result["noise_floor"] > 0 and result["rows"] == 2
    assert result["ratio"] == 0.0
    for arm in ("plain", "cuda", "plain_reseed"):
        assert len(rs.read_losses(str(tmp_path / "rs" / arm / "8" / "metrics.csv"))) == 2


def test_cli_gives_every_frame_an_identity_row(tmp_path, monkeypatch):
    """The arms train on the CLI's default synthetic frames, 2% of them
    marked bad: the identity table has a row for every frame index the
    batches carry (the good frames' count would leave the last indices
    without one)."""
    from gif_tpu_torch.flame import resources
    from gif_tpu_torch.train import cli, loop

    seen = {}
    monkeypatch.setattr(resources, "load_flame_resources",
                        lambda path: resources.synthetic_flame_resources(seed=1, n_vertices=503))
    monkeypatch.setattr(loop, "train", lambda cfg, dataset, *a, **k: seen.update(cfg=cfg, dataset=dataset))
    cli.run(cli.parse_args(["--run_id", "8", "--device", "cpu", "--synthetic_n", "100", "--out_dir", str(tmp_path)]))
    cfg, ds = seen["cfg"], seen["dataset"]
    assert len(ds) == 98 and cfg.embedding_vocab_size == 100
    assert ds.good_indices.max() < cfg.embedding_vocab_size
