"""Serving a run, and the deterministic switch, on the CPU.

``load_generator_params`` takes the converted pickle before the run
checkpoint when both are given, as ``gif_tpu.eval.sampling`` does;
``python -m gif_tpu_torch.serve`` (:func:`gif_tpu_torch.serve.build_server`)
serves ``--converted_ckpt`` with exactly the weights JAX's
``load_generator_params`` reads from the same trees (equality), and its
sampler's images match the JAX sampler's at the sampler bars of
tests/test_torch_sampling.py; ``--ckpt`` serves the checkpoint's EMA
generator; ``--run_id`` defaults to 0 as in ``gif_tpu.serve``.
``device.set_deterministic`` sets PyTorch's flags and raises without a
deterministic ``CUBLAS_WORKSPACE_CONFIG``; ``train(deterministic=True)``
turns it on for the steps and off after, with the same run as without."""

import pickle

import numpy as np
import pytest
import torch

from gif_tpu.eval.sampling import FlameSampler as JFlameSampler
from gif_tpu.eval.sampling import load_generator_params as j_load_generator_params
from gif_tpu.flame.resources import synthetic_flame_resources as j_synth
from gif_tpu_torch import device as tdevice
from gif_tpu_torch import serve
from gif_tpu_torch.data import pipeline as tp
from gif_tpu_torch.eval.sampling import load_generator_params, random_flame_params
from gif_tpu_torch.flame.resources import synthetic_flame_resources
from gif_tpu_torch.tools.convert_params import convert_generator_params, train_state_trees
from gif_tpu_torch.train import cli
from gif_tpu_torch.train import config as tconfig
from gif_tpu_torch.train import loop as tloop
from gif_tpu_torch.train.checkpoint import CheckpointManager
from gif_tpu_torch.train.state import create_train_state
from torch_port_common import cpu_threads, jax_generator_params, tiny_overrides


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Six test processes share the machine under tier-1: cap each one's
    # thread pools (torch_port_common.cpu_threads).
    with cpu_threads():
        yield


STEP = 2.0 / 255.0  # one 8-bit condition step


@pytest.fixture(scope="module")
def two_sources(tmp_path_factory):
    """A trees pickle whose EMA holds the JAX generator's weights, and a run
    checkpoint whose EMA holds other (seeded) ones."""
    _, params, buffers = jax_generator_params()
    cfg = tconfig.get_config(8, **tiny_overrides())
    tmp = tmp_path_factory.mktemp("sources")
    state = create_train_state(cfg, seed=3, device="cpu")
    CheckpointManager(str(tmp / "checkpoint")).save(state)
    state.g_ema.load_state_dict(convert_generator_params(params, buffers))
    with open(tmp / "trees.pkl", "wb") as f:
        pickle.dump(train_state_trees(state), f)
    return cfg, tmp


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_the_converted_pickle_wins_over_the_checkpoint(two_sources):
    cfg, tmp = two_sources
    jcfg, _, _ = jax_generator_params()
    both = load_generator_params(cfg, ckpt=str(tmp / "checkpoint"), converted_ckpt=str(tmp / "trees.pkl"))
    j_params, j_buffers = j_load_generator_params(jcfg, ckpt=str(tmp / "checkpoint"),
                                                  converted_ckpt=str(tmp / "trees.pkl"))
    assert _equal(both, convert_generator_params(j_params, j_buffers))
    assert _equal(both, load_generator_params(cfg, converted_ckpt=str(tmp / "trees.pkl")))
    assert not _equal(both, load_generator_params(cfg, ckpt=str(tmp / "checkpoint")))


def _build(monkeypatch, *flags):
    # The served preset at the tiny size (the port's CLI builds the full one).
    real = tconfig.get_config
    monkeypatch.setattr(tconfig, "get_config", lambda run_id, **kw: real(run_id, **{**kw, **tiny_overrides()}))
    server, port = serve.build_server(["--flame_resources", "synthetic_small", "--vocab", "16", "--device", "cpu",
                                       "--batch_size", "4", *flags])
    return server, port


@pytest.mark.parametrize("both", [False, True])
def test_serve_converted_ckpt_matches_jax(two_sources, monkeypatch, both):
    cfg, tmp = two_sources
    jcfg, _, _ = jax_generator_params()
    extra = ["--ckpt", str(tmp / "checkpoint")] if both else []
    server, port = _build(monkeypatch, "--run_id", "8", "--converted_ckpt", str(tmp / "trees.pkl"), *extra)
    try:
        assert port == 8000
        j_params, j_buffers = j_load_generator_params(jcfg, converted_ckpt=str(tmp / "trees.pkl"))
        assert _equal(server.sampler.generator.state_dict(), convert_generator_params(j_params, j_buffers))
        fl = random_flame_params(np.random.default_rng(4), 5)
        idx = np.array([1, 2, 3, 9, 15])
        j_img, j_cond = JFlameSampler(jcfg, j_synth(seed=1, n_vertices=503), j_params, j_buffers, batch_size=4,
                                      eye_center=True).sample(fl, idx)
        t_img, t_cond = server.sampler.sample(fl, idx)
        diff = np.abs(t_cond - j_cond)
        assert diff.max() <= STEP * 1.001 and (diff > STEP * 0.5).mean() < 0.005
        with torch.inference_mode():
            g_img = server.sampler.generator(torch.from_numpy(j_cond), input_indices=torch.from_numpy(idx),
                                             step=cfg.max_step).numpy()
        np.testing.assert_allclose(g_img, j_img, rtol=1e-4, atol=1e-5)
        served = server.generate(fl[0], identity=1)
        want = ((np.clip(t_img[0], -1, 1) + 1) * 127.5).astype(np.uint8)
        np.testing.assert_array_equal(served, want)
    finally:
        server.stop()


def test_serve_ckpt_serves_the_runs_ema_and_defaults_to_run_0(two_sources, monkeypatch):
    _, tmp = two_sources
    server, _ = _build(monkeypatch, "--ckpt", str(tmp / "checkpoint"), "--port", "8123")
    try:
        assert server.cfg.run_id == 0
        assert _equal(server.sampler.generator.state_dict(), CheckpointManager.read(str(tmp / "checkpoint"))["g_ema"])
    finally:
        server.stop()


@pytest.fixture
def restore_determinism():
    yield
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False


def test_set_deterministic_sets_the_flags_and_needs_cublas_config(monkeypatch, restore_determinism):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        tdevice.set_deterministic(True)
    assert not torch.are_deterministic_algorithms_enabled()
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:2")
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        tdevice.set_deterministic(True)
    for value in (":4096:8", ":16:8"):
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", value)
        tdevice.set_deterministic(True)
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        tdevice.set_deterministic(False)
        assert not torch.are_deterministic_algorithms_enabled() and not torch.backends.cudnn.deterministic
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
    tdevice.set_deterministic(False)  # turning it off needs nothing


def test_train_deterministic_runs_the_same_steps(tmp_path, monkeypatch, restore_determinism):
    cfg = tconfig.get_config(8, **tiny_overrides(batch_size=4, r1_interval=2, fid_every=10_000,
                                                 checkpoint_every=10_000,
                                                 apply_texture_space_interpolation_loss=False))
    res = synthetic_flame_resources(seed=1, n_vertices=503)
    rng = np.random.default_rng(11)
    images, flame = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8), tp.sample_flame_params(rng, 8)
    seen = []
    real_set = tloop.set_deterministic
    monkeypatch.setattr(tloop, "set_deterministic",
                        lambda on: seen.append((on, torch.are_deterministic_algorithms_enabled())) or real_set(on))
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    a = tloop.train(cfg, tp.FlameDataset(images, flame), res, str(tmp_path / "a"), total_iters=2, log_every=1,
                    device="cpu", deterministic=True)
    assert seen == [(True, False), (False, True)] and not torch.are_deterministic_algorithms_enabled()
    b = tloop.train(cfg, tp.FlameDataset(images, flame), res, str(tmp_path / "b"), total_iters=2, log_every=1,
                    device="cpu")
    assert len(seen) == 2
    for name, t in a.state_dict()["generator"].items():
        assert torch.equal(t, b.state_dict()["generator"][name]), name
    assert cli.parse_args(["--deterministic"]).deterministic and not cli.parse_args([]).deterministic
