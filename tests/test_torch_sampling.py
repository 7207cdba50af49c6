"""End to end on the CPU: the port's FlameSampler (eye-centring -> render ->
8-bit quantize -> G) against the JAX FlameSampler with the same converted
weights, the port's micro-batching GifServer, and the no-CPU-fallback rule
of the default-device entry points."""

import threading

import numpy as np
import pytest
import torch

from gif_tpu.eval.sampling import FlameSampler as JFlameSampler
from gif_tpu.flame.resources import synthetic_flame_resources as j_synth
from gif_tpu_torch.eval.sampling import FlameSampler, load_generator_params, random_flame_params
from gif_tpu_torch.flame.resources import synthetic_flame_resources
from gif_tpu_torch.models.generator import StyledGenerator
from gif_tpu_torch.serve import GifServer, main as serve_main
from gif_tpu_torch.tools.convert_params import convert_generator_params
from gif_tpu_torch.train.config import get_config
from torch_port_common import jax_generator_params, tiny_overrides


@pytest.fixture(scope="module")
def weights():
    jcfg, params, buffers = jax_generator_params()
    return jcfg, params, buffers, convert_generator_params(params, buffers)


@pytest.mark.parametrize("eye_center", [True, False])
def test_flame_sampler_matches_jax(weights, eye_center):
    jcfg, params, buffers, sd = weights
    cfg = get_config(8, **tiny_overrides())
    fl = random_flame_params(np.random.default_rng(0), 5)
    idx = np.array([0, 3, 7, 11, 15])
    j_img, j_cond = JFlameSampler(
        jcfg, j_synth(seed=1, n_vertices=503), params, buffers, batch_size=4,
        eye_center=eye_center,
    ).sample(fl, idx)
    sampler = FlameSampler(
        cfg, synthetic_flame_resources(seed=1, n_vertices=503), sd, batch_size=4,
        eye_center=eye_center, device="cpu",
    )
    t_img, t_cond = sampler.sample(fl, idx)
    assert t_img.shape == j_img.shape == (5, 32, 32, 3)
    assert t_cond.shape == j_cond.shape == (5, 32, 32, 6)
    assert sampler.render_overflows == 0
    # Floor quantisation may flip a value by exactly one 8-bit step where
    # the two renders straddle a bin edge; allow that on < 0.5% of values.
    step = 2.0 / 255.0
    diff = np.abs(t_cond - j_cond)
    assert diff.max() <= step * 1.001
    assert (diff > step * 0.5).mean() < 0.005
    # With eye centring the 503-vertex mesh has no eye vertices (both clamp
    # to the last vertex), the camera degenerates and nothing is drawn — in
    # both packages; without it the head covers much of the frame.
    fg = (j_cond[..., 3:] > -1).any(-1).mean()
    assert fg == 0.0 if eye_center else fg > 0.3
    # The images: the port's G fed the JAX conditions.
    gen = sampler.generator
    with torch.inference_mode():
        g_img = gen(torch.from_numpy(j_cond), input_indices=torch.from_numpy(idx),
                    step=cfg.max_step).numpy()
    np.testing.assert_allclose(g_img, j_img, rtol=1e-4, atol=1e-5)
    if diff.max() == 0:
        np.testing.assert_allclose(t_img, j_img, rtol=1e-4, atol=1e-5)


def test_gif_server_answers_concurrent_requests():
    cfg = get_config(8, **tiny_overrides())
    server = GifServer(
        cfg, synthetic_flame_resources(seed=1, n_vertices=503), load_generator_params(cfg, seed=1),
        batch_size=4, max_wait_ms=30, device="cpu",
    )
    try:
        imgs = [None] * 3

        def worker(i):
            imgs[i] = server.generate(None, identity=i, seed=i)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for img in imgs:
            assert img is not None and img.shape == (32, 32, 3) and img.dtype == np.uint8
        assert server.requests_served == 3
        with pytest.raises(ValueError, match="236"):
            server.generate(np.zeros(7), identity=0)
        with pytest.raises(ValueError, match="identity"):
            server.generate(None, identity=16)
    finally:
        server.stop()


def test_http_api_on_localhost():
    import json
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    from gif_tpu_torch.serve import make_handler

    cfg = get_config(8, **tiny_overrides())
    server = GifServer(
        cfg, synthetic_flame_resources(seed=1, n_vertices=503), load_generator_params(cfg),
        batch_size=2, max_wait_ms=10, device="cpu",
    )
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            assert json.loads(r.read())["status"] == "ok"
        req = urllib.request.Request(
            f"{base}/generate", data=json.dumps({"identity": 1, "seed": 3}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.headers["Content-Type"] == "image/png"
            assert r.read()[:8] == b"\x89PNG\r\n\x1a\n"
        bad = urllib.request.Request(f"{base}/generate", data=b'{"identity": 99}')
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=60)
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(8, **tiny_overrides())
    res = synthetic_flame_resources(seed=1, n_vertices=503)
    sd = StyledGenerator.from_config(cfg).state_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        FlameSampler(cfg, res, sd)
    with pytest.raises(RuntimeError, match="CUDA"):
        GifServer(cfg, res, sd)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_main(["--flame_resources", "synthetic_small", "--vocab", "16"])
