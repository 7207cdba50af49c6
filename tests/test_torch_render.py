"""Port parity: the plain albedo sampler (rtol 1e-5 against the JAX
package's grid_sample_bilinear and torch's F.grid_sample; a bf16 bar
against the TPU kernel's interpret mode), SH9 shading, PCA albedo and the
whole renderer (kernel 2 itself: tests/test_torch_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gif_tpu.flame.resources import synthetic_flame_resources as j_synth
from gif_tpu.render import renderer as jrend
from gif_tpu.render import shading as jsh
from gif_tpu.render.sampler_pallas import grid_sample_bilinear_mxu
from gif_tpu_torch.flame.resources import synthetic_flame_resources
from gif_tpu_torch.render import renderer as trend
from gif_tpu_torch.render import sampler_cuda
from gif_tpu_torch.render import shading as tsh


def _img_grid(rng, b=2, h=16, w=128, c=3, ho=12, wo=10):
    img = rng.uniform(0, 1, size=(b, h, w, c)).astype(np.float32)
    # Includes out-of-range points (zeros padding) and the -1 background.
    grid = rng.uniform(-1.2, 1.2, size=(b, ho, wo, 2)).astype(np.float32)
    grid[:, 0, 0] = -1.0
    return img, grid


def test_plain_sampler_matches_jax_and_torch():
    img, grid = _img_grid(np.random.default_rng(0))
    got = tsh.grid_sample_bilinear(torch.from_numpy(img), torch.from_numpy(grid))
    want = jsh.grid_sample_bilinear(jnp.asarray(img), jnp.asarray(grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    ref = F.grid_sample(
        torch.from_numpy(img).permute(0, 3, 1, 2), torch.from_numpy(grid), align_corners=False
    ).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)


def test_plain_sampler_matches_tpu_kernel_interpret():
    # The TPU kernel samples a bf16 texture on the matrix unit: hold it to
    # bf16's 2^-8 relative rounding of values in [0, 1].
    img, grid = _img_grid(np.random.default_rng(1))
    got = tsh.grid_sample_bilinear(torch.from_numpy(img), torch.from_numpy(grid))
    want = grid_sample_bilinear_mxu(jnp.asarray(img), jnp.asarray(grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-2, atol=1e-2)


def test_sampler_wrapper_takes_plain_version_on_cpu():
    img, grid = _img_grid(np.random.default_rng(2))
    before = sampler_cuda.grid_sample.launches
    got = sampler_cuda.grid_sample(torch.from_numpy(img), torch.from_numpy(grid))
    assert sampler_cuda.grid_sample.launches == before
    assert torch.equal(got, tsh.grid_sample_bilinear(torch.from_numpy(img), torch.from_numpy(grid)))


def test_sh9_and_albedo_match_jax():
    rng = np.random.default_rng(3)
    n = rng.standard_normal((2, 4, 5, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    light = rng.standard_normal((2, 9, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tsh.sh9_shading(torch.from_numpy(n), torch.from_numpy(light)).numpy(),
        np.asarray(jsh.sh9_shading(jnp.asarray(n), jnp.asarray(light))),
        rtol=1e-5, atol=1e-6,
    )
    res = synthetic_flame_resources(seed=1, n_vertices=503)
    code = rng.standard_normal((2, 50)).astype(np.float32) * 3
    got = tsh.albedo_from_tex_code(
        torch.from_numpy(res.tex_mean), torch.from_numpy(res.tex_dirs), torch.from_numpy(code)
    )
    want = jsh.albedo_from_tex_code(res.tex_mean, res.tex_dirs, jnp.asarray(code))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_renderer_matches_jax():
    res_t = synthetic_flame_resources(seed=1, n_vertices=503)
    res_j = j_synth(seed=1, n_vertices=503)
    rng = np.random.default_rng(4)
    b = 2
    shape = (rng.standard_normal((b, 100)) * 0.5).astype(np.float32)
    exp = (rng.standard_normal((b, 50)) * 0.5).astype(np.float32)
    pose = (rng.standard_normal((b, 6)) * 0.1).astype(np.float32)
    tex = rng.standard_normal((b, 50)).astype(np.float32)
    light = np.zeros((b, 9, 3), np.float32)
    light[:, 0] = 3.0
    light[:, 1:4] = rng.standard_normal((b, 3, 3)) * 0.3
    cam = np.array([[8.0, 0.02, -0.01], [7.0, 0.0, 0.03]], np.float32)
    args = (shape, exp, pose, tex, light, cam)
    want = jrend.render_tex_and_normal(
        res_j, *map(jnp.asarray, args), image_size=32, max_tris_per_tile=None
    )
    got = trend.render_tex_and_normal(
        res_t, *map(torch.from_numpy, args), image_size=32, max_tris_per_tile=None
    )
    mask = np.asarray(want.mask)
    assert 0.2 < mask.mean() < 0.95
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    np.testing.assert_array_equal(got.overflow.numpy(), np.asarray(want.overflow))
    np.testing.assert_allclose(got.depth.numpy()[mask], np.asarray(want.depth)[mask], rtol=1e-3)
    np.testing.assert_allclose(got.textured.numpy(), np.asarray(want.textured), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(want.normal), rtol=1e-3, atol=1e-3)
