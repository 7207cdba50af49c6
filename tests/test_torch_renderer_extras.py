"""Port parity of the renderer's extras: ``constant_albedo`` (a grey level
in place of the PCA albedo, computed without a texture lookup) and the
``FlameRenderer`` façade against JAX's at the render parity bars of
tests/test_torch_render.py (rtol / atol 1e-3; the façade's 8-bit floors
within one step, flipped on < 0.5% of values); ``assert_no_overflow``
raises in both packages and stays silent without overflow."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_tpu.flame.resources import synthetic_flame_resources as j_synth
from gif_tpu.render import renderer as jrend
from gif_tpu_torch.flame.resources import synthetic_flame_resources
from gif_tpu_torch.render import FlameRenderer, renderer as trend
from gif_tpu_torch.render import shading as tsh

RTOL = ATOL = 1e-3  # tests/test_torch_render.py's render bars
STEP = 1.0 / 255.0


@pytest.fixture(scope="module")
def resources():
    return j_synth(seed=1, n_vertices=503), synthetic_flame_resources(seed=1, n_vertices=503)


def _codes(b=2, seed=4):
    rng = np.random.default_rng(seed)
    shape = (rng.standard_normal((b, 100)) * 0.5).astype(np.float32)
    exp = (rng.standard_normal((b, 50)) * 0.5).astype(np.float32)
    pose = (rng.standard_normal((b, 6)) * 0.1).astype(np.float32)
    tex = rng.standard_normal((b, 50)).astype(np.float32)
    light = np.zeros((b, 9, 3), np.float32)
    light[:, 0] = 3.0
    light[:, 1:4] = rng.standard_normal((b, 3, 3)) * 0.3
    cam = np.array([[8.0, 0.02, -0.01], [7.0, 0.0, 0.03]], np.float32)[:b]
    return shape, exp, pose, tex, light, cam


@pytest.mark.parametrize("level", [0.6, 0.25])
def test_constant_albedo_matches_jax_without_a_texture_lookup(resources, level, monkeypatch):
    jres, tres = resources
    args = _codes()
    want = jrend.render_tex_and_normal(jres, *map(jnp.asarray, args), image_size=32, max_tris_per_tile=None,
                                       constant_albedo=level)

    def no_lookup(*a):
        raise AssertionError("the albedo lookup ran under constant_albedo")

    monkeypatch.setattr(trend, "grid_sample", no_lookup)
    got = trend.render_tex_and_normal(tres, *map(torch.from_numpy, args), image_size=32, max_tris_per_tile=None,
                                      constant_albedo=level)
    mask = np.asarray(want.mask)
    assert 0.2 < mask.mean() < 0.95
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    np.testing.assert_allclose(got.textured.numpy(), np.asarray(want.textured), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(want.normal), rtol=RTOL, atol=ATOL)
    # The textured map no longer depends on the texture code.
    other = list(args)
    other[3] = other[3] * 5.0
    again = trend.render_tex_and_normal(tres, *map(torch.from_numpy, other), image_size=32,
                                        max_tris_per_tile=None, constant_albedo=level)
    torch.testing.assert_close(again.textured, got.textured, rtol=0, atol=0)


def test_constant_map_sample_is_the_sampler_on_a_constant_map():
    rng = np.random.default_rng(7)
    grid = torch.as_tensor(rng.uniform(-1.1, 1.1, (2, 9, 11, 2)).astype(np.float32))
    grid[:, 0, 0] = -1.0
    grid[:, 0, 1] = 1.0
    want = tsh.grid_sample_bilinear(torch.full((2, 16, 16, 3), 0.7), grid)
    torch.testing.assert_close(trend.constant_map_sample(0.7, grid, 16), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("constant_albedo", [None, 0.5])
def test_flame_renderer_matches_jax(resources, constant_albedo):
    jres, tres = resources
    shape, exp, pose, tex, light, cam = _codes()
    params = (shape, exp, pose, light, tex)
    j_normal, j_tex = jrend.FlameRenderer(jres, image_size=32).get_rendered_mesh(
        tuple(map(jnp.asarray, params)), jnp.asarray(cam), constant_albedo=constant_albedo)
    renderer = FlameRenderer(tres, image_size=32)
    t_normal, t_tex = renderer.get_rendered_mesh(tuple(map(torch.from_numpy, params)), torch.from_numpy(cam),
                                                 constant_albedo=constant_albedo)
    for got, want in ((t_normal.numpy(), np.asarray(j_normal)), (t_tex.numpy(), np.asarray(j_tex))):
        assert got.shape == want.shape == (2, 32, 32, 3)
        np.testing.assert_array_equal(np.floor(got * 255.0 + 0.5), got * 255.0)  # on the 8-bit grid
        diff = np.abs(got - want)
        assert diff.max() <= STEP * 1.001 and (diff > STEP * 0.5).mean() < 0.005
    np.testing.assert_array_equal(renderer.get_flame_faces().numpy(), np.asarray(
        jrend.FlameRenderer(jres).get_flame_faces()))


def test_assert_no_overflow_raises_in_both(resources):
    jres, tres = resources
    args = _codes()
    with pytest.raises(Exception, match="tile overflow"):
        jrend.render_tex_and_normal(jres, *map(jnp.asarray, args), image_size=32, max_tris_per_tile=4,
                                    assert_no_overflow=True)
    with pytest.raises(RuntimeError, match="tile overflow"):
        trend.render_tex_and_normal(tres, *map(torch.from_numpy, args), image_size=32, max_tris_per_tile=4,
                                    assert_no_overflow=True)
    # Without overflow the switch only checks; the flag off never reads back.
    maps = trend.render_tex_and_normal(tres, *map(torch.from_numpy, args), image_size=32,
                                       max_tris_per_tile=None, assert_no_overflow=True)
    assert not maps.overflow.any()
    over = trend.render_tex_and_normal(tres, *map(torch.from_numpy, args), image_size=32, max_tris_per_tile=4)
    assert over.overflow.all()
