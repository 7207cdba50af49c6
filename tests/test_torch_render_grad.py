"""Port parity of the render's gradients on the CPU, where the autograd
Functions around kernels 1 and 2 run with their plain launchers (the card
cases are in tests/test_torch_kernels.py): kernel 1's attribute VJP
against JAX's ``_rwa_bwd`` on the same winners (rtol 1e-5), the sampler's
image and grid gradients against ``jax.vjp`` of JAX's
``grid_sample_bilinear`` and of its TPU kernel's custom VJP (rtol 1e-5), and
the whole renderer's gradient with respect to the texture, light and
expression codes (the last through the normals, i.e. the face
attributes) against ``jax.grad`` of ``render_tex_and_normal``.  The two
packages' rasterizers place barycentrics ~1e-3 apart (the bars of
tests/test_torch_raster.py), so the renderer's gradients are held at
rtol 1e-3 with an absolute floor of 1e-3 of their largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gif_tpu.flame.resources import synthetic_flame_resources as j_synth
from gif_tpu.render import renderer as jrend
from gif_tpu.render import shading as jsh
from gif_tpu.render.raster_pallas import _rwa_bwd
from gif_tpu.render.sampler_pallas import grid_sample_bilinear_mxu
from gif_tpu_torch.flame.resources import synthetic_flame_resources
from gif_tpu_torch.render import raster as tr
from gif_tpu_torch.render import raster_cuda, sampler_cuda, scatter_cuda
from gif_tpu_torch.render import renderer as trend


def _random_faces(rng, b, n_faces, h, w):
    centers = rng.uniform(5, min(h, w) - 5, size=(b, n_faces, 1, 2))
    offsets = rng.uniform(-8, 8, size=(b, n_faces, 3, 2))
    z = rng.uniform(1.0, 20.0, size=(b, n_faces, 3, 1))
    return np.concatenate([centers + offsets, z], axis=-1).astype(np.float32)


def test_raster_attribute_gradient_matches_jax_vjp():
    rng = np.random.default_rng(0)
    b, f, h, w, d = 2, 120, 32, 32, 5
    fv = torch.from_numpy(_random_faces(rng, b, f, h, w)).requires_grad_(True)
    attrs = torch.from_numpy(rng.standard_normal((b, f, 3, d)).astype(np.float32)).requires_grad_(True)
    g = rng.standard_normal((b, h, w, d)).astype(np.float32)
    before = raster_cuda.rasterize_with_attrs.launches
    rast, img = raster_cuda.rasterize_with_attrs(fv, attrs, h, w, 16, 64)
    d_fv, d_attrs = torch.autograd.grad(img, (fv, attrs), torch.from_numpy(g), allow_unused=True)
    assert raster_cuda.rasterize_with_attrs.launches == before  # CPU: the plain version
    assert d_fv is None  # the positions get no gradient
    assert (rast.tri_id >= 0).float().mean() > 0.3
    res = (jnp.asarray(rast.tri_id.numpy()), jnp.asarray(rast.bary.numpy()), (b, f, 3, d))
    want_fv, want_attrs = _rwa_bwd(h, w, 16, 64, res, (None, jnp.asarray(g)))
    assert not np.asarray(want_fv).any()
    np.testing.assert_allclose(d_attrs.numpy(), np.asarray(want_attrs), rtol=1e-5, atol=1e-5)
    # The Function's VJP is the autograd of the plain version's gather.
    _, plain_img = tr.rasterize_plain(fv, attrs, h=h, w=w, tile=16, max_tris_per_tile=64)
    (want_plain,) = torch.autograd.grad(plain_img, attrs, torch.from_numpy(g))
    np.testing.assert_allclose(d_attrs.numpy(), want_plain.numpy(), rtol=1e-5, atol=1e-6)


def test_sampler_image_and_grid_gradients_match_jax():
    rng = np.random.default_rng(1)
    b, h, w, c = 2, 16, 128, 3
    img = rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (b, 12, 10, 2)).astype(np.float32)
    grid[:, 0, 0] = -1.0
    cot = rng.standard_normal((b, 12, 10, c)).astype(np.float32)
    ti = torch.from_numpy(img).requires_grad_(True)
    tg = torch.from_numpy(grid).requires_grad_(True)
    before = sampler_cuda.grid_sample.launches, scatter_cuda.scatter_bilinear.launches
    out = sampler_cuda.grid_sample(ti, tg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(
        jsh.grid_sample_bilinear(jnp.asarray(img), jnp.asarray(grid))), rtol=1e-5, atol=1e-6)
    d_img, d_grid = torch.autograd.grad(out, (ti, tg), torch.from_numpy(cot))
    assert (sampler_cuda.grid_sample.launches, scatter_cuda.scatter_bilinear.launches) == before
    for fn in (jsh.grid_sample_bilinear, grid_sample_bilinear_mxu):
        _, vjp = jax.vjp(fn, jnp.asarray(img), jnp.asarray(grid))
        want_img, want_grid = vjp(jnp.asarray(cot))
        np.testing.assert_allclose(d_img.numpy(), np.asarray(want_img), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(d_grid.numpy(), np.asarray(want_grid), rtol=1e-5, atol=1e-4)
    assert np.abs(d_grid.numpy()).max() > 1.0


def test_render_gradients_match_jax():
    res_t = synthetic_flame_resources(seed=1, n_vertices=503)
    res_j = j_synth(seed=1, n_vertices=503)
    rng = np.random.default_rng(4)
    b, s = 2, 32
    shape = (rng.standard_normal((b, 100)) * 0.5).astype(np.float32)
    exp = (rng.standard_normal((b, 50)) * 0.5).astype(np.float32)
    pose = (rng.standard_normal((b, 6)) * 0.1).astype(np.float32)
    tex = rng.standard_normal((b, 50)).astype(np.float32)
    light = np.zeros((b, 9, 3), np.float32)
    light[:, 0] = 3.0
    light[:, 1:4] = rng.standard_normal((b, 3, 3)) * 0.3
    cam = np.array([[8.0, 0.02, -0.01], [7.0, 0.0, 0.03]], np.float32)
    w_tex = rng.standard_normal((b, s, s, 3)).astype(np.float32)
    w_nrm = rng.standard_normal((b, s, s, 3)).astype(np.float32)

    def j_loss(e, t, li):
        maps = jrend.render_tex_and_normal(res_j, jnp.asarray(shape), e, jnp.asarray(pose), t, li,
                                           jnp.asarray(cam), image_size=s, max_tris_per_tile=None)
        return jnp.sum(maps.textured * w_tex) + jnp.sum(maps.normal * w_nrm)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(exp), jnp.asarray(tex), jnp.asarray(light))
    te, tt, tli = (torch.from_numpy(x).requires_grad_(True) for x in (exp, tex, light))
    maps = trend.render_tex_and_normal(res_t, torch.from_numpy(shape), te, torch.from_numpy(pose), tt, tli,
                                       torch.from_numpy(cam), image_size=s, max_tris_per_tile=None)
    loss = (maps.textured * torch.from_numpy(w_tex)).sum() + (maps.normal * torch.from_numpy(w_nrm)).sum()
    got = torch.autograd.grad(loss, (te, tt, tli))
    for name, g, w in zip(("expcode", "texcode", "lightcode"), got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-3 * np.abs(w).max(), err_msg=name)


def test_render_gradient_after_inference_mode_use():
    """A resource set whose tensors were first made under inference mode (as
    the server makes them) still renders differentiably afterwards."""
    res = synthetic_flame_resources(seed=1, n_vertices=503)
    b = 1
    args = [torch.zeros((b, 100)), torch.zeros((b, 50)), torch.zeros((b, 6)), torch.zeros((b, 50)),
            torch.zeros((b, 9, 3)), torch.tensor([[8.0, 0.0, 0.0]])]
    args[4][:, 0] = 3.0
    with torch.inference_mode():
        trend.render_tex_and_normal(res, *args, image_size=32, max_tris_per_tile=None)
    tex = args[3].clone().requires_grad_(True)
    maps = trend.render_tex_and_normal(res, *args[:3], tex, *args[4:], image_size=32, max_tris_per_tile=None)
    (g,) = torch.autograd.grad(maps.textured.sum(), tex)
    assert g.abs().sum().item() > 0
