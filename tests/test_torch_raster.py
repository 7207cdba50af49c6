"""Port parity: the plain rasterizer against the JAX package's XLA raster
(tri_id equal, depth rtol 1e-3, bary rtol 5e-3 / atol 2e-3 — the bars the
JAX package holds its own kernel to), attribute interpolation, overflow and
the degenerate / back-face rules (kernel 1 itself:
tests/test_torch_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_tpu.render import raster as jr
from gif_tpu.render.raster_pallas import morton_face_order as j_morton
from gif_tpu_torch.render import raster as tr
from gif_tpu_torch.render import raster_cuda


def _random_faces(rng, b, n_faces, h, w):
    """Random pixel-space triangles with positive depth."""
    centers = rng.uniform(5, min(h, w) - 5, size=(b, n_faces, 1, 2))
    offsets = rng.uniform(-8, 8, size=(b, n_faces, 3, 2))
    z = rng.uniform(1.0, 20.0, size=(b, n_faces, 3, 1))
    return np.concatenate([centers + offsets, z], axis=-1).astype(np.float32)


def _plain(fv, attrs=None, **kw):
    return tr.rasterize_plain(
        torch.from_numpy(fv), None if attrs is None else torch.from_numpy(attrs), **kw
    )


def test_plain_raster_matches_jax():
    rng = np.random.default_rng(0)
    h = w = 64
    fv = _random_faces(rng, 2, 200, h, w)
    attrs = rng.standard_normal((2, 200, 3, 5)).astype(np.float32)
    want = jr.rasterize(jnp.asarray(fv), h=h, w=w, tile=16, max_tris_per_tile=96)
    got, attr_img = _plain(fv, attrs, h=h, w=w, tile=16, max_tris_per_tile=96)

    np.testing.assert_array_equal(got.tri_id.numpy(), np.asarray(want.tri_id))
    np.testing.assert_array_equal(got.tile_overflow.numpy(), np.asarray(want.tile_overflow))
    hit = np.asarray(want.tri_id) >= 0
    assert hit.mean() > 0.3
    np.testing.assert_allclose(got.depth.numpy()[hit], np.asarray(want.depth)[hit], rtol=1e-3)
    np.testing.assert_array_equal(got.depth.numpy()[~hit], tr.BIG_DEPTH)
    np.testing.assert_allclose(
        got.bary.numpy()[hit], np.asarray(want.bary)[hit], rtol=5e-3, atol=2e-3
    )
    # The fused attributes are the JAX interpolation of the port's own
    # winners (the barycentrics themselves carry the bary bar above).
    ref_attr = jr.interpolate_face_attributes(
        jnp.asarray(got.tri_id.numpy()), jnp.asarray(got.bary.numpy()), jnp.asarray(attrs)
    )
    np.testing.assert_allclose(attr_img.numpy(), np.asarray(ref_attr), rtol=1e-5, atol=1e-6)


def test_interpolate_face_attributes_matches_jax():
    rng = np.random.default_rng(1)
    tri = rng.integers(-1, 10, size=(2, 8, 8)).astype(np.int32)
    bary = rng.dirichlet(np.ones(3), size=(2, 8, 8)).astype(np.float32)
    attrs = rng.standard_normal((2, 10, 3, 4)).astype(np.float32)
    want = jr.interpolate_face_attributes(jnp.asarray(tri), jnp.asarray(bary), jnp.asarray(attrs))
    got = tr.interpolate_face_attributes(
        torch.from_numpy(tri), torch.from_numpy(bary), torch.from_numpy(attrs)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_overflow_and_capacity_match_jax():
    rng = np.random.default_rng(3)
    fv = _random_faces(rng, 1, 64, 32, 32)
    want = jr.rasterize(jnp.asarray(fv), h=32, w=32, tile=32, max_tris_per_tile=8)
    got, _ = _plain(fv, h=32, w=32, tile=32, max_tris_per_tile=8)
    assert got.tile_overflow.any()
    np.testing.assert_array_equal(got.tile_overflow.numpy(), np.asarray(want.tile_overflow))
    np.testing.assert_array_equal(got.tri_id.numpy(), np.asarray(want.tri_id))
    for n_faces, n_tiles in [(10042, 64), (1002, 1), (100, 4)]:
        assert tr.auto_max_tris_per_tile(n_faces, n_tiles) == jr.auto_max_tris_per_tile(
            n_faces, n_tiles
        )


def test_degenerate_and_backfacing_never_hit():
    h = w = 32
    # Exactly collinear corners: det == 0 in f32.
    degenerate = np.array([[[[1.0, 1.0, 1.0], [3.0, 3.0, 1.0], [5.0, 5.0, 1.0]]]], np.float32)
    got, _ = _plain(degenerate, h=h, w=w, tile=16, max_tris_per_tile=4)
    assert (got.tri_id.numpy() < 0).all()
    tri = np.array([[[[5, 5, 2.0], [25, 6, 2.0], [15, 25, 2.0]]]], np.float32)
    n_front = (_plain(tri, h=h, w=w, tile=16, max_tris_per_tile=4)[0].tri_id >= 0).sum()
    n_back = (_plain(tri[:, :, [0, 2, 1]], h=h, w=w, tile=16, max_tris_per_tile=4)[0].tri_id >= 0).sum()
    assert (n_front > 0) != (n_back > 0)
    fv = jnp.asarray(np.concatenate([tri, tri[:, :, [0, 2, 1]]], axis=1))
    assert int((jr.rasterize(fv, h=h, w=w, tile=16, max_tris_per_tile=4).tri_id >= 0).sum()) == int(
        n_front + n_back
    )


def test_to_pixel_space_and_morton_match_jax():
    from gif_tpu_torch.flame.resources import synthetic_flame_resources

    rng = np.random.default_rng(4)
    ndc = rng.uniform(-1, 1, size=(2, 50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tr.to_pixel_space(torch.from_numpy(ndc), 32, 64).numpy(),
        np.asarray(jr.to_pixel_space(jnp.asarray(ndc), 32, 64)),
        rtol=1e-6,
    )
    res = synthetic_flame_resources(seed=1, n_vertices=503)
    np.testing.assert_array_equal(
        raster_cuda.morton_face_order(res.faces, res.v_template),
        j_morton(res.faces, res.v_template),
    )


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    fv = _random_faces(rng, 1, 20, 32, 32)
    attrs = rng.standard_normal((1, 20, 3, 5)).astype(np.float32)
    before = raster_cuda.rasterize_with_attrs.launches
    rast, img = raster_cuda.rasterize_with_attrs(
        torch.from_numpy(fv), torch.from_numpy(attrs), 32, 32, 16, 32
    )
    ref, ref_img = _plain(fv, attrs, h=32, w=32, tile=16, max_tris_per_tile=32)
    assert raster_cuda.rasterize_with_attrs.launches == before
    for a, b in zip(rast, ref):
        assert torch.equal(a, b)
    assert torch.equal(img, ref_img)
