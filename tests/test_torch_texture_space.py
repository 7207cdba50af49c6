"""Port parity of the texture steal and the interpolation loss's pieces on
the CPU: ``sample_at_points`` (forward rtol 1e-6; image gradient rtol 1e-5
against ``jax.vjp`` of the JAX op, whose CPU backward is the sort / cumsum
formulation), kernel 6's plain version against the TPU kernel in interpret
mode (bf16 products there: 2e-2), ``steal_texture`` and
``flame_texture_space`` on the 503-vertex and the FLAME-sized synthetic
meshes (textures rtol 1e-5, visibility exact), and the interpolation helpers and penalty with its image gradient
under draws made by ``jax.random`` and handed to both (kernel 6 itself:
tests/test_torch_kernels.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_tpu.flame.resources import synthetic_flame_resources as j_synth
from gif_tpu.models import texture_space as jts
from gif_tpu.render.sampler_pallas import scatter_bilinear_mxu
from gif_tpu.render.sampling_ops import sample_at_points as j_sample_at_points
from gif_tpu.train import losses as jl
from gif_tpu_torch.flame.resources import synthetic_flame_resources
from gif_tpu_torch.models import texture_space as tts
from gif_tpu_torch.render import sampling_ops, scatter_cuda
from gif_tpu_torch.train import losses as tl

MESHES = {"503": dict(seed=1, n_vertices=503), "flame": dict()}
# Texture values lie in [-1, 1].  The barycentric blend and projection sum
# in another order in the two packages, which moves a sample point by a few
# float32 ulps of its [-1, 1] coordinate; the JAX package holds its own
# steal to the reference torch code at 1e-5 (tests/
# test_texture_space_parity.py).  On a white-noise image of width W a point
# moved by 4 ulps of 1.0 changes its sample by up to 4 * 2^-23 * W/2 * 2.
TEX_ATOL = 1e-5


def noise_atol(w):
    return 4 * 2.0**-23 * (w / 2) * 2


def _img_pts(rng, b=2, h=9, w=11, c=3, p=40):
    img = rng.standard_normal((b, h, w, c)).astype(np.float32)
    # Out-of-range points (zeros padding), and points on the edge texels.
    pts = rng.uniform(-1.2, 1.2, (b, p, 2)).astype(np.float32)
    pts[:, 0] = -1.0
    pts[:, 1] = 1.0
    return img, pts


def _flame(rng, b):
    flame = np.zeros((b, 236), np.float32)
    flame[:, :100] = rng.standard_normal((b, 100)) * 0.3
    flame[:, 100:150] = rng.standard_normal((b, 50)) * 0.3
    flame[:, 150:156] = rng.standard_normal((b, 6)) * 0.05
    flame[:, 156] = rng.uniform(7.0, 9.0, b)
    flame[:, 157:159] = rng.standard_normal((b, 2)) * 0.02
    flame[:, 159:209] = rng.standard_normal((b, 50))
    flame[:, 209:236] = rng.standard_normal((b, 27))
    return flame


def test_sample_at_points_forward_matches_jax():
    img, pts = _img_pts(np.random.default_rng(0))
    got = sampling_ops.sample_at_points(torch.from_numpy(img), torch.from_numpy(pts))
    want = j_sample_at_points(jnp.asarray(img), jnp.asarray(pts))
    assert got.dtype == torch.float32 and got.shape == (2, 40, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape,reference", [
    ((2, 9, 11, 3, 40), "custom_vjp"),
    # Over thousands of points the sort / cumsum backward loses ~1e-5
    # absolutely (a difference of two running sums); held there to XLA's
    # autodiff of the plain gather (a scatter-add) instead.
    ((3, 32, 32, 3, 2001), "autodiff"),
])
def test_sample_at_points_gradient_matches_jax_vjp(shape, reference):
    from gif_tpu.render.sampling_ops import _sample_fwd_impl

    b, h, w, c, p = shape
    rng = np.random.default_rng(1)
    img, pts = _img_pts(rng, b, h, w, c, p)
    cot = rng.standard_normal((b, p, c)).astype(np.float32)
    fn = j_sample_at_points if reference == "custom_vjp" else _sample_fwd_impl
    _, vjp = jax.vjp(fn, jnp.asarray(img), jnp.asarray(pts))
    want_img, want_pts = vjp(jnp.asarray(cot))
    ti = torch.from_numpy(img).requires_grad_(True)
    tp = torch.from_numpy(pts).requires_grad_(True)
    before = scatter_cuda.scatter_bilinear.launches
    sampling_ops.sample_at_points(ti, tp).backward(torch.from_numpy(cot))
    assert scatter_cuda.scatter_bilinear.launches == before  # CPU: the plain version
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(want_img), rtol=1e-5, atol=1e-6)
    assert tp.grad is None
    if reference == "custom_vjp":
        assert not np.asarray(want_pts).any()


def test_scatter_plain_matches_tpu_kernel_interpret():
    rng = np.random.default_rng(2)
    b, h, w, c, p = 2, 64, 64, 2, 300
    pts = rng.uniform(-1.2, 1.2, (b, p, 2)).astype(np.float32)
    g = rng.standard_normal((b, p, c)).astype(np.float32)
    got = sampling_ops.scatter_bilinear_plain(torch.from_numpy(g), torch.from_numpy(pts), h, w)
    want = scatter_bilinear_mxu(jnp.asarray(g), jnp.asarray(pts), h, w)
    assert got.shape == (b, h, w, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)


def test_scatter_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (2, 50, 2)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 50, 3)).astype(np.float32))
    before = scatter_cuda.scatter_bilinear.launches
    got = scatter_cuda.scatter_bilinear(g, pts, 16, 8)
    assert scatter_cuda.scatter_bilinear.launches == before
    assert torch.equal(got, sampling_ops.scatter_bilinear_plain(g, pts, 16, 8))


def _smooth_image(b, s):
    """Slowly varying images: a texel's value moves with its projected
    point, which carries FLAME decode's ~1e-6 relative differences between
    the packages; on white noise that alone exceeds rtol 1e-5."""
    y, x = np.meshgrid(np.linspace(0, 1, s), np.linspace(0, 1, s), indexing="ij")
    img = np.stack([np.sin(2 * x + 1 + k) * np.cos(1.5 * y + k) for k in range(3)], -1)
    return np.stack([img * (0.5 + 0.25 * i) for i in range(b)]).astype(np.float32)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_steal_texture_matches_jax(mesh):
    """Identical geometry in both packages; white-noise source images."""
    res_t = synthetic_flame_resources(**MESHES[mesh])
    res_j = j_synth(**MESHES[mesh])
    flat = res_t.texture_y_coords * 256 + res_t.texture_x_coords
    assert len(np.unique(flat)) < len(flat)  # duplicates: last write wins is exercised
    rng = np.random.default_rng(4)
    v = res_t.n_vertices
    verts = (res_t.v_template[None] + rng.standard_normal((2, v, 3)) * 0.002).astype(np.float32)
    vnorm = rng.standard_normal((2, v, 3)).astype(np.float32)
    vnorm /= np.linalg.norm(vnorm, axis=-1, keepdims=True)
    cam = np.array([[8.0, 0.01, -0.02], [7.5, -0.03, 0.02]], np.float32)
    src = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    tex_j, vis_j = jts.steal_texture(res_j, *map(jnp.asarray, (src, verts, vnorm, cam)))
    tex_t, vis_t = tts.steal_texture(res_t, *map(torch.from_numpy, (src, verts, vnorm, cam)))
    assert tex_t.shape == (2, 256, 256, 3) and vis_t.shape == (2, 256, 256, 1)
    np.testing.assert_array_equal(vis_t.numpy(), np.asarray(vis_j))
    np.testing.assert_allclose(tex_t.numpy(), np.asarray(tex_j), rtol=1e-5, atol=noise_atol(64))
    texels, entries = tts.texel_inverse_map(res_t, "cpu")
    assert len(texels) == len(np.unique(flat)) == len(np.unique(entries.numpy()))
    assert texels is tts.texel_inverse_map(res_t, "cpu")[0]  # built once per device


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_flame_texture_space_matches_jax(mesh):
    """Decode, projected normals and the steal, from FLAME parameters."""
    res_t = synthetic_flame_resources(**MESHES[mesh])
    res_j = j_synth(**MESHES[mesh])
    flame = _flame(np.random.default_rng(4), 2)
    src = _smooth_image(2, 64)
    tex_j, vis_j = jts.flame_texture_space(res_j, jnp.asarray(src), jnp.asarray(flame))
    tex_t, vis_t = tts.flame_texture_space(res_t, torch.from_numpy(src), torch.from_numpy(flame))
    vis_j = np.asarray(vis_j)
    assert vis_j.any() and not vis_j.all()
    np.testing.assert_array_equal(vis_t.numpy(), vis_j)
    np.testing.assert_allclose(tex_t.numpy(), np.asarray(tex_j), rtol=1e-5, atol=TEX_ATOL)


def test_interp_helpers_match_jax():
    rng = np.random.default_rng(5)
    flame = _flame(rng, 5)
    key = jax.random.PRNGKey(3)
    t = jax.random.uniform(key)
    want = jl.interpolate_flame_batch(jnp.asarray(flame), key)
    got = tl.interpolate_flame_batch(torch.from_numpy(flame), np.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        tl.interp_render_flame(got).numpy(), np.asarray(jl.interp_render_flame(want))
    )
    textured, normal = (rng.uniform(-0.2, 1.2, (2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    for rend, norm in ((True, True), (True, False), (False, True)):
        kw = dict(rendered_flame_as_condition=rend, normal_maps_as_cond=norm)
        np.testing.assert_array_equal(
            tl.interp_condition_channels(torch.from_numpy(textured), torch.from_numpy(normal), **kw).numpy(),
            np.asarray(jl.interp_condition_channels(jnp.asarray(textured), jnp.asarray(normal), **kw)),
        )


@pytest.mark.parametrize("mask", ["resources", "resized", "none"])
def test_interp_penalty_and_image_gradient_match_jax(mask):
    res_t = synthetic_flame_resources(seed=1, n_vertices=503)
    res_j = j_synth(seed=1, n_vertices=503)
    rng = np.random.default_rng(6)
    n = 4
    flame = _flame(rng, n)
    images = rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)
    frm = {
        "resources": res_t.face_region_mask,
        "resized": rng.uniform(0, 1, (100, 120)).astype(np.float32),
        "none": None,
    }[mask]
    key = jax.random.PRNGKey(7)
    sel = jax.random.choice(key, n * (n - 1) // 2, (n,), replace=False)

    def j_pen(im):
        return jl.interp_penalty_from_images(
            res_j, im, jnp.asarray(flame), key, None if frm is None else jnp.asarray(frm)
        )

    want, want_grad = jax.value_and_grad(j_pen)(jnp.asarray(images))
    ti = torch.from_numpy(images).requires_grad_(True)
    got = tl.interp_penalty_from_images(
        res_t, ti, torch.from_numpy(flame), np.asarray(sel),
        None if frm is None else torch.from_numpy(frm),
    )
    (got_grad,) = torch.autograd.grad(got, ti)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert np.abs(np.asarray(want_grad)).max() > 0
    np.testing.assert_allclose(
        got_grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-5 * np.abs(np.asarray(want_grad)).max()
    )


def test_interp_penalty_refuses_one_interpolant():
    res_t = synthetic_flame_resources(seed=1, n_vertices=503)
    with pytest.raises(ValueError, match=">= 2 interpolated samples"):
        tl.interp_penalty_from_images(
            res_t, torch.zeros((1, 32, 32, 3)), torch.from_numpy(_flame(np.random.default_rng(0), 1))
        )


def test_interp_draws_come_from_the_generator():
    """Left None, t, the identity and the pairs are drawn from the
    generator passed: the same seed gives the same loss."""
    res_t = synthetic_flame_resources(seed=1, n_vertices=503)
    flame = torch.from_numpy(_flame(np.random.default_rng(8), 4))
    flame[:, 156] = 8.0
    weights = torch.randn((8,), generator=torch.Generator().manual_seed(0))

    def gen_apply(cond, idx):
        return torch.tanh(cond[..., :3] * weights[idx][:, None, None, None])

    def loss(seed):
        g = torch.Generator().manual_seed(seed)
        fl = tl.interpolate_flame_batch(flame, generator=g)
        return tl.texture_interpolation_loss(
            res_t, fl, gen_apply, generator=g, max_ids=8, image_size=32,
            face_region_mask=torch.from_numpy(res_t.face_region_mask),
        ).item()

    assert loss(1) == loss(1) > 0
