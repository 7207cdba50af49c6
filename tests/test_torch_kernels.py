"""The port's hand-written kernels against their plain PyTorch versions, on
a card.  Every kernel computes in its plain version's arithmetic order
with explicitly rounded operations, so the bar is equality — except the
bilinear scatter (kernel 6), whose atomics add in no fixed order: its bar
is ``max |got - plain| <= 1e-5 * max |plain| + 1e-7``.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch (skip the JAX-importing conftest there):

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Without a CUDA device every test here skips.
"""

import numpy as np
import pytest
import torch

from gif_tpu_torch.ops import activations, blur_cuda
from gif_tpu_torch.render import raster, raster_cuda, sampler_cuda, sampling_ops, scatter_cuda, shading
from torch_port_common import cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda


def _random_faces(rng, b, n_faces, h, w):
    centers = rng.uniform(5, min(h, w) - 5, size=(b, n_faces, 1, 2))
    offsets = rng.uniform(-12, 12, size=(b, n_faces, 3, 2))
    z = rng.uniform(1.0, 20.0, size=(b, n_faces, 3, 1))
    return np.concatenate([centers + offsets, z], axis=-1).astype(np.float32)


@pytest.mark.parametrize("cap", [256, 16])  # 16: tiles overflow
def test_raster_kernel_matches_plain(cuda_device, cap):
    rng = np.random.default_rng(0)
    fv = torch.from_numpy(_random_faces(rng, 2, 600, 128, 128)).to(cuda_device)
    attrs = torch.from_numpy(rng.standard_normal((2, 600, 3, 5)).astype(np.float32)).to(cuda_device)
    before = raster_cuda.rasterize_with_attrs.launches
    got, got_img = raster_cuda.rasterize_with_attrs(fv, attrs, 128, 128, 32, cap)
    want, want_img = raster.rasterize_plain(fv, attrs, h=128, w=128, tile=32, max_tris_per_tile=cap)
    torch.cuda.synchronize()
    assert raster_cuda.rasterize_with_attrs.launches == before + 1
    assert (want.tri_id >= 0).float().mean() > 0.3
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got_img, want_img)


def _raster_case(case, rng):
    """(faces, attrs, h, w, tile, caps) of one bit-equality case."""
    h = w = 128
    if case == "z_ties":  # duplicated faces under other ids: the lowest id wins
        base = _random_faces(rng, 2, 200, h, w)
        fv = np.concatenate([base, base[:, ::-1], base], axis=1)
    elif case == "degenerate_backfacing":
        fv = _random_faces(rng, 2, 600, h, w)
        fv[:, :150] = fv[:, :150, [0, 2, 1]]
        line = np.linspace(0, 1, 3, dtype=np.float32)[:, None]
        fv[:, 150:200, :, :2] = fv[:, 150:200, :1, :2] + line * (fv[:, 150:200, 1:2, :2] - fv[:, 150:200, :1, :2])
        fv[:, 200:220, :, :2] = fv[:, 200:220, :1, :2]
    elif case == "near_integer":  # corners one ulp either side of integer pixels
        fv = _random_faces(rng, 2, 800, h, w)
        fv[..., :2] = np.round(fv[..., :2] / 3.0)
        fv[..., :2] = fv[..., :2] * 3.0
        toward = np.where(rng.integers(0, 2, fv[..., :2].shape) == 1, np.inf, -np.inf).astype(np.float32)
        fv[..., :2] = np.where(rng.integers(0, 3, fv[..., :2].shape) == 0, fv[..., :2],
                               np.nextafter(fv[..., :2], toward))
    elif case == "slivers":  # nearly collinear corners: rounding draws them far off
        p0 = rng.uniform(8, h - 8, size=(2, 1500, 2))
        d = rng.normal(size=(2, 1500, 2)) * rng.choice([0.3, 3.0, 20.0], size=(2, 1500, 1))
        off = rng.normal(size=(2, 1500, 2)) * 10.0 ** rng.uniform(-7, 0, size=(2, 1500, 1))
        xy = np.stack([p0, p0 + d, p0 + rng.uniform(0.2, 1, (2, 1500, 1)) * d + off], axis=2)
        fv = np.concatenate([xy, rng.uniform(1, 4, (2, 1500, 3, 1))], axis=-1)
    elif case == "crowded_tile":  # 3000 small faces in one 32 x 32 tile
        centers = rng.uniform(34, 62, size=(1, 3000, 1, 2))
        xy = centers + rng.uniform(-2, 2, size=(1, 3000, 3, 2))
        fv = np.concatenate([xy, rng.uniform(1, 20, (1, 3000, 3, 1))], axis=-1)
    else:  # "large": 24-px faces over a 256-px image
        h = w = 256
        fv = _random_faces(rng, 3, 1500, h, w)
    fv = fv.astype(np.float32)
    attrs = rng.standard_normal(fv.shape[:2] + (3, 5)).astype(np.float32)
    return fv, attrs, h, w, 32, [fv.shape[1], 16]


@pytest.mark.parametrize("case", ["z_ties", "degenerate_backfacing", "near_integer", "slivers", "crowded_tile",
                                  "large"])
def test_raster_kernel_bit_equal_cases(cuda_device, case):
    fv_np, attrs_np, h, w, tile, caps = _raster_case(case, np.random.default_rng(10))
    fv = torch.from_numpy(fv_np).to(cuda_device)
    attrs = torch.from_numpy(attrs_np).to(cuda_device)
    for cap in caps:
        got, got_img = raster_cuda.rasterize_with_attrs(fv, attrs, h, w, tile, cap)
        want, want_img = raster.rasterize_plain(fv, attrs, h=h, w=w, tile=tile, max_tris_per_tile=cap)
        torch.cuda.synchronize()
        for a, b, name in zip((*got, got_img), (*want, want_img), ("depth", "tri_id", "bary", "overflow", "attrs")):
            assert a.dtype == b.dtype and torch.equal(a, b), (case, cap, name)
    if case == "crowded_tile":
        ids, counts, _ = raster.bin_faces(fv, tile, fv.shape[1], h, w)
        assert int(counts.max()) > 1024
    if case == "z_ties":
        assert int(want.tri_id.max()) < 400  # under cap 16 too: the third copy never wins


def test_raster_kernel_call_never_syncs(cuda_device):
    """The whole call — binning included — is queued on the stream: no
    host-device synchronization, so it runs under sync debug mode "error"."""
    rng = np.random.default_rng(11)
    fv = torch.from_numpy(_random_faces(rng, 4, 2000, 256, 256)).to(cuda_device)
    attrs = torch.from_numpy(rng.standard_normal((4, 2000, 3, 5)).astype(np.float32)).to(cuda_device)
    raster_cuda.rasterize_with_attrs(fv, attrs, 256, 256, 32, 128)  # builds and loads the library
    torch.cuda.synchronize()
    before = raster_cuda.rasterize_with_attrs.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, got_img = raster_cuda.rasterize_with_attrs(fv, attrs, 256, 256, 32, 128)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, want_img = raster.rasterize_plain(fv, attrs, h=256, w=256, tile=32, max_tris_per_tile=128)
    assert raster_cuda.rasterize_with_attrs.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and torch.equal(got_img, want_img)


def test_sampler_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.uniform(0, 1, (4, 256, 256, 3)).astype(np.float32)).to(cuda_device)
    grid = torch.from_numpy(rng.uniform(-1.2, 1.2, (4, 64, 64, 2)).astype(np.float32)).to(cuda_device)
    before = sampler_cuda.grid_sample.launches
    got = sampler_cuda.grid_sample(img, grid)
    want = shading.grid_sample_bilinear(img, grid)
    torch.cuda.synchronize()
    assert sampler_cuda.grid_sample.launches == before + 1
    assert torch.equal(got, want)


def _nchw_images(rng, b, h, w, device):
    """(B, H, W, 3) float32 NHWC views of NCHW memory, as the generator
    returns its images."""
    x = torch.from_numpy(rng.uniform(-1, 1, (b, 3, h, w)).astype(np.float32)).to(device)
    return x.permute(0, 2, 3, 1)


@pytest.mark.parametrize("case", ["albedo_nhwc", "nchw_view", "nchw_batch_slice", "nchw_odd_width"])
def test_sampler_kernel_reads_strided_images(cuda_device, case):
    rng = np.random.default_rng(2)
    if case == "albedo_nhwc":
        img = torch.from_numpy(rng.uniform(0, 1, (3, 64, 48, 3)).astype(np.float32)).to(cuda_device)
        grid = torch.from_numpy(rng.uniform(-1.1, 1.1, (3, 64, 48, 2)).astype(np.float32)).to(cuda_device)
    else:
        img = _nchw_images(rng, 5, 64, 45 if case == "nchw_odd_width" else 48, cuda_device)
        pts = torch.from_numpy(rng.uniform(-1.1, 1.1, (5, 2001, 2)).astype(np.float32)).to(cuda_device)
        if case == "nchw_batch_slice":  # the texture steal: G's interpolant rows
            img, pts = img[2:], pts[2:]
        grid = pts[:, :, None, :]
        assert not img.is_contiguous()
    before = sampler_cuda.grid_sample.launches
    got = sampler_cuda.grid_sample(img, grid)
    torch.cuda.synchronize()
    assert sampler_cuda.grid_sample.launches == before + 1
    assert torch.equal(got, shading.grid_sample_bilinear(img, grid))
    assert torch.equal(got, shading.grid_sample_bilinear(img.contiguous(), grid))


def test_sampler_kernel_makes_no_copy(cuda_device):
    rng = np.random.default_rng(3)
    img = _nchw_images(rng, 16, 256, 256, cuda_device)[1:]
    grid = torch.from_numpy(rng.uniform(-1, 1, (15, 20000, 1, 2)).astype(np.float32)).to(cuda_device)
    sampler_cuda.grid_sample(img, grid)  # first launch: builds and loads the library
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats(cuda_device)
    n_alloc, n_bytes = stats["allocation.all.allocated"], stats["allocated_bytes.all.allocated"]
    out = sampler_cuda.grid_sample(img, grid)
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats(cuda_device)
    # One allocation, the output's (rounded up to the caching allocator's
    # 512-byte blocks): no copy of the 11.8 MB image or the grid.
    assert stats["allocation.all.allocated"] - n_alloc == 1
    assert 0 <= stats["allocated_bytes.all.allocated"] - n_bytes - out.numel() * 4 < 512


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flr_kernel_matches_plain(cuda_device, dtype):
    x = torch.randn((8, 512, 33, 33), device=cuda_device).to(dtype)
    b = torch.randn(512, device=cuda_device)
    before = activations.fused_leaky_relu.launches
    got = activations.fused_leaky_relu(x, b)
    want = activations.fused_leaky_relu_plain(x, b)
    torch.cuda.synchronize()
    assert activations.fused_leaky_relu.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pads", [(1, 1, 1, 1), (2, 1, 0, 3)])
def test_blur_kernel_matches_plain(cuda_device, dtype, pads):
    x = torch.randn((4, 64, 65, 67), device=cuda_device).to(dtype)
    taps = blur_cuda.taps_1d((1, 3, 3, 1), 4.0)
    before = blur_cuda.blur4.launches
    got = blur_cuda.blur4(x, taps, pads)
    want = blur_cuda.blur4_plain(x, taps[::-1], pads)
    torch.cuda.synchronize()
    assert blur_cuda.blur4.launches == before + 1
    assert torch.equal(got, want)


# Kernel 4's paths (ops/blur_cuda.py::blur4_launch_geometry): whole planes
# (maps up to 24 px), strips with 16-byte row loads (width a multiple of 8,
# aligned base), strips with scalar loads (odd widths, and a batch slice
# whose base is off the 16-byte grid), each with aligned and unaligned
# output rows.
BLUR_INPUTS = {
    "planes": (16, 64, 9, 9),
    "planes_odd": (3, 5, 17, 13),
    "strips_vec": (2, 32, 64, 64),
    "strips_vec_tall": (1, 16, 130, 128),
    "strips_scalar": (2, 16, 65, 67),
    "strips_wide": (1, 4, 257, 255),
    "strips_slice": (3, 8, 40, 64),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pads", [(1, 1, 1, 1), (2, 2, 2, 2), (1, 2, 1, 2), (0, 3, 0, 3)])
@pytest.mark.parametrize("path", list(BLUR_INPUTS))
def test_blur_kernel_paths_match_plain(cuda_device, path, pads, dtype):
    shape = BLUR_INPUTS[path]
    x = torch.randn(int(np.prod(shape)) + 3, device=cuda_device).to(dtype)
    # A contiguous input whose base is 16-byte aligned, or 3 elements past
    # that (as a slice of a larger buffer may be).
    x = (x[3:] if path == "strips_slice" else x[:-3]).reshape(shape).requires_grad_(True)
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == (path == "strips_slice")
    taps = blur_cuda.taps_1d((1, 3, 3, 1), 4.0)
    before = blur_cuda.blur4.launches, blur_cuda.blur4_vjp.launches
    out = blur_cuda.blur4(x, taps, pads)
    g = torch.randn(out.shape, device=cuda_device).to(dtype)
    (dx,) = torch.autograd.grad(out, x, g)
    torch.cuda.synchronize()
    assert (blur_cuda.blur4.launches, blur_cuda.blur4_vjp.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(out, blur_cuda.blur4_plain(x.detach(), taps[::-1], pads))
    assert torch.equal(dx, blur_cuda.blur4_plain(g, taps, tuple(3 - p for p in pads)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flr_backward_kernel_matches_plain(cuda_device, dtype):
    x = torch.randn((8, 512, 33, 33), device=cuda_device).to(dtype).requires_grad_(True)
    b = torch.randn(512, device=cuda_device).requires_grad_(True)
    g = torch.randn((8, 512, 33, 33), device=cuda_device).to(dtype)
    g = g.to(memory_format=torch.channels_last).requires_grad_(True)  # as cuDNN may hand it
    before = activations.fused_leaky_relu_backward.launches
    dx, db = torch.autograd.grad(activations.fused_leaky_relu(x, b), (x, b), g, create_graph=True)
    want = activations.fused_leaky_relu_backward_plain(x.detach(), b.detach(), g.detach())
    torch.cuda.synchronize()
    assert activations.fused_leaky_relu_backward.launches == before + 1
    assert dx.dtype == dtype and torch.equal(dx, want)
    torch.testing.assert_close(db, want.float().sum((0, 2, 3)), rtol=1e-5, atol=1e-3)
    # Grad-of-grad: kernel 5 again, on the incoming gradient.
    u = torch.randn_like(dx)
    (dg,) = torch.autograd.grad((dx * u).sum(), g)
    torch.cuda.synchronize()
    assert activations.fused_leaky_relu_backward.launches == before + 2
    assert torch.equal(dg, activations.fused_leaky_relu_backward_plain(x.detach(), b.detach(), u))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pads", [(2, 2, 2, 2), (1, 1, 1, 1)])
def test_blur_vjp_kernel_matches_plain(cuda_device, dtype, pads):
    x = torch.randn((4, 64, 64, 64), device=cuda_device).to(dtype).requires_grad_(True)
    taps = blur_cuda.taps_1d((1, 3, 3, 1), 1.0)
    out = blur_cuda.blur4(x, taps, pads)
    g = torch.randn(out.shape, device=cuda_device).to(dtype).to(memory_format=torch.channels_last)
    before_f, before_v = blur_cuda.blur4.launches, blur_cuda.blur4_vjp.launches
    (dx,) = torch.autograd.grad(out, x, g)
    want = blur_cuda.blur4_plain(g, taps, tuple(3 - p for p in pads))
    torch.cuda.synchronize()
    assert (blur_cuda.blur4.launches, blur_cuda.blur4_vjp.launches) == (before_f, before_v + 1)
    assert dx.shape == x.shape and torch.equal(dx, want)


def _scatter_points(rng, b, p, h, w, layout="mixed"):
    """Points over [-1.2, 1.2]^2 (some outside the image), a third of them
    on one texel (contention), and the corners and edges exactly; or all
    in one 8 x 8 pixel region ("clustered"), spread over the image
    ("spread"), or all outside it ("outside")."""
    if layout == "clustered":
        px = rng.uniform(0, 8, (b, p, 2)) + np.array([w // 3, h // 2])
        return (2 * (px + 0.5) / np.array([w, h]) - 1).astype(np.float32)
    if layout == "spread":
        return rng.uniform(-1, 1, (b, p, 2)).astype(np.float32)
    if layout == "outside":
        return (rng.choice([-1, 1], (b, p, 2)) * rng.uniform(1 + 2.0 / min(h, w), 3, (b, p, 2))).astype(np.float32)
    pts = rng.uniform(-1.2, 1.2, (b, p, 2)).astype(np.float32)
    pts[:, : p // 3] = (2 * (np.array([5.5, 3.5]) + 0.25) / np.array([w, h]) - 1).astype(np.float32)
    pts[:, -4:] = np.array([[-1, -1], [1, 1], [-1, 1], [1 - 1e-7, -1]], np.float32)
    return pts


@pytest.mark.parametrize("layout", ["mixed", "clustered", "spread", "outside"])
@pytest.mark.parametrize("b,p,h,w,c", [(3, 20001, 64, 48, 3), (2, 777, 256, 256, 3), (1, 5, 7, 9, 2),
                                       (15, 20000, 256, 256, 3)])
def test_scatter_kernel_matches_plain(cuda_device, b, p, h, w, c, layout):
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(_scatter_points(rng, b, p, h, w, layout)).to(cuda_device)
    g = torch.from_numpy(rng.standard_normal((b, p, c)).astype(np.float32)).to(cuda_device)
    before = scatter_cuda.scatter_bilinear.launches
    got = scatter_cuda.scatter_bilinear(g, pts, h, w)
    want = sampling_ops.scatter_bilinear_plain(g, pts, h, w)
    torch.cuda.synchronize()
    assert scatter_cuda.scatter_bilinear.launches == before + 1
    assert got.shape == (b, h, w, c) and got.dtype == torch.float32
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item() + 1e-7, err
    if layout == "outside":
        assert not bool(got.any())  # every element written, and zero


def test_sample_at_points_launches_kernels_2_and_6(cuda_device):
    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.standard_normal((2, 64, 64, 3)).astype(np.float32)).to(cuda_device)
    pts = torch.from_numpy(_scatter_points(rng, 2, 1001, 64, 64)).to(cuda_device)
    cot = torch.from_numpy(rng.standard_normal((2, 1001, 3)).astype(np.float32)).to(cuda_device)
    img.requires_grad_(True)
    before = sampler_cuda.grid_sample.launches, scatter_cuda.scatter_bilinear.launches
    out = sampling_ops.sample_at_points(img, pts)
    (d_img,) = torch.autograd.grad(out, img, cot)
    torch.cuda.synchronize()
    assert (sampler_cuda.grid_sample.launches, scatter_cuda.scatter_bilinear.launches) == (
        before[0] + 1, before[1] + 1)
    want = shading.grid_sample_bilinear(img.detach(), pts[:, :, None, :])[:, :, 0]
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    plain = sampling_ops.scatter_bilinear_plain(cot, pts, 64, 64)
    assert (d_img - plain).abs().max().item() <= 1e-5 * plain.abs().max().item() + 1e-7


def test_kernel_wrappers_raise_on_unsupported_input(cuda_device):
    with pytest.raises(ValueError):
        blur_cuda.blur4(torch.zeros((1, 1, 8, 8), dtype=torch.float16, device=cuda_device),
                        blur_cuda.taps_1d((1, 3, 3, 1), 1.0), (1, 1, 1, 1))
    with pytest.raises(ValueError):
        sampler_cuda.grid_sample(torch.zeros((1, 4, 4, 3), dtype=torch.float64, device=cuda_device),
                                 torch.zeros((1, 2, 2, 2), dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):
        scatter_cuda.scatter_bilinear(torch.zeros((1, 4, 3), dtype=torch.float64, device=cuda_device),
                                      torch.zeros((1, 4, 2), dtype=torch.float64, device=cuda_device), 8, 8)


def _albedo_points(rng, b, n, device):
    """(b, n, 2) grid points as the albedo lookup makes them at 256 px: about
    two thirds background pixels, whose interpolated UV is 0 (grid -1: one
    valid tap, on texel (0, 0)), the rest spread over the face's UV
    region."""
    pts = rng.uniform(-0.8, 0.8, (b, n, 2)).astype(np.float32)
    pts[rng.uniform(size=(b, n)) < 0.65] = -1.0
    return torch.from_numpy(pts).to(device)


def test_scatter_kernel_at_the_albedo_shape(cuda_device):
    """Kernel 6 as the albedo lookup's image gradient: 65536 points a sample
    (a 256 x 256 render) into the 256 x 256 x 3 albedo map."""
    rng = np.random.default_rng(8)
    pts = _albedo_points(rng, 4, 256 * 256, cuda_device)
    g = torch.from_numpy(rng.standard_normal((4, 256 * 256, 3)).astype(np.float32)).to(cuda_device)
    before = scatter_cuda.scatter_bilinear.launches
    got = scatter_cuda.scatter_bilinear(g, pts, 256, 256)
    want = sampling_ops.scatter_bilinear_plain(g, pts, 256, 256)
    torch.cuda.synchronize()
    assert scatter_cuda.scatter_bilinear.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item() + 1e-7


def test_raster_function_backward_matches_plain(cuda_device):
    """Kernel 1's autograd Function: the attribute gradient (an index_add_
    on the kernel's winners) equals the autograd of the plain version's
    gather up to the order of their atomic sums; positions get none."""
    rng = np.random.default_rng(9)
    fv = torch.from_numpy(_random_faces(rng, 2, 600, 128, 128)).to(cuda_device).requires_grad_(True)
    attrs = torch.from_numpy(rng.standard_normal((2, 600, 3, 5)).astype(np.float32)).to(cuda_device)
    attrs.requires_grad_(True)
    cot = torch.from_numpy(rng.standard_normal((2, 128, 128, 5)).astype(np.float32)).to(cuda_device)
    _, img = raster_cuda.rasterize_with_attrs(fv, attrs, 128, 128, 32, 256)
    d_fv, got = torch.autograd.grad(img, (fv, attrs), cot, allow_unused=True)
    _, plain_img = raster.rasterize_plain(fv, attrs, h=128, w=128, tile=32, max_tris_per_tile=256)
    (want,) = torch.autograd.grad(plain_img, attrs, cot)
    assert d_fv is None and want.abs().max().item() > 0
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item() + 1e-7


def test_sampler_function_backward_matches_plain(cuda_device):
    """``grid_sample`` on the card: forward kernel 2, image gradient kernel 6
    (its bar), grid gradient plain torch — against the autograd of the plain
    sampler on the same card tensors (rtol 1e-5 of the largest entry)."""
    rng = np.random.default_rng(10)
    img = torch.from_numpy(rng.uniform(0, 1, (4, 256, 256, 3)).astype(np.float32)).to(cuda_device)
    grid = _albedo_points(rng, 4, 128 * 128, cuda_device).reshape(4, 128, 128, 2)
    cot = torch.from_numpy(rng.standard_normal((4, 128, 128, 3)).astype(np.float32)).to(cuda_device)
    img.requires_grad_(True)
    grid.requires_grad_(True)
    before = sampler_cuda.grid_sample.launches, scatter_cuda.scatter_bilinear.launches
    out = sampler_cuda.grid_sample(img, grid)
    d_img, d_grid = torch.autograd.grad(out, (img, grid), cot)
    torch.cuda.synchronize()
    assert (sampler_cuda.grid_sample.launches, scatter_cuda.scatter_bilinear.launches) == (
        before[0] + 1, before[1] + 1)
    want_out = shading.grid_sample_bilinear(img, grid)
    want_img, want_grid = torch.autograd.grad(want_out, (img, grid), cot)
    assert torch.equal(out, want_out.detach())
    assert (d_img - want_img).abs().max().item() <= 1e-5 * want_img.abs().max().item() + 1e-7
    assert (d_grid - want_grid).abs().max().item() <= 1e-5 * want_grid.abs().max().item()


def test_two_rank_step_on_one_card_stays_bit_equal(cuda_device, tmp_path):
    """Two ranks (gloo: NCCL refuses two ranks on one card) take two tiny
    run_id-8 steps on the card, each on its half of the batch (R1 on the
    second): the replicas' G, D and EMA stay bit-equal after each step,
    and kernels 1-5 launch on both ranks."""
    from torch_parallel_ranks import cuda_steps, run_ranks

    run_ranks(cuda_steps, 2, str(tmp_path / "rank{}.pt"))
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2))
    assert r0["digests"] == r1["digests"] and r0["digests"][0] != r0["digests"][1]
    assert r0["r1"] > 0 and r0["used"] == r1["used"] == 16
    for r in (r0, r1):
        assert all(n > 0 for n in r["launches"]), r["launches"]


def _posed_ndc(device):
    """Three posed heads of the 503-vertex mesh through the renderer's
    camera and y / z flips, on ``device``."""
    from gif_tpu_torch.flame.camera import batch_orth_proj
    from gif_tpu_torch.flame.decoder import flame_decode
    from gif_tpu_torch.flame.resources import synthetic_flame_resources

    res = synthetic_flame_resources(seed=1, n_vertices=503)
    rng = np.random.default_rng(12)
    codes = [torch.from_numpy((rng.standard_normal((3, n)) * s).astype(np.float32)).to(device)
             for n, s in ((100, 0.5), (50, 0.5), (6, 0.3))]
    cam = torch.tensor([[8.0, 0.0, 0.0], [6.0, 0.02, -0.03], [9.0, -0.01, 0.01]], device=device)
    trans = batch_orth_proj(flame_decode(res, *codes), cam)
    return res, codes, cam, torch.cat([trans[:, :, :1], -trans[:, :, 1:]], dim=2)


def _plain_raster(monkeypatch):
    monkeypatch.setattr(raster_cuda, "rasterize_cuda", lambda fv, a, h, w, tile, cap: raster.rasterize_plain(
        fv, a, h=h, w=w, tile=tile, max_tris_per_tile=cap))


@pytest.mark.parametrize("which", ["get_visibility", "get_visibility_z"])
def test_visibility_on_the_card_equals_the_plain_path(cuda_device, monkeypatch, which):
    """Per-vertex visibility through kernel 1 (one launch) equals the same
    function through the plain rasterizer on the same card tensors."""
    res, _, _, verts = _posed_ndc(cuda_device)
    fn = getattr(raster, which)
    before = raster_cuda.rasterize_with_attrs.launches
    got = fn(verts, res.faces, 256, 256)
    torch.cuda.synchronize()
    assert raster_cuda.rasterize_with_attrs.launches == before + 1
    _plain_raster(monkeypatch)
    want = fn(verts, res.faces, 256, 256)
    assert torch.equal(got, want) and got.is_cuda
    assert bool((want > 0).any()) and bool((want == 0).any())


def test_constant_albedo_render_on_the_card_equals_the_plain_render(cuda_device, monkeypatch):
    """``constant_albedo`` on the card: kernel 1 launches once, kernel 2
    never, and the maps equal the render through the plain rasterizer —
    the normal map within 1e-5: the vertex normals are ``index_add_`` sums,
    whose atomics add in no fixed order on the card (the ambient-only
    light makes the textured map independent of them)."""
    from gif_tpu_torch.render import renderer

    res, (shape, exp, pose), cam, _ = _posed_ndc(cuda_device)
    tex = torch.zeros((3, 50), device=cuda_device)
    light = torch.zeros((3, 9, 3), device=cuda_device)
    light[:, 0] = 3.0
    before = raster_cuda.rasterize_with_attrs.launches, sampler_cuda.grid_sample.launches
    got = renderer.render_tex_and_normal(res, shape, exp, pose, tex, light, cam, image_size=256,
                                         max_tris_per_tile=None, constant_albedo=0.6)
    torch.cuda.synchronize()
    assert (raster_cuda.rasterize_with_attrs.launches, sampler_cuda.grid_sample.launches) == (
        before[0] + 1, before[1])
    _plain_raster(monkeypatch)
    want = renderer.render_tex_and_normal(res, shape, exp, pose, tex, light, cam, image_size=256,
                                          max_tris_per_tile=None, constant_albedo=0.6)
    for name in ("textured", "mask", "depth", "overflow"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert (got.normal - want.normal).abs().max().item() <= 1e-5
    assert bool(want.mask.any())


# The `even` resampling mode's kernel-4 calls (ops/conv.py, models/layers.py):
# the upsample blur's (1, 0) on the even (2H + 2)-sized transposed-conv
# output, the down-blurs' (2, 3) before a 3x3 and (1, 2) before the 1x1
# skip; and their VJP pads 3 - p.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,pads,gain", [((4, 64, 66, 66), (1, 0, 1, 0), 4.0),
                                             ((4, 64, 64, 64), (2, 3, 2, 3), 1.0),
                                             ((4, 64, 32, 32), (1, 2, 1, 2), 1.0)])
def test_blur_kernel_at_the_even_mode_pads(cuda_device, dtype, shape, pads, gain):
    x = torch.randn(shape, device=cuda_device).to(dtype).requires_grad_(True)
    taps = blur_cuda.taps_1d((1, 3, 3, 1), gain)
    got = blur_cuda.blur4(x, taps, pads)
    want = blur_cuda.blur4_plain(x.detach(), taps[::-1], pads)
    assert got.shape[2] % 2 == 0 and torch.equal(got, want)
    g = torch.randn_like(got)
    (dx,) = torch.autograd.grad(got, x, g)
    want_dx = blur_cuda.blur4_plain(g, taps, tuple(3 - p for p in pads))
    torch.cuda.synchronize()
    assert torch.equal(dx, want_dx)


@pytest.mark.parametrize("layout", ["mixed", "clustered", "spread"])
def test_scatter_kernel_is_bit_equal_across_calls_under_determinism(cuda_device, layout):
    """The fixed-order accumulate step (``torch.use_deterministic_algorithms``):
    two calls on the same inputs give the same bits, and stay within the
    kernel's bar of the plain version."""
    rng = np.random.default_rng(6)
    b, p, h, w, c = 15, 20000, 256, 256, 3
    pts = torch.from_numpy(_scatter_points(rng, b, p, h, w, layout)).to(cuda_device)
    g = torch.from_numpy(rng.standard_normal((b, p, c)).astype(np.float32)).to(cuda_device)
    torch.use_deterministic_algorithms(True)
    try:
        first = scatter_cuda.scatter_bilinear(g, pts, h, w)
        second = scatter_cuda.scatter_bilinear(g, pts, h, w)
        want = sampling_ops.scatter_bilinear_plain(g, pts, h, w)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    err = (first - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item() + 1e-7, err
