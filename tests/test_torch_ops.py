"""Port parity of the op set (f32, CPU): fused bias+lrelu against the JAX
op with and without its Pallas kernel (interpret mode), its gradient
against the Pallas VJP (kernel 5) and its grad-of-grad against the XLA
path's; the 4-tap blur against ``blur4_pallas`` (interpret mode) and
``upfirdn2d``, its gradient and grad-of-grad against ``jax.grad`` of
``blur4_pallas``; the modulated conv (plain and upsample), ``upsample_2x``,
``equal_linear``, ``pixel_norm``, ``equal_conv2d`` and the bilinear resize
(the kernels themselves: tests/test_torch_kernels.py).  Tolerances are f32
reassociation bars (rtol 1e-5; 1e-4 where a conv sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_tpu.ops import activations as ja
from gif_tpu.ops import blur_pallas as jb
from gif_tpu.ops import conv as jconv
from gif_tpu.ops import linear as jl
from gif_tpu.ops import upfirdn as ju
from gif_tpu.utils.image import resize_bilinear as j_resize
from gif_tpu_torch.ops import activations as ta
from gif_tpu_torch.ops import blur_cuda as tb
from gif_tpu_torch.ops import conv as tconv
from gif_tpu_torch.ops import linear as tl
from gif_tpu_torch.ops import upfirdn as tu
from gif_tpu_torch.utils.image import resize_bilinear as t_resize

TAPS = (1, 3, 3, 1)


def nhwc(x):
    return np.ascontiguousarray(np.moveaxis(x, 1, -1))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_fused_leaky_relu_matches_jax(use_pallas):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 5, 6)).astype(np.float32)  # NCHW
    bias = rng.standard_normal(8).astype(np.float32)
    want = ja.fused_leaky_relu(jnp.asarray(nhwc(x)), jnp.asarray(bias), use_pallas=use_pallas)
    before = ta.fused_leaky_relu.launches
    got = ta.fused_leaky_relu(torch.from_numpy(x), torch.from_numpy(bias))
    assert ta.fused_leaky_relu.launches == before  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), nchw(want).numpy(), rtol=1e-6, atol=1e-6)


def test_fused_leaky_relu_grad_and_grad_of_grad_match_jax():
    rng = np.random.default_rng(7)
    x, g = (rng.standard_normal((2, 8, 5, 6)).astype(np.float32) for _ in range(2))  # NCHW
    bias = rng.standard_normal(8).astype(np.float32)
    u = rng.standard_normal((2, 8, 5, 6)).astype(np.float32)
    v = rng.standard_normal(8).astype(np.float32)
    xj, gj, uj = (jnp.asarray(nhwc(a)) for a in (x, g, u))
    bj = jnp.asarray(bias)

    def jax_vjp(gg, use_pallas):
        _, vjp = jax.vjp(lambda a, b: ja.fused_leaky_relu(a, b, use_pallas=use_pallas), xj, bj)
        return vjp(gg)

    # First order against the Pallas kernel 5 (interpret mode).
    want_dx, want_db = jax_vjp(gj, True)
    xt = torch.from_numpy(x).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    gt = torch.from_numpy(g).requires_grad_(True)
    before = ta.fused_leaky_relu_backward.launches
    dx, db = torch.autograd.grad(ta.fused_leaky_relu(xt, bt), (xt, bt), gt, create_graph=True)
    assert ta.fused_leaky_relu_backward.launches == before  # CPU: the plain version
    np.testing.assert_allclose(dx.detach().numpy(), nchw(want_dx).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(db.detach().numpy(), np.asarray(want_db), rtol=1e-5, atol=1e-5)
    # Second order: d/dg of <dx, u> + <db, v> (the Pallas VJP has no JVP
    # rule, so against the XLA path's custom VJP); zero in x and bias.
    def s_jax(gg):
        jdx, jdb = jax_vjp(gg, False)
        return jnp.sum(jdx * uj) + jnp.sum(jdb * jnp.asarray(v))

    want_dg = jax.grad(s_jax)(gj)
    s = (dx * torch.from_numpy(u)).sum() + (db * torch.from_numpy(v)).sum()
    dg, dx2, db2 = torch.autograd.grad(s, (gt, xt, bt), allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(dg.numpy(), nchw(want_dg).numpy(), rtol=1e-5, atol=1e-6)
    assert not dx2.any() and not db2.any()


# The up-path geometry (gain 4, pads 1,1 on an odd map) and other pads.
BLUR_CASES = [((1, 1, 1, 1), 4.0, 9), ((2, 2, 2, 2), 1.0, 12), ((0, 3, 3, 0), 1.0, 10)]


@pytest.mark.parametrize("pads,gain,size", BLUR_CASES)
def test_blur_matches_jax_kernel_and_upfirdn(pads, gain, size):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, size, size + 1)).astype(np.float32)  # NCHW
    got = tb.blur4(torch.from_numpy(x), tb.taps_1d(TAPS, gain), pads)
    want_kernel = jb.blur4_pallas(jnp.asarray(nhwc(x)), jb.taps_1d(TAPS, gain), pads)
    want_xla = ju.upfirdn2d(jnp.asarray(nhwc(x)), ju._cached_kernel(TAPS, gain), pad=pads)
    np.testing.assert_allclose(got.numpy(), nchw(want_kernel).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), nchw(want_xla).numpy(), rtol=1e-5, atol=1e-6)
    assert tb.taps_1d(TAPS, gain) == jb.taps_1d(TAPS, gain)


# The discriminator's down-blurs (pads 2,2 before a 3x3, 1,1 before the
# 1x1 skip) and the generator's gain-4 up-blur.
BLUR_GRAD_CASES = [((2, 2, 2, 2), 1.0), ((1, 1, 1, 1), 1.0), ((1, 1, 1, 1), 4.0)]


@pytest.mark.parametrize("pads,gain", BLUR_GRAD_CASES)
def test_blur_grad_and_grad_of_grad_match_jax_kernel(pads, gain):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 4, 10, 9)).astype(np.float32)  # NCHW
    w = rng.standard_normal(4).astype(np.float32)
    ct = rng.standard_normal(tb.blur4(torch.from_numpy(x), tb.taps_1d(TAPS, gain), pads).shape)
    ct = ct.astype(np.float32)
    jtaps = jb.taps_1d(TAPS, gain)

    # First order: jax.grad of the Pallas kernel (its VJP runs the kernel).
    want = jax.grad(lambda v: jnp.sum(jb.blur4_pallas(v, jtaps, pads) * jnp.asarray(nhwc(ct))))(
        jnp.asarray(nhwc(x))
    )
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad((tb.blur4(xt, tb.taps_1d(TAPS, gain), pads) * torch.from_numpy(ct)).sum(), xt)
    np.testing.assert_allclose(got.numpy(), nchw(want).numpy(), rtol=1e-5, atol=1e-5)

    # Second order, R1-shaped: d/dw sum((d/dx sum(blur(x * w)^2))^2).
    def r1_jax(wj):
        gx = jax.grad(lambda v: jnp.sum(jb.blur4_pallas(v * wj, jtaps, pads) ** 2))(jnp.asarray(nhwc(x)))
        return jnp.sum(gx**2)

    want_w = jax.grad(r1_jax)(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tb.blur4(xt * wt[None, :, None, None], tb.taps_1d(TAPS, gain), pads)
    (gx,) = torch.autograd.grad(out.square().sum(), xt, create_graph=True)
    (got_w,) = torch.autograd.grad(gx.square().sum(), wt)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-4, atol=1e-4)


def test_minibatch_stddev_matches_jax():
    from gif_tpu.ops.stddev import minibatch_stddev as j_mbstd
    from gif_tpu_torch.ops.stddev import minibatch_stddev as t_mbstd

    rng = np.random.default_rng(9)
    for n, c, f in ((8, 6, 1), (4, 6, 2), (2, 4, 1)):
        x = rng.standard_normal((n, c, 3, 5)).astype(np.float32)
        got = t_mbstd(torch.from_numpy(x), group_size=4, num_features=f)
        want = j_mbstd(jnp.asarray(nhwc(x)), group_size=4, num_features=f)
        assert got.shape == (n, c + f, 3, 5)
        np.testing.assert_allclose(got.numpy(), nchw(want).numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        t_mbstd(torch.zeros((6, 4, 2, 2)), group_size=4)


def test_upsample_2x_and_upfirdn_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 7, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tu.upsample_2x(torch.from_numpy(x)).numpy(),
        nchw(ju.upsample_2x(jnp.asarray(nhwc(x)))).numpy(),
        rtol=1e-5, atol=1e-6,
    )
    k = ju._cached_kernel(TAPS, 1.0)
    np.testing.assert_allclose(
        tu.upfirdn2d(torch.from_numpy(x), k, down=2, pad=(2, 1)).numpy(),
        nchw(ju.upfirdn2d(jnp.asarray(nhwc(x)), k, down=2, pad=(2, 1))).numpy(),
        rtol=1e-5, atol=1e-6,
    )


@pytest.mark.parametrize("upsample,demodulate", [(False, True), (True, True), (False, False)])
def test_modulated_conv2d_matches_jax(upsample, demodulate):
    rng = np.random.default_rng(3)
    k = 1 if not demodulate else 3
    x = rng.standard_normal((2, 6, 5, 5)).astype(np.float32)
    w_hwio = rng.standard_normal((k, k, 6, 4)).astype(np.float32)
    style = (rng.standard_normal((2, 6)) + 1.0).astype(np.float32)
    want = jconv.modulated_conv2d(
        jnp.asarray(nhwc(x)), jnp.asarray(w_hwio), jnp.asarray(style),
        demodulate=demodulate, upsample=upsample,
    )
    got = tconv.modulated_conv2d(
        torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))),
        torch.from_numpy(style), demodulate=demodulate, upsample=upsample,
    )
    assert got.shape[2] == (10 if upsample else 5)
    np.testing.assert_allclose(got.numpy(), nchw(want).numpy(), rtol=1e-4, atol=1e-5)


def test_equal_conv2d_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 8, 8)).astype(np.float32)
    w_hwio = rng.standard_normal((3, 3, 5, 7)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    want = jconv.equal_conv2d(jnp.asarray(nhwc(x)), jnp.asarray(w_hwio), jnp.asarray(b), stride=2, padding=1)
    got = tconv.equal_conv2d(
        torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))),
        torch.from_numpy(b), stride=2, padding=1,
    )
    np.testing.assert_allclose(got.numpy(), nchw(want).numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("activation,apply_sqrt2", [(False, False), (True, False), (True, True)])
def test_equal_linear_and_pixel_norm_match_jax(activation, apply_sqrt2):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    w = rng.standard_normal((8, 16)).astype(np.float32) * 100
    b = rng.standard_normal(8).astype(np.float32)
    kw = dict(lr_mul=0.01, activation=activation, apply_sqrt2=apply_sqrt2)
    want = jl.equal_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw)
    got = tl.equal_linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tl.pixel_norm(torch.from_numpy(x)).numpy(), np.asarray(jl.pixel_norm(jnp.asarray(x))),
        rtol=1e-5, atol=1e-6,
    )


def test_resize_bilinear_matches_jax():
    x = np.random.default_rng(6).uniform(-1, 1, size=(2, 256, 256, 6)).astype(np.float32)
    for s in (4, 8, 32, 128):
        np.testing.assert_allclose(
            t_resize(torch.from_numpy(x), s, s).numpy(),
            np.asarray(j_resize(jnp.asarray(x), s, s)),
            rtol=1e-5, atol=1e-6,
        )


def test_layout_helpers_tell_the_formats_apart_and_count_copies():
    from gif_tpu_torch.ops import layout

    x = torch.randn(2, 5, 4, 3)
    cl = x.contiguous(memory_format=torch.channels_last)
    assert not layout.is_channels_last(x) and layout.is_channels_last(cl)
    # One memory order for both (a single channel, 1 x 1 maps): NCHW.
    assert not layout.is_channels_last(torch.randn(2, 1, 4, 3).contiguous(memory_format=torch.channels_last))
    assert not layout.is_channels_last(torch.randn(2, 5, 1, 1).contiguous(memory_format=torch.channels_last))
    assert not layout.is_channels_last(torch.randn(4, 6)) and not layout.is_channels_last(cl[:, :3])
    before = layout.layout_copies.copies
    assert layout.dense(x, False) is x and layout.dense(cl, True) is cl
    assert layout.layout_copies.copies == before
    got = layout.dense(cl, False), layout.dense(x, True), layout.dense(cl[:, 1:], True)
    assert got[0].is_contiguous() and layout.is_channels_last(got[1]) and layout.is_channels_last(got[2])
    assert torch.equal(got[0], x) and torch.equal(got[1], x) and torch.equal(got[2], x[:, 1:])
    assert layout.layout_copies.copies == before + 3
    # A weight gradient in the NHWC strides a channels-last map gives it,
    # back in its OIHW weight's, counted apart.
    w = torch.randn(4, 5, 3, 3)
    before = layout.layout_copies.weight_grads
    assert layout.like(w, w) is w and layout.layout_copies.weight_grads == before
    src = torch.randn(4, 5, 3, 3).bfloat16().contiguous(memory_format=torch.channels_last)
    gw = layout.like(src, w)
    assert gw.stride() == w.stride() and gw.dtype == torch.bfloat16
    assert torch.equal(gw, src) and layout.layout_copies.weight_grads == before + 1


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("stride,padding,size", [(1, 1, 9), (2, 0, 9), (2, 0, 10), (1, 0, 7)])
def test_conv_function_matches_native_conv_to_second_order(stride, padding, size, channels_last):
    """``Conv2dFunction`` (the discriminator's conv): its output and first
    derivatives equal the native conv's bit for bit; its second
    derivatives (R1's through the image gradient, and through both
    gradients) equal the native double backward's to f64 rounding; every
    weight gradient has the weight's strides, whatever the map's format."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(size + stride)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x0 = torch.randn((2, 3, size, size), dtype=torch.float64, generator=gen).contiguous(memory_format=fmt)
    w0 = torch.randn((4, 3, 3, 3), dtype=torch.float64, generator=gen)
    ho = (size + 2 * padding - 3) // stride + 1
    u = torch.randn((2, 4, ho, ho), dtype=torch.float64, generator=gen)

    def derivatives(conv):
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        y = conv(x, w)
        first = torch.autograd.grad((y * u).sum(), (x, w))
        (gx,) = torch.autograd.grad((conv(x, w) * u).sum(), x, create_graph=True)
        r1 = torch.autograd.grad(gx.square().sum(), w)
        gx, gw = torch.autograd.grad((conv(x, w) * u * conv(x, w)).sum(), (x, w), create_graph=True)
        both = torch.autograd.grad(gx.square().sum() + gw.square().sum(), (x, w))
        return y.detach(), first, r1 + both

    got = derivatives(lambda x, w: tconv.Conv2dFunction.apply(x, w, stride, padding))
    want = derivatives(lambda x, w: F.conv2d(x, w, stride=stride, padding=padding))
    assert torch.equal(got[0], want[0]) and all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    for a, b in zip(got[2], want[2]):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10 * b.abs().max().item())
    assert all(gw.stride() == w0.stride() for gw in (got[1][1], got[2][0], got[2][2]))
