"""Kernels 3 and 5: fused bias + leaky-relu(0.2) + sqrt(2) gain and its
backward, in Triton, behind autograd Functions.

Port of :mod:`gif_tpu.ops.activations` ``fused_leaky_relu``; replaces the
TPU kernels ``gif_tpu/ops/activations.py::_flr_fwd_kernel`` (kernel 3) and
``::_flr_bwd_kernel`` (kernel 5), both reached through
``_pallas_rows_call`` / ``fused_leaky_relu(use_pallas=True)`` and its
``custom_vjp``.  The per-channel bias runs along dim 1 of NCHW-shaped
maps, which come in two memory formats (:mod:`gif_tpu_torch.ops.layout`):
NCHW-contiguous (the generator's), where an element's channel is
``(offset // HW) % C``, and channels-last (the discriminator's), where it
is ``offset % C``: the same kernel with ``HW = 1``, chosen by the input's
own strides; the output keeps the input's format.  Forward and backward
launches are counted apart, and so are the two formats
(``fused_leaky_relu.launches`` / ``fused_leaky_relu_cl.launches``, the
same for ``fused_leaky_relu_backward``).

What bounds both on the H100: memory.  The forward reads x and writes y
(~4 flops an element); the backward reads x and g and writes dx (3 x
itemsize bytes an element).  Each kernel is one elementwise pass (bf16 or
f32 in and out, f32 math), each program a contiguous block of ``_BLOCK``
elements so loads and stores coalesce; the bias (<= 512 floats) stays in
L1/L2.  A channels-last map is one contiguous run of storage as well, so
it takes the same single pass.

Gradients, as the JAX ``custom_vjp`` defines them (``activations.py:124-143``):
``dx = g * sqrt2 * (x + b >= 0 ? 1 : 0.2)`` and ``db = sum(dx)`` over N, H
and W (a torch reduction, as JAX sums outside its kernel).  The residuals
are ``x`` and ``bias``.  ``dx`` is linear in ``g`` and piecewise constant
in ``x``, so the backward is itself an autograd Function whose own
backward is kernel 5 again on the incoming gradient: R1 takes
grad-of-grad through every activated discriminator layer.
"""

from __future__ import annotations

import functools
import math
import types

import torch

from gif_tpu_torch.ops import layout

_NEG_SLOPE = 0.2
_SCALE = math.sqrt(2.0)
_BLOCK = 2048


def _bias_view(bias: torch.Tensor, ndim: int) -> torch.Tensor:
    return bias.float().reshape((1, -1) + (1,) * (ndim - 2))


def fused_leaky_relu_plain(
    x: torch.Tensor, bias: torch.Tensor, negative_slope: float = _NEG_SLOPE, scale: float = _SCALE
) -> torch.Tensor:
    """Plain version of kernel 3: ``lrelu(x + bias[c]) * scale`` in f32,
    cast back to ``x``'s dtype.  x: (N, C, ...), bias: (C,)."""
    y = x.float() + _bias_view(bias, x.ndim)
    return (torch.where(y >= 0, y, y * negative_slope) * scale).to(x.dtype)


def fused_leaky_relu_backward_plain(
    x: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
    negative_slope: float = _NEG_SLOPE, scale: float = _SCALE,
) -> torch.Tensor:
    """Plain version of kernel 5: ``g * (x + bias[c] >= 0 ? scale :
    scale * negative_slope)`` in f32, cast to ``x``'s dtype."""
    y = x.float() + _bias_view(bias, x.ndim)
    gf = g.float()
    return torch.where(y >= 0, gf * scale, gf * (scale * negative_slope)).to(x.dtype)


@functools.cache
def _triton_kernels():
    # Triton resolves the names a kernel body uses in its module's globals,
    # so ``tl`` is bound there — on first launch, never at import (CPU
    # machines have no triton).
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def flr_fwd(x_ptr, b_ptr, o_ptr, n, hw, c, neg, scale, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        x = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
        ch = (offs // hw) % c
        b = tl.load(b_ptr + ch, mask=m, other=0.0)
        y = x + b
        y = tl.where(y >= 0, y, y * neg) * scale
        tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=m)

    @triton.jit
    def flr_bwd(x_ptr, b_ptr, g_ptr, o_ptr, n, hw, c, scale, neg_scale, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        x = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
        g = tl.load(g_ptr + offs, mask=m, other=0.0).to(tl.float32)
        ch = (offs // hw) % c
        b = tl.load(b_ptr + ch, mask=m, other=0.0)
        y = x + b
        dx = tl.where(y >= 0, g * scale, g * neg_scale)
        tl.store(o_ptr + offs, dx.to(o_ptr.dtype.element_ty), mask=m)

    return flr_fwd, flr_bwd


def _check(x: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"fused_leaky_relu kernel does not take {x.dtype}")
    if x.ndim < 2 or bias.shape != (x.shape[1],):
        raise ValueError(f"bias {tuple(bias.shape)} does not match x {tuple(x.shape)} on dim 1")


def _grid_args(x: torch.Tensor, channels_last: bool):
    """(grid, elements, the run of storage one channel index covers): the
    map's H x W on NCHW storage, 1 on channels-last storage."""
    n = x.numel()
    hw = n // (x.shape[0] * x.shape[1]) if n and not channels_last else 1
    return (-(-n // _BLOCK),), n, hw


def fused_leaky_relu_triton(
    x: torch.Tensor, bias: torch.Tensor, negative_slope: float = _NEG_SLOPE, scale: float = _SCALE
) -> torch.Tensor:
    """Launch kernel 3 (CUDA tensors only) in ``x``'s memory format."""
    _check(x, bias)
    cl = layout.is_channels_last(x)
    x = layout.dense(x, cl)
    b = bias.float().contiguous()
    out = torch.empty_like(x)
    grid, n, hw = _grid_args(x, cl)
    # Triton raises on a refused launch, the counterpart of the CUDA
    # wrappers' cudaGetLastError check.
    _triton_kernels()[0][grid](
        x, b, out, n, hw, x.shape[1], float(negative_slope), float(scale),
        BLOCK=_BLOCK, num_warps=4,
    )
    (fused_leaky_relu_cl if cl else fused_leaky_relu).launches += 1
    return out


def fused_leaky_relu_backward_triton(
    x: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
    negative_slope: float = _NEG_SLOPE, scale: float = _SCALE,
) -> torch.Tensor:
    """Launch kernel 5 (CUDA tensors only): dx in ``x``'s dtype and memory
    format."""
    _check(x, bias)
    if g.shape != x.shape:
        raise ValueError(f"gradient {tuple(g.shape)} does not match x {tuple(x.shape)}")
    cl = layout.is_channels_last(x)
    x = layout.dense(x, cl)
    # cuDNN's conv backward may hand the gradient back in the other format.
    g = layout.dense(g, cl)
    b = bias.float().contiguous()
    out = torch.empty_like(x)
    grid, n, hw = _grid_args(x, cl)
    _triton_kernels()[1][grid](
        x, b, g, out, n, hw, x.shape[1], float(scale), float(scale * negative_slope),
        BLOCK=_BLOCK, num_warps=4,
    )
    (fused_leaky_relu_backward_cl if cl else fused_leaky_relu_backward).launches += 1
    return out


def _forward(x, bias, negative_slope, scale):
    if x.is_cuda:
        return fused_leaky_relu_triton(x, bias, negative_slope, scale)
    return fused_leaky_relu_plain(x, bias, negative_slope, scale)


def fused_leaky_relu_backward(x, bias, g, negative_slope=_NEG_SLOPE, scale=_SCALE):
    """dx of :func:`fused_leaky_relu` (no autograd): CPU tensors take the
    plain version; CUDA tensors launch kernel 5."""
    if x.is_cuda:
        return fused_leaky_relu_backward_triton(x, bias, g, negative_slope, scale)
    return fused_leaky_relu_backward_plain(x, bias, g, negative_slope, scale)


class FusedLeakyReLUBackward(torch.autograd.Function):
    """``dx = flr_bwd(x, bias, g)``, differentiable in ``g``: linear in g
    and piecewise constant in x and bias (zero gradient almost
    everywhere), so its backward is kernel 5 on the incoming gradient."""

    @staticmethod
    def forward(ctx, g, x, bias, negative_slope, scale):
        ctx.save_for_backward(x, bias)
        ctx.consts = (negative_slope, scale)
        return fused_leaky_relu_backward(x, bias, g, negative_slope, scale)

    @staticmethod
    def backward(ctx, gg):
        x, bias = ctx.saved_tensors
        dg = FusedLeakyReLUBackward.apply(gg, x, bias, *ctx.consts)
        return dg, None, None, None, None


class FusedLeakyReLU(torch.autograd.Function):
    """Kernel 3 forward; backward through :class:`FusedLeakyReLUBackward`
    (kernel 5) with ``db = sum(dx)`` over every dim but 1."""

    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        ctx.save_for_backward(x, bias)
        ctx.consts = (negative_slope, scale)
        return _forward(x, bias, negative_slope, scale)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        dx = FusedLeakyReLUBackward.apply(g, x, bias, *ctx.consts)
        dims = (0,) + tuple(range(2, x.ndim))
        db = dx.float().sum(dims).to(bias.dtype)
        return dx, db, None, None


def fused_leaky_relu(
    x: torch.Tensor, bias: torch.Tensor, negative_slope: float = _NEG_SLOPE, scale: float = _SCALE
) -> torch.Tensor:
    """(x + bias[c]) -> leaky_relu -> * scale, bias along dim 1, twice
    differentiable.  CPU tensors take the plain versions; CUDA tensors
    launch kernels 3 (forward) and 5 (every backward)."""
    return FusedLeakyReLU.apply(x, bias, negative_slope, scale)


fused_leaky_relu.launches = 0
fused_leaky_relu_backward.launches = 0
# The launch counters of the channels-last variants.
fused_leaky_relu_cl = types.SimpleNamespace(launches=0)
fused_leaky_relu_backward_cl = types.SimpleNamespace(launches=0)
