"""Kernel 4: the separable 4-tap FIR blur with static pads, and its VJP.

Replaces the TPU kernel ``gif_tpu/ops/blur_pallas.py::_blur_slab_kernel``
(reached through ``_blur4_fwd_impl`` / ``blur4_pallas`` and its
``custom_vjp``).  The CUDA source is ``gif_tpu_torch/csrc/blur.cu``; its
header says what bounds it on the H100 (memory) and how the design meets
that (a halo'd tile in shared memory, both passes fused, the pads never
materialized).  Call sites: the upsampling modulated conv (``ops/conv.py``:
gain 4, pads (1, 1) on the odd ``2H+1`` transposed-conv outputs) and the
discriminator's down-blurs (``models/layers.py`` ``ConvLayer``: pads (2, 2)
before a 3x3 and (1, 1) before the 1x1 skip).

The blur is linear, so its VJP is the same kernel on the incoming gradient
with the taps reversed and each pad ``p`` replaced by ``3 - p`` (the
full-correlation transpose).  :class:`Blur4Function` expresses that VJP
through itself, so every differentiation order stays inside the rule — R1
takes grad-of-grad through the discriminator's blurs — as
``blur_pallas.py:241-252`` does for JAX.  Forward and VJP launches are
counted apart (``blur4.launches``, ``blur4_vjp.launches``).
"""

from __future__ import annotations

import functools
import types

import numpy as np
import torch
import torch.nn.functional as F

from gif_tpu_torch import kernels


@functools.cache
def taps_1d(taps: tuple, gain: float) -> tuple:
    """Per-axis factor of the 2-D FIR ``outer(t, t) * gain``: normalised
    taps scaled by sqrt(gain), so the two separable passes compose to the
    2-D blur exactly."""
    t = np.asarray(taps, dtype=np.float32)
    t = t / t.sum() * np.sqrt(gain)
    return tuple(float(v) for v in t)


def _out_shape(x: torch.Tensor, pads: tuple) -> tuple:
    p0y, p1y, p0x, p1x = pads
    return x.shape[2] + p0y + p1y - 3, x.shape[3] + p0x + p1x - 3


def blur4_plain(x: torch.Tensor, taps: tuple, pads: tuple) -> torch.Tensor:
    """Plain version: ``sum_ij taps[i] taps[j] xpad[y+i, x+j]`` on NCHW,
    vertical pass then horizontal, f32 math, cast back to ``x``'s dtype.
    ``taps`` here are applied as given (correlation)."""
    p0y, p1y, p0x, p1x = pads
    ho, wo = _out_shape(x, pads)
    t0, t1, t2, t3 = taps
    xp = F.pad(x.float(), (p0x, p1x, p0y, p1y))
    v = t0 * xp[:, :, 0:ho] + t1 * xp[:, :, 1 : ho + 1] + t2 * xp[:, :, 2 : ho + 2] + t3 * xp[:, :, 3 : ho + 3]
    o = t0 * v[..., 0:wo] + t1 * v[..., 1 : wo + 1] + t2 * v[..., 2 : wo + 2] + t3 * v[..., 3 : wo + 3]
    return o.to(x.dtype)


def blur4_cuda(x: torch.Tensor, taps: tuple, pads: tuple) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA bf16 / f32 NCHW tensors only); the
    caller counts the launch."""
    if x.dtype not in (torch.bfloat16, torch.float32) or x.ndim != 4:
        raise ValueError(f"blur kernel takes 4-D bf16/f32, got {x.dtype} {tuple(x.shape)}")
    if len(taps) != 4 or min(pads) < 0 or max(pads) > 3:
        raise ValueError(f"blur kernel takes 4 taps and pads in [0, 3], got {taps} {pads}")
    x = x.contiguous()
    n, c, h, w = x.shape
    ho, wo = _out_shape(x, pads)
    out = torch.empty((n, c, ho, wo), dtype=x.dtype, device=x.device)
    fn = kernels.function("gif_blur4_forward", 2, 8, 4)
    err = fn(
        x.data_ptr(), out.data_ptr(), n * c, h, w, ho, wo, pads[0], pads[2],
        int(x.dtype == torch.bfloat16), *taps, kernels.stream_ptr(x),
    )
    kernels.check(err, "gif_blur4_forward")
    return out


def _launch(x: torch.Tensor, taps: tuple, pads: tuple, counter) -> torch.Tensor:
    """Correlate ``x`` with ``taps``: the kernel on a CUDA tensor (counted
    on ``counter``), the plain version on a CPU tensor."""
    if not x.is_cuda:
        return blur4_plain(x, taps, pads)
    out = blur4_cuda(x, taps, pads)
    counter.launches += 1
    return out


class Blur4Function(torch.autograd.Function):
    """Correlation of NCHW ``x`` with ``taps`` under ``pads``; the VJP is
    this Function again (taps reversed, pads ``3 - p``), counted on
    ``blur4_vjp``."""

    @staticmethod
    def forward(ctx, x, taps, pads, counter):
        ctx.taps, ctx.pads = taps, pads
        return _launch(x, taps, pads, counter)

    @staticmethod
    def backward(ctx, g):
        tpads = tuple(3 - p for p in ctx.pads)
        return Blur4Function.apply(g.contiguous(), ctx.taps[::-1], tpads, blur4_vjp), None, None, None


def blur4(x: torch.Tensor, taps: tuple, pads: tuple) -> torch.Tensor:
    """4-tap separable FIR blur of NCHW ``x``: ``upfirdn2d(x, outer(taps,
    taps), pad=pads)`` for taps already normalised and sqrt(gain)-scaled
    per axis (:func:`taps_1d`); ``pads`` = (p0y, p1y, p0x, p1x), each in
    [0, 3].  A true convolution, i.e. a correlation with the flipped taps.
    Differentiable to any order.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    return Blur4Function.apply(x, tuple(taps)[::-1], tuple(pads), blur4)


# The launch counter of kernel 4's VJP launches (forward launches count on
# ``blur4.launches``).
blur4_vjp = types.SimpleNamespace(launches=0)
blur4.launches = 0
