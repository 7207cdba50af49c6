"""StyleGAN3's filtered leaky ReLU: bias, upsample by ``up`` through a
separable low-pass FIR, leaky ReLU with gain and clamp, low-pass FIR and
downsample by ``down`` (Karras et al. 2021, "Alias-Free Generative
Adversarial Networks", NVlabs/stylegan3 ``torch_utils/ops/filtered_lrelu.py``
``_filtered_lrelu_ref``).  Per layer of the alias-free generator
(:mod:`gif_tpu_torch.models.stylegan3`):

1. ``x + b`` (per channel, dim 1);
2. zero-stuff by ``up``, pad / crop by ``padding``, correlate with the
   flipped up filter along x then y, each axis scaled by ``up`` (2-D gain
   ``up**2``);
3. ``clamp(lrelu(., slope) * gain, -clamp, clamp)``;
4. correlate with the flipped down filter along x then y, keep every
   ``down``-th sample.

Filters are designed by :func:`design_lowpass_filter`, a numpy copy of
``scipy.signal.firwin(numtaps, cutoff, width=width, fs=fs)`` (a
Kaiser-windowed sinc with unit DC gain), so the port imports no scipy.

The kernel (``csrc/filtered_lrelu.cu``, CUDA C++) replaces no TPU kernel:
the JAX package has no alias-free generator.  It exists because the plain
form writes the upsampled map to device memory (at 1024 px up to 2098 x
2098 samples a channel, about 1.35 G samples an image over the 14 filtered
layers) and reads it back three times.  One launch does steps 1-4 per
output tile with every intermediate in shared memory; the backward is one
launch too, which recomputes the activation's derivative from ``x``
rather than saving a mask.  What bounds it and how the design meets that
is in the source's header.  Launches are counted on
``filtered_lrelu.launches`` and ``filtered_lrelu_backward.launches``.

Every accumulation is float32 whatever the map's dtype; the output takes
``x``'s dtype.  CPU tensors take the plain version (autograd through
depthwise convolutions), CUDA tensors the kernels; the kernels take 6 taps
a unit of ``up`` and of ``down`` with ``up`` in {2, 4} and ``down`` 2,
every layer of the published schedules but ToRGB (which has no filter,
:func:`bias_clamp`).
"""

from __future__ import annotations

import math
import types

import numpy as np
import torch
import torch.nn.functional as F

from gif_tpu_torch import kernels

# Taps of the kernel's filters per unit of up / down (NVlabs' filter_size).
FILTER_SIZE = 6
# Output tile of the forward kernel; dx tile of the backward, by ``up``.
FWD_TILE = 32
BWD_TILE = {2: 32, 4: 16}
KERNEL_FACTORS = ((2, 2), (4, 2))


def _kaiser_beta(atten: float) -> float:
    if atten > 50:
        return 0.1102 * (atten - 8.7)
    if atten > 21:
        return 0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21)
    return 0.0


def design_lowpass_filter(numtaps: int, cutoff: float, width: float, fs: float) -> np.ndarray | None:
    """``scipy.signal.firwin(numtaps, cutoff, width=width, fs=fs)`` in numpy:
    a sinc low-pass at ``cutoff`` under a Kaiser window whose attenuation
    follows the transition ``width``, scaled to unit gain at DC.  float32;
    None for ``numtaps == 1`` (the identity)."""
    if numtaps == 1:
        return None
    nyq = 0.5 * fs
    atten = 2.285 * (numtaps - 1) * np.pi * (width / nyq) + 7.95
    m = np.arange(numtaps) - 0.5 * (numtaps - 1)
    c = cutoff / nyq
    h = c * np.sinc(c * m) * np.kaiser(numtaps, _kaiser_beta(atten))
    return (h / h.sum()).astype(np.float32)


def output_size(size: int, up: int, down: int, pad0: int, pad1: int, taps_up: int, taps_down: int) -> int:
    return (size * up + pad0 + pad1 - (taps_up - 1) - (taps_down - 1) + (down - 1)) // down


def _upfirdn_separable(x: torch.Tensor, taps: torch.Tensor, up: int, down: int, pads) -> torch.Tensor:
    """Zero-stuff ``x`` (N, C, H, W) by ``up``, pad / crop by ``pads`` (y0,
    y1, x0, x1), correlate with the 1-D ``taps`` along x then y, keep every
    ``down``-th sample."""
    n, c, h, w = x.shape
    if up > 1:
        x = F.pad(x.reshape(n, c, h, 1, w, 1), (0, up - 1, 0, 0, 0, up - 1)).reshape(n, c, h * up, w * up)
    y0, y1, x0, x1 = pads
    x = F.pad(x, (max(x0, 0), max(x1, 0), max(y0, 0), max(y1, 0)))
    x = x[:, :, max(-y0, 0): x.shape[2] - max(-y1, 0), max(-x0, 0): x.shape[3] - max(-x1, 0)]
    k = taps.to(x.dtype)
    x = F.conv2d(x, k.reshape(1, 1, 1, -1).repeat(c, 1, 1, 1), groups=c)
    x = F.conv2d(x, k.reshape(1, 1, -1, 1).repeat(c, 1, 1, 1), groups=c)
    return x[:, :, ::down, ::down]


def _pads(padding) -> tuple:
    """NVlabs' ``[x0, x1, y0, y1]`` (or one int) as (y0, y1, x0, x1)."""
    if isinstance(padding, int):
        return (padding,) * 4
    x0, x1, y0, y1 = padding
    return y0, y1, x0, x1


def filtered_lrelu_plain(x, fu, fd, b, up: int, down: int, padding, gain: float, slope: float,
                         clamp: float | None) -> torch.Tensor:
    """Plain version: the four steps with depthwise convolutions in float32
    (float64 for float64 maps; the upsampled map in memory), cast back to
    ``x``'s dtype."""
    ct = torch.promote_types(x.dtype, torch.float32)
    y = x.to(ct) + b.to(ct).reshape(1, -1, 1, 1)
    y = _upfirdn_separable(y, torch.flip(fu.to(ct), (0,)) * up, up, 1, _pads(padding))
    y = torch.where(y >= 0, y, y * slope) * gain
    if clamp is not None:
        y = y.clamp(-clamp, clamp)
    y = _upfirdn_separable(y, torch.flip(fd.to(ct), (0,)), 1, down, (0, 0, 0, 0))
    return y.to(x.dtype)


def bias_clamp(x: torch.Tensor, b: torch.Tensor, clamp: float | None) -> torch.Tensor:
    """The filter-free case (ToRGB: up = down = 1, gain 1, slope 1): ``x +
    b`` clamped, in float32, cast back to ``x``'s dtype."""
    y = x.float() + b.float().reshape(1, -1, 1, 1)
    if clamp is not None:
        y = y.clamp(-clamp, clamp)
    return y.to(x.dtype)


def _check(x, fu, fd, b, up, down) -> None:
    if (up, down) not in KERNEL_FACTORS:
        raise ValueError(f"filtered_lrelu kernel takes (up, down) in {KERNEL_FACTORS}, got {(up, down)}")
    if fu.numel() != FILTER_SIZE * up or fd.numel() != FILTER_SIZE * down:
        raise ValueError(f"filtered_lrelu kernel takes {FILTER_SIZE} taps a unit of up / down, "
                         f"got {fu.numel()} / {fd.numel()} for up {up}, down {down}")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.ndim != 4 or b.shape != (x.shape[1],):
        raise ValueError(f"filtered_lrelu kernel takes 4-D bf16 / f32 and a bias of dim 1, got "
                         f"{x.dtype} {tuple(x.shape)} {tuple(b.shape)}")
    if x.shape[0] * x.shape[1] > 65535:
        raise ValueError(f"filtered_lrelu kernel takes at most 65535 planes, got {x.shape[0] * x.shape[1]}")


def _launch_args(x, fu, fd, b, up, padding):
    y0, _, x0, _ = _pads(padding)
    taps_u = (torch.flip(fu.float(), (0,)) * up).contiguous()
    taps_d = torch.flip(fd.float(), (0,)).contiguous()
    return taps_u, taps_d, b.float().contiguous(), y0, x0


def filtered_lrelu_cuda(x, fu, fd, b, up, down, padding, gain, slope, clamp) -> torch.Tensor:
    """Launch the forward kernel (CUDA tensors only); the caller counts."""
    _check(x, fu, fd, b, up, down)
    x = x.contiguous()
    n, c, h, w = x.shape
    y0, y1, x0, x1 = _pads(padding)
    oh = output_size(h, up, down, y0, y1, fu.numel(), fd.numel())
    ow = output_size(w, up, down, x0, x1, fu.numel(), fd.numel())
    out = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device)
    taps_u, taps_d, bias, p0y, p0x = _launch_args(x, fu, fd, b, up, padding)
    tiles_y, tiles_x = -(-oh // FWD_TILE), -(-ow // FWD_TILE)
    fn = kernels.function("gif_filtered_lrelu_forward", 5, 13, 3)
    err = fn(x.data_ptr(), bias.data_ptr(), taps_u.data_ptr(), taps_d.data_ptr(), out.data_ptr(),
             n * c, c, h, w, oh, ow, up, down, p0y, p0x, tiles_x, tiles_y, int(x.dtype == torch.bfloat16),
             float(gain), float(slope), float(math.inf if clamp is None else clamp), kernels.stream_ptr(x))
    kernels.check(err, "gif_filtered_lrelu_forward")
    return out


def filtered_lrelu_backward_cuda(x, dy, fu, fd, b, up, down, padding, gain, slope, clamp):
    """Launch the backward kernel: (dx in ``x``'s dtype, db in float32 from
    the unrounded dx); the caller counts."""
    _check(x, fu, fd, b, up, down)
    x, dy = x.contiguous(), dy.to(x.dtype).contiguous()
    n, c, h, w = x.shape
    dx = torch.empty_like(x)
    t = BWD_TILE[up]
    tiles_y, tiles_x = -(-h // t), -(-w // t)
    db_part = torch.empty((n, c, tiles_y * tiles_x), dtype=torch.float32, device=x.device)
    taps_u, taps_d, bias, p0y, p0x = _launch_args(x, fu, fd, b, up, padding)
    fn = kernels.function("gif_filtered_lrelu_backward", 7, 13, 3)
    err = fn(x.data_ptr(), bias.data_ptr(), dy.data_ptr(), taps_u.data_ptr(), taps_d.data_ptr(), dx.data_ptr(),
             db_part.data_ptr(), n * c, c, h, w, dy.shape[2], dy.shape[3], up, down, p0y, p0x, tiles_x, tiles_y,
             int(x.dtype == torch.bfloat16), float(gain), float(slope),
             float(math.inf if clamp is None else clamp), kernels.stream_ptr(x))
    kernels.check(err, "gif_filtered_lrelu_backward")
    return dx, db_part.sum((0, 2))


class FilteredLReLUFunction(torch.autograd.Function):
    """The forward kernel; its backward is the backward kernel, with ``db``
    the sum of ``dx`` over N, H and W, in float32 before ``dx`` is rounded
    (the kernel's per-tile sums, added by torch).  First order only:
    nothing differentiates the generator twice."""

    @staticmethod
    def forward(ctx, x, b, fu, fd, up, down, padding, gain, slope, clamp):
        ctx.save_for_backward(x, b, fu, fd)
        ctx.consts = (up, down, padding, gain, slope, clamp)
        out = filtered_lrelu_cuda(x, fu, fd, b, up, down, padding, gain, slope, clamp)
        filtered_lrelu.launches += 1
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, b, fu, fd = ctx.saved_tensors
        up, down, padding, gain, slope, clamp = ctx.consts
        dx, db = filtered_lrelu_backward_cuda(x, dy, fu, fd, b, up, down, padding, gain, slope, clamp)
        filtered_lrelu_backward.launches += 1
        return dx, db.to(b.dtype), None, None, None, None, None, None, None, None


def filtered_lrelu(x, fu, fd, b, up: int = 1, down: int = 1, padding=0, gain: float = math.sqrt(2),
                   slope: float = 0.2, clamp: float | None = None) -> torch.Tensor:
    """The filtered leaky ReLU of NCHW ``x`` (module docstring).  ``fu`` /
    ``fd``: 1-D filters (:func:`design_lowpass_filter`) applied as true
    convolutions; ``padding``: NVlabs' ``[x0, x1, y0, y1]`` of the up pass
    (negative crops).  Differentiable once in ``x`` and ``b``."""
    if not x.is_cuda:
        return filtered_lrelu_plain(x, fu, fd, b, up, down, padding, gain, slope, clamp)
    return FilteredLReLUFunction.apply(x, b, fu, fd, up, down, padding, gain, slope, clamp)


filtered_lrelu.launches = 0
filtered_lrelu_backward = types.SimpleNamespace(launches=0)
