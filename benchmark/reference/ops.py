"""The StyleGAN2 op set in plain PyTorch, NCHW: a frozen copy of the plain
versions of the measured program's ops (equalized linear and conv,
modulated conv in its ``legacy`` resampling form, the 4-tap FIR blur, the
upsampling FIR, fused bias + leaky ReLU, minibatch stddev).  Every op is
differentiated by autograd, twice where R1 needs it.

:func:`lower_precision` is the control of the benchmark's comparison: inside
it every convolution that the configuration runs in bfloat16 reads its
input and its weight rounded to float8 (e4m3, one scale per tensor), the
next precision below the stated one.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

SQRT2 = 1.41421356237
_NEG_SLOPE = 0.2
_SCALE = math.sqrt(2.0)
FP8_MAX = 448.0  # largest finite float8 e4m3 value


class _Precision:
    lower = False


_PRECISION = _Precision()


@contextlib.contextmanager
def lower_precision():
    """Run the bfloat16 convolutions on float8-rounded operands."""
    prev = _PRECISION.lower
    _PRECISION.lower = True
    try:
        yield
    finally:
        _PRECISION.lower = prev


def _operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a bfloat16 convolution reads it: unchanged, or under
    :func:`lower_precision` rounded to float8 e4m3 with a per-tensor scale
    (straight-through: the gradient passes as if unrounded)."""
    if not _PRECISION.lower or x.dtype != torch.bfloat16:
        return x
    scale = x.detach().abs().amax().float().clamp(min=1e-12) / FP8_MAX
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


def conv2d(x, w, **kw):
    return F.conv2d(_operand(x), _operand(w), **kw)


def conv_transpose2d(x, w, **kw):
    return F.conv_transpose2d(_operand(x), _operand(w), **kw)


# -- linear -------------------------------------------------------------


def equal_linear(x, weight, bias, *, lr_mul=1.0, activation=False, apply_sqrt2=False):
    scale = (1.0 / math.sqrt(weight.shape[1])) * lr_mul
    out = x @ (weight * scale).T
    if bias is not None:
        out = out + bias * lr_mul
    if activation:
        out = F.leaky_relu(out, negative_slope=0.2)
        if apply_sqrt2:
            out = out * SQRT2
    return out


def pixel_norm(x, dim=-1, eps=1e-8):
    return x * torch.rsqrt(torch.mean(torch.square(x), dim=dim, keepdim=True) + eps)


# -- activations --------------------------------------------------------


def fused_leaky_relu(x, bias, negative_slope=_NEG_SLOPE, scale=_SCALE):
    """``lrelu(x + bias[c]) * scale`` in f32, cast back to ``x``'s dtype."""
    y = x.float() + bias.float().reshape((1, -1) + (1,) * (x.ndim - 2))
    return (torch.where(y >= 0, y, y * negative_slope) * scale).to(x.dtype)


# -- FIR ----------------------------------------------------------------


@functools.cache
def taps_1d(taps: tuple, gain: float) -> tuple:
    t = np.asarray(taps, dtype=np.float32)
    t = t / t.sum() * np.sqrt(gain)
    return tuple(float(v) for v in t)


def blur4(x, taps, pads):
    """Correlation of NCHW ``x`` with the 4 per-axis ``taps`` under ``pads``
    (p0y, p1y, p0x, p1x): vertical pass then horizontal, f32 math, cast
    back to ``x``'s dtype."""
    p0y, p1y, p0x, p1x = pads
    ho, wo = x.shape[2] + p0y + p1y - 3, x.shape[3] + p0x + p1x - 3
    t0, t1, t2, t3 = taps
    xp = F.pad(x.float(), (p0x, p1x, p0y, p1y))
    v = t0 * xp[:, :, 0:ho] + t1 * xp[:, :, 1 : ho + 1] + t2 * xp[:, :, 2 : ho + 2] + t3 * xp[:, :, 3 : ho + 3]
    o = t0 * v[..., 0:wo] + t1 * v[..., 1 : wo + 1] + t2 * v[..., 2 : wo + 2] + t3 * v[..., 3 : wo + 3]
    return o.to(x.dtype)


def blur(x, pad, taps=(1, 3, 3, 1), upsample_factor=1):
    """FIR blur with explicit pad (a true convolution: flipped taps)."""
    gain = float(upsample_factor**2) if upsample_factor > 1 else 1.0
    pad4 = (pad[0], pad[1], pad[0], pad[1]) if len(pad) == 2 else tuple(pad)
    return blur4(x, taps_1d(tuple(taps), gain)[::-1], pad4)


@functools.cache
def _cached_kernel(taps: tuple, gain: float) -> np.ndarray:
    k = np.asarray(taps, dtype=np.float32)
    k = np.outer(k, k)
    return (k / k.sum()) * gain


def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
    py0, py1, px0, px1 = (pad[0], pad[1], pad[0], pad[1]) if len(pad) == 2 else tuple(pad)
    n, c, h, w = x.shape
    if up > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(n, c, h * up, w * up)
    x = F.pad(x, (max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)))
    x = x[:, :, max(-py0, 0) : x.shape[2] - max(-py1, 0), max(-px0, 0) : x.shape[3] - max(-px1, 0)]
    k = torch.as_tensor(np.asarray(kernel), dtype=x.dtype, device=x.device)
    k = torch.flip(k, (0, 1))[None, None].expand(c, 1, -1, -1)
    x = F.conv2d(x, k, groups=c)
    return x[:, :, ::down, ::down]


def upsample_2x(x, taps=(1, 3, 3, 1), factor=2):
    kernel = _cached_kernel(tuple(taps), float(factor**2))
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=factor, down=1, pad=((p + 1) // 2 + factor - 1, p // 2))


def even_extended_pad(h, pad0, pad1, taps_len, consumer_k):
    """The ``legacy`` resampling form's pads, unchanged."""
    return pad0, pad1


# -- convolutions -------------------------------------------------------


def equal_conv2d(x, weight, bias=None, *, stride=1, padding=0):
    cout, cin, kh, kw = weight.shape
    scale = 1.0 / math.sqrt(cin * kh * kw)
    out = conv2d(x, (weight * scale).to(x.dtype), stride=stride, padding=padding)
    if bias is not None:
        out = out + bias.to(out.dtype)[None, :, None, None]
    return out


def demodulation(w, style, eps=1e-8):
    sigma = torch.square(style.float()) @ torch.square(w.float()).sum((2, 3)).T
    return torch.rsqrt(sigma + eps)


def modulated_conv2d(x, weight, style, *, demodulate=True, upsample=False, blur_taps=(1, 3, 3, 1), eps=1e-8):
    """Style-modulated conv, batch-shared weight; the up path is the
    stride-2 transposed conv to an odd map, then the gain-4 blur."""
    cout, cin, kh, kw = weight.shape
    w = weight * (1.0 / math.sqrt(cin * kh * kw))
    xs = x * style[:, :, None, None].to(x.dtype)
    wc = w.to(x.dtype)
    if upsample:
        p = (len(blur_taps) - 2) - (kh - 1)
        pad0, pad1 = (p + 1) // 2 + 1, p // 2 + 1
        out = conv_transpose2d(xs, wc.transpose(0, 1), stride=2)
        out = blur(out, pad=(pad0, pad1), taps=blur_taps, upsample_factor=2)
    else:
        out = conv2d(xs, wc, padding=kh // 2)
    if demodulate:
        out = out * demodulation(w, style, eps)[:, :, None, None].to(out.dtype)
    return out


# -- discriminator head -------------------------------------------------


def minibatch_stddev(x, group_size=4, num_features=1, eps=1e-8):
    n, c, h, w = x.shape
    g = min(n, group_size)
    f = num_features
    if n % g or c % f:
        raise ValueError(f"minibatch_stddev: batch {n} / group {g}, channels {c} / features {f}")
    y = x.reshape(g, n // g, f, c // f, h, w)
    std = torch.sqrt(torch.var(y, dim=0, correction=0) + eps)
    avg = std.mean(dim=(2, 3, 4))
    avg = avg[None].expand(g, -1, -1).reshape(n, f, 1, 1)
    return torch.cat([x, avg.expand(n, f, h, w).to(x.dtype)], dim=1)
