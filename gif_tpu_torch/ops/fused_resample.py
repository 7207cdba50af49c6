"""Blur-folded up/down convolutions: StyleGAN2's ``conv_transpose + FIR
blur`` and ``FIR blur + strided conv`` chains as ONE dense convolution each
(port of :mod:`gif_tpu.ops.fused_resample`), NCHW / OIHW.

Because blur, zero-stuffing and convolution are all linear, each chain
collapses into one dense convolution with a *composed* kernel:

- ``downsample_conv_2x``:  blur(pad p) . conv(k, s2)  ==  conv(K, s2) with
  ``K = w (*) flip(blur)`` (full correlation-composition, size k+3).
- ``upsample_conv_2x``:  blur(gain 4) . conv_transpose(k3, s2)  ==  a
  3x3 conv producing the four output phases as channels, followed by
  depth-to-space:  ``out[2y+a, 2x+b] = (x * P_ab)[y, x]`` where the four
  3x3 phase kernels ``P_ab`` are slices of the composed 6-tap kernel.

Both compositions are exact (same linear map, different association) and
are applied to the *kernel* through a constant basis matrix (the FIR taps
are static), so the per-call cost is one tiny matmul.  Plain functions
over ``F.conv2d``, no kernel of the port's own.  ``upsample_conv_2x`` is
the ``phase`` resampling mode's upsample (``ops.conv``); the JAX package
keeps its in-model form apart.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from gif_tpu_torch.ops.upfirdn import _cached_kernel


def _blur_kernel_2d(taps: tuple, gain: float) -> np.ndarray:
    # The live blur path's normalization (upfirdn._cached_kernel), upcast
    # for the f64 composition-basis algebra below.
    return np.asarray(_cached_kernel(tuple(taps), float(gain)), np.float64)


@functools.lru_cache(maxsize=None)
def _down_basis(kernel_size: int, taps: tuple) -> np.ndarray:
    """Constant matrix M ((k+L-1)^2, k^2) with ``vec(K) = M @ vec(w)`` for the
    downsample composition ``K[t] = sum_u w[u] * flip(blur)[t-u]``.

    Built numerically from basis kernels so orientation conventions are
    inherited from the op semantics rather than re-derived:
    ``blur(x, pad) = correlate(pad(x), flip(blur2d))`` and the stride-2 conv
    is a plain correlation, so the composed correlation kernel is the full
    convolution of ``w`` with ``flip(blur2d)``.
    """
    L = len(taps)
    k = kernel_size
    m = k + L - 1
    kf = _blur_kernel_2d(taps, 1.0)[::-1, ::-1]
    M = np.zeros((m * m, k * k))
    for u1 in range(k):
        for u2 in range(k):
            K = np.zeros((m, m))
            # place flip(blur) at offset (u1, u2): K[t] = kf[t - u]
            K[u1 : u1 + L, u2 : u2 + L] = kf
            M[:, u1 * k + u2] = K.reshape(-1)
    return M.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _up_basis(taps: tuple) -> np.ndarray:
    """Constant matrix M ((2*2*3*3), 9) mapping a 3x3 kernel to the four 3x3
    polyphase kernels of the composed upsample transform.

    Derivation (verified exactly against the reference chain): with
    ``y[r] = sum_m x[m] * wT[r - 2m]`` (the VALID stride-2 transposed conv,
    ``transpose_kernel=True`` — wT == w, no flip) and the gain-4 blur
    ``z[i] = sum_j B[j] * y[i + j - 1]`` (pad 1/1), the composition is
    ``z[2y+a] = sum_d x[y+d] * C[a - 2d]`` with
    ``C[t] = sum_j B[j] * w[t + j - 1]``, support t in [-2, 3].  The phase
    kernels are therefore ``P_ab[d1, d2] = C[a - 2*(d1-1), b - 2*(d2-1)]``.
    """
    if len(taps) != 4:
        raise ValueError("upsample composition derived for 4-tap FIR kernels")
    B = _blur_kernel_2d(taps, 4.0)
    M = np.zeros((2 * 2 * 3 * 3, 9))
    for u1 in range(3):
        for u2 in range(3):
            # C[t] for basis w = delta(u): C[t1,t2] = B[t1+j... ] — build the
            # full 6x6 composed kernel indexed by t+2 in [0, 5].
            C = np.zeros((6, 6))
            for j1 in range(4):
                for j2 in range(4):
                    t1 = u1 - j1 + 1  # w[t + j - 1] = delta(u) -> t = u - j + 1
                    t2 = u2 - j2 + 1
                    if -2 <= t1 <= 3 and -2 <= t2 <= 3:
                        C[t1 + 2, t2 + 2] += B[j1, j2]
            for a in range(2):
                for b in range(2):
                    for d1 in range(3):
                        for d2 in range(3):
                            row = ((a * 2 + b) * 3 + d1) * 3 + d2
                            M[row, u1 * 3 + u2] = C[a - 2 * (d1 - 1) + 2, b - 2 * (d2 - 1) + 2]
    return M.astype(np.float32)


def downsample_conv_2x(x: torch.Tensor, w: torch.Tensor, taps=(1, 3, 3, 1), pad_override=None) -> torch.Tensor:
    """``blur(x, pad=((p+1)//2, p//2)); conv(w, stride 2, VALID)`` as ONE
    dense stride-2 conv with the blur folded into the kernel;
    ``p = (L - 2) + (k - 1)``.

    Args:
      x: ``(N, Ci, H, W)``.
      w: ``(Co, Ci, k, k)`` (already He-scaled by the caller).
    """
    co, ci, k, k2 = w.shape
    if k2 != k:
        raise ValueError("square kernels only")
    L = len(taps)
    M = torch.as_tensor(_down_basis(k, tuple(taps)), device=w.device)
    # (k*k, ci*co) in the basis's (u1, u2) order.
    wk = w.float().permute(2, 3, 1, 0).reshape(k * k, ci * co)
    K = (M @ wk).reshape(k + L - 1, k + L - 1, ci, co).permute(3, 2, 0, 1)
    p = (L - 2) + (k - 1)
    p0, p1 = (p + 1) // 2, p // 2
    if pad_override is not None:
        p0, p1 = pad_override
    return F.conv2d(F.pad(x, (p0, p1, p0, p1)), K.to(x.dtype), stride=2)


def upsample_conv_2x(x: torch.Tensor, w: torch.Tensor, taps=(1, 3, 3, 1)) -> torch.Tensor:
    """``conv_transpose(w, s2, VALID); blur(gain 4)`` as ONE 3x3 conv
    producing the four polyphase outputs + depth-to-space, for 3x3 kernels
    and 4-tap FIRs.

    Args:
      x: ``(N, Ci, H, W)``.
      w: ``(Co, Ci, 3, 3)`` — the kernel of the *forward* conv this is the
        transpose of (the layout of ``gif_tpu.ops.fused_resample``'s HWIO
        ``w``, as OIHW).

    Returns:
      ``(N, Co, 2H, 2W)``.
    """
    co, ci, kh, kw = w.shape
    if kh != 3 or kw != 3:
        raise ValueError("polyphase upsample composition requires 3x3 kernels")
    M = torch.as_tensor(_up_basis(tuple(taps)), device=w.device)
    wk = w.float().permute(2, 3, 1, 0).reshape(9, ci * co)
    # (a, b, d1, d2, ci, co) -> (co, a, b, ci, d1, d2): F.pixel_shuffle's
    # (C, r, r) channel order.
    P = (M @ wk).reshape(2, 2, 3, 3, ci, co).permute(5, 0, 1, 4, 2, 3).reshape(4 * co, ci, 3, 3)
    return F.pixel_shuffle(F.conv2d(x, P.to(x.dtype), padding=1), 2)
