"""upfirdn2d and the Blur / Upsample resampling family, NCHW.

Port of :mod:`gif_tpu.ops.upfirdn`: zero-stuff upsample by ``up``, pad by
``pad`` (negative pads crop), correlate with the *flipped* FIR kernel, keep
every ``down``-th sample.  Output size per axis:

    out = (in * up + pad0 + pad1 - kh + 1) ceildiv-by-stride down

``blur`` — the up-path blur of the modulated conv and the discriminator's
down-blurs — runs on kernel 4 (:mod:`gif_tpu_torch.ops.blur_cuda`), its
VJP included, for 4-tap kernels; ``upsample_2x``
(the ToRGB skip) was never a TPU kernel and stays a plain depthwise conv.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from gif_tpu_torch.ops.blur_cuda import blur4, taps_1d


@functools.cache
def _cached_kernel(taps: tuple, gain: float) -> np.ndarray:
    k = np.asarray(taps, dtype=np.float32)
    k = np.outer(k, k)
    return (k / k.sum()) * gain


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1, pad=(0, 0)) -> torch.Tensor:
    """Upsample-FIR-downsample on NCHW images.

    Args:
      x: ``(N, C, H, W)``.
      kernel: 2-D FIR kernel (numpy or tensor).
      up / down: integer resampling factors (both axes).
      pad: ``(pad0, pad1)`` for both axes or ``(y0, y1, x0, x1)``.
    """
    py0, py1, px0, px1 = (pad[0], pad[1], pad[0], pad[1]) if len(pad) == 2 else tuple(pad)
    n, c, h, w = x.shape
    if up > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(n, c, h * up, w * up)
    x = F.pad(x, (max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)))
    x = x[
        :,
        :,
        max(-py0, 0) : x.shape[2] - max(-py1, 0),
        max(-px0, 0) : x.shape[3] - max(-px1, 0),
    ]
    k = torch.as_tensor(np.asarray(kernel), dtype=x.dtype, device=x.device)
    k = torch.flip(k, (0, 1))[None, None].expand(c, 1, -1, -1)
    x = F.conv2d(x, k, groups=c)
    return x[:, :, ::down, ::down]


def upsample_2x(x: torch.Tensor, taps=(1, 3, 3, 1), factor: int = 2) -> torch.Tensor:
    """FIR upsample by ``factor`` (the reference Upsample's pads)."""
    kernel = _cached_kernel(tuple(taps), float(factor**2))
    p = kernel.shape[0] - factor
    pad0 = (p + 1) // 2 + factor - 1
    pad1 = p // 2
    return upfirdn2d(x, kernel, up=factor, down=1, pad=(pad0, pad1))


def blur(x: torch.Tensor, pad, taps=(1, 3, 3, 1), upsample_factor: int = 1) -> torch.Tensor:
    """FIR blur with explicit pad (reference Blur), on kernel 4: 4 taps,
    pads in [0, 3] — every blur the generator and the discriminator run."""
    gain = float(upsample_factor**2) if upsample_factor > 1 else 1.0
    pad4 = (pad[0], pad[1], pad[0], pad[1]) if len(pad) == 2 else tuple(pad)
    return blur4(x, taps_1d(tuple(taps), gain), pad4)
