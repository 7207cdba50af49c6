"""Equalized and style-modulated convolutions, NCHW.

Port of :mod:`gif_tpu.ops.conv` (``equal_conv2d``; ``modulated_conv2d`` in
its default ``legacy`` resampling form).  Weights are OIHW.  The style
modulation scales input channels and the demodulation scales output
channels, so both commute with the convolution:

    conv(x, scale * w * s_b) * d_b  ==  conv(x * s_b, scale * w) * d_b

and the port keeps the reference's batch-shared form — the activations are
scaled and ONE shared-weight convolution serves the whole batch (no
batch-as-groups).  Demodulation is computed in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gif_tpu_torch.ops.upfirdn import blur


def equal_conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int = 1,
    padding: int = 0,
) -> torch.Tensor:
    """Conv with runtime He scaling.  x: (N, Cin, H, W); weight: (Cout,
    Cin, kh, kw) unit-normal initialized."""
    cout, cin, kh, kw = weight.shape
    scale = 1.0 / math.sqrt(cin * kh * kw)
    out = F.conv2d(x, (weight * scale).to(x.dtype), stride=stride, padding=padding)
    if bias is not None:
        out = out + bias.to(out.dtype)[None, :, None, None]
    return out


def modulated_conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    style: torch.Tensor,
    *,
    demodulate: bool = True,
    upsample: bool = False,
    blur_taps=(1, 3, 3, 1),
    eps: float = 1e-8,
) -> torch.Tensor:
    """Style-modulated conv (StyleGAN2) on NCHW activations.

    Args:
      x: (N, Cin, H, W), in the compute dtype.
      weight: (Cout, Cin, kh, kw) unit-normal initialized (the runtime
        ``1/sqrt(fan_in)`` He scale is applied here).
      style: (N, Cin) f32 per-input-channel modulation.

    Returns:
      (N, Cout, H', W'); H' = 2H with ``upsample``, else H.
    """
    cout, cin, kh, kw = weight.shape
    w = weight * (1.0 / math.sqrt(cin * kh * kw))
    xs = x * style[:, :, None, None].to(x.dtype)
    wc = w.to(x.dtype)
    if upsample:
        # conv_transpose2d(stride 2, padding 0) with the un-flipped weight
        # viewed as (Cin, Cout, kh, kw) — the lhs-dilated, flipped-kernel
        # conv of the reference — then the gain-4 blur (kernel 4) with pads
        # ((p+1)//2 + 1, p//2 + 1), p = taps - 2 - (k - 1).
        out = F.conv_transpose2d(xs, wc.transpose(0, 1), stride=2)
        p = (len(blur_taps) - 2) - (kh - 1)
        out = blur(out, pad=((p + 1) // 2 + 1, p // 2 + 1), taps=blur_taps, upsample_factor=2)
    else:
        out = F.conv2d(xs, wc, padding=kh // 2)
    if demodulate:
        # d_{b,o} = rsqrt( sum_{i,h,w} (w_{oihw} * s_{bi})^2 + eps ), in f32.
        sigma = torch.square(style.float()) @ torch.square(w.float()).sum((2, 3)).T
        out = out * torch.rsqrt(sigma + eps)[:, :, None, None].to(out.dtype)
    return out
