"""Equalized and style-modulated convolutions, NCHW.

Port of :mod:`gif_tpu.ops.conv` (``equal_conv2d``, ``modulated_conv2d``
with its three resampling formulations, ``resample_mode``,
``even_extended_pad``).  Weights are OIHW.  The style
modulation scales input channels and the demodulation scales output
channels, so both commute with the convolution:

    conv(x, scale * w * s_b) * d_b  ==  conv(x * s_b, scale * w) * d_b

and the port keeps the reference's batch-shared form — the activations are
scaled and ONE shared-weight convolution serves the whole batch (no
batch-as-groups).  Demodulation is computed in f32.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from gif_tpu_torch.ops.fused_resample import upsample_conv_2x
from gif_tpu_torch.ops.upfirdn import blur

RESAMPLE_MODES = ("legacy", "even", "phase")


def resample_mode() -> str:
    """The resampling-conv formulation (``GIF_TPU_TORCH_RESAMPLE``, as the
    JAX package reads ``GIF_TPU_RESAMPLE``; default ``legacy``).  Three
    forms of the same math (``gif_tpu.ops.conv.resample_mode``):

    - ``legacy``: the reference's split form — the stride-2 transposed conv
      to an odd (2H + 1)-sized map, then the gain-4 blur (kernel 4) with
      pads (1, 1); the down-blurs with pads ((p + 1) // 2, p // 2).
    - ``even``: one extra high-side output row and column on the transposed
      conv (``output_padding=1``: exactly zero, the very zero the blur's
      high pad would supply), so the map is even-sized and the blur's high
      pad drops by one — the same output, bit for bit where the transposed
      conv sums in the same order at both sizes (oneDNN's CPU kernels do
      not); the down-blurs get a +1
      high pad that the following VALID stride-2 conv never reads
      (:func:`even_extended_pad`).
    - ``phase``: the FIR folded into the conv kernel and the stride-2
      transposed conv phase-decomposed into ONE dense 3x3 conv producing
      2 * 2 * Cout channels, then depth-to-space
      (:func:`gif_tpu_torch.ops.fused_resample.upsample_conv_2x`; JAX
      composes the same kernel by its own tables): no blur launch on the
      up path.  The same values up to float reassociation.

    Which is fastest on the H100 is measured (``PERF.md``); the default
    stays ``legacy`` as in ``gif_tpu``."""
    mode = os.environ.get("GIF_TPU_TORCH_RESAMPLE", "legacy")
    if mode not in RESAMPLE_MODES:
        raise ValueError(f"GIF_TPU_TORCH_RESAMPLE must be one of {RESAMPLE_MODES}, got {mode!r}")
    return mode


def even_extended_pad(h: int, pad0: int, pad1: int, taps_len: int, consumer_k: int):
    """+1 high-side blur pad when (a) the blur output would be odd-sized and
    (b) the extra row / column is provably never read by the following
    VALID stride-2 conv with ``consumer_k``-sized windows (output count
    unchanged).  Output values are bitwise-identical; only the map parity
    changes.  No-op under ``legacy``."""
    if resample_mode() == "legacy":
        return pad0, pad1
    out = h + pad0 + pad1 - taps_len + 1
    if out % 2 == 1 and (out - consumer_k) % 2 == 0:
        return pad0, pad1 + 1
    return pad0, pad1


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
        mode = resample_mode()
        # The phase algebra is derived for the k = 3 / 4-tap case, the only
        # upsample GIF has; anything else takes the even form.
        if mode == "phase" and kh == kw == 3 and len(blur_taps) == 4:
            out = upsample_conv_2x(xs, wc, tuple(blur_taps))
        else:
            # conv_transpose2d(stride 2, padding 0) with the un-flipped
            # weight viewed as (Cin, Cout, kh, kw) — the lhs-dilated,
            # flipped-kernel conv of the reference — then the gain-4 blur
            # (kernel 4) with pads ((p+1)//2 + 1, p//2 + 1), p = taps - 2 -
            # (k - 1).  Outside legacy the transposed conv writes one more
            # (exactly zero) row and column and the blur's high pad drops
            # by one: the same output from an even-sized map.
            p = (len(blur_taps) - 2) - (kh - 1)
            pad0, pad1 = (p + 1) // 2 + 1, p // 2 + 1
            extra = 1 if (mode != "legacy" and kh % 2 == 1 and pad1 >= 1) else 0
            out = F.conv_transpose2d(xs, wc.transpose(0, 1), stride=2, output_padding=extra)
            out = blur(out, pad=(pad0, pad1 - extra), taps=blur_taps, upsample_factor=2)
    else:
        out = F.conv2d(xs, wc, padding=kh // 2)
    if demodulate:
        # d_{b,o} = rsqrt( sum_{i,h,w} (w_{oihw} * s_{bi})^2 + eps ), in f32.
        sigma = torch.square(style.float()) @ torch.square(w.float()).sum((2, 3)).T
        out = out * torch.rsqrt(sigma + eps)[:, :, None, None].to(out.dtype)
    return out
