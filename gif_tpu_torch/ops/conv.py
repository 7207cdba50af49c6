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

``equal_conv2d`` (the discriminator's convolutions) differentiates
through :class:`Conv2dFunction`, whose second derivative is made of
first-order convolutions — forward, input gradient and weight gradient
— where PyTorch's own conv double backward forms R1's weight gradient as
a convolution of the two batch-transposed maps with a map-sized kernel,
which cuDNN runs only on its legacy NCHW kernels.  The values are the
same up to float reassociation.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from gif_tpu_torch.ops import layout
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


def _wanted(ctx, n: int) -> list:
    """Whether the running backward needs the gradient of each of the
    Function's first ``n`` inputs: the engine's own answer (native ops ask
    it the same), so a gradient nobody asked for (D's weights under G's
    loss, R1's first backward) is never computed."""
    out = []
    for needs, (node, _) in zip(ctx.needs_input_grad[:n], ctx.next_functions):
        try:
            out.append(needs and node is not None and torch._C._will_engine_execute_node(node))
        except RuntimeError:  # a leaf that ``autograd.grad`` captures: asked for
            out.append(True)
    return out


def _conv_backward(gy, x, w, stride, padding, mask):
    return torch.ops.aten.convolution_backward(
        gy, x, w, None, [stride] * 2, [padding] * 2, [1, 1], False, [0, 0], 1, mask + [False])[:2]


class Conv2dFunction(torch.autograd.Function):
    """``F.conv2d(x, w, stride=, padding=)`` (groups 1, no bias) whose
    backward is :class:`Conv2dBackwardFunction`, differentiable again."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding)
        return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx, gw = Conv2dBackwardFunction.apply(gy, x, w, *ctx.conv, *_wanted(ctx, 2))
        return gx, gw, None, None


class Conv2dBackwardFunction(torch.autograd.Function):
    """(input gradient, weight gradient) of a conv — each None where not
    wanted — differentiable in ``gy``, ``x`` and ``w``: ``gx`` is linear in
    ``gy`` and ``w``, ``gw`` in ``gy`` and ``x``, so for incoming ``ggx``,
    ``ggw`` the gradients are ``conv(ggx, w) + conv(x, ggw)`` for ``gy``,
    the input gradient of ``gy`` against ``ggw`` for ``x``, and the weight
    gradient of ``gy`` against ``ggx`` for ``w``.  Both weight gradients
    come back in ``w``'s strides (:func:`gif_tpu_torch.ops.layout.like`):
    cuDNN hands a channels-last map's back with NHWC strides, and Adam's
    foreach kernels and the data-parallel bucket want the parameter's."""

    @staticmethod
    def forward(ctx, gy, x, w, stride, padding, want_x, want_w):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(gy, x, w)
        ctx.conv = (stride, padding)
        gx, gw = _conv_backward(gy, x, w, stride, padding, [want_x, want_w])
        return gx, None if gw is None else layout.like(gw, w)

    @staticmethod
    def backward(ctx, ggx, ggw):
        gy, x, w = ctx.saved_tensors
        stride, padding = ctx.conv
        want_gy, want_x, want_w = _wanted(ctx, 3)
        dgy = dx = dw = None
        if want_gy:
            if ggx is not None:
                dgy = F.conv2d(ggx, w, stride=stride, padding=padding)
            if ggw is not None:
                dx_w = F.conv2d(x, ggw, stride=stride, padding=padding)
                dgy = dx_w if dgy is None else dgy + dx_w
        if ggw is not None and want_x:
            dx = _conv_backward(gy, x, ggw, stride, padding, [True, False])[0]
        if ggx is not None and want_w:
            dw = layout.like(_conv_backward(gy, ggx, w, stride, padding, [False, True])[1], w)
        return dgy, dx, dw, None, None, None, None


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
    out = Conv2dFunction.apply(x, (weight * scale).to(x.dtype), stride, padding)
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
    padding: int | None = None,
    input_gain: torch.Tensor | None = None,
    prenormalize: bool = False,
) -> torch.Tensor:
    """Style-modulated conv (StyleGAN2; StyleGAN3's layer with the last
    three arguments) on NCHW activations.

    Args:
      x: (N, Cin, H, W), in the compute dtype.
      weight: (Cout, Cin, kh, kw) unit-normal initialized (the runtime
        ``1/sqrt(fan_in)`` He scale is applied here).
      style: (N, Cin) f32 per-input-channel modulation.
      padding: of the stride-1 conv (``kh // 2`` when None; StyleGAN3's
        full convolution is ``kh - 1``).
      input_gain: a 0-d f32 factor on the output (StyleGAN3's
        ``rsqrt(magnitude_ema)``, applied to the modulated weight there).
      prenormalize: StyleGAN3's pre-normalization, with ``demodulate``:
        the weight by its RMS per output channel (in place of the He
        scale) and the styles by their RMS over the whole (N, Cin) array.

    Returns:
      (N, Cout, H', W'); H' = 2H with ``upsample``, else H + 2 padding -
      kh + 1.
    """
    cout, cin, kh, kw = weight.shape
    if prenormalize:
        w = weight * weight.square().mean((1, 2, 3), keepdim=True).rsqrt()
        style = style * style.square().mean().rsqrt()
    else:
        w = weight * (1.0 / math.sqrt(cin * kh * kw))
    scaled = style if input_gain is None else style * input_gain
    xs = x * scaled[:, :, None, None].to(x.dtype)
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
        out = F.conv2d(xs, wc, padding=kh // 2 if padding is None else padding)
    if demodulate:
        # Demodulated without the input gain: StyleGAN3 applies it to the
        # weight after the demodulation.
        out = out * demodulation(w, style, eps)[:, :, None, None].to(out.dtype)
    return out


def demodulation(w: torch.Tensor, style: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(N, Cout) demodulation coefficients ``d_{b,o} = rsqrt( sum_{i,h,w}
    (w_{oihw} * s_{bi})^2 + eps )`` of the He-scaled weight ``w`` and the
    styles, in f32 whatever the compute dtype."""
    sigma = torch.square(style.float()) @ torch.square(w.float()).sum((2, 3)).T
    return torch.rsqrt(sigma + eps)
