"""Equalized linear layer and pixel norm (port of :mod:`gif_tpu.ops.linear`).

``equal_linear``: runtime weight scaling ``lr_mul / sqrt(fan_in)``, bias
scaled by ``lr_mul``; with ``activation`` a leaky-relu(0.2) follows and —
the reference's quirk — NO sqrt(2) gain unless ``apply_sqrt2`` is set.
``pixel_norm``: x * rsqrt(mean(x^2) + 1e-8) over the feature axis.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SQRT2 = 1.41421356237


def equal_linear(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None,
    *,
    lr_mul: float = 1.0,
    activation: bool = False,
    apply_sqrt2: bool = False,
) -> torch.Tensor:
    """y = x @ (weight * scale)^T (+ bias * lr_mul) [+ leaky-relu].

    x: ``(..., in_dim)``; weight: ``(out_dim, in_dim)``, stored unscaled;
    bias: ``(out_dim,)`` or None.
    """
    scale = (1.0 / math.sqrt(weight.shape[1])) * lr_mul
    out = x @ (weight * scale).T
    if bias is not None:
        out = out + bias * lr_mul
    if activation:
        out = F.leaky_relu(out, negative_slope=0.2)
        if apply_sqrt2:
            out = out * SQRT2
    return out


def pixel_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """x * rsqrt(mean(x^2, dim) + eps)."""
    return x * torch.rsqrt(torch.mean(torch.square(x), dim=dim, keepdim=True) + eps)
