"""Bilinear image resizing, half-pixel centres, no antialiasing (a frozen
copy of the measured program's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_nchw(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of NCHW images (identity at the same size)."""
    if x.shape[2] == height and x.shape[3] == width:
        return x
    return F.interpolate(
        x, size=(height, width), mode="bilinear", align_corners=False, antialias=False
    )


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of NHWC images."""
    return resize_bilinear_nchw(x.permute(0, 3, 1, 2), height, width).permute(0, 2, 3, 1)
