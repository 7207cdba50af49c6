"""Bilinear sampling at scattered points, in plain PyTorch: the texture
steal's inner op (``grid_sample`` arithmetic, zeros padding,
``align_corners=False``), differentiated in the image by autograd."""

from __future__ import annotations

import torch

from .shading import grid_sample_bilinear


def sample_at_points(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) images at (B, P, 2) [-1, 1] points (x, y) -> (B, P, C)
    in the image's dtype; the points get no gradient."""
    b, _, _, c = img.shape
    out = grid_sample_bilinear(img, pts.detach()[:, :, None, :])
    return out.reshape(b, -1, c).to(img.dtype)
