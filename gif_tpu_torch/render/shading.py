"""Spherical-harmonic shading, PCA albedo, and the plain bilinear sampler.

Port of :mod:`gif_tpu.render.shading`: 9 real SH basis functions of the
pixel normal weighted by a per-image (9, 3) light code, multiplied into
the FLAME PCA albedo (mean + dirs @ code, 0..255 scale, normalized to
[0, 1]).
"""

from __future__ import annotations

import numpy as np
import torch

_PI = np.pi

# Standard per-band constants for SH irradiance rendering
# (Ramamoorthi & Hanrahan 2001), as used by DECA's add_SHlight.
SH_CONST = np.array(
    [
        1.0 / np.sqrt(4 * _PI),
        (2 * _PI / 3.0) * np.sqrt(3.0 / (4 * _PI)),
        (2 * _PI / 3.0) * np.sqrt(3.0 / (4 * _PI)),
        (2 * _PI / 3.0) * np.sqrt(3.0 / (4 * _PI)),
        (_PI / 4.0) * 3.0 * np.sqrt(5.0 / (12 * _PI)),
        (_PI / 4.0) * 3.0 * np.sqrt(5.0 / (12 * _PI)),
        (_PI / 4.0) * 3.0 * np.sqrt(5.0 / (12 * _PI)),
        (_PI / 4.0) * (3.0 / 2.0) * np.sqrt(5.0 / (12 * _PI)),
        (_PI / 4.0) * 0.5 * np.sqrt(5.0 / (4 * _PI)),
    ],
    dtype=np.float32,
)


def sh9_basis(n: torch.Tensor) -> torch.Tensor:
    """9-term SH basis of unit normals.  n: (..., 3) -> (..., 9)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    basis = torch.stack(
        [
            torch.ones_like(nx),
            nx,
            ny,
            nz,
            nx * ny,
            nx * nz,
            ny * nz,
            nx**2 - ny**2,
            3.0 * nz**2 - 1.0,
        ],
        dim=-1,
    )
    return basis * torch.as_tensor(SH_CONST, dtype=n.dtype, device=n.device)


def sh9_shading(normals: torch.Tensor, light: torch.Tensor) -> torch.Tensor:
    """Per-pixel RGB irradiance: (B,H,W,3) normals, (B,9,3) light ->
    (B,H,W,3)."""
    return torch.einsum("bhwk,bkc->bhwc", sh9_basis(normals), light)


def albedo_from_tex_code(tex_mean, tex_dirs, tex_code: torch.Tensor) -> torch.Tensor:
    """FLAME PCA texture: (mean + dirs @ code) / 255, clipped to [0, 1].

    tex_mean: (R, R, 3) and tex_dirs: (R, R, 3, n_tex) tensors on the
    code's device; tex_code: (B, n_tex).  Returns (B, R, R, 3)."""
    tex = tex_mean[None] + torch.einsum("hwcn,bn->bhwc", tex_dirs, tex_code)
    return torch.clamp(tex / 255.0, 0.0, 1.0)


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Plain ``F.grid_sample`` (bilinear, zeros padding, align_corners=False)
    on NHWC images, in the CUDA sampler's arithmetic order.

    Args:
      img: (B, H, W, C).
      grid: (B, Ho, Wo, 2) sampling locations in [-1, 1], (x, y) order.

    Returns:
      (B, Ho, Wo, C).
    """
    b, h, w, c = img.shape
    gx = (grid[..., 0] + 1.0) * (w / 2.0) - 0.5
    gy = (grid[..., 1] + 1.0) * (h / 2.0) - 0.5
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    dx = (gx - x0)[..., None]
    dy = (gy - y0)[..., None]
    flat = img.reshape(b, h * w, c)

    def tap(yy, xx):
        valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        idx = torch.where(valid, yy * w + xx, 0).long().reshape(b, -1, 1)
        val = torch.gather(flat, 1, idx.expand(-1, -1, c)).reshape(grid.shape[:3] + (c,))
        return torch.where(valid[..., None], val, 0.0)

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    return (
        v00 * (1 - dx) * (1 - dy)
        + v01 * dx * (1 - dy)
        + v10 * (1 - dx) * dy
        + v11 * dx * dy
    )
