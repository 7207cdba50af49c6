"""Differentiable bilinear sampling at scattered points (port of
:mod:`gif_tpu.render.sampling_ops`, and of the albedo lookup's VJP,
``_gsm_bwd`` in ``gif_tpu/render/sampler_pallas.py``).

``sample_at_points`` samples (B, H, W, C) images at (B, P, 2) points — the
texture steal's inner op; ``sampler_cuda.grid_sample`` (the albedo lookup)
is the same operator on a (B, Ho, Wo, 2) grid.  Both run through
:class:`SampleAtPoints`: its forward on the card is kernel 2 (the albedo
sampler, ``csrc/sampler.cu``) with the points viewed as a (B, P, 1) grid,
on the CPU kernel 2's plain version; its image gradient is kernel 6
(``csrc/scatter.cu``), the transpose of the sampling operator, or on the
CPU its plain version below, an ``index_add_`` of the valid taps.  The
point gradient (plain torch: XLA's ``grid_sample`` VJP in JAX) is taken
for the albedo lookup's grid only; the steal's points come from FLAME
data and get none, as JAX's ``sample_at_points`` gives them zeros.
"""

from __future__ import annotations

import torch

from gif_tpu_torch.render import sampler_cuda
from gif_tpu_torch.render.shading import grid_sample_bilinear


def tap_data(h: int, w: int, pts: torch.Tensor):
    """The geometry both directions share: per-tap linear pixel ids
    (B, P, 4), weights (B, P, 4) and validity (B, P, 4) of (B, P, 2) points
    in [-1, 1] grid coordinates (x, y); taps in (y0, x0), (y0, x0 + 1),
    (y0 + 1, x0), (y0 + 1, x0 + 1) order.  Ids of invalid taps are clipped
    into the image."""
    gx = (pts[..., 0] + 1.0) * (w / 2.0) - 0.5
    gy = (pts[..., 1] + 1.0) * (h / 2.0) - 0.5
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    dx = gx - x0
    dy = gy - y0
    ids, wgt, ok = [], [], []
    for i in (0, 1):
        for j in (0, 1):
            xi = x0 + j
            yi = y0 + i
            ok.append((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h))
            wgt.append((dx if j else 1 - dx) * (dy if i else 1 - dy))
            ids.append(
                torch.clamp(yi, 0, h - 1).long() * w + torch.clamp(xi, 0, w - 1).long()
            )
    return torch.stack(ids, -1), torch.stack(wgt, -1), torch.stack(ok, -1)


def scatter_bilinear_plain(g: torch.Tensor, pts: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Kernel 6's plain version: ``d_img[b, y, x, c] += w_y * w_x * g[b, p,
    c]`` over each point's valid taps, into a zeroed (B, h, w, C) float32
    image — an ``index_add_`` of the tap products."""
    b, p, c = g.shape
    ids, wgt, ok = tap_data(h, w, pts)
    contrib = (wgt[..., None] * g[:, :, None, :]).reshape(b, 4 * p, c)
    flat_ids = (ids + torch.arange(b, device=ids.device)[:, None, None] * (h * w)).reshape(-1)
    keep = ok.reshape(-1)
    out = torch.zeros((b * h * w, c), dtype=torch.float32, device=g.device)
    out.index_add_(0, flat_ids[keep], contrib.reshape(-1, c)[keep].float())
    return out.reshape(b, h, w, c)


def sample_points_grad(img: torch.Tensor, pts: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The point gradient of bilinear sampling: (B, H, W, C) image, (B, P,
    2) points and (B, P, C) cotangents -> (B, P, 2), the derivative of the
    four-tap blend in its fractional offsets (the taps' integer corners
    carry none) scaled by the grid's ``w / 2`` and ``h / 2``."""
    b, h, w, c = img.shape
    ids, _, ok = tap_data(h, w, pts)
    vals = torch.gather(img.reshape(b, h * w, c), 1, ids.reshape(b, -1, 1).expand(-1, -1, c))
    v00, v01, v10, v11 = (vals.reshape(ids.shape + (c,)) * ok[..., None].to(img.dtype)).unbind(2)
    gx = (pts[..., 0] + 1.0) * (w / 2.0) - 0.5
    gy = (pts[..., 1] + 1.0) * (h / 2.0) - 0.5
    dx = (gx - torch.floor(gx))[..., None]
    dy = (gy - torch.floor(gy))[..., None]
    d_dx = (v01 - v00) * (1 - dy) + (v11 - v10) * dy
    d_dy = (v10 - v00) * (1 - dx) + (v11 - v01) * dx
    return torch.stack([(g * d_dx).sum(-1) * (w / 2.0), (g * d_dy).sum(-1) * (h / 2.0)], dim=-1)


class SampleAtPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, pts, pts_grad):
        ctx.save_for_backward(img, pts)
        ctx.pts_grad = pts_grad
        b, _, _, c = img.shape
        grid = pts[:, :, None, :]
        if img.is_cuda:
            out = sampler_cuda.grid_sample_cuda(img, grid)
        else:
            out = grid_sample_bilinear(img, grid)
        return out.reshape(b, -1, c).to(img.dtype)

    @staticmethod
    def backward(ctx, g):
        # Imported here: scatter_cuda imports this module for kernel 6's
        # plain version.
        from gif_tpu_torch.render.scatter_cuda import scatter_bilinear

        img, pts = ctx.saved_tensors
        _, h, w, _ = img.shape
        d_img = d_pts = None
        if ctx.needs_input_grad[0]:
            d_img = scatter_bilinear(g.float(), pts, h, w).to(img.dtype)
        if ctx.pts_grad and ctx.needs_input_grad[1]:
            d_pts = sample_points_grad(img.float(), pts, g.float()).to(pts.dtype)
        return d_img, d_pts, None


def sample_at_points(img: torch.Tensor, pts: torch.Tensor, pts_grad: bool = False) -> torch.Tensor:
    """Bilinear sampling of (B, H, W, C) images at (B, P, 2) grid points
    ([-1, 1], (x, y) order; ``grid_sample`` zeros padding,
    ``align_corners=False``), differentiable in the image and, with
    ``pts_grad``, in the points.  (B, P, C) in the image's dtype."""
    return SampleAtPoints.apply(img, pts, pts_grad)
