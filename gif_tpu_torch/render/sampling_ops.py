"""Differentiable bilinear sampling at scattered points (port of
:mod:`gif_tpu.render.sampling_ops`).

``sample_at_points`` samples (B, H, W, C) images at (B, P, 2) points — the
texture steal's inner op.  Its forward on the card is kernel 2 (the albedo
sampler, ``csrc/sampler.cu``) with the points viewed as a (B, P, 1) grid;
its image gradient is kernel 6 (``csrc/scatter.cu``), the transpose of the
sampling operator.  On the CPU both directions are the plain versions
below: a four-tap gather and an ``index_add_`` of the valid taps.

Gradients flow to the image values only; the points get none (they come
from FLAME data in every GIF use, never from parameters).
"""

from __future__ import annotations

import torch

from gif_tpu_torch.render import sampler_cuda


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


def sample_at_points_plain(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """The plain forward: gather the four taps, weight, sum.  (B, P, C)."""
    b, h, w, c = img.shape
    ids, wgt, ok = tap_data(h, w, pts)
    flat = img.reshape(b, h * w, c)
    vals = torch.gather(flat, 1, ids.reshape(b, -1, 1).expand(-1, -1, c)).reshape(ids.shape + (c,))
    wgt = (wgt * ok.to(img.dtype))[..., None]
    return torch.sum(vals * wgt, dim=2)


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


class SampleAtPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, pts):
        ctx.save_for_backward(pts)
        ctx.img_shape, ctx.img_dtype = img.shape, img.dtype
        if img.is_cuda:
            b, _, _, c = img.shape
            out = sampler_cuda.grid_sample_cuda(img, pts[:, :, None, :]).reshape(b, -1, c)
        else:
            out = sample_at_points_plain(img, pts)
        return out.to(img.dtype)

    @staticmethod
    def backward(ctx, g):
        # Imported here: scatter_cuda imports this module for kernel 6's
        # plain version.
        from gif_tpu_torch.render.scatter_cuda import scatter_bilinear

        (pts,) = ctx.saved_tensors
        _, h, w, _ = ctx.img_shape
        d_img = scatter_bilinear(g.float(), pts, h, w)
        return d_img.to(ctx.img_dtype), None


def sample_at_points(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of (B, H, W, C) images at (B, P, 2) grid points
    ([-1, 1], (x, y) order; ``grid_sample`` zeros padding,
    ``align_corners=False``), differentiable in the image.  (B, P, C) in
    the image's dtype."""
    return SampleAtPoints.apply(img, pts)
