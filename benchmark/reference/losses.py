"""The GAN losses, R1 and the texture-space interpolation penalty, in
plain PyTorch (a frozen copy of the measured program's arithmetic)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import constants as cnst
from .image import resize_bilinear
from .texture_space import flame_texture_space


def d_ns_loss(real_scores, fake_scores):
    return F.softplus(-real_scores).mean() + F.softplus(fake_scores).mean()


def g_ns_loss(fake_scores):
    return F.softplus(-fake_scores).mean()


def r1_penalty(d_apply, real_image, condition, weight=5.0):
    """weight * ||d sum(D(x)) / d x||^2 per sample, meaned; differentiable
    a second time."""
    real = real_image.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(d_apply(real, condition).sum(), real, create_graph=True)
    return weight * g.reshape(g.shape[0], -1).square().sum(1).mean()


def interpolate_flame_batch(flame_labels, t):
    """Lerp consecutive rows' first 159 dims by ``t``; tex / light of the
    first row of each pair.  (N, 236) -> (N - 1, 236)."""
    t = torch.tensor(float(t), dtype=flame_labels.dtype, device=flame_labels.device)
    head = flame_labels[:-1, :159] + t * (flame_labels[1:, :159] - flame_labels[:-1, :159])
    return torch.cat([head, flame_labels[:-1, 159:]], dim=-1)


def interp_render_flame(flame_batch):
    """Row 0's tex / light codes in every row."""
    out = flame_batch.clone()
    for key in ("tex", "lit"):
        i, j = cnst.DECA_IDX[key]
        out[:, i:j] = flame_batch[0:1, i:j]
    return out


def interp_condition_channels(textured, normal, *, rendered_flame_as_condition, normal_maps_as_cond):
    """Raw render maps -> the interpolants' conditions in [-1, 1] (no 8-bit
    floor)."""
    rend = torch.clamp(textured, 0.0, 1.0) * 2.0 - 1.0
    norm = torch.clamp(normal, 0.0, 1.0) * 2.0 - 1.0
    parts = ([rend] if rendered_flame_as_condition else []) + ([norm] if normal_maps_as_cond else [])
    return torch.cat(parts, dim=-1)


def interp_pairs(n):
    return np.array([(i, j) for i in range(n) for j in range(i + 1, n)])


def interp_penalty_from_images(res, images, flame_batch, pairs, face_region_mask):
    """Pairwise texture-consistency penalty of the (N, H, W, 3) generated
    interpolants, over the ``pairs`` (indices into :func:`interp_pairs`)."""
    n = flame_batch.shape[0]
    textures, vis = flame_texture_space(res, images, flame_batch[:, :159])
    if face_region_mask is None:
        face_region_mask = torch.ones(textures.shape[1:3], dtype=textures.dtype, device=textures.device)
    if tuple(face_region_mask.shape) != tuple(textures.shape[1:3]):
        face_region_mask = resize_bilinear(face_region_mask[None, :, :, None], textures.shape[1],
                                           textures.shape[2])[0, :, :, 0]
    mask2d = face_region_mask[None, :, :, None]
    all_pairs = interp_pairs(n)
    n_pick = min(n, len(all_pairs))
    sel = all_pairs[np.asarray(pairs)]
    pi = torch.as_tensor(sel[:, 0], device=images.device)
    pj = torch.as_tensor(sel[:, 1], device=images.device)
    vis_f = vis.to(textures.dtype)
    common = vis_f[pi] * vis_f[pj]
    diff = textures[pi] * common - textures[pj] * common
    per_pair = torch.mean(torch.sigmoid(diff**2) * mask2d, dim=(1, 2, 3))
    return 16.0 * torch.sum(per_pair) / n_pick
