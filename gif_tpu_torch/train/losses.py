"""GAN losses (port of :mod:`gif_tpu.train.losses`): the non-saturating
softplus losses, the R1 penalty (weight 5, on the real images only) and the
texture-space interpolation loss with its pieces.  The other regularizers
(path length, direct gradient, embedding) wait for the slices that run
them.

The interpolation loss draws three random values: the lerp weight ``t``,
the fixed identity and the ``n_pick`` pairs.  Each is an argument; left
``None`` it is drawn from the ``torch.Generator`` passed (the default
generator when none is).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from gif_tpu_torch import constants as cnst
from gif_tpu_torch.models.texture_space import flame_texture_space
from gif_tpu_torch.render.renderer import render_tex_and_normal
from gif_tpu_torch.utils.image import resize_bilinear


def d_ns_loss(real_scores: torch.Tensor, fake_scores: torch.Tensor) -> torch.Tensor:
    """softplus(-real).mean() + softplus(fake).mean()."""
    return F.softplus(-real_scores).mean() + F.softplus(fake_scores).mean()


def g_ns_loss(fake_scores: torch.Tensor) -> torch.Tensor:
    return F.softplus(-fake_scores).mean()


def r1_from_scores(real_scores: torch.Tensor, real_image: torch.Tensor, weight: float) -> torch.Tensor:
    """weight * ||d sum(D(x)) / d x||^2 per sample, meaned, for scores
    already computed from ``real_image`` (which requires grad).  The graph
    is kept, so the penalty backpropagates into D's parameters."""
    (g,) = torch.autograd.grad(real_scores.sum(), real_image, create_graph=True)
    return weight * g.reshape(g.shape[0], -1).square().sum(1).mean()


def r1_penalty(d_apply, real_image: torch.Tensor, condition, weight: float = 5.0) -> torch.Tensor:
    """R1 with its own D forward: ``d_apply(image, condition) -> (B, 1)``.
    Differentiable a second time."""
    real = real_image.detach().requires_grad_(True)
    return r1_from_scores(d_apply(real, condition), real, weight)


def interpolate_flame_batch(flame_labels: torch.Tensor, t=None, generator=None) -> torch.Tensor:
    """Lerp consecutive FLAME label rows with one shared weight ``t`` (drawn
    uniform in [0, 1) when None), keeping tex/light (dims 159:) of the
    first row of each pair.  (N, 236) -> (N - 1, 236)."""
    if t is None:
        t = torch.rand((), generator=generator)
    t = torch.tensor(float(t), dtype=flame_labels.dtype, device=flame_labels.device)
    head = flame_labels[:-1, :159] + t * (flame_labels[1:, :159] - flame_labels[:-1, :159])
    return torch.cat([head, flame_labels[:-1, 159:]], dim=-1)


def interp_render_flame(flame_batch: torch.Tensor) -> torch.Tensor:
    """Row 0's tex/light codes in every row: the interpolants render under
    one shared texture and lighting."""
    out = flame_batch.clone()
    for key in ("tex", "lit"):
        i, j = cnst.DECA_IDX[key]
        out[:, i:j] = flame_batch[0:1, i:j]
    return out


def interp_condition_channels(textured, normal, *, rendered_flame_as_condition: bool,
                              normal_maps_as_cond: bool) -> torch.Tensor:
    """Raw render maps -> the interpolants' generator conditions in [-1, 1].
    Unlike the data conditions there is no 8-bit floor quantization: the
    reference feeds the live render straight in."""
    rend = torch.clamp(textured, 0.0, 1.0) * 2.0 - 1.0
    norm = torch.clamp(normal, 0.0, 1.0) * 2.0 - 1.0
    if rendered_flame_as_condition and normal_maps_as_cond:
        return torch.cat([rend, norm], dim=-1)
    if rendered_flame_as_condition:
        return rend
    return norm


def interp_pairs(n: int) -> np.ndarray:
    """All (i, j), i < j, pairs of n interpolants, (n (n - 1) / 2, 2)."""
    return np.array([(i, j) for i in range(n) for j in range(i + 1, n)])


def interp_penalty_from_images(res, images: torch.Tensor, flame_batch: torch.Tensor, pairs=None,
                               face_region_mask: torch.Tensor | None = None, generator=None):
    """Pairwise texture-consistency penalty of the generated interpolants
    (N, H, W, 3): steal their textures back and penalize masked pairwise
    differences under the common visibility, over ``n_pick = min(N, N (N -
    1) / 2)`` pairs.  ``pairs`` holds their (n_pick,) indices into
    :func:`interp_pairs` (drawn without replacement when None)."""
    n = flame_batch.shape[0]
    if n < 2:
        raise ValueError(
            "texture_interpolation_loss needs >= 2 interpolated samples "
            f"(= per-shard batch >= 3), got n={n}; raise the per-device "
            "batch size or disable apply_texture_space_interpolation_loss"
        )
    textures, vis = flame_texture_space(res, images, flame_batch[:, :159])
    if face_region_mask is None:
        face_region_mask = torch.ones(textures.shape[1:3], dtype=textures.dtype, device=textures.device)
    if tuple(face_region_mask.shape) != tuple(textures.shape[1:3]):
        face_region_mask = resize_bilinear(
            face_region_mask[None, :, :, None], textures.shape[1], textures.shape[2]
        )[0, :, :, 0]
    mask2d = face_region_mask[None, :, :, None]

    all_pairs = interp_pairs(n)
    n_pick = min(n, len(all_pairs))
    if pairs is None:
        pairs = torch.randperm(len(all_pairs), generator=generator)[:n_pick]
    sel = all_pairs[np.asarray(pairs)]
    pi = torch.as_tensor(sel[:, 0], device=images.device)
    pj = torch.as_tensor(sel[:, 1], device=images.device)

    vis_f = vis.to(textures.dtype)
    common = vis_f[pi] * vis_f[pj]
    diff = textures[pi] * common - textures[pj] * common
    per_pair = torch.mean(torch.sigmoid(diff**2) * mask2d, dim=(1, 2, 3))
    return 16.0 * torch.sum(per_pair) / n_pick


def texture_interpolation_loss(res, flame_batch: torch.Tensor, generator_apply, *, identity=None,
                               pairs=None, generator=None, rendered_flame_as_condition: bool = True,
                               normal_maps_as_cond: bool = True, max_ids: int = 1,
                               face_region_mask: torch.Tensor | None = None, image_size: int = 256,
                               max_tris_per_tile: int | None = None):
    """Texture must not change with FLAME articulation: render the (already
    interpolated) (N, 236) flame batch under one shared texture + light
    code, generate the images of ONE identity (``identity``, drawn from
    [0, max_ids) when None) with ``generator_apply(cond, indices)``, and
    take :func:`interp_penalty_from_images` of them.  The render is data:
    no gradient reaches it."""
    n = flame_batch.shape[0]
    fp = interp_render_flame(flame_batch)
    tex0, tex1 = cnst.DECA_IDX["tex"]
    lit0, lit1 = cnst.DECA_IDX["lit"]
    cam0, cam1 = cnst.DECA_IDX["cam"]
    with torch.no_grad():
        maps = render_tex_and_normal(
            res, fp[:, 0:100], fp[:, 100:150], fp[:, 150:156], fp[:, tex0:tex1],
            fp[:, lit0:lit1].reshape(n, 9, 3), fp[:, cam0:cam1],
            image_size=image_size, max_tris_per_tile=max_tris_per_tile,
        )
        gen_in = interp_condition_channels(
            maps.textured, maps.normal,
            rendered_flame_as_condition=rendered_flame_as_condition,
            normal_maps_as_cond=normal_maps_as_cond,
        )
    if identity is None:
        identity = torch.randint(0, max_ids, (), generator=generator)
    indices = torch.full((n,), int(identity), dtype=torch.long, device=flame_batch.device)
    images = generator_apply(gen_in, indices)
    return interp_penalty_from_images(res, images, flame_batch, pairs, face_region_mask, generator)
