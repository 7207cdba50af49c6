"""GAN losses and regularizers (port of :mod:`gif_tpu.train.losses`): the
non-saturating softplus losses, the R1 penalty (weight 5, on the real
images only), the path-length penalty (a 512-d z and a true EMA of the
path length: the JAX package's two fixes of the original code), the
direct gradient penalty, the derangement behind shuffled-condition negatives, the L2 parameter norm of
the embedding regularizer, the texture-space interpolation loss with its
pieces, and two terms no preset uses (``wgan_gp_loss``,
``disentanglement_penalty``).

Every random draw is an argument; left ``None`` it is drawn from the
``torch.Generator`` passed (the default generator when none is).  The
interpolation loss draws the lerp weight ``t``, the fixed identity and the
``n_pick`` pairs; the path-length penalty its projection noise; the
derangement its cyclic shift.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from gif_tpu_torch import constants as cnst
from gif_tpu_torch.models.texture_space import flame_texture_space
from gif_tpu_torch.parallel.collectives import differentiable_mean
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


def path_length_penalty(g_apply_z, z: torch.Tensor, pl_mean: torch.Tensor, decay: float = 0.01,
                        noise=None, generator=None, group=None):
    """StyleGAN2's path-length penalty on the z -> image Jacobian.

    ``g_apply_z(z) -> images`` (B, H, W, 3); ``z`` (B, 512); ``pl_mean`` the
    running mean of path lengths (0-d).  ``noise`` is the projection's
    standard-normal draw of the images' shape (drawn from ``generator``
    when None), scaled by ``1 / sqrt(images.numel())``.  Returns (penalty,
    new_pl_mean), both differentiable in G's parameters: as in the JAX
    package, ``new_pl_mean`` is not detached, so the gradient also reaches
    G through it.  With a process ``group`` the mean length is averaged
    across its ranks before the running-mean update (differentiably), so
    every replica carries the same ``pl_mean``."""
    z = z.detach().requires_grad_(True)
    images = g_apply_z(z)
    if noise is None:
        noise = torch.randn(images.shape, generator=generator)
    noise = torch.as_tensor(noise, dtype=images.dtype, device=images.device)
    noise = noise / float(np.sqrt(np.prod(images.shape, dtype=np.float64)))
    (grads,) = torch.autograd.grad(images, z, noise, create_graph=True)
    lengths = differentiable_mean(torch.mean(torch.sqrt(torch.sum(grads**2, dim=1))), group)
    new_mean = pl_mean + decay * (lengths - pl_mean)
    return (lengths - new_mean) ** 2, new_mean


def direct_grad_penalty(g_apply_cond, cond: torch.Tensor) -> torch.Tensor:
    """The direct gradient regularizer's penalty: the per-sample squared
    norm of ``d sum(G(cond)**2) / d cond``, meaned over the batch (the step
    weights it by 8e-8).  ``g_apply_cond(cond) -> images``.  The gradient's
    graph is kept, so the penalty is differentiable in G's parameters (a
    second-order pass through G)."""
    c = cond.detach().requires_grad_(True)
    (g_c,) = torch.autograd.grad(torch.sum(g_apply_cond(c) ** 2), c, create_graph=True)
    return g_c.reshape(g_c.shape[0], -1).square().sum(1).mean()


def wgan_gp_loss(predictions: torch.Tensor) -> torch.Tensor:
    """-(p - 0.001 p^2), elementwise (API surface; no preset uses it)."""
    return -(predictions - 0.001 * predictions**2)


def derangement_indices(n: int, shift=None, generator=None) -> torch.Tensor:
    """A fixed-point-free permutation of range(n): a cyclic shift by
    ``shift`` in [1, n) (drawn uniformly from ``generator`` when None).
    Raises for n < 2, where no derangement exists."""
    if n < 2:
        raise ValueError(
            f"derangement needs n >= 2 (got per-shard batch {n}); raise the "
            "global batch or use fewer mesh devices"
        )
    if shift is None:
        shift = torch.randint(1, n, (), generator=generator)
    shift = int(shift)
    if not 1 <= shift < n:
        raise ValueError(f"derangement shift {shift} is not in [1, {n})")
    return (torch.arange(n) + shift) % n


def disentanglement_penalty(d_apply_flm, image: torch.Tensor, flame_params: torch.Tensor) -> torch.Tensor:
    """Factor-wise gradient penalty of a discriminator with 5 decision
    columns [real, shape-match, exp-match, pose-match, cam-match]:
    ``d_apply_flm(image, flame) -> (B, 5)``; per column, the norm of the
    gradient with respect to the FLAME parameters outside that column's
    factor.  (B,) per-sample penalties, differentiable a second time (API
    surface; no preset uses it)."""
    sh, ex = cnst.INDICES["SHAPE"], cnst.INDICES["EXP"]
    po, ca = cnst.INDICES["POSE"], cnst.INDICES["CAM"]
    flame = flame_params.detach().requires_grad_(True)
    scores = d_apply_flm(image, flame)

    def col_grad(col):
        (g,) = torch.autograd.grad(scores[:, col].sum(), flame, create_graph=True)
        return g

    def norm(part):
        return torch.linalg.norm(part.reshape(part.shape[0], -1), dim=1)

    d_img = norm(col_grad(0))
    d_shape = norm(col_grad(1)[:, ex[0]:236])
    g2 = col_grad(2)
    d_exp = norm(torch.cat([g2[:, sh[0]:sh[1]], g2[:, po[0]:ca[1]]], dim=1))
    g3 = col_grad(3)
    d_pose = norm(torch.cat([g3[:, sh[0]:sh[1]], g3[:, ex[0]:ex[1]]], dim=1))
    g4 = col_grad(4)
    d_cam = norm(torch.cat([g4[:, sh[0]:sh[1]], g4[:, ex[0]:ex[1]]], dim=1))
    return 0.5 * (d_img + d_shape + d_exp + d_pose + d_cam)


def l2_param_norm(params) -> torch.Tensor:
    """Sum of the parameters' L2 norms (the embedding regularizer)."""
    return sum(torch.linalg.norm(p.reshape(-1)) for p in params)


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
