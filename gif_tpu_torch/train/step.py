"""Condition-map rendering and the GAN train step (port of
:mod:`gif_tpu.train.step`: ``render_flame_maps``, ``quantize_condition``,
``render_condition_maps`` and ``make_train_step``).

One step, as the reference iteration runs it (``step.py:213-658``):

1. render the condition maps on the device (no gradient reaches the
   render: the maps are data, floored onto the 8-bit grid);
2. the generator forward; its graph is kept and reused for G's gradient
   (``step.py:318-324``), D sees it detached;
3. D update: non-saturating softplus loss, plus R1 on the reals — every
   step through the same D(real) forward when ``r1_interval == 1``, else
   with its own forward on steps where ``(step + 1) % r1_interval == 0`` —
   and one Adam step;
4. G update through the *updated* D (``n_critic``: an integer ``n`` trains
   G every n-th step, a fraction ``1/k`` k times a step), one Adam step
   each, and the EMA of G's parameters after each.

Under the texture-space interpolation loss (run ids 0, 3, 29) G's loss
adds the pairwise texture penalty of B - 1 interpolants of consecutive
FLAME rows, generated at one identity and stolen back into UV space
(``losses.interp_penalty_from_images``).  Fused (``step.py:205-211``),
their render and G forward share the data batch's: one render and one G
program over 2B - 1 rows, and G's gradient is one backward of ``g_adv +
scale * interp`` through the kept forward.

Every kernel of the path launches on the card: the rasterizer and the
albedo sampler in the render, the fused bias+lrelu forward and backward and
the FIR blur and its VJP in G and D (R1's grad-of-grad included), and under
the interpolation loss the sampler again (the texture steal's forward) and
the bilinear scatter (its backward).

The branches of the JAX step that belong to later slices (path-length and
direct-grad regularizers, embedding reg, shuffled-condition negatives,
instance noise, crop/flip augmentation) raise ``NotImplementedError``
naming the flag.
"""

from __future__ import annotations

import torch

from gif_tpu_torch import constants as cnst
from gif_tpu_torch.device import resolve_device, second_order_safe, set_tf32_policy
from gif_tpu_torch.render.renderer import RenderedMaps, render_tex_and_normal
from gif_tpu_torch.train import losses as L
from gif_tpu_torch.train.config import TrainConfig
from gif_tpu_torch.utils.ema import ema_update
from gif_tpu_torch.utils.image import resize_bilinear


def render_flame_maps(
    res, flame_params: torch.Tensor, image_size: int, max_tris_per_tile: int | None = None
) -> RenderedMaps:
    """Raster the 236-d DECA layout (shape/exp/pose/cam/tex/lit slices of
    ``constants.DECA_IDX``) into raw textured + normal maps."""
    b = flame_params.shape[0]
    tex0, tex1 = cnst.DECA_IDX["tex"]
    lit0, lit1 = cnst.DECA_IDX["lit"]
    cam0, cam1 = cnst.DECA_IDX["cam"]
    return render_tex_and_normal(
        res,
        flame_params[:, 0:100],
        flame_params[:, 100:150],
        flame_params[:, 150:156],
        flame_params[:, tex0:tex1],
        flame_params[:, lit0:lit1].reshape(b, 9, 3),
        flame_params[:, cam0:cam1],
        image_size=image_size,
        max_tris_per_tile=max_tris_per_tile,
    )


def quantize_condition(textured, normal, cfg: TrainConfig) -> torch.Tensor:
    """Raw render maps -> [-1, 1] condition maps floored onto the 8-bit
    grid (the reference's PNG round trip), resized first to the training
    resolution when ``render_image_size != max_size``."""
    if cfg.render_image_size != cfg.max_size:
        textured = resize_bilinear(textured, cfg.max_size, cfg.max_size)
        normal = resize_bilinear(normal, cfg.max_size, cfg.max_size)
    rend = torch.floor(torch.clamp(textured, 0.0, 1.0) * 255.0) / 255.0
    norm = torch.floor(torch.clamp(normal, 0.0, 1.0) * 255.0) / 255.0
    parts = []
    if cfg.rendered_flame_as_condition:
        parts.append(rend * 2.0 - 1.0)
    if cfg.normal_maps_as_cond:
        parts.append(norm * 2.0 - 1.0)
    return torch.cat(parts, dim=-1)


def render_condition_maps(
    res,
    flame_params: torch.Tensor,
    cfg: TrainConfig,
    max_tris_per_tile: int | None = None,
    return_overflow: bool = False,
):
    """FLAME 236-d params -> quantized [-1, 1] NHWC condition maps; with
    ``return_overflow`` also the per-sample (B,) raster overflow flags."""
    maps = render_flame_maps(res, flame_params, cfg.render_image_size, max_tris_per_tile)
    cond = quantize_condition(maps.textured, maps.normal, cfg)
    if return_overflow:
        return cond, maps.overflow
    return cond


def check_supported(cfg: TrainConfig) -> None:
    """Raise ``NotImplementedError`` naming the first flag of ``cfg`` that
    needs a branch of the JAX step this port does not have yet."""
    unported = [
        (cfg.gen_reg_type.lower() != "none", f"gen_reg_type={cfg.gen_reg_type!r}"),
        (cfg.embedding_reg_weight > 0, f"embedding_reg_weight={cfg.embedding_reg_weight}"),
        (cfg.shfld_cond_as_neg_smpl, "shfld_cond_as_neg_smpl=True"),
        (cfg.d_input_noise_std > 0, f"d_input_noise_std={cfg.d_input_noise_std}"),
    ]
    for bad, flag in unported:
        if bad:
            raise NotImplementedError(f"{flag}: this branch of the train step is not ported yet")


def g_schedule(cfg: TrainConfig) -> tuple[int, int]:
    """(G trains every ``g_interval``-th step, ``g_iters`` times): n_critic
    >= 1 trains G every round(n_critic) steps once, a fraction trains it
    round(1 / n_critic) times every step."""
    nc = cfg.n_critic
    if nc >= 1:
        return int(round(nc)), 1
    return 1, int(round(1.0 / nc))


def d_loss_and_grads(disc, real, cond, fake, cfg: TrainConfig, do_r1: bool):
    """D's softplus loss on (real, fake) under ``cond``, R1 (every step
    through the shared D(real) forward when ``r1_interval == 1``, else with
    its own forward where ``do_r1``), and the gradient of their sum with
    respect to D's parameters.  Returns (d_loss, r1, grads)."""
    params = list(disc.parameters())
    if cfg.r1_interval == 1:
        real_in = real.detach().requires_grad_(True)
        real_scores = disc(real_in, cond)
        d_loss = L.d_ns_loss(real_scores, disc(fake, cond))
        r1 = L.r1_from_scores(real_scores, real_in, cfg.r1_weight)
    else:
        d_loss = L.d_ns_loss(disc(real, cond), disc(fake, cond))
        if do_r1:
            r1 = L.r1_penalty(disc, real, cond, cfg.r1_weight)
        else:
            r1 = torch.zeros((), device=real.device)
    with second_order_safe(real.device):
        grads = torch.autograd.grad(d_loss + r1, params, materialize_grads=True)
    return d_loss.detach(), r1.detach(), grads


def g_loss_and_grads(gen, disc, fake_live, cond, interp_fn=None, adaptive: bool = False):
    """G's loss and its gradient with respect to G's parameters only
    (nothing accumulates into D).  ``fake_live`` is a generator output whose
    graph is live; its first ``len(cond)`` rows are scored by ``disc``
    (non-saturating loss ``g_adv``).  With ``interp_fn`` the loss adds the
    interpolation penalty ``interp_fn()`` (a scalar whose graph reaches G),
    scaled by ``0.25 * g_adv / penalty`` (both detached) when ``adaptive``.
    Returns (g_adv, interp — 0 without ``interp_fn`` —, grads)."""
    g_adv = L.g_ns_loss(disc(fake_live[: cond.shape[0]], cond))
    interp = torch.zeros_like(g_adv)
    if interp_fn is not None:
        interp_raw = interp_fn()
        scale = 0.25 * g_adv.detach() / interp_raw.detach() if adaptive else 1.0
        interp = interp_raw * scale
    grads = torch.autograd.grad(g_adv + interp, list(gen.parameters()), materialize_grads=True)
    return g_adv.detach(), interp.detach(), grads


def _adam_step(opt: torch.optim.Optimizer, params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def make_train_step(
    cfg: TrainConfig,
    res,
    device=None,
    max_tris_per_tile: int | None = None,
    face_region_mask=None,
    fuse_interp: bool = True,
    generator: torch.Generator | None = None,
):
    """Build ``train_step(state, batch, draws=None) -> (state, metrics)``.

    ``batch`` holds ``real_image`` (B, S, S, 3) in [-1, 1], ``flame`` (B,
    236), ``indices`` (B,) identity indices and, unless
    ``cfg.render_in_step``, ``cond`` (B, S, S, C) precomputed condition
    maps.  The step updates ``state`` (a :class:`TrainState` on
    ``device``) in place and returns it with 0-d tensor metrics
    ``d_loss``, ``g_loss``, ``r1``, ``g_total`` and ``render_overflow``
    (the fraction of samples whose render dropped triangles), and
    ``interp`` under the interpolation loss (0 on steps without a G
    update; ``g_total = g_loss + interp``).

    The interpolation loss draws the lerp weight, the interpolants' fixed
    identity and the penalized pairs from ``generator`` (a CPU
    ``torch.Generator``; seeded 0 when None); ``draws`` may override them
    with ``interp_t``, ``interp_identity`` and ``interp_pairs`` (see
    :mod:`gif_tpu_torch.train.losses`).  ``fuse_interp`` runs its render
    and generator forward together with the data batch's — one render and
    one G forward over 2B - 1 rows — where that is exact: G trains once
    every step and conditions render at the training size.
    ``face_region_mask`` defaults to ``res.face_region_mask``.

    ``device`` is CUDA unless the caller passes another; without a card the
    default raises.  ``max_tris_per_tile=None`` sizes the raster's tile
    capacity from the mesh.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_tf32_policy()
    g_interval, g_iters = g_schedule(cfg)
    step_idx = cfg.max_step
    interp_on = cfg.apply_texture_space_interpolation_loss
    do_fuse = (
        fuse_interp and interp_on and g_interval == 1 and g_iters == 1
        and cfg.render_image_size == cfg.max_size
    )
    rng = generator if generator is not None else torch.Generator().manual_seed(0)
    if face_region_mask is None:
        face_region_mask = getattr(res, "face_region_mask", None)
    frm = None if face_region_mask is None else torch.as_tensor(
        face_region_mask, dtype=torch.float32, device=dev
    )

    def as_tensor(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def train_step(state, batch, draws=None):
        for key in ("crop", "flip"):
            if key in batch:
                raise NotImplementedError(f"batch key {key!r}: augmented batches are not ported yet")
        draws = draws or {}
        real = as_tensor(batch["real_image"], torch.float32)
        indices = as_tensor(batch["indices"], torch.long)
        flame = as_tensor(batch["flame"], torch.float32)
        b = real.shape[0]
        gen, disc = state.generator, state.discriminator

        if interp_on and b < 3:
            raise ValueError(
                "texture-space interpolation loss pairs interpolants within a "
                f"batch and needs >= 3 samples; got batch {b}"
            )
        if do_fuse:
            flm_interp = L.interpolate_flame_batch(flame, draws.get("interp_t"), rng)
            identity = draws.get("interp_identity")
            if identity is None:
                identity = torch.randint(0, cfg.embedding_vocab_size, (), generator=rng)
            interp_indices = torch.full((b - 1,), int(identity), dtype=torch.long, device=dev)
        # One render of the data rows and, fused, the interpolants; the
        # overflow metric covers the data rows only.
        with torch.no_grad():
            rows = ([flame] if cfg.render_in_step else []) + (
                [L.interp_render_flame(flm_interp)] if do_fuse else []
            )
            if rows:
                maps = render_flame_maps(res, torch.cat(rows), cfg.render_image_size, max_tris_per_tile)
            if cfg.render_in_step:
                cond = quantize_condition(maps.textured[:b], maps.normal[:b], cfg)
                overflow = maps.overflow[:b]
            else:
                cond = as_tensor(batch["cond"], torch.float32)
                overflow = torch.zeros((b,), dtype=torch.bool, device=dev)
            if do_fuse:
                n_data = b if cfg.render_in_step else 0
                interp_cond = L.interp_condition_channels(
                    maps.textured[n_data:], maps.normal[n_data:],
                    rendered_flame_as_condition=cfg.rendered_flame_as_condition,
                    normal_maps_as_cond=cfg.normal_maps_as_cond,
                )

        def g_forward():
            return gen(cond, input_indices=indices, step=step_idx)

        # D update.  When G trains every step, this forward is also G's
        # forward for its first update: its graph is kept.  Fused, it runs
        # over the data rows and the interpolants; D sees the data rows.
        if do_fuse:
            fake_live = gen(
                torch.cat([cond, interp_cond]),
                input_indices=torch.cat([indices, interp_indices]),
                step=step_idx,
            )
            fake, fake_interp = fake_live[:b].detach(), fake_live[b:]
        elif g_interval == 1:
            fake_live = g_forward()
            fake = fake_live.detach()
        else:
            fake_live = None
            with torch.no_grad():
                fake = g_forward()
        do_r1 = (state.step + 1) % cfg.r1_interval == 0
        d_loss, r1, d_grads = d_loss_and_grads(disc, real, cond, fake, cfg, do_r1)
        _adam_step(state.d_opt, disc.parameters(), d_grads)

        # G update(s), scored by the updated D.  Unfused, each update draws
        # and renders its own interpolants.
        if do_fuse:
            def interp_fn():
                return L.interp_penalty_from_images(
                    res, fake_interp, flm_interp, draws.get("interp_pairs"), frm, rng
                )
        elif interp_on:
            def interp_fn():
                return L.texture_interpolation_loss(
                    res, L.interpolate_flame_batch(flame, draws.get("interp_t"), rng),
                    lambda c, i: gen(c, input_indices=i, step=step_idx),
                    identity=draws.get("interp_identity"), pairs=draws.get("interp_pairs"),
                    generator=rng, rendered_flame_as_condition=cfg.rendered_flame_as_condition,
                    normal_maps_as_cond=cfg.normal_maps_as_cond,
                    max_ids=cfg.embedding_vocab_size, face_region_mask=frm,
                    image_size=cfg.render_image_size, max_tris_per_tile=max_tris_per_tile,
                )
        else:
            interp_fn = None
        g_adv = torch.zeros((), device=dev)
        interp = torch.zeros((), device=dev)
        if g_interval == 1 or (state.step + 1) % g_interval == 0:
            for _ in range(g_iters):
                live, fake_live = (fake_live if fake_live is not None else g_forward()), None
                g_adv, interp, g_grads = g_loss_and_grads(
                    gen, disc, live, cond, interp_fn, cfg.adaptive_interp_loss
                )
                del live
                _adam_step(state.g_opt, gen.parameters(), g_grads)
                ema_update(state.g_ema.parameters(), gen.parameters(), cfg.ema_decay)

        state.step += 1
        state.used_samples += b
        metrics = {
            "d_loss": d_loss,
            "g_loss": g_adv,
            "r1": r1,
            "g_total": g_adv + interp,
            "render_overflow": overflow.float().mean(),
        }
        if interp_on:
            metrics["interp"] = interp
        return state, metrics

    return train_step
