"""Condition-map rendering and the GAN train step (port of
:mod:`gif_tpu.train.step`: ``render_flame_maps``, ``quantize_condition``,
``render_condition_maps``, ``apply_condition_augment`` and
``make_train_step``).

One step, as the reference iteration runs it (``step.py:213-658``):

1. render the condition maps on the device from the true FLAME fit
   (``flame_render`` when the batch carries one, else ``flame``; no
   gradient reaches the render: the maps are data, floored onto the 8-bit
   grid), then crop and flip them as the real image was;
2. the generator forward; its graph is kept and reused for G's gradient
   (``step.py:318-324``), D sees it detached;
3. D update: non-saturating softplus loss — with shuffled-condition
   negatives, D's fake batch is ``[fake, fake]`` under ``[cond,
   cond[perm]]`` for a derangement ``perm`` — plus R1 on the reals — every
   step through the same D(real) forward when ``r1_interval == 1``, else
   with its own forward on steps where ``(step + 1) % r1_interval == 0`` —
   and one Adam step.  Instance noise (``d_input_noise_std``) adds a fresh
   draw to the reals and to the fakes D trains on;
4. G update through the *updated* D (``n_critic``: an integer ``n`` trains
   G every n-th step, a fraction ``1/k`` k times a step), one Adam step
   each, and the EMA of G's parameters after each.  G's loss is ``g_adv +
   rest + interp``: the adversarial loss on a fresh instance-noise draw of
   its fakes, ``rest`` the regularizers (path length, weight 2, with its
   own G forward from z and the running mean in ``state.pl_mean``; or the
   direct gradient penalty, weight 8e-8, a gradient of G with respect to
   its conditions; plus ``embedding_reg_weight`` times the mapping net's
   L2 norm), ``interp`` the interpolation penalty, scaled by ``0.25 *
   (g_adv + rest) / interp`` when adaptive.  Second-order terms are
   differentiated under :func:`second_order_safe`.

Under the texture-space interpolation loss (run ids 0, 3, 29) G's loss
adds the pairwise texture penalty of B - 1 interpolants of consecutive
FLAME rows, generated at one identity and stolen back into UV space
(``losses.interp_penalty_from_images``).  Fused (``step.py:205-211``),
their render and G forward share the data batch's: one render and one G
program over 2B - 1 rows, and G's gradient is one backward of ``g_adv +
rest + scale * interp`` through the kept forward (``rest`` with its own
forwards).

Data parallel (``group``): each rank steps on its own slice of the global
batch with its own draws; D's and G's gradients are mean-all-reduced
after each backward and before each Adam step, the path length is
averaged across ranks before the running-mean update, and the metrics
are averaged — the JAX package's ``shard_map`` step with ``lax.pmean``.
Minibatch stddev and the interpolation pairs stay within a rank's rows.

Every kernel of the path launches on the card: the rasterizer and the
albedo sampler in the render, the fused bias+lrelu forward and backward and
the FIR blur and its VJP in G and D (R1's and the regularizers'
grad-of-grad included), and under the interpolation loss the sampler again
(the texture steal's forward) and the bilinear scatter (its backward).

While a profiler records, the step marks its phases with
:func:`gif_tpu_torch.utils.profiling.span` (off, each span is a bool
check).  ``train.step`` is the whole call, with attributes ``step`` (the
counter before the step) and ``r1``, and the allocator's ``cudaMalloc``
calls and alloc retries and the kernel wrappers' layout copies
(``layout_copies``, :mod:`gif_tpu_torch.ops.layout`) across it; its
children, in order:

- ``train.render``: the fused interpolants' draws, the render, the
  quantization and the crop / flip of the conditions;
- ``train.g_forward``: G's forward (over 2B - 1 rows when fused), whose
  graph G's first update reuses;
- ``train.d_grads``: the shuffled negatives, the instance noise, D's
  forwards, its loss, R1 on R1 steps and D's gradient;
- ``train.d_adam``: D's all-reduce (data parallel) and Adam step;
- per G iteration (attribute ``it``): ``train.g_grads``, G's loss through
  the updated D, the regularizers, the interpolation penalty with its
  steal, and G's gradient; ``train.g_adam``, the path length's running
  mean, G's all-reduce and Adam step; ``train.ema``, the EMA update.
"""

from __future__ import annotations

import torch

from gif_tpu_torch import constants as cnst
from gif_tpu_torch.data.augment import same_padding_crop_torch
from gif_tpu_torch.device import resolve_device, second_order_safe, set_tf32_policy
from gif_tpu_torch.ops.layout import layout_copies
from gif_tpu_torch.parallel.collectives import mean_all_reduce
from gif_tpu_torch.parallel.mesh import process_count
from gif_tpu_torch.render.renderer import RenderedMaps, render_tex_and_normal
from gif_tpu_torch.train import losses as L
from gif_tpu_torch.train.config import TrainConfig
from gif_tpu_torch.utils.ema import ema_update
from gif_tpu_torch.utils.image import resize_bilinear
from gif_tpu_torch.utils.profiling import span


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


def apply_condition_augment(cond: torch.Tensor, batch: dict) -> torch.Tensor:
    """Give rendered condition maps the pixel transforms the real image got,
    in the reference order: crop (``batch["crop"]``, (B, 2) row / column
    shifts) FIRST, then the horizontal flip (``batch["flip"]``, (B,)
    bools).  The asymmetric edge fills do not commute with the flip."""
    if "crop" in batch:
        cond = same_padding_crop_torch(cond, torch.as_tensor(batch["crop"], device=cond.device))
    if "flip" in batch:
        flip = torch.as_tensor(batch["flip"], device=cond.device).bool()
        cond = torch.where(flip[:, None, None, None], cond.flip(2), cond)
    return cond


GEN_REG_TYPES = ("none", "path_len_reg", "direct_grad_reg")


# The program's counters ``train.step`` records the change of.
_STEP_COUNTS = {"layout_copies": lambda: layout_copies.copies}


def g_schedule(cfg: TrainConfig) -> tuple[int, int]:
    """(G trains every ``g_interval``-th step, ``g_iters`` times): n_critic
    >= 1 trains G every round(n_critic) steps once, a fraction trains it
    round(1 / n_critic) times every step."""
    nc = cfg.n_critic
    if nc >= 1:
        return int(round(nc)), 1
    return 1, int(round(1.0 / nc))


def d_loss_and_grads(disc, real, cond, fake, cfg: TrainConfig, do_r1: bool, fake_cond=None):
    """D's softplus loss on ``real`` under ``cond`` and ``fake`` under
    ``fake_cond`` (``cond`` when None), R1 (every step through the shared
    D(real) forward when ``r1_interval == 1``, else with its own forward
    where ``do_r1``), and the gradient of their sum with respect to D's
    parameters.  Returns (d_loss, r1, grads)."""
    params = list(disc.parameters())
    fake_cond = cond if fake_cond is None else fake_cond
    if cfg.r1_interval == 1:
        real_in = real.detach().requires_grad_(True)
        real_scores = disc(real_in, cond)
        d_loss = L.d_ns_loss(real_scores, disc(fake, fake_cond))
        r1 = L.r1_from_scores(real_scores, real_in, cfg.r1_weight)
    else:
        d_loss = L.d_ns_loss(disc(real, cond), disc(fake, fake_cond))
        if do_r1:
            r1 = L.r1_penalty(disc, real, cond, cfg.r1_weight)
        else:
            r1 = torch.zeros((), device=real.device)
    with second_order_safe(real.device):
        grads = torch.autograd.grad(d_loss + r1, params, materialize_grads=True)
    return d_loss.detach(), r1.detach(), grads


def g_loss_and_grads(gen, disc, fake_live, cond, interp_fn=None, adaptive: bool = False, rest_fn=None,
                     d_input=None, second_order: bool = False):
    """G's loss and its gradient with respect to G's parameters only
    (nothing accumulates into D).  ``fake_live`` is a generator output whose
    graph is live; its first ``len(cond)`` rows, through ``d_input`` (the
    instance noise; identity when None), are scored by ``disc``
    (non-saturating loss ``g_adv``).  ``rest_fn()`` gives the regularizer
    terms ``rest`` (a scalar whose graph reaches G) and a value passed
    back; ``interp_fn()`` the interpolation penalty, scaled by ``0.25 *
    (g_adv + rest) / penalty`` (detached) when ``adaptive``.  The gradient
    of ``g_adv + rest + interp`` is one backward, under
    :func:`second_order_safe` when ``second_order``.  Returns (g_adv, rest,
    interp — each 0 without its term —, grads, the value ``rest_fn``
    passed back)."""
    b = cond.shape[0]
    scored = fake_live[:b] if d_input is None else d_input(fake_live[:b])
    g_adv = L.g_ns_loss(disc(scored, cond))
    rest, aux = rest_fn() if rest_fn is not None else (torch.zeros_like(g_adv), None)
    interp = torch.zeros_like(g_adv)
    if interp_fn is not None:
        interp_raw = interp_fn()
        scale = 0.25 * (g_adv + rest).detach() / interp_raw.detach() if adaptive else 1.0
        interp = interp_raw * scale
    total = g_adv + rest + interp
    params = list(gen.parameters())
    if second_order:
        with second_order_safe(total.device):
            grads = torch.autograd.grad(total, params, materialize_grads=True)
    else:
        grads = torch.autograd.grad(total, params, materialize_grads=True)
    return g_adv.detach(), rest.detach(), interp.detach(), grads, aux


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
    group=None,
):
    """Build ``train_step(state, batch, draws=None) -> (state, metrics)``
(for a StyleGAN3 config, :func:`gif_tpu_torch.train.uncond_step.make_uncond_train_step`'s,
with ``res`` unused).

    ``batch`` holds ``real_image`` (B, S, S, 3) in [-1, 1], ``flame`` (B,
    236), ``indices`` (B,) identity indices and, unless
    ``cfg.render_in_step``, ``cond`` (B, S, S, C) precomputed condition
    maps.  An augmented batch also carries ``crop`` (B, 2) pixel shifts
    and / or ``flip`` (B,) bools, which the rendered conditions receive
    (crop, then flip), and ``flame_render`` (B, 236), the true fit the
    conditions render from (``flame``, the label, may be crop-zeroed or
    flip-sentinelled; the fused interpolants still come from it).  The step
    updates ``state`` (a :class:`TrainState` on ``device``) in place and
    returns it with 0-d tensor metrics ``d_loss``, ``g_loss``, ``r1``,
    ``g_total`` (``g_loss + rest + interp``, 0 on steps without a G update)
    and ``render_overflow`` (the fraction of samples whose render dropped
    triangles), and ``interp`` under the interpolation loss.

    Random draws come from ``generator`` (a CPU ``torch.Generator``; seeded
    0 when None); ``draws`` may override them:

    - ``interp_t``, ``interp_identity``, ``interp_pairs``: the
      interpolation loss's lerp weight, fixed identity and pairs (see
      :mod:`gif_tpu_torch.train.losses`);
    - ``shuffle_shift``: the cyclic shift of the shuffled-condition
      derangement, in [1, B);
    - ``noise_real`` (B, S, S, 3) and ``noise_fake`` (B or 2B, S, S, 3):
      standard-normal instance noise on D's reals and fakes;
    - per G iteration ``i`` (a leading axis of length ``round(1 /
      n_critic)``, or 1): ``noise_g[i]`` (B, S, S, 3), the instance noise
      on the fakes G is scored on; ``pl_z[i]`` (B, 512) and ``pl_noise[i]``
      (B, S, S, 3), the path-length penalty's latent and projection noise
      (standard normal; the penalty scales the noise).

    ``fuse_interp`` runs the interpolation loss's render and generator
    forward together with the data batch's — one render and one G forward
    over 2B - 1 rows — where that is exact: G trains once every step and
    conditions render at the training size.  ``face_region_mask`` defaults
    to ``res.face_region_mask``.

    ``device`` is CUDA unless the caller passes another; without a card the
    default raises.  ``max_tris_per_tile=None`` sizes the raster's tile
    capacity from the mesh.

    With a process ``group`` (:mod:`gif_tpu_torch.parallel`) ``batch`` is
    this rank's slice of the global batch and ``generator`` this rank's
    own stream; each gradient is mean-all-reduced across the ranks before
    its Adam step, the metrics are averaged across them, and
    ``used_samples`` grows by the global batch.  Every rank must call the
    step in lockstep with a replica of the same state.
    """
    if cfg.architecture == "stylegan3-t":
        from gif_tpu_torch.train.uncond_step import make_uncond_train_step

        return make_uncond_train_step(cfg, device=device, generator=generator, group=group)
    reg = cfg.gen_reg_type.lower()
    if reg not in GEN_REG_TYPES:
        raise ValueError(f"gen_reg_type {cfg.gen_reg_type!r} is not one of {GEN_REG_TYPES}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_tf32_policy()
    world = process_count(group) if group is not None else 1
    g_interval, g_iters = g_schedule(cfg)
    step_idx = cfg.max_step
    interp_on = cfg.apply_texture_space_interpolation_loss
    do_fuse = (
        fuse_interp and interp_on and g_interval == 1 and g_iters == 1
        and cfg.render_image_size == cfg.max_size
    )
    ins_std = cfg.d_input_noise_std
    rng = generator if generator is not None else torch.Generator().manual_seed(0)
    if face_region_mask is None:
        face_region_mask = getattr(res, "face_region_mask", None)
    frm = None if face_region_mask is None else torch.as_tensor(
        face_region_mask, dtype=torch.float32, device=dev
    )

    def as_tensor(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def train_step(state, batch, draws=None):
        do_r1 = (state.step + 1) % cfg.r1_interval == 0
        with span("train.step", allocator=True, counts=_STEP_COUNTS, step=state.step, r1=do_r1):
            return step_phases(state, batch, draws or {}, do_r1)

    def step_phases(state, batch, draws, do_r1):
        real = as_tensor(batch["real_image"], torch.float32)
        indices = as_tensor(batch["indices"], torch.long)
        flame = as_tensor(batch["flame"], torch.float32)
        b = real.shape[0]
        gen, disc = state.generator, state.discriminator

        def draw(key, shape, it=None):
            """``draws[key]`` (its ``it``-th entry per G iteration), else a
            standard-normal draw from ``rng``."""
            x = draws.get(key)
            if x is not None and it is not None:
                x = x[it]
            if x is None:
                x = torch.randn(shape, generator=rng)
            return as_tensor(x, torch.float32)

        def d_input(img, key, it=None):
            """Instance noise: a fresh draw on every image D sees."""
            if not ins_std:
                return img
            return img + draw(key, img.shape, it) * ins_std

        if interp_on and b < 3:
            raise ValueError(
                "texture-space interpolation loss pairs interpolants "
                "WITHIN a data shard and needs >= 3 samples per shard; "
                f"got per-shard batch {b} — raise the global batch or "
                "use fewer mesh devices"
            )
        with span("train.render"):
            if do_fuse:
                flm_interp = L.interpolate_flame_batch(flame, draws.get("interp_t"), rng)
                identity = draws.get("interp_identity")
                if identity is None:
                    identity = torch.randint(0, cfg.embedding_vocab_size, (), generator=rng)
                interp_indices = torch.full((b - 1,), int(identity), dtype=torch.long, device=dev)
            # One render of the data rows (from the true fit) and, fused, the
            # interpolants; the overflow metric covers the data rows only.
            with torch.no_grad():
                flame_render = as_tensor(batch.get("flame_render", batch["flame"]), torch.float32)
                rows = ([flame_render] if cfg.render_in_step else []) + (
                    [L.interp_render_flame(flm_interp)] if do_fuse else []
                )
                if rows:
                    maps = render_flame_maps(res, torch.cat(rows), cfg.render_image_size, max_tris_per_tile)
                if cfg.render_in_step:
                    cond = quantize_condition(maps.textured[:b], maps.normal[:b], cfg)
                    cond = apply_condition_augment(cond, batch)
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
        with span("train.g_forward"):
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
        with span("train.d_grads"):
            if cfg.shfld_cond_as_neg_smpl:
                # The same fakes under deranged conditions are extra negatives.
                perm = L.derangement_indices(b, draws.get("shuffle_shift"), rng).to(dev)
                d_fake, d_fake_cond = torch.cat([fake, fake]), torch.cat([cond, cond[perm]])
            else:
                d_fake, d_fake_cond = fake, cond
            real_d = d_input(real, "noise_real")
            d_fake = d_input(d_fake, "noise_fake")
            d_loss, r1, d_grads = d_loss_and_grads(disc, real_d, cond, d_fake, cfg, do_r1, d_fake_cond)
        with span("train.d_adam"):
            if group is not None:
                mean_all_reduce(d_grads, group)
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

        def rest_fn(it):
            """The regularizer terms of G iteration ``it`` and the path
            length's new running mean."""
            rest, pl_mean = torch.zeros((), device=dev), state.pl_mean
            if reg == "path_len_reg":
                # z and the projection noise are independent draws; the G
                # forward from z has no identity indices.
                z = draw("pl_z", (b, 512), it)
                ppl, pl_mean = L.path_length_penalty(
                    lambda zz: gen(cond, z=zz, step=step_idx), z, state.pl_mean,
                    noise=draw("pl_noise", real.shape, it), group=group,
                )
                rest = rest + 2.0 * ppl
            elif reg == "direct_grad_reg":
                rest = rest + 8e-8 * L.direct_grad_penalty(
                    lambda c: gen(c, input_indices=indices, step=step_idx), cond
                )
            if cfg.embedding_reg_weight > 0:
                rest = rest + cfg.embedding_reg_weight * L.l2_param_norm(gen.mapping.parameters())
            return rest, pl_mean

        g_adv = rest = interp = torch.zeros((), device=dev)
        if g_interval == 1 or (state.step + 1) % g_interval == 0:
            for it in range(g_iters):
                with span("train.g_grads", it=it):
                    live, fake_live = (fake_live if fake_live is not None else g_forward()), None
                    g_adv, rest, interp, g_grads, pl_mean = g_loss_and_grads(
                        gen, disc, live, cond, interp_fn, cfg.adaptive_interp_loss,
                        rest_fn=lambda: rest_fn(it), d_input=lambda x: d_input(x, "noise_g", it),
                        second_order=reg != "none",
                    )
                    del live
                with span("train.g_adam", it=it):
                    state.pl_mean = pl_mean.detach()
                    if group is not None:
                        mean_all_reduce(g_grads, group)
                    _adam_step(state.g_opt, gen.parameters(), g_grads)
                with span("train.ema", it=it):
                    ema_update(state.g_ema.parameters(), gen.parameters(), cfg.ema_decay)

        state.step += 1
        state.used_samples += b * world
        metrics = {
            "d_loss": d_loss,
            "g_loss": g_adv,
            "r1": r1,
            "g_total": g_adv + rest + interp,
            "render_overflow": overflow.float().mean(),
        }
        if interp_on:
            metrics["interp"] = interp
        if group is not None:
            values = [v.detach().clone() for v in metrics.values()]
            mean_all_reduce(values, group)
            metrics = dict(zip(metrics, values))
        return state, metrics

    return train_step
