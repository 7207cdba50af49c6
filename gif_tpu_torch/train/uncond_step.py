"""StyleGAN3-T's unconditional train step (NVlabs/stylegan3
``training/training_loop.py`` and ``training/loss.py`` at ``--cfg=stylegan3-t``:
no style mixing, no path length, so G has no regularization phase).

One step, in the published phase order:

1. G (``Gboth``): G's forward from ``z_g``, its non-saturating loss through
   D, G's gradient (nothing accumulates into D) and one Adam step;
2. D (``Dmain``): the updated G's forward from a fresh ``z_d`` without a
   gradient, which updates every synthesis layer's magnitude EMA, D's
   softplus loss on those fakes and on the reals, D's gradient and one Adam
   step;
3. on R1 steps (``step % r1_interval == 0``, the first step among them:
   NVlabs' ``batch_idx % 16 == 0``), ``Dreg``: R1 on D's own forward of the
   reals, ``r1_interval * r1_weight * mean(|grad|^2)`` (``r1_weight`` is
   gamma / 2, the interval the lazy regularizer's gain), its gradient and
   a second Adam step of D;
4. the EMA of G's parameters, and G's magnitude EMAs copied into the EMA
   generator (NVlabs copies G's buffers).

Images are NCHW out of G and NHWC into D (``Discriminator`` takes the
dataset's layout).  Every random draw is ``z_g`` / ``z_d`` (B, 512),
standard normal, from ``generator`` unless ``draws`` gives it.  The
phases are spans, under the GIF step's names: ``train.g_forward``
(attribute ``phase`` "g" or "d": the D step's G forward is one too),
``train.g_grads``, ``train.g_adam``, ``train.d_grads`` and ``train.d_adam``
(attribute ``r1`` on the R1 phase), ``train.ema``; ``train.step`` counts
the filtered-leaky-ReLU kernel's forward and backward launches and the
magnitude-EMA updates across the step.  Data parallel (``group``): each
gradient is mean-all-reduced before its Adam step, and the metrics
averaged; the magnitude EMAs stay each rank's own, as NVlabs keeps them.
"""

from __future__ import annotations

import torch

from gif_tpu_torch.device import resolve_device, second_order_safe, set_tf32_policy
from gif_tpu_torch.models.stylegan3 import magnitude_ema_updates
from gif_tpu_torch.ops.filtered_lrelu import filtered_lrelu, filtered_lrelu_backward
from gif_tpu_torch.ops.layout import layout_copies
from gif_tpu_torch.parallel.collectives import mean_all_reduce
from gif_tpu_torch.parallel.mesh import process_count
from gif_tpu_torch.train import losses as L
from gif_tpu_torch.utils.ema import ema_update
from gif_tpu_torch.utils.profiling import span

Z_DIM = 512

_STEP_COUNTS = {
    "layout_copies": lambda: layout_copies.copies,
    "filtered_lrelu": lambda: filtered_lrelu.launches,
    "filtered_lrelu_backward": lambda: filtered_lrelu_backward.launches,
    "magnitude_ema_updates": lambda: magnitude_ema_updates.count,
}


def _adam_step(opt: torch.optim.Optimizer, params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def nhwc(images: torch.Tensor) -> torch.Tensor:
    """G's NCHW images as the NHWC batch D takes (a view)."""
    return images.permute(0, 2, 3, 1)


def make_uncond_train_step(cfg, device=None, generator: torch.Generator | None = None, group=None):
    """``train_step(state, batch, draws=None) -> (state, metrics)`` for a
    :class:`~gif_tpu_torch.train.config.StyleGAN3Config`: ``batch`` holds
    ``real_image`` (B, S, S, 3) in [-1, 1]; ``draws`` may give ``z_g`` and
    ``z_d``.  Updates ``state`` in place; metrics ``d_loss``, ``g_loss``,
    ``r1`` (0 off R1 steps, else the penalty with its weights), 0-d
    tensors."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_tf32_policy()
    world = process_count(group) if group is not None else 1
    rng = generator if generator is not None else torch.Generator().manual_seed(0)

    def draw(draws, key, b):
        z = draws.get(key)
        if z is None:
            z = torch.randn((b, Z_DIM), generator=rng)
        return torch.as_tensor(z, dtype=torch.float32, device=dev)

    def reduced(grads):
        if group is not None:
            mean_all_reduce(grads, group)
        return grads

    def train_step(state, batch, draws=None):
        do_r1 = state.step % cfg.r1_interval == 0
        with span("train.step", allocator=True, counts=_STEP_COUNTS, step=state.step, r1=do_r1):
            return step_phases(state, batch, draws or {}, do_r1)

    def step_phases(state, batch, draws, do_r1):
        real = torch.as_tensor(batch["real_image"], dtype=torch.float32, device=dev)
        b = real.shape[0]
        gen, disc = state.generator, state.discriminator
        z_g, z_d = draw(draws, "z_g", b), draw(draws, "z_d", b)

        with span("train.g_forward", phase="g"):
            fake = gen(z_g)
        with span("train.g_grads", it=0):
            g_loss = L.g_ns_loss(disc(nhwc(fake)))
            g_grads = torch.autograd.grad(g_loss, list(gen.parameters()), materialize_grads=True)
            del fake
        with span("train.g_adam", it=0):
            _adam_step(state.g_opt, gen.parameters(), reduced(g_grads))

        with span("train.g_forward", phase="d"):
            with torch.no_grad():
                fake = gen(z_d, update_emas=True)
        with span("train.d_grads"):
            d_loss = L.d_ns_loss(disc(real), disc(nhwc(fake)))
            d_grads = torch.autograd.grad(d_loss, list(disc.parameters()), materialize_grads=True)
            del fake
        with span("train.d_adam"):
            _adam_step(state.d_opt, disc.parameters(), reduced(d_grads))

        r1 = torch.zeros((), device=dev)
        if do_r1:
            with span("train.d_grads", r1=True):
                r1 = cfg.r1_interval * L.r1_penalty(disc, real, None, cfg.r1_weight)
                with second_order_safe(dev):
                    r1_grads = torch.autograd.grad(r1, list(disc.parameters()), materialize_grads=True)
            with span("train.d_adam", r1=True):
                _adam_step(state.d_opt, disc.parameters(), reduced(r1_grads))

        with span("train.ema", it=0):
            ema_update(state.g_ema.parameters(), gen.parameters(), cfg.ema_decay)
            with torch.no_grad():
                torch._foreach_copy_(state.g_ema.magnitude_emas(), gen.magnitude_emas())

        state.step += 1
        state.used_samples += b * world
        metrics = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(), "r1": r1.detach()}
        if group is not None:
            values = [v.clone() for v in metrics.values()]
            mean_all_reduce(values, group)
            metrics = dict(zip(metrics, values))
        return state, metrics

    return train_step
