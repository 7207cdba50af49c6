"""The GIF train step in plain PyTorch: the reference that the benchmark's
training cells are compared with.

One step as the configuration states it: the condition maps rendered from
the batch's FLAME codes and floored onto the 8-bit grid; under the
texture-space interpolation loss, the interpolants rendered and generated
with the data rows (one render and one G forward over 2B - 1 rows); D's
softplus loss, with R1 on its own forward every ``r1_interval``-th step;
Adam on D; G's loss (the adversarial term through the updated D, plus the
interpolation penalty) and Adam on G; the EMA of G.  Adam is written out
(optax's rule, eps 1e-8, bias-corrected), as is the EMA.  Every random
draw is an argument.
"""

from __future__ import annotations

import contextlib
import math

import torch

from . import losses as L
from .discriminator import Discriminator
from .generator import StyledGenerator
from .renderer import render_tex_and_normal

ADAM_EPS = 1e-8


def _second_order_safe(device):
    """oneDNN's bf16 conv double backward is wrong on the CPU (3x3 pad-1
    convs); R1's gradient there takes PyTorch's native convolution."""
    if device.type == "cpu":
        return torch.backends.mkldnn.flags(enabled=False)
    return contextlib.nullcontext()


UNSUPPORTED = {
    "r1_interval": lambda v: v < 2,
    "n_critic": lambda v: v != 1.0,
    "d_input_noise_std": lambda v: v != 0.0,
    "shfld_cond_as_neg_smpl": bool,
    "gen_reg_type": lambda v: v != "none",
    "embedding_reg_weight": lambda v: v != 0.0,
    "adaptive_interp_loss": bool,
    "render_in_step": lambda v: not v,
}


def build_models(cfg: dict):
    """(generator, discriminator) of ``cfg`` on the meta device: their
    weights come from :meth:`ReferenceTrainer.__init__`."""
    dtype = getattr(torch, cfg["compute_dtype"])
    max_step = int(math.log2(cfg["max_size"])) - 2
    cond_ch = 3 * int(cfg["rendered_flame_as_condition"]) + 3 * int(cfg["normal_maps_as_cond"])
    with torch.device("meta"):
        gen = StyledGenerator(
            embedding_vocab_size=cfg["embedding_vocab_size"], n_mlp=cfg["nmlp_for_z_to_w"],
            core_tensor_res=cfg["core_tensor_res"], channel_multiplier=cfg["channel_multiplier"],
            max_channels=cfg["max_channels"], cond_channels=cond_ch, max_step=max_step,
            apply_sqrt2=cfg["apply_sqrt_in_eq_linear"], dtype=dtype,
        )
        disc = Discriminator(
            size=cfg["max_size"], in_channels=3 + cond_ch, channel_multiplier=cfg["channel_multiplier"],
            max_channels=cfg["max_channels"], dtype=dtype,
        )
    return gen, disc


def render_flame(res, flame, cfg: dict):
    """Raw textured + normal maps of (B, 236) FLAME codes."""
    b = flame.shape[0]
    return render_tex_and_normal(
        res, flame[:, 0:100], flame[:, 100:150], flame[:, 150:156], flame[:, 159:209],
        flame[:, 209:236].reshape(b, 9, 3), flame[:, 156:159], image_size=cfg["render_image_size"],
    )


def quantize_condition(textured, normal, cfg: dict):
    """Raw maps -> [-1, 1] condition maps floored onto the 8-bit grid."""
    rend = torch.floor(torch.clamp(textured, 0.0, 1.0) * 255.0) / 255.0
    norm = torch.floor(torch.clamp(normal, 0.0, 1.0) * 255.0) / 255.0
    parts = ([rend * 2.0 - 1.0] if cfg["rendered_flame_as_condition"] else []) + (
        [norm * 2.0 - 1.0] if cfg["normal_maps_as_cond"] else [])
    return torch.cat(parts, dim=-1)


class Adam:
    """Adam with bias correction: ``p -= lr * m_hat / (sqrt(v_hat) + eps)``."""

    def __init__(self, params, lr, betas):
        self.params, self.lr, self.betas, self.t = list(params), lr, betas, 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1.0 - b1**self.t, 1.0 - b2**self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + ADAM_EPS))


class ReferenceTrainer:
    """G, D, the EMA of G and both optimizers, stepped by :meth:`step`."""

    def __init__(self, cfg: dict, res, g_weights: dict, d_weights: dict, device):
        for key, bad in UNSUPPORTED.items():
            if bad(cfg[key]):
                raise ValueError(f"the reference step does not run {key}={cfg[key]!r}")
        self.cfg, self.res, self.device = cfg, res, torch.device(device)
        self.gen, self.disc = build_models(cfg)
        self.gen.load_state_dict(g_weights, assign=True)
        self.disc.load_state_dict(d_weights, assign=True)
        self.g_params = list(self.gen.parameters())
        self.d_params = list(self.disc.parameters())
        self.ema = [p.detach().clone() for p in self.g_params]
        lr = cfg["lr"]

        def reg(interval):
            ratio = interval / (interval + 1)
            return lr * ratio, (0.0, 0.99**ratio)

        self.g_opt = Adam(self.g_params, *reg(cfg["g_reg_interval"]))
        self.d_opt = Adam(self.d_params, *reg(cfg["d_reg_interval"]))
        self.max_step = int(math.log2(cfg["max_size"])) - 2
        mask = getattr(res, "face_region_mask", None)
        self.face_mask = None if mask is None else torch.as_tensor(mask, dtype=torch.float32, device=self.device)

    def _render(self, flame):
        return render_flame(self.res, flame, self.cfg)

    def _quantize(self, textured, normal):
        return quantize_condition(textured, normal, self.cfg)

    def step(self, batch: dict, draws: dict, step_index: int):
        """One train step at counter ``step_index`` (R1 where ``(step_index +
        1) % r1_interval == 0``).  Returns (metrics as floats, D's gradient,
        G's gradient): each gradient a list in parameter order."""
        cfg = self.cfg
        real = batch["real_image"].float()
        flame = batch["flame"].float()
        indices = batch["indices"].long()
        b = real.shape[0]
        interp_on = cfg["apply_texture_space_interpolation_loss"]
        with torch.no_grad():
            rows = [flame]
            if interp_on:
                flm_interp = L.interpolate_flame_batch(flame, draws["interp_t"])
                rows.append(L.interp_render_flame(flm_interp))
            maps = self._render(torch.cat(rows))
            cond = self._quantize(maps.textured[:b], maps.normal[:b])
            overflow = maps.overflow[:b]
            if interp_on:
                interp_cond = L.interp_condition_channels(
                    maps.textured[b:], maps.normal[b:],
                    rendered_flame_as_condition=cfg["rendered_flame_as_condition"],
                    normal_maps_as_cond=cfg["normal_maps_as_cond"])
        if interp_on:
            interp_ix = torch.full((b - 1,), int(draws["interp_identity"]), dtype=torch.long, device=self.device)
            fake_live = self.gen(torch.cat([cond, interp_cond]), input_indices=torch.cat([indices, interp_ix]),
                                 step=self.max_step)
        else:
            fake_live = self.gen(cond, input_indices=indices, step=self.max_step)
        fake = fake_live[:b].detach()

        d_loss = L.d_ns_loss(self.disc(real, cond), self.disc(fake, cond))
        if (step_index + 1) % cfg["r1_interval"] == 0:
            r1 = L.r1_penalty(self.disc, real, cond, cfg["r1_weight"])
        else:
            r1 = torch.zeros((), device=self.device)
        with _second_order_safe(self.device):
            d_grads = torch.autograd.grad(d_loss + r1, self.d_params)
        self.d_opt.step(d_grads)

        g_adv = L.g_ns_loss(self.disc(fake_live[:b], cond))
        interp = torch.zeros((), device=self.device)
        if interp_on:
            interp = L.interp_penalty_from_images(self.res, fake_live[b:], flm_interp, draws["interp_pairs"],
                                                  self.face_mask)
        g_grads = torch.autograd.grad(g_adv + interp, self.g_params)
        self.g_opt.step(g_grads)
        with torch.no_grad():
            decay = cfg["ema_decay"]
            for e, p in zip(self.ema, self.g_params):
                e.mul_(decay).add_(p * (1.0 - decay))
        metrics = {"d_loss": d_loss, "g_loss": g_adv, "r1": r1, "g_total": g_adv + interp,
                   "render_overflow": overflow.float().mean()}
        if interp_on:
            metrics["interp"] = interp
        return {k: float(v.detach()) for k, v in metrics.items()}, [g.detach() for g in d_grads], [g.detach() for g in g_grads]
