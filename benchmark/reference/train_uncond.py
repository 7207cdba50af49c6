"""StyleGAN3-T's unconditional train step in plain PyTorch: the reference
of the ``stylegan3-t`` cells (NVlabs/stylegan3 ``training/training_loop.py``
and ``training/loss.py`` at ``--cfg=stylegan3-t``).

Phases in the published order, each with its own Adam step: ``Gboth`` (G's
softplus loss through D from ``z_g``), ``Dmain`` (D's softplus loss on
reals and on the updated G's fakes from ``z_d``, made without a gradient
and updating G's magnitude EMAs), and on R1 steps (``step_index %
r1_interval == 0``) ``Dreg``: ``r1_interval * r1_weight * mean(|dD/dx|^2)``
on D's own forward of the reals (``r1_weight`` = gamma / 2).  Then the EMA
of G's parameters, and G's magnitude EMAs copied into the EMA's.  Adam is
:class:`.train.Adam`, G's at ``glr`` with betas (0, 0.99), D's with
StyleGAN2's lazy-regularization ratio ``d_reg_interval / (d_reg_interval
+ 1)`` on ``lr`` and beta2.  Every random draw is an argument.  TF32
off; the precision is :mod:`.stylegan3`'s.

Departures from NVlabs: images reach D unblurred and the EMA does not ramp
up (the state of training past its first 200 kimg, when both have run
out); the D phase's gradient is not nan-cleaned (no NaN arises in three
steps).
"""

from __future__ import annotations

import torch

from . import losses as L
from .stylegan3 import Discriminator, Generator
from .train import Adam, _second_order_safe


def build_models(cfg: dict, precision: str = "float32"):
    """(G, D) of ``cfg`` (a ``train_config`` dict) in ``precision``
    (:mod:`.stylegan3`; "config" of a float32 configuration is float32)
    on the meta device; their weights and buffers come from a state dict."""
    if precision == "config" and cfg["compute_dtype"] == "float32":
        precision = "float32"
    with torch.device("meta"):
        gen = Generator(cfg["max_size"], cfg["channel_base"], cfg["max_channels"], cfg["nmlp_for_z_to_w"],
                        cfg["magnitude_ema_beta"], cfg["num_fp16_res"], precision)
        disc = Discriminator(cfg["max_size"], cfg["channel_multiplier"], cfg["max_channels"], 4,
                             cfg["num_fp16_res"], precision)
    return gen, disc


def nhwc(images):
    return images.permute(0, 2, 3, 1)


class ReferenceUncondTrainer:
    """G, D, the EMA of G and both optimizers, stepped by :meth:`step`."""

    def __init__(self, cfg: dict, g_weights: dict, d_weights: dict, device, precision: str = "float32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.device = cfg, torch.device(device)
        self.gen, self.disc = build_models(cfg, precision)
        self.gen.load_state_dict(g_weights, assign=True)
        self.disc.load_state_dict(d_weights, assign=True)
        self.g_params = list(self.gen.parameters())
        self.d_params = list(self.disc.parameters())
        self.ema = [p.detach().clone() for p in self.g_params]
        self.ema_magnitudes = [m.clone() for m in self.gen.magnitude_emas()]
        ratio = cfg["d_reg_interval"] / (cfg["d_reg_interval"] + 1)
        self.g_opt = Adam(self.g_params, cfg["glr"], (0.0, 0.99))
        self.d_opt = Adam(self.d_params, cfg["lr"] * ratio, (0.0, 0.99**ratio))

    def step(self, batch: dict, draws: dict, step_index: int):
        """One step at counter ``step_index``.  Returns (metrics as floats,
        D's gradient of its main phase, G's gradient, D's gradient of its R1
        phase or None off R1 steps), each gradient a list in parameter
        order."""
        cfg = self.cfg
        real = batch["real_image"].float()
        g_loss = L.g_ns_loss(self.disc(nhwc(self.gen(draws["z_g"].float()))))
        g_grads = torch.autograd.grad(g_loss, self.g_params)
        self.g_opt.step(g_grads)

        with torch.no_grad():
            fake = self.gen(draws["z_d"].float(), update_emas=True)
        d_loss = L.d_ns_loss(self.disc(real), self.disc(nhwc(fake)))
        d_grads = torch.autograd.grad(d_loss, self.d_params)
        self.d_opt.step(d_grads)

        r1, r1_grads = torch.zeros((), device=self.device), None
        if step_index % cfg["r1_interval"] == 0:
            r1 = cfg["r1_interval"] * L.r1_penalty(lambda x, c: self.disc(x), real, None, cfg["r1_weight"])
            with _second_order_safe(self.device):
                r1_grads = torch.autograd.grad(r1, self.d_params, materialize_grads=True)
            self.d_opt.step(r1_grads)

        with torch.no_grad():
            decay = cfg["ema_decay"]
            for e, p in zip(self.ema, self.g_params):
                e.mul_(decay).add_(p * (1.0 - decay))
            for e, m in zip(self.ema_magnitudes, self.gen.magnitude_emas()):
                e.copy_(m)
        metrics = {"d_loss": d_loss, "g_loss": g_loss, "r1": r1}
        return ({k: float(v.detach()) for k, v in metrics.items()}, [g.detach() for g in d_grads],
                [g.detach() for g in g_grads], None if r1_grads is None else [g.detach() for g in r1_grads])
