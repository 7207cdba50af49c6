"""Train state: both networks, the G EMA, both Adam optimizers and the loop
counters (port of :mod:`gif_tpu.train.state`).

``TrainState`` holds ``nn.Module``s and ``torch.optim.Adam``s, and the
train step updates them in place (the JAX state is an immutable pytree
that each step replaces).  Adam follows StyleGAN2's reg-ratio
hyperparameters (``TrainConfig.g_lr`` / ``g_betas`` / ``d_lr`` /
``d_betas``) with eps 1e-8, optax ``adam``'s update rule: ``-lr * m_hat /
(sqrt(v_hat) + eps)``.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from gif_tpu_torch.device import resolve_device, set_tf32_policy
from gif_tpu_torch.models.discriminator import Discriminator
from gif_tpu_torch.models.generator import StyledGenerator
from gif_tpu_torch.train.config import TrainConfig

ADAM_EPS = 1e-8


@dataclasses.dataclass
class TrainState:
    step: int
    generator: StyledGenerator
    discriminator: Discriminator
    g_ema: StyledGenerator  # shares the generator's frozen embedding buffer
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    pl_mean: torch.Tensor  # path-length running mean (0-d f32)
    used_samples: int

    def state_dict(self) -> dict:
        """Everything a checkpoint holds: G, the EMA and D state_dicts, both
        Adam states, ``step``, ``used_samples`` and ``pl_mean``.  The
        tensors are the live ones (no copies); the EMA's ``embedding`` is
        the generator's own tensor, so ``torch.save`` stores it once."""
        return {
            "generator": self.generator.state_dict(),
            "g_ema": self.g_ema.state_dict(),
            "discriminator": self.discriminator.state_dict(),
            "g_opt": self.g_opt.state_dict(),
            "d_opt": self.d_opt.state_dict(),
            "step": self.step,
            "used_samples": self.used_samples,
            "pl_mean": self.pl_mean,
        }

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Load :meth:`state_dict`'s output in place (strictly, key for
        key); the EMA keeps sharing the generator's embedding buffer."""
        self.generator.load_state_dict(sd["generator"])
        self.g_ema.load_state_dict(sd["g_ema"])
        self.g_ema.embedding = self.generator.embedding
        self.discriminator.load_state_dict(sd["discriminator"])
        self.g_opt.load_state_dict(sd["g_opt"])
        self.d_opt.load_state_dict(sd["d_opt"])
        self.step = int(sd["step"])
        self.used_samples = int(sd["used_samples"])
        self.pl_mean = sd["pl_mean"].to(self.pl_mean.device, torch.float32).clone()


def make_optimizers(cfg: TrainConfig, g_params, d_params):
    """Adam with StyleGAN2 reg-ratio-scaled hyperparameters for G and D."""
    g_opt = torch.optim.Adam(g_params, lr=cfg.g_lr, betas=cfg.g_betas, eps=ADAM_EPS)
    d_opt = torch.optim.Adam(d_params, lr=cfg.d_lr, betas=cfg.d_betas, eps=ADAM_EPS)
    return g_opt, d_opt


def build_models(cfg: TrainConfig, seed: int = 0):
    """(generator, discriminator) as ``cfg`` describes them, on the CPU,
    seeded from ``seed`` and ``seed + 1``."""
    gen = StyledGenerator.from_config(cfg, seed=seed)
    disc = Discriminator.from_config(cfg, seed=seed + 1)
    return gen, disc


def create_train_state(cfg: TrainConfig, seed: int = 0, device=None) -> TrainState:
    """A fresh state on ``device`` (CUDA unless the caller passes another):
    seeded networks, the EMA a copy of G, fresh optimizers, counters 0."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_tf32_policy()
    gen, disc = build_models(cfg, seed)
    gen, disc = gen.to(dev), disc.to(dev)
    g_ema = copy.deepcopy(gen).requires_grad_(False)
    g_ema.embedding = gen.embedding  # a frozen buffer: one copy serves both
    g_opt, d_opt = make_optimizers(cfg, gen.parameters(), disc.parameters())
    return TrainState(
        step=0, generator=gen, discriminator=disc, g_ema=g_ema, g_opt=g_opt, d_opt=d_opt,
        pl_mean=torch.zeros((), device=dev), used_samples=0,
    )


def _load_adam(opt: torch.optim.Adam, module: torch.nn.Module, moments: dict) -> None:
    step = torch.tensor(float(moments["step"]), dtype=torch.float32)
    for name, p in module.named_parameters():
        opt.state[p] = {
            "step": step.clone(),
            "exp_avg": moments["exp_avg"][name].to(p),
            "exp_avg_sq": moments["exp_avg_sq"][name].to(p),
        }


@torch.no_grad()
def load_train_state(state: TrainState, converted: dict) -> TrainState:
    """Load a state written by
    :func:`gif_tpu_torch.tools.convert_params.convert_train_state` into
    ``state``, in place: networks and EMA (strictly, key for key), both
    Adam states, the counters and ``pl_mean``."""
    state.generator.load_state_dict(converted["generator"])
    state.discriminator.load_state_dict(converted["discriminator"])
    state.g_ema.load_state_dict(converted["g_ema"])
    state.g_ema.embedding = state.generator.embedding
    _load_adam(state.g_opt, state.generator, converted["g_opt"])
    _load_adam(state.d_opt, state.discriminator, converted["d_opt"])
    state.step = int(converted["step"])
    state.pl_mean = torch.tensor(float(converted["pl_mean"]), device=state.pl_mean.device)
    state.used_samples = int(converted["used_samples"])
    return state
