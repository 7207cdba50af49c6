"""Train state: both networks, the G EMA, both Adam optimizers and the loop
counters (port of :mod:`gif_tpu.train.state`).

``TrainState`` holds ``nn.Module``s and ``torch.optim.Adam``s, and the
train step updates them in place (the JAX state is an immutable pytree
that each step replaces).  Adam follows StyleGAN2's reg-ratio
hyperparameters (``TrainConfig.g_lr`` / ``g_betas`` / ``d_lr`` /
``d_betas``) with eps 1e-8, optax ``adam``'s update rule: ``-lr * m_hat /
(sqrt(v_hat) + eps)``.

A run starts from a fresh state, a converted reference checkpoint
(:func:`warm_start_from_converted`) or its own checkpoint; under data
parallelism rank 0's state is then broadcast to every rank
(:func:`replicate_train_state`).
"""

from __future__ import annotations

import copy
import dataclasses
import pickle

import torch

from gif_tpu_torch.device import resolve_device, set_tf32_policy
from gif_tpu_torch.models.discriminator import Discriminator
from gif_tpu_torch.models.generator import StyledGenerator
from gif_tpu_torch.parallel.mesh import process_count, replicate
from gif_tpu_torch.tools.convert_params import convert_discriminator_params, convert_generator_params
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
        share_embedding(self.g_ema, self.generator)
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
    seeded from ``seed`` and ``seed + 1``: GIF's conditional G, or
    StyleGAN3-T's for a :class:`~gif_tpu_torch.train.config.StyleGAN3Config`."""
    if cfg.architecture == "stylegan3-t":
        from gif_tpu_torch.models.stylegan3 import StyleGAN3Generator

        gen = StyleGAN3Generator.from_config(cfg, seed=seed)
    else:
        gen = StyledGenerator.from_config(cfg, seed=seed)
    disc = Discriminator.from_config(cfg, seed=seed + 1)
    return gen, disc


def share_embedding(g_ema: torch.nn.Module, gen: torch.nn.Module) -> None:
    """Point the EMA at the generator's frozen identity embedding (GIF's G;
    StyleGAN3's has none)."""
    if hasattr(gen, "embedding"):
        g_ema.embedding = gen.embedding


def create_train_state(cfg: TrainConfig, seed: int = 0, device=None) -> TrainState:
    """A fresh state on ``device`` (CUDA unless the caller passes another):
    seeded networks, the EMA a copy of G, fresh optimizers, counters 0."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_tf32_policy()
    gen, disc = build_models(cfg, seed)
    gen, disc = gen.to(dev), disc.to(dev)
    g_ema = copy.deepcopy(gen).requires_grad_(False)
    share_embedding(g_ema, gen)  # a frozen buffer: one copy serves both
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


def _check_shapes(got: dict, module: torch.nn.Module, what: str) -> None:
    """Every tensor of the converted ``got`` must exist in ``module``'s
    state_dict with the same shape and vice versa; one error names every
    offending leaf."""
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    have = {k: tuple(v.shape) for k, v in got.items()}
    problems = [f"  {k}: checkpoint has {v}, model wants {want[k]}" for k, v in have.items()
                if k in want and v != want[k]]
    problems += [f"  {k}: missing from checkpoint" for k in want if k not in have]
    problems += [f"  {k}: unexpected in checkpoint" for k in have if k not in want]
    if problems:
        raise ValueError(
            f"{what}: converted checkpoint does not fit this config "
            f"({len(problems)} problem(s)):\n" + "\n".join(problems)
        )


@torch.no_grad()
def warm_start_from_converted(state: TrainState, path: str) -> TrainState:
    """Seed ``state`` (fresh, from :func:`create_train_state`) in place
    with a converted reference checkpoint: the pickle of flax-layout numpy
    trees ``g_params`` / ``g_ema_params`` / ``d_params`` / ``buffers``
    that :mod:`gif_tpu_torch.tools.convert_checkpoint` (or the JAX
    package's) writes — the reference's fine-tune path (run_id 29 resumes
    a released ``.model``).  The optimizers stay fresh and the counters
    zero.  Raises ``ValueError`` naming every leaf whose shape does not
    fit.  Only unpickle files this project wrote."""
    with open(path, "rb") as f:
        trees = pickle.load(f)
    for key in ("g_params", "g_ema_params", "d_params", "buffers"):
        if key not in trees:
            raise ValueError(f"{path}: missing tree {key!r}")
    parts = (
        (state.generator, convert_generator_params(trees["g_params"], trees["buffers"]), "generator"),
        (state.g_ema, convert_generator_params(trees["g_ema_params"], trees["buffers"]), "EMA generator"),
        (state.discriminator, convert_discriminator_params(trees["d_params"]), "discriminator"),
    )
    for module, sd, what in parts:
        _check_shapes(sd, module, f"{path} ({what})")
    for module, sd, _ in parts:
        module.load_state_dict(sd)
    state.g_ema.embedding = state.generator.embedding
    return state


@torch.no_grad()
def replicate_train_state(state: TrainState, group=None) -> TrainState:
    """Broadcast rank 0's state — networks, EMA, both Adam states,
    ``pl_mean`` and the counters — to every rank of ``group``, in place,
    so the replicas start equal whether fresh, warm-started or restored.
    A no-op with one rank."""
    if process_count(group) == 1:
        return state
    counters = torch.tensor([state.step, state.used_samples], dtype=torch.int64, device=state.pl_mean.device)
    replicate(state.generator, state.g_ema, state.discriminator, state.g_opt, state.d_opt, state.pl_mean,
              counters, group=group)
    state.step, state.used_samples = (int(v) for v in counters.tolist())
    return state
