"""Training configuration with named presets.

The port's own copy of :mod:`gif_tpu.train.config` — the same dataclass,
presets (run ids 0, 3, 7, 8, 29) and tiny overrides, as data, so a config
built here equals the reference's field for field.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Optional


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # Which G the step trains: "gif", GIF's conditional StyleGAN2 (these
    # fields, the JAX package's), or another architecture's config class
    # (:class:`StyleGAN3Config`).
    architecture: ClassVar[str] = "gif"
    run_id: int = 0
    # --- model ---
    rendered_flame_as_condition: bool = True
    normal_maps_as_cond: bool = True
    embedding_vocab_size: int = 69158  # len(dataset) in the reference (:257-258)
    core_tensor_res: int = 4
    nmlp_for_z_to_w: int = 8
    apply_sqrt_in_eq_linear: bool = False
    channel_multiplier: int = 2
    # Cap on conv channels (512 = reference parity; small values for fast
    # CPU tests / the virtual-mesh dryrun).  NB the reference's
    # ``use_posed_constant_input`` flag is NOT carried here: its
    # ConstantInput.forward ignores the pose argument entirely
    # (stg2_generator.py:21-31 — ``forward(input)`` returns the learned
    # constant), so the flag is behaviorally inert in the reference and all
    # shipped configs set it False (configurations.py:42,83,124,164,204).
    max_channels: int = 512
    # Compute dtype of the G/D conv stacks ("bfloat16" | "float32").
    # Params, mapping net, demodulation, RGB/skip accumulation, minibatch
    # stddev, and all losses stay f32 (ADA-style mixed precision).
    compute_dtype: str = "bfloat16"

    # --- image / batch ---
    init_size: int = 256
    max_size: int = 256
    batch_size: int = 16  # global; split across the data mesh axis
    flame_dims: int = 159

    # --- optimization (train.py:365-382) ---
    lr: float = 0.002
    g_reg_interval: int = 4
    d_reg_interval: int = 16
    r1_interval: int = 16  # grad penalty every 16th iter (train.py:145)
    r1_weight: float = 5.0  # losses.py:96
    n_critic: float = 1.0
    # Instance noise on every image D sees (real, fake, and G's scored
    # fakes; fresh iid draw per evaluation).  0 = off (the reference
    # recipe).  Stabilizer for targets where the reals lie on a
    # low-dimensional manifold of the condition — see
    # docs/experiments/fid_dynamics_r05.md.
    d_input_noise_std: float = 0.0

    # --- regularizers / D negatives ---
    shfld_cond_as_neg_smpl: bool = False  # shuffled-condition negatives
    gen_reg_type: str = "none"  # none | path_len_reg | direct_grad_reg
    embedding_reg_weight: float = 0.0
    apply_texture_space_interpolation_loss: bool = True
    adaptive_interp_loss: bool = False

    # --- data / rendering ---
    render_in_step: bool = True  # render cond maps on-device inside the step
    render_image_size: int = 256

    # --- bookkeeping ---
    phase: int = 120_000
    checkpoint_every: int = 1000
    fid_every: int = 500
    ema_decay: float = 0.5 ** (32 / (10 * 1000))

    @property
    def cond_channels(self) -> int:
        return 3 * int(self.rendered_flame_as_condition) + 3 * int(
            self.normal_maps_as_cond
        )

    @property
    def disc_in_channels(self) -> int:
        return 3 + self.cond_channels

    @property
    def max_step(self) -> int:
        import math

        return int(math.log2(self.max_size)) - 2

    @property
    def d_low_precision_res(self) -> int:
        """The lowest input resolution of a D block in the compute dtype
        (0: every block)."""
        return 0

    @property
    def d_dense_sqrt2(self) -> bool:
        """Whether D's ``final_dense`` leaky ReLU takes the gain sqrt(2)."""
        return False

    @property
    def g_lr(self) -> float:
        ratio = self.g_reg_interval / (self.g_reg_interval + 1)
        return self.lr * ratio

    @property
    def g_betas(self) -> tuple:
        ratio = self.g_reg_interval / (self.g_reg_interval + 1)
        return (0.0, 0.99**ratio)

    @property
    def d_lr(self) -> float:
        ratio = self.d_reg_interval / (self.d_reg_interval + 1)
        return self.lr * ratio

    @property
    def d_betas(self) -> tuple:
        ratio = self.d_reg_interval / (self.d_reg_interval + 1)
        return (0.0, 0.99**ratio)


_PRESETS = {
    # run_id 0: full GIF from scratch (configurations.py:34-73)
    0: dict(
        rendered_flame_as_condition=True,
        normal_maps_as_cond=True,
        apply_texture_space_interpolation_loss=True,
    ),
    # run_id 3: normal maps only (configurations.py:75-114)
    3: dict(
        rendered_flame_as_condition=False,
        normal_maps_as_cond=True,
        apply_texture_space_interpolation_loss=True,
    ),
    # run_id 7: textured render only, no interp loss (configurations.py:116-154)
    7: dict(
        rendered_flame_as_condition=True,
        normal_maps_as_cond=False,
        apply_texture_space_interpolation_loss=False,
    ),
    # run_id 8: both conditions, no interp loss (configurations.py:156-194)
    8: dict(
        rendered_flame_as_condition=True,
        normal_maps_as_cond=True,
        apply_texture_space_interpolation_loss=False,
    ),
    # run_id 29: full model fine-tune (configurations.py:196-235); its
    # pretrained checkpoint also carries the EqualLinear sqrt2 quirk
    # (plots/generate_random_samples.py:82-91).
    29: dict(
        rendered_flame_as_condition=True,
        normal_maps_as_cond=True,
        apply_texture_space_interpolation_loss=True,
        apply_sqrt_in_eq_linear=True,
    ),
}


@dataclasses.dataclass(frozen=True)
class StyleGAN3Config(TrainConfig):
    """StyleGAN3-T (models/stylegan3.py) with StyleGAN2's unconditional D,
    trained by train/uncond_step.py.  Of the GIF fields it reads the
    widths (``max_size``, ``max_channels``, ``channel_multiplier`` for D,
    ``nmlp_for_z_to_w``), ``compute_dtype``, ``batch_size``, ``lr`` (D's),
    ``d_reg_interval``, ``r1_interval``, ``r1_weight`` (gamma / 2) and
    ``ema_decay``; the condition flags are off."""

    architecture: ClassVar[str] = "stylegan3-t"
    # G's channel table: channel_base / 2 / cutoff, capped at max_channels.
    channel_base: int = 32768
    # The N highest resolutions of G and D in the compute dtype, the rest
    # in float32 (NVlabs' fp16 rule).
    num_fp16_res: int = 4
    magnitude_ema_beta: float = 0.5 ** (32 / 20_000)
    # G's learning rate.  G has no lazy regularizer, so its Adam takes it
    # and betas (0, 0.99) as they are.
    glr: float = 0.0025

    @property
    def d_low_precision_res(self) -> int:
        return max(2 ** (int(math.log2(self.max_size)) + 1 - self.num_fp16_res), 8)

    @property
    def d_dense_sqrt2(self) -> bool:
        return True

    @property
    def g_lr(self) -> float:
        return self.glr

    @property
    def g_betas(self) -> tuple:
        return (0.0, 0.99)


# Presets of other architectures: name -> (config class, fields).
MODEL_PRESETS = {
    # StyleGAN3-T at FFHQ 1024 px (NVlabs/stylegan3 train.py --cfg=stylegan3-t
    # --gpus=8 --batch=32 --gamma=32.8 --mirror=1): 2 mapping layers, D's
    # learning rate 0.002, R1 gamma 32.8 every 16th step, channel_base
    # 32768 (D's table is channel_multiplier 2's).  The batch is global,
    # over 8 cards.
    "stylegan3-t-ffhq1024": (StyleGAN3Config, dict(
        rendered_flame_as_condition=False,
        normal_maps_as_cond=False,
        apply_texture_space_interpolation_loss=False,
        render_in_step=False,
        nmlp_for_z_to_w=2,
        channel_multiplier=2,
        max_channels=512,
        init_size=1024,
        max_size=1024,
        render_image_size=1024,
        batch_size=32,
        lr=0.002,
        d_reg_interval=16,
        r1_interval=16,
        r1_weight=16.4,
    )),
}


# Overrides for interactive CPU smoke runs (scripts' --tiny flag, e2e
# script tests): XLA:CPU executes per-sample modulated-conv work serially,
# so the 512-channel 256px model takes minutes per batch on host.
TINY_OVERRIDES = dict(
    max_size=32,
    init_size=32,
    render_image_size=32,
    max_channels=16,
    nmlp_for_z_to_w=2,
    compute_dtype="float32",
)


# The same for the StyleGAN3-T preset: 32 px, at most 32 channels.
SG3_TINY_OVERRIDES = dict(
    max_size=32,
    init_size=32,
    render_image_size=32,
    channel_base=1024,
    max_channels=32,
    compute_dtype="float32",
)


def get_config(run_id: int | str = 0, **overrides) -> TrainConfig:
    """The GIF preset ``run_id``, or the preset of :data:`MODEL_PRESETS`
    of that name, with ``overrides``."""
    if run_id in MODEL_PRESETS:
        cls, fields = MODEL_PRESETS[run_id]
        return cls(run_id=run_id, **{**fields, **overrides})
    if run_id not in _PRESETS:
        raise ValueError(
            f"Unknown run_id {run_id}; shipped presets: {sorted(_PRESETS)} and {sorted(MODEL_PRESETS)}"
        )
    kwargs = dict(_PRESETS[run_id])
    kwargs.update(overrides)
    return TrainConfig(run_id=run_id, **kwargs)
