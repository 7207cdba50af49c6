"""The GIF conditional StyleGAN2 generator (a frozen copy of the measured
program's module): a frozen identity embedding, the z -> w mapping net,
a learned constant and one block per scale, the condition maps resized
to every scale and injected at every conv, skip-accumulated ToRGBs.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from .layers import MappingNetwork, StyledConv, ToRGB
from .image import resize_bilinear_nchw


def synthesis_channels(channel_multiplier: int = 2, max_channels: int = 512) -> list[int]:
    """Per-block output channels at sizes 4, 8, ..., 1024, capped."""
    chans = [
        512,
        512,
        512,
        512,
        256 * channel_multiplier,
        128 * channel_multiplier,
        64 * channel_multiplier,
        32 * channel_multiplier,
        16 * channel_multiplier,
    ]
    return [min(c, max_channels) for c in chans]


class SynthesisBlock(nn.Module):
    """One upsampling + one plain StyledConv, or a single plain conv for
    the first block."""

    def __init__(self, in_ch, out_ch, cond_ch, one_conv_block=False, apply_sqrt2=False,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(apply_sqrt2=apply_sqrt2, dtype=dtype, generator=generator)
        self.conv1 = StyledConv(in_ch, out_ch, cond_ch, 3, upsample=not one_conv_block, **kw)
        self.conv2 = None if one_conv_block else StyledConv(out_ch, out_ch, cond_ch, 3, **kw)

    def forward(self, x, latent, cond):
        x = self.conv1(x, latent, cond)
        if self.conv2 is not None:
            x = self.conv2(x, latent, cond)
        return x


class SynthesisNetwork(nn.Module):
    def __init__(
        self,
        core_tensor_res: int = 4,
        channel_multiplier: int = 2,
        max_channels: int = 512,
        cond_channels: int = 6,
        max_step: int = 6,
        apply_sqrt2: bool = False,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        chans = synthesis_channels(channel_multiplier, max_channels)
        c0 = min(512, max_channels)
        self.const_input = nn.Parameter(
            torch.randn((1, c0, core_tensor_res, core_tensor_res), generator=generator)
        )
        self.start_step = int(math.log2(core_tensor_res)) - 2
        self.max_step = max_step
        in_ch = c0
        for i in range(self.start_step, max_step + 1):
            setattr(self, f"block{i}", SynthesisBlock(
                in_ch, chans[i], cond_channels, one_conv_block=(i == self.start_step),
                apply_sqrt2=apply_sqrt2, dtype=dtype, generator=generator,
            ))
            setattr(self, f"to_rgb{i}", ToRGB(
                chans[i], apply_sqrt2=apply_sqrt2, dtype=dtype, generator=generator
            ))
            in_ch = chans[i]

    def forward(
        self,
        latent,
        conds,
        step: int,
        inject_index: Sequence[int] | None = None,
        mixing_range: tuple = (-1, -1),
    ):
        """latent: (B, 512) or a sequence of them (style mixing); conds:
        per-scale NCHW condition maps for i = 0..step.  Returns (B, 3,
        4*2**step, 4*2**step) f32.

        With several styles and ``mixing_range == (-1, -1)`` a crossover
        walk over ``inject_index`` moves to the next style once the block
        index passes each injection point; otherwise blocks inside
        ``[mixing_range[0], mixing_range[1]]`` take style 1 and all others
        style 0."""
        if step > self.max_step:
            raise ValueError(f"step {step} > the {self.max_step} this network was built for")
        styles = list(latent) if isinstance(latent, (list, tuple)) else [latent]
        if len(styles) < 2:
            inject_index = [step + 2]  # never crosses
        elif mixing_range == (-1, -1):
            if inject_index is None:
                raise ValueError(
                    "multiple styles need inject_index (static crossover "
                    "block ids) or an explicit mixing_range"
                )
            inject_index = list(inject_index)
            if len(inject_index) != len(styles) - 1:
                raise ValueError(
                    f"{len(styles)} styles need {len(styles) - 1} injection "
                    f"points, got {len(inject_index)}"
                )
        x = self.const_input.expand(styles[0].shape[0], -1, -1, -1)
        skip = None
        crossover = 0
        for i in range(self.start_step, step + 1):
            if mixing_range == (-1, -1):
                if crossover < len(inject_index) and i > inject_index[crossover]:
                    crossover = min(crossover + 1, len(styles) - 1)
                style_i = styles[crossover]
            else:
                in_range = mixing_range[0] <= i <= mixing_range[1]
                style_i = styles[1 if in_range and len(styles) > 1 else 0]
            x = getattr(self, f"block{i}")(x, style_i, conds[i])
            skip = getattr(self, f"to_rgb{i}")(x, style_i, skip)
        return skip


class StyledGenerator(nn.Module):
    """Top-level generator: identity index (or z) + NHWC condition map ->
    NHWC image."""

    def __init__(
        self,
        embedding_vocab_size: int = 70000,
        n_mlp: int = 8,
        core_tensor_res: int = 4,
        channel_multiplier: int = 2,
        max_channels: int = 512,
        cond_channels: int = 6,
        max_step: int = 6,
        w_truncation_factor: float = 1.0,
        apply_sqrt2: bool = False,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.w_truncation_factor = w_truncation_factor
        self.mapping = MappingNetwork(n_mlp=n_mlp, style_dim=512, generator=generator)
        self.synthesis = SynthesisNetwork(
            core_tensor_res=core_tensor_res,
            channel_multiplier=channel_multiplier,
            max_channels=max_channels,
            cond_channels=cond_channels,
            max_step=max_step,
            apply_sqrt2=apply_sqrt2,
            dtype=dtype,
            generator=generator,
        )
        # Frozen random identity codes — a non-trainable buffer.
        self.register_buffer(
            "embedding", torch.randn((embedding_vocab_size, 512), generator=generator)
        )

    @classmethod
    def from_config(cls, cfg, w_truncation_factor: float = 1.0, seed: int = 0):
        """The generator ``cfg`` describes, initialised on the CPU from
        ``torch.Generator().manual_seed(seed)``."""
        return cls(
            embedding_vocab_size=cfg.embedding_vocab_size,
            n_mlp=cfg.nmlp_for_z_to_w,
            core_tensor_res=cfg.core_tensor_res,
            channel_multiplier=cfg.channel_multiplier,
            max_channels=cfg.max_channels,
            cond_channels=cfg.cond_channels,
            max_step=cfg.max_step,
            w_truncation_factor=w_truncation_factor,
            apply_sqrt2=cfg.apply_sqrt_in_eq_linear,
            dtype=getattr(torch, cfg.compute_dtype),
            generator=torch.Generator().manual_seed(seed),
        )

    def forward(
        self,
        cond: torch.Tensor,
        input_indices: torch.Tensor | None = None,
        z: torch.Tensor | None = None,
        step: int = 6,
        mean_w: torch.Tensor | None = None,
        inject_index: Sequence[int] | None = None,
        mixing_range: tuple = (-1, -1),
    ) -> torch.Tensor:
        """Generate images.

        Args:
          cond: (B, H, W, C) condition maps in [-1, 1].
          input_indices: (B,) identity indices into the frozen embedding;
            mutually exclusive with ``z``.
          z: (B, 512) latent fed straight to the mapping net, or a
            sequence of them for style mixing.
          step: images come out at 4 * 2**step.
          mean_w: (512,) mean latent, required when w_truncation_factor
            deviates from 1.
          inject_index: crossover block ids for style mixing, one per
            extra style.
          mixing_range: (lo, hi); blocks in [lo, hi] take style 1, the
            rest style 0.

        Returns:
          (B, 4*2**step, 4*2**step, 3) float32 images.
        """
        if z is not None:
            zs = list(z) if isinstance(z, (list, tuple)) else [z]
            w = [self.mapping(zz) for zz in zs]
        else:
            if input_indices is None:
                input_indices = torch.zeros(cond.shape[0], dtype=torch.long, device=cond.device)
            w = self.mapping(self.embedding[input_indices.long()])
            if abs(self.w_truncation_factor - 1.0) > 0.01:
                if mean_w is None:
                    raise ValueError(
                        "w_truncation_factor set but no mean_w supplied; "
                        "compute it with StyledGenerator.mean_latent()."
                    )
                w = w + (mean_w - w) * (1.0 - self.w_truncation_factor)
            w = [w]
        cond_nchw = cond.permute(0, 3, 1, 2).float()
        conds = [resize_bilinear_nchw(cond_nchw, 4 * 2**i, 4 * 2**i) for i in range(step + 1)]
        out = self.synthesis(
            w if len(w) > 1 else w[0], conds, step, inject_index=inject_index, mixing_range=mixing_range
        )
        return out.permute(0, 2, 3, 1)

    def mean_latent(self) -> torch.Tensor:
        """Mean w over the whole identity-embedding table."""
        return torch.mean(self.mapping(self.embedding), dim=0)
