"""The conditional StyleGAN2 residual discriminator (a frozen copy of the
measured program's module): ``concat(image, condition)``, a 1x1
``from_rgb``, ResBlocks down to 4x4 in the compute dtype, then a float32
head (minibatch stddev, a 3x3 conv, two equalized dense layers).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from . import ops
from .layers import ConvLayer, EqualLinear, ResBlock


def discriminator_channels(channel_multiplier: int = 2, max_channels: int = 512) -> dict:
    chans = {
        4: 512,
        8: 512,
        16: 512,
        32: 512,
        64: 256 * channel_multiplier,
        128: 128 * channel_multiplier,
        256: 64 * channel_multiplier,
        512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }
    return {k: min(v, max_channels) for k, v in chans.items()}


class Discriminator(nn.Module):
    def __init__(
        self,
        size: int = 256,
        in_channels: int = 9,
        channel_multiplier: int = 2,
        max_channels: int = 512,
        stddev_group: int = 4,
        stddev_feat: int = 1,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        chans = discriminator_channels(channel_multiplier, max_channels)
        self.stddev_group = stddev_group
        self.stddev_feat = stddev_feat
        self.from_rgb = ConvLayer(in_channels, chans[size], 1, dtype=dtype, generator=generator)
        self.log_size = int(math.log2(size))
        in_ch = chans[size]
        for i in range(self.log_size, 2, -1):
            out_ch = chans[2 ** (i - 1)]
            setattr(self, f"res{i}", ResBlock(in_ch, out_ch, dtype=dtype, generator=generator))
            in_ch = out_ch
        self.final_conv = ConvLayer(in_ch + stddev_feat, chans[4], 3, generator=generator)
        self.final_dense = EqualLinear(chans[4] * 4 * 4, chans[4], activation=True, generator=generator)
        self.out = EqualLinear(chans[4], 1, generator=generator)

    @classmethod
    def from_config(cls, cfg, seed: int = 0):
        """The discriminator ``cfg`` describes, initialised on the CPU from
        ``torch.Generator().manual_seed(seed)``."""
        return cls(
            size=cfg.max_size,
            in_channels=cfg.disc_in_channels,
            channel_multiplier=cfg.channel_multiplier,
            max_channels=cfg.max_channels,
            dtype=getattr(torch, cfg.compute_dtype),
            generator=torch.Generator().manual_seed(seed),
        )

    def forward(self, image: torch.Tensor, condition: torch.Tensor | None = None) -> torch.Tensor:
        """image: (B, S, S, 3); condition: (B, S, S, C_cond) or None.
        Returns (B, 1) f32 scores."""
        x = image if condition is None else torch.cat([image, condition], dim=-1)
        x = self.from_rgb(x.permute(0, 3, 1, 2).contiguous())
        for i in range(self.log_size, 2, -1):
            x = getattr(self, f"res{i}")(x)
        # The head runs in f32 (stddev statistics and the score MLP are tiny).
        x = ops.minibatch_stddev(x.float(), self.stddev_group, self.stddev_feat)
        x = self.final_conv(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.out(self.final_dense(x))
