"""The conditional StyleGAN2 residual discriminator (port of
:mod:`gif_tpu.models.discriminator`).

The input is ``concat(image, condition)`` along channels (9 channels for
run_id 8), a 1x1 ``from_rgb`` ConvLayer, ``log2(size) - 2`` ResBlocks down
to 4x4 in the compute dtype, then a head in f32: minibatch stddev, a 3x3
``final_conv``, and a two-layer equalized MLP to one score.  Every map
from ``from_rgb`` to the head is channels-last (NCHW-shaped, NHWC strides;
:mod:`gif_tpu_torch.ops.layout`), forward and backward to any order, so
cuDNN convolves it on its NHWC kernels without layout conversions and
kernels 3-5 take it natively.  Module names
follow the flax tree, so :mod:`gif_tpu_torch.tools.convert_params` maps it
one to one.  ``final_dense`` reads the 4x4 map flattened in H, W, C order,
as the NHWC reference does, so its weight converts unchanged.

StyleGAN3-T trains the same residual D, unconditional (3 channels in), as
NVlabs' ``networks_stylegan2.Discriminator`` at its defaults: the blocks
of input resolution ``low_precision_res`` and above in the compute dtype
(the four highest resolutions, NVlabs' ``num_fp16_res = 4``), the rest in
float32, and ``final_dense``'s leaky ReLU with gain sqrt(2)
(``apply_sqrt2``, the config's ``d_dense_sqrt2``).  GIF keeps every block
in the compute dtype and no gain.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from gif_tpu_torch import ops
from gif_tpu_torch.models.layers import ConvLayer, EqualLinear, ResBlock


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
        low_precision_res: int = 0,
        apply_sqrt2: bool = False,
    ):
        super().__init__()
        chans = discriminator_channels(channel_multiplier, max_channels)
        self.stddev_group = stddev_group
        self.stddev_feat = stddev_feat

        def block_dtype(res):
            return dtype if res >= low_precision_res else torch.float32

        self.from_rgb = ConvLayer(in_channels, chans[size], 1, dtype=block_dtype(size), generator=generator)
        self.log_size = int(math.log2(size))
        in_ch = chans[size]
        for i in range(self.log_size, 2, -1):
            out_ch = chans[2 ** (i - 1)]
            setattr(self, f"res{i}", ResBlock(in_ch, out_ch, dtype=block_dtype(2**i), generator=generator))
            in_ch = out_ch
        self.final_conv = ConvLayer(in_ch + stddev_feat, chans[4], 3, generator=generator)
        self.final_dense = EqualLinear(chans[4] * 4 * 4, chans[4], activation=True, apply_sqrt2=apply_sqrt2,
                                       generator=generator)
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
            low_precision_res=cfg.d_low_precision_res,
            apply_sqrt2=cfg.d_dense_sqrt2,
        )

    def forward(self, image: torch.Tensor, condition: torch.Tensor | None = None) -> torch.Tensor:
        """image: (B, S, S, 3); condition: (B, S, S, C_cond) or None.
        Returns (B, 1) f32 scores."""
        x = image if condition is None else torch.cat([image, condition], dim=-1)
        # The NHWC input seen as a channels-last NCHW map: a view of the
        # concatenation (a copy only of an input that is not NHWC-dense).
        x = self.from_rgb(x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
        for i in range(self.log_size, 2, -1):
            x = getattr(self, f"res{i}")(x)
        # The head runs in f32 (stddev statistics and the score MLP are tiny).
        x = ops.minibatch_stddev(x.float(), self.stddev_group, self.stddev_feat)
        x = self.final_conv(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.out(self.final_dense(x))
