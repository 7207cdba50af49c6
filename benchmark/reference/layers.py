"""The G and D layers as ``nn.Module``s over :mod:`.ops`, NCHW (a frozen
copy of the measured program's modules, with the same parameter names,
so one state_dict loads into both).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import ops


def _normal(shape, std: float, generator: torch.Generator | None) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


def _const(shape, value: float) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, float(value)))


class EqualLinear(nn.Module):
    """Equalized linear layer (weight ~ N(0, scale_weight / lr_mul))."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        bias: bool = True,
        bias_init: float = 0.0,
        lr_mul: float = 1.0,
        activation: bool = False,
        scale_weight: float = 1.0,
        apply_sqrt2: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.weight = _normal((out_dim, in_dim), scale_weight / lr_mul, generator)
        self.bias = _const((out_dim,), bias_init) if bias else None
        self.lr_mul = lr_mul
        self.activation = activation
        self.apply_sqrt2 = apply_sqrt2

    def forward(self, x):
        return ops.equal_linear(
            x,
            self.weight,
            self.bias,
            lr_mul=self.lr_mul,
            activation=self.activation,
            apply_sqrt2=self.apply_sqrt2,
        )


class EqualConv2d(nn.Module):
    """Conv with runtime He scaling (weight ~ N(0, 1), OIHW)."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0, bias=True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = _normal((out_ch, in_ch, kernel_size, kernel_size), 1.0, generator)
        self.bias = _const((out_ch,), 0.0) if bias else None
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        return ops.equal_conv2d(x, self.weight, self.bias, stride=self.stride, padding=self.padding)


class ModulatedConv2d(nn.Module):
    """Modulated conv; styles and demodulation in f32, the conv in
    ``dtype``."""

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        kernel_size: int,
        demodulate: bool = True,
        upsample: bool = False,
        blur_taps=(1, 3, 3, 1),
        apply_sqrt2: bool = False,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.weight = _normal((out_ch, in_ch, kernel_size, kernel_size), 1.0, generator)
        self.modulation = EqualLinear(
            512, in_ch, bias_init=1.0, apply_sqrt2=apply_sqrt2, generator=generator
        )
        self.demodulate = demodulate
        self.upsample = upsample
        self.blur_taps = tuple(blur_taps)
        self.dtype = dtype

    def forward(self, x, latent):
        return ops.modulated_conv2d(
            x.to(self.dtype),
            self.weight,
            self.modulation(latent),
            demodulate=self.demodulate,
            upsample=self.upsample,
            blur_taps=self.blur_taps,
        )


class ConditionInjection(nn.Module):
    """The GIF condition-as-noise injection net: 3x3 convs c -> 2c -> 4c ->
    out with ReLUs over the resized condition maps, added to the features.
    Tiny init (std 0.01, bias 1e-4)."""

    def __init__(
        self,
        cond_ch: int,
        out_ch: int,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        chans = [cond_ch, 2 * cond_ch, 4 * cond_ch, out_ch]
        for i in range(3):
            conv = nn.Module()
            conv.weight = _normal((chans[i + 1], chans[i], 3, 3), 0.01, generator)
            conv.bias = _const((chans[i + 1],), 1e-4)
            setattr(self, f"conv{i}", conv)
        self.dtype = dtype

    def forward(self, features, cond):
        # conv0 reads the f32 conditions (the 8-bit condition levels
        # need 9 significant bits, one more than bf16 holds) and its output
        # is cast to the compute dtype; conv1 and conv2 run in it.
        conv = self.conv0
        h = ops.conv2d(cond.float(), conv.weight, bias=conv.bias, padding=1).to(self.dtype)
        for i in range(1, 3):
            h = F.relu(h)
            conv = getattr(self, f"conv{i}")
            h = ops.conv2d(h, conv.weight.to(self.dtype), bias=conv.bias.to(self.dtype), padding=1)
        return features + h.to(features.dtype)


class StyledConv(nn.Module):
    """ModulatedConv2d -> ConditionInjection -> fused bias+lrelu,
    clamped to +-256 in low precision."""

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        cond_ch: int,
        kernel_size: int = 3,
        upsample: bool = False,
        demodulate: bool = True,
        apply_sqrt2: bool = False,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.conv = ModulatedConv2d(
            in_ch,
            out_ch,
            kernel_size,
            demodulate=demodulate,
            upsample=upsample,
            apply_sqrt2=apply_sqrt2,
            dtype=dtype,
            generator=generator,
        )
        self.noise = ConditionInjection(cond_ch, out_ch, dtype=dtype, generator=generator)
        self.act_bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x, latent, cond):
        x = self.conv(x, latent)
        x = self.noise(x, cond)
        x = ops.fused_leaky_relu(x, self.act_bias)
        if x.dtype != torch.float32:
            x = torch.clamp(x, -256.0, 256.0)
        return x


class ToRGB(nn.Module):
    """1x1 demod-free modulated conv + bias, accumulated in f32 onto the
    upsampled skip."""

    def __init__(
        self,
        in_ch: int,
        apply_sqrt2: bool = False,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.conv = ModulatedConv2d(
            in_ch, 3, 1, demodulate=False, apply_sqrt2=apply_sqrt2, dtype=dtype,
            generator=generator,
        )
        self.bias = nn.Parameter(torch.zeros(3))

    def forward(self, x, latent, skip=None):
        out = self.conv(x, latent).float() + self.bias[None, :, None, None]
        if skip is not None:
            out = out + ops.upsample_2x(skip)
        return out


class ConvLayer(nn.Module):
    """[down-blur] + EqualConv2d + fused bias+lrelu, in ``dtype``, clamped to +-256 in low precision.  ``activate``
    layers carry the bias as ``act_bias``; the others (the ResBlock skip)
    have none."""

    def __init__(self, in_ch, out_ch, kernel_size, downsample=False, activate=True,
                 dtype=torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        self.downsample = downsample
        self.kernel_size = kernel_size
        self.conv = EqualConv2d(
            in_ch, out_ch, kernel_size,
            stride=2 if downsample else 1,
            padding=0 if downsample else kernel_size // 2,
            bias=False, generator=generator,
        )
        self.act_bias = nn.Parameter(torch.zeros(out_ch)) if activate else None
        self.dtype = dtype

    def forward(self, x):
        x = x.to(self.dtype)
        if self.downsample:
            p = (4 - 2) + (self.kernel_size - 1)
            pad0, pad1 = (p + 1) // 2, p // 2
            # An even-sized blur output where the extra row / column is
            # never read by the VALID stride-2 conv (``even`` / ``phase``
            # resampling; ``legacy`` keeps these pads on every map size).
            py0, py1 = ops.even_extended_pad(x.shape[2], pad0, pad1, 4, self.kernel_size)
            px0, px1 = ops.even_extended_pad(x.shape[3], pad0, pad1, 4, self.kernel_size)
            x = ops.blur(x, pad=(py0, py1, px0, px1))
        x = self.conv(x)
        if self.act_bias is not None:
            x = ops.fused_leaky_relu(x, self.act_bias)
            if x.dtype != torch.float32:
                x = torch.clamp(x, -256.0, 256.0)
        return x


class ResBlock(nn.Module):
    """Two ConvLayers (the second downsampling) + a 1x1 downsampling skip,
    summed and scaled by 1/sqrt(2)."""

    def __init__(self, in_ch, out_ch, dtype=torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.conv1 = ConvLayer(in_ch, in_ch, 3, **kw)
        self.conv2 = ConvLayer(in_ch, out_ch, 3, downsample=True, **kw)
        self.skip = ConvLayer(in_ch, out_ch, 1, downsample=True, activate=False, **kw)
        self.dtype = dtype

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return ((out + self.skip(x)) * (1.0 / math.sqrt(2.0))).to(self.dtype)


class MappingNetwork(nn.Module):
    """PixelNorm + n_mlp EqualLinear(lr_mul, leaky-relu) z -> w mapping."""

    def __init__(
        self,
        n_mlp: int = 8,
        style_dim: int = 512,
        lr_mul: float = 0.01,
        scale_weight: float = 1.0,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.n_mlp = n_mlp
        for i in range(n_mlp):
            setattr(
                self,
                f"dense{i}",
                EqualLinear(
                    style_dim, style_dim, lr_mul=lr_mul, activation=True,
                    scale_weight=scale_weight, generator=generator,
                ),
            )

    def forward(self, z):
        if self.n_mlp <= 0:
            return z
        h = ops.pixel_norm(z)
        for i in range(self.n_mlp):
            h = getattr(self, f"dense{i}")(h)
        return h
