"""StyleGAN3-T's generator (Karras et al. 2021, "Alias-Free Generative
Adversarial Networks", arXiv:2106.12423), written to the equations of
NVlabs/stylegan3 ``training/networks_stylegan3.py`` (config ``stylegan3-t``).

- The mapping network: z normalized by its second moment, ``n_mlp``
  equalized fully connected layers (learning-rate multiplier 0.01, leaky
  ReLU with gain sqrt(2)) to w.  There is no style mixing or truncation in
  training, so every layer reads the same w (NVlabs broadcasts it to
  ``num_layers + 2`` copies).
- ``SynthesisInput``: Fourier features of ``channels`` frequencies drawn
  uniformly from a disc of radius ``bandwidth``, rotated and translated by
  an affine map of w (weight 0, bias (1, 0, 0, 0) at initialization),
  amplitudes cut to zero across the band edge, then a learned 1x1 mixing.
- ``num_layers + 1`` ``SynthesisLayer``\\s on the schedule of
  :func:`synthesis_schedule` (the layer names are the published ones,
  ``L0_36_512`` ... ``L14_1024_3`` at 1024 px): a modulated 3x3 conv with
  full padding (1x1 without demodulation for ToRGB), weight and style
  pre-normalization and the input gain ``rsqrt(magnitude_ema)``, then the
  filtered leaky ReLU (:mod:`gif_tpu_torch.ops.filtered_lrelu`) with the
  layer's up / down filters, gain sqrt(2), slope 0.2 and clamp 256 (ToRGB:
  bias and clamp).  The magnitude EMA tracks the mean square of the
  layer's input in the forwards called with ``update_emas`` (the D step's
  G forward), with decay ``magnitude_ema_beta``.
- The output is scaled by 0.25 and returned in float32, NCHW.

Precision: the layers whose sampling rate times 2**``num_fp16_res`` exceeds
the resolution run their convolutions in ``dtype`` (bf16 where NVlabs runs
fp16: L5-L14 at 1024 px), the rest in float32; the filtered leaky ReLU
accumulates in float32 either way.  Under a profiler the input and the
layers are the spans ``sg3.input`` and ``sg3.synthesis``; magnitude-EMA
updates count on ``magnitude_ema_updates.count``.
"""

from __future__ import annotations

import math
import types

import numpy as np
import torch
import torch.nn as nn

from gif_tpu_torch.models.layers import EqualLinear
from gif_tpu_torch.ops.conv import modulated_conv2d
from gif_tpu_torch.ops.filtered_lrelu import bias_clamp, design_lowpass_filter, filtered_lrelu
from gif_tpu_torch.ops.linear import pixel_norm
from gif_tpu_torch.utils.profiling import span

W_DIM = 512
FILTER_SIZE = 6
LRELU_UPSAMPLING = 2
CONV_CLAMP = 256.0
OUTPUT_SCALE = 0.25

magnitude_ema_updates = types.SimpleNamespace(count=0)


def synthesis_schedule(img_resolution: int, channel_base: int = 32768, channel_max: int = 512,
                       num_layers: int = 14, num_critical: int = 2, first_cutoff: float = 2,
                       first_stopband: float = 2**2.1, last_stopband_rel: float = 2**0.3,
                       margin_size: int = 10, num_fp16_res: int = 4, img_channels: int = 3) -> list:
    """The synthesis layers' parameters, NVlabs' ``SynthesisNetwork``
    schedule: a geometric progression of cutoffs and minimum stopbands up to
    the last ``num_critical`` critically sampled layers, sampling rates the
    next power of two above twice the stopband, ``margin_size`` pixels of
    margin, channels ``channel_base / 2 / cutoff`` capped at ``channel_max``.
    Entry 0 is the Fourier input; entry i + 1 is layer i, a dict with its
    name, channels, sizes, sampling rates, cutoffs, half-widths, ``up`` /
    ``down`` factors, filters, padding and whether it runs in low
    precision."""
    last_cutoff = img_resolution / 2
    last_stopband = last_cutoff * last_stopband_rel
    exponents = np.minimum(np.arange(num_layers + 1) / (num_layers - num_critical), 1)
    cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
    stopbands = first_stopband * (last_stopband / first_stopband) ** exponents
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, img_resolution))))
    half_widths = np.maximum(stopbands, rates / 2) - cutoffs
    sizes = rates + margin_size * 2
    sizes[-2:] = img_resolution
    channels = np.rint(np.minimum((channel_base / 2) / cutoffs, channel_max))
    channels[-1] = img_channels
    out = [dict(channels=int(channels[0]), size=int(sizes[0]), sampling_rate=float(rates[0]),
                bandwidth=float(cutoffs[0]))]
    for i in range(num_layers + 1):
        p = max(i - 1, 0)
        torgb = i == num_layers
        in_rate, out_rate = int(rates[p]), int(rates[i])
        tmp_rate = max(in_rate, out_rate) * (1 if torgb else LRELU_UPSAMPLING)
        up, down = tmp_rate // in_rate, tmp_rate // out_rate
        up_taps = FILTER_SIZE * up if up > 1 and not torgb else 1
        down_taps = FILTER_SIZE * down if down > 1 and not torgb else 1
        kernel = 1 if torgb else 3
        in_size, out_size = int(sizes[p]), int(sizes[i])
        pad_total = (out_size - 1) * down + 1 - (in_size + kernel - 1) * up + up_taps + down_taps - 2
        pad_lo = (pad_total + up) // 2  # the symmetric interpretation (NVlabs, Appendix C.3)
        pad_hi = pad_total - pad_lo
        out.append(dict(
            name=f"L{i}_{out_size}_{int(channels[i])}", torgb=torgb,
            in_channels=int(channels[p]), out_channels=int(channels[i]), in_size=in_size, out_size=out_size,
            in_rate=in_rate, out_rate=out_rate, tmp_rate=tmp_rate, up=up, down=down, kernel=kernel,
            up_filter=design_lowpass_filter(up_taps, cutoffs[p], half_widths[p] * 2, tmp_rate),
            down_filter=design_lowpass_filter(down_taps, cutoffs[i], half_widths[i] * 2, tmp_rate),
            padding=(pad_lo, pad_hi, pad_lo, pad_hi),
            low_precision=bool(rates[i] * 2**num_fp16_res > img_resolution),
        ))
    return out


class MappingNetwork(nn.Module):
    """z -> w: second-moment normalization, then ``n_mlp`` fully connected
    layers ``fc{i}`` (lr multiplier 0.01, leaky ReLU x sqrt(2))."""

    def __init__(self, n_mlp: int = 2, generator: torch.Generator | None = None):
        super().__init__()
        self.n_mlp = n_mlp
        for i in range(n_mlp):
            setattr(self, f"fc{i}", EqualLinear(W_DIM, W_DIM, lr_mul=0.01, activation=True, apply_sqrt2=True,
                                                generator=generator))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = pixel_norm(z.float())
        for i in range(self.n_mlp):
            x = getattr(self, f"fc{i}")(x)
        return x


def fourier_frequencies(channels: int, bandwidth: float, generator: torch.Generator | None = None):
    """(freqs (C, 2), phases (C,)) drawn as NVlabs draws them: directions
    and radii from a 2-D normal, reshaped to a uniform disc of radius
    ``bandwidth``; phases uniform in [-0.5, 0.5)."""
    freqs = torch.randn([channels, 2], generator=generator)
    radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
    freqs = freqs / (radii * radii.square().exp().pow(0.25)) * bandwidth
    phases = torch.rand([channels], generator=generator) - 0.5
    return freqs, phases


class SynthesisInput(nn.Module):
    def __init__(self, channels: int, size: int, sampling_rate: float, bandwidth: float,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.channels, self.size = channels, size
        self.sampling_rate, self.bandwidth = sampling_rate, bandwidth
        freqs, phases = fourier_frequencies(channels, bandwidth, generator)
        self.weight = nn.Parameter(torch.randn([channels, channels], generator=generator))
        self.affine = EqualLinear(W_DIM, 4, scale_weight=0.0, generator=generator)
        with torch.no_grad():
            self.affine.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0]))
        self.register_buffer("transform", torch.eye(3))
        self.register_buffer("freqs", freqs)
        self.register_buffer("phases", phases)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        t = self.affine(w)  # (r_c, r_s, t_x, t_y)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        c, s, tx, ty = t.unbind(1)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        # Inverse rotation, then inverse translation, of the output image.
        m_r = torch.stack([c, -s, zero, s, c, zero, zero, zero, one], 1).reshape(-1, 3, 3)
        m_t = torch.stack([one, zero, -tx, zero, one, -ty, zero, zero, one], 1).reshape(-1, 3, 3)
        transforms = m_r @ m_t @ self.transform[None]
        phases = self.phases[None] + (self.freqs[None] @ transforms[:, :2, 2:]).squeeze(2)
        freqs = self.freqs[None] @ transforms[:, :2, :2]
        amplitudes = (1 - (freqs.norm(dim=2) - self.bandwidth)
                      / (self.sampling_rate / 2 - self.bandwidth)).clamp(0, 1)
        # Sample positions of the pixel centres, in units of the sampling
        # rate's period (``affine_grid`` with align_corners=False).
        coords = (torch.arange(self.size, device=w.device, dtype=torch.float32) + 0.5 - self.size / 2) \
            / self.sampling_rate
        x = coords[None, None, :, None] * freqs[:, None, None, :, 0] \
            + coords[None, :, None, None] * freqs[:, None, None, :, 1]
        x = torch.sin((x + phases[:, None, None, :]) * (2 * np.pi)) * amplitudes[:, None, None, :]
        x = x @ (self.weight / math.sqrt(self.channels)).t()
        return x.permute(0, 3, 1, 2)


class SynthesisLayer(nn.Module):
    def __init__(self, spec: dict, dtype: torch.dtype, magnitude_ema_beta: float,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spec, self.dtype, self.beta = spec, dtype, magnitude_ema_beta
        k = spec["kernel"]
        self.affine = EqualLinear(W_DIM, spec["in_channels"], bias_init=1.0, generator=generator)
        self.weight = nn.Parameter(torch.randn([spec["out_channels"], spec["in_channels"], k, k],
                                               generator=generator))
        self.bias = nn.Parameter(torch.zeros([spec["out_channels"]]))
        self.register_buffer("magnitude_ema", torch.ones([]))
        for key in ("up_filter", "down_filter"):
            f = spec[key]
            self.register_buffer(key, None if f is None else torch.from_numpy(f), persistent=False)

    def forward(self, x: torch.Tensor, w: torch.Tensor, update_emas: bool = False) -> torch.Tensor:
        sp = self.spec
        if update_emas:
            with torch.no_grad():
                self.magnitude_ema.copy_(x.detach().float().square().mean().lerp(self.magnitude_ema, self.beta))
            magnitude_ema_updates.count += 1
        torgb = sp["torgb"]
        x = modulated_conv2d(x.to(self.dtype), self.weight, self.affine(w), demodulate=not torgb,
                             padding=sp["kernel"] - 1, input_gain=self.magnitude_ema.rsqrt(),
                             prenormalize=not torgb)
        if torgb:
            return bias_clamp(x, self.bias, CONV_CLAMP)
        return filtered_lrelu(x, self.up_filter, self.down_filter, self.bias, sp["up"], sp["down"], sp["padding"],
                              gain=math.sqrt(2), slope=0.2, clamp=CONV_CLAMP)


class SynthesisNetwork(nn.Module):
    def __init__(self, img_resolution: int, channel_base: int, channel_max: int, dtype: torch.dtype,
                 magnitude_ema_beta: float, num_fp16_res: int = 4, generator: torch.Generator | None = None):
        super().__init__()
        schedule = synthesis_schedule(img_resolution, channel_base, channel_max, num_fp16_res=num_fp16_res)
        self.input = SynthesisInput(**schedule[0], generator=generator)
        self.layer_names = []
        for spec in schedule[1:]:
            ldtype = dtype if spec["low_precision"] else torch.float32
            setattr(self, spec["name"], SynthesisLayer(spec, ldtype, magnitude_ema_beta, generator))
            self.layer_names.append(spec["name"])

    def forward(self, w: torch.Tensor, update_emas: bool = False) -> torch.Tensor:
        with span("sg3.input"):
            x = self.input(w)
        with span("sg3.synthesis"):
            for name in self.layer_names:
                x = getattr(self, name)(x, w, update_emas)
        return x.float() * OUTPUT_SCALE


class StyleGAN3Generator(nn.Module):
    """z (B, 512) -> images (B, 3, R, R) in float32 (NCHW)."""

    def __init__(self, img_resolution: int = 1024, channel_base: int = 32768, channel_max: int = 512,
                 n_mlp: int = 2, dtype: torch.dtype = torch.float32, magnitude_ema_beta: float = 0.999,
                 num_fp16_res: int = 4, generator: torch.Generator | None = None):
        super().__init__()
        self.mapping = MappingNetwork(n_mlp, generator)
        self.synthesis = SynthesisNetwork(img_resolution, channel_base, channel_max, dtype, magnitude_ema_beta,
                                          num_fp16_res, generator)

    @classmethod
    def from_config(cls, cfg, seed: int = 0):
        """The generator ``cfg`` describes, initialised on the CPU from
        ``torch.Generator().manual_seed(seed)``."""
        return cls(img_resolution=cfg.max_size, channel_base=cfg.channel_base, channel_max=cfg.max_channels,
                   n_mlp=cfg.nmlp_for_z_to_w, dtype=getattr(torch, cfg.compute_dtype),
                   magnitude_ema_beta=cfg.magnitude_ema_beta, num_fp16_res=cfg.num_fp16_res,
                   generator=torch.Generator().manual_seed(seed))

    def magnitude_emas(self) -> list:
        return [getattr(self.synthesis, n).magnitude_ema for n in self.synthesis.layer_names]

    def forward(self, z: torch.Tensor, update_emas: bool = False) -> torch.Tensor:
        return self.synthesis(self.mapping(z), update_emas)
