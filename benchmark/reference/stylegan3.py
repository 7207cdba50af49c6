"""StyleGAN3-T's generator and the unconditional StyleGAN2 discriminator in
plain PyTorch: the reference of the ``stylegan3-t`` cells, written from
NVlabs/stylegan3 ``training/networks_stylegan3.py`` (G),
``training/networks_stylegan2.py`` (D) and ``torch_utils/ops``'s reference
paths (``_filtered_lrelu_ref``, ``_upfirdn2d_ref``), and nothing of the
measured program.

Precision (``precision``; TF32 off, ``train_uncond.py`` sets both flags):

- ``"float32"``: every layer in float32, the modulated convolution in
  NVlabs' form (the styles, demodulation and gain folded into per-sample
  weights, one grouped convolution): the CPU tests hold the program to it;
- ``"config"``: the configuration's precision, the comparison that decides
  ``correct``: the layers it runs in bfloat16 (G's of sampling rate x
  2**num_fp16_res above the resolution, D's four highest resolutions) in
  bfloat16 at the points where the program rounds, G's convolution in the
  program's batch-shared form (the same product: ``conv(x * s, w) * d``),
  the filtered leaky ReLU in float32 between them;
- ``"float8"``: the control, one precision below: the same, with every
  bfloat16 value and its gradient rounded to float8 (:class:`Fp8Round`;
  D's blocks on float8 operands, :func:`.ops.lower_precision`).

Against a float32 reference the program's bfloat16 bias and style
gradients read up to 0.44 off per leaf (cancelling sums over 1024 px
maps), as far as the float8 control's (from 0.43): no limit parts them
(PERF.md).
Departures from NVlabs, each also in the configuration's ``assumed``:

- the filters are ``scipy.signal.firwin``'s design written out in numpy
  (scipy is not imported);
- D is the repository's residual D (:mod:`.layers`): its final dense layer
  reads the 4 x 4 map in H, W, C order (NVlabs: C, H, W; a permutation of
  a randomly drawn weight), and its layers clamp at 256 only in the low
  precision (NVlabs clamps in float32 too; no activation here comes near
  256);
- the mapping network does not track ``w_avg`` (read only by truncation,
  which training does not use), and every layer reads the same w (no
  style mixing in ``stylegan3-t``);
- ``filtered_lrelu`` runs per image under ``torch.utils.checkpoint`` in
  G's graph, so the 1024 px upsampled maps of one image are alive at a
  time; the arithmetic is unchanged.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from . import ops
from .layers import ConvLayer, EqualLinear, ResBlock


def firwin(numtaps: int, cutoff: float, width: float, fs: float):
    """``scipy.signal.firwin(numtaps, cutoff, width=width, fs=fs)``: a
    Kaiser-windowed sinc, unit gain at DC; None for one tap."""
    if numtaps == 1:
        return None
    nyq = fs / 2
    atten = 2.285 * (numtaps - 1) * np.pi * (width / nyq) + 7.95
    if atten > 50:
        beta = 0.1102 * (atten - 8.7)
    elif atten > 21:
        beta = 0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21)
    else:
        beta = 0.0
    m = np.arange(numtaps) - (numtaps - 1) / 2
    h = (cutoff / nyq) * np.sinc((cutoff / nyq) * m) * np.kaiser(numtaps, beta)
    return torch.as_tensor(h / np.sum(h), dtype=torch.float32, device="cpu")


def layer_specs(res: int, channel_base: int, channel_max: int, num_fp16_res: int = 4) -> tuple:
    """(input's (channels, size, sampling rate, bandwidth), per layer a
    dict) of ``SynthesisNetwork.__init__`` with num_layers 14, num_critical
    2, first_cutoff 2, first_stopband 2**2.1, last_stopband_rel 2**0.3,
    margin_size 10, and ``SynthesisLayer.__init__``'s filters and padding."""
    n = 14
    last_cutoff = res / 2
    last_stopband = last_cutoff * 2**0.3
    e = np.minimum(np.arange(n + 1) / (n - 2), 1)
    cutoffs = 2 * (last_cutoff / 2) ** e
    stopbands = 2**2.1 * (last_stopband / 2**2.1) ** e
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, res))))
    half_widths = np.maximum(stopbands, rates / 2) - cutoffs
    sizes = rates + 20
    sizes[-2:] = res
    channels = np.rint(np.minimum((channel_base / 2) / cutoffs, channel_max))
    channels[-1] = 3
    specs = []
    for idx in range(n + 1):
        prev = max(idx - 1, 0)
        torgb = idx == n
        tmp = max(rates[prev], rates[idx]) * (1 if torgb else 2)
        up, down = int(np.rint(tmp / rates[prev])), int(np.rint(tmp / rates[idx]))
        up_taps = 6 * up if up > 1 and not torgb else 1
        down_taps = 6 * down if down > 1 and not torgb else 1
        k = 1 if torgb else 3
        total = (sizes[idx] - 1) * down + 1 - (sizes[prev] + k - 1) * up + up_taps + down_taps - 2
        lo = (total + up) // 2
        specs.append(dict(
            name=f"L{idx}_{int(sizes[idx])}_{int(channels[idx])}", torgb=torgb, k=k, up=up, down=down,
            cin=int(channels[prev]), cout=int(channels[idx]),
            fu=firwin(up_taps, cutoffs[prev], half_widths[prev] * 2, tmp),
            fd=firwin(down_taps, cutoffs[idx], half_widths[idx] * 2, tmp),
            padding=[int(lo), int(total - lo), int(lo), int(total - lo)],
            low=bool(rates[idx] * 2**num_fp16_res > res),
        ))
    first = dict(channels=int(channels[0]), size=int(sizes[0]), sampling_rate=float(rates[0]),
                 bandwidth=float(cutoffs[0]))
    return first, specs


def upfirdn2d(x, f, up=1, down=1, padding=(0, 0, 0, 0), gain=1.0):
    """``_upfirdn2d_ref`` for a 1-D (separable) filter; padding [x0, x1, y0, y1]."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h, 1, w, 1)
    x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1]).reshape(n, c, h * up, w * up)
    px0, px1, py0, py1 = padding
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0): x.shape[2] - max(-py1, 0), max(-px0, 0): x.shape[3] - max(-px1, 0)]
    f = (f * gain ** 0.5).to(x.dtype).flip(0)
    f = f[None, None].repeat([c, 1, 1])
    x = F.conv2d(x, f.unsqueeze(2), groups=c)
    x = F.conv2d(x, f.unsqueeze(3), groups=c)
    return x[:, :, ::down, ::down]


def filtered_lrelu(x, fu, fd, b, up, down, padding, gain, slope, clamp):
    """``_filtered_lrelu_ref``: bias, upsample, leaky ReLU with gain and
    clamp, downsample."""
    x = x + b[None, :, None, None]
    x = upfirdn2d(x, fu, up=up, padding=padding, gain=up**2)
    x = F.leaky_relu(x, slope) * gain
    x = x.clamp(-clamp, clamp)
    return upfirdn2d(x, fd, down=down)


class Fp8Round(torch.autograd.Function):
    """Round to float8 e4m3 with a per-tensor scale (the largest magnitude
    maps to 448), and the gradient too, to any order of differentiation."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().float().clamp(min=1e-30) / ops.FP8_MAX
        return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return Fp8Round.apply(g)


class Mapping(nn.Module):
    def __init__(self, n_mlp: int):
        super().__init__()
        self.n_mlp = n_mlp
        for i in range(n_mlp):
            setattr(self, f"fc{i}", EqualLinear(512, 512, lr_mul=0.01, activation=True, apply_sqrt2=True))

    def forward(self, z):
        x = z * (z.square().mean(1, keepdim=True) + 1e-8).rsqrt()
        for i in range(self.n_mlp):
            x = getattr(self, f"fc{i}")(x)
        return x


class Input(nn.Module):
    def __init__(self, channels, size, sampling_rate, bandwidth):
        super().__init__()
        self.channels, self.size, self.sampling_rate, self.bandwidth = channels, size, sampling_rate, bandwidth
        self.weight = nn.Parameter(torch.empty([channels, channels]))
        self.affine = EqualLinear(512, 4)
        self.register_buffer("transform", torch.eye(3, 3))
        self.register_buffer("freqs", torch.empty([channels, 2]))
        self.register_buffer("phases", torch.empty([channels]))

    def forward(self, w):
        transforms = self.transform.unsqueeze(0)
        freqs, phases = self.freqs.unsqueeze(0), self.phases.unsqueeze(0)
        t = self.affine(w)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        m_r = torch.eye(3, device=w.device).unsqueeze(0).repeat([w.shape[0], 1, 1])
        m_r[:, 0, 0] = t[:, 0]
        m_r[:, 0, 1] = -t[:, 1]
        m_r[:, 1, 0] = t[:, 1]
        m_r[:, 1, 1] = t[:, 0]
        m_t = torch.eye(3, device=w.device).unsqueeze(0).repeat([w.shape[0], 1, 1])
        m_t[:, 0, 2] = -t[:, 2]
        m_t[:, 1, 2] = -t[:, 3]
        transforms = m_r @ m_t @ transforms
        phases = phases + (freqs @ transforms[:, :2, 2:]).squeeze(2)
        freqs = freqs @ transforms[:, :2, :2]
        amplitudes = (1 - (freqs.norm(dim=2) - self.bandwidth) / (self.sampling_rate / 2 - self.bandwidth)).clamp(0, 1)
        theta = torch.eye(2, 3, device=w.device)
        theta[0, 0] = 0.5 * self.size / self.sampling_rate
        theta[1, 1] = 0.5 * self.size / self.sampling_rate
        grids = F.affine_grid(theta.unsqueeze(0), [1, 1, self.size, self.size], align_corners=False)
        x = (grids.unsqueeze(3) @ freqs.permute(0, 2, 1).unsqueeze(1).unsqueeze(2)).squeeze(3)
        x = x + phases.unsqueeze(1).unsqueeze(2)
        x = torch.sin(x * (np.pi * 2)) * amplitudes.unsqueeze(1).unsqueeze(2)
        x = x @ (self.weight / np.sqrt(self.channels)).t()
        return x.permute(0, 3, 1, 2)


class Layer(nn.Module):
    def __init__(self, spec: dict, beta: float, precision: str):
        super().__init__()
        self.s, self.beta = spec, beta
        self.low = precision if spec["low"] and precision != "float32" else None
        self.affine = EqualLinear(512, spec["cin"], bias_init=1.0)
        self.weight = nn.Parameter(torch.empty([spec["cout"], spec["cin"], spec["k"], spec["k"]]))
        self.bias = nn.Parameter(torch.zeros([spec["cout"]]))
        self.register_buffer("magnitude_ema", torch.ones([]))

    def lo(self, t):
        """``t`` rounded to the layer's low precision: bfloat16, or float8
        (forward and gradient) under the control."""
        return (Fp8Round.apply(t) if self.low == "float8" else t).to(torch.bfloat16)

    def conv(self, x, w, s, input_gain):
        """NVlabs' ``modulated_conv2d``: pre-normalized, modulated,
        demodulated (not ToRGB), input-gained per-sample weights as one
        grouped convolution with padding k - 1."""
        b = x.shape[0]
        demod = not self.s["torgb"]
        if demod:
            w = w * w.square().mean([1, 2, 3], keepdim=True).rsqrt()
            s = s * s.square().mean().rsqrt()
        w = w.unsqueeze(0) * s.unsqueeze(1).unsqueeze(3).unsqueeze(4)
        if demod:
            w = w * (w.square().sum(dim=[2, 3, 4]) + 1e-8).rsqrt().unsqueeze(2).unsqueeze(3).unsqueeze(4)
        w = w * input_gain
        x = F.conv2d(x.reshape(1, -1, *x.shape[2:]), w.reshape(-1, *w.shape[2:]), padding=self.s["k"] - 1, groups=b)
        return x.reshape(b, -1, *x.shape[2:])

    def conv_low(self, x, w, s, input_gain):
        """The same product in bfloat16, as the program forms it:
        ``conv(x * (s g), w) * d`` with one weight for the batch, each
        factor and product rounded where the program rounds it."""
        k = self.s["k"]
        if self.s["torgb"]:
            w, d = w * (1.0 / math.sqrt(w[0].numel())), None
        else:
            w = w * w.square().mean([1, 2, 3], keepdim=True).rsqrt()
            s = s * s.square().mean().rsqrt()
            d = (s.square() @ w.square().sum((2, 3)).T + 1e-8).rsqrt()
        x = self.lo(x * self.lo(s * input_gain)[:, :, None, None])
        x = self.lo(F.conv2d(x, self.lo(w), padding=k - 1))
        return x if d is None else self.lo(x * self.lo(d)[:, :, None, None])

    def forward(self, x, w, update_emas=False):
        sp = self.s
        if update_emas:
            self.magnitude_ema.copy_(x.detach().float().square().mean().lerp(self.magnitude_ema, self.beta))
        styles = self.affine(w)
        if self.low:
            x = self.conv_low(self.lo(x), self.weight, styles, self.magnitude_ema.rsqrt()).float()
        else:
            if sp["torgb"]:
                styles = styles / np.sqrt(sp["cin"] * sp["k"] ** 2)
            x = self.conv(x.float(), self.weight, styles, self.magnitude_ema.rsqrt())
        if sp["torgb"]:
            x = (x + self.bias[None, :, None, None]).clamp(-256, 256)
        else:
            args = (sp["fu"].to(x.device), sp["fd"].to(x.device), self.bias, sp["up"], sp["down"], sp["padding"],
                    np.sqrt(2), 0.2, 256)
            if torch.is_grad_enabled():
                x = torch.cat([torch.utils.checkpoint.checkpoint(filtered_lrelu, x[i:i + 1], *args, use_reentrant=False)
                               for i in range(x.shape[0])])
            else:
                x = torch.cat([filtered_lrelu(x[i:i + 1], *args) for i in range(x.shape[0])])
        return self.lo(x) if self.low else x


class Generator(nn.Module):
    """z -> (B, 3, R, R) float32; the parameter and buffer names are the
    program's (``mapping.fc{i}``, ``synthesis.input``, ``synthesis.L*``)."""

    def __init__(self, res: int, channel_base: int, channel_max: int, n_mlp: int, beta: float,
                 num_fp16_res: int = 4, precision: str = "float32"):
        super().__init__()
        first, specs = layer_specs(res, channel_base, channel_max, num_fp16_res)
        self.mapping = Mapping(n_mlp)
        self.synthesis = nn.Module()
        self.synthesis.input = Input(**first)
        self.names = [s["name"] for s in specs]
        for spec in specs:
            setattr(self.synthesis, spec["name"], Layer(spec, beta, precision))

    def forward(self, z, update_emas=False):
        w = self.mapping(z)
        x = self.synthesis.input(w)
        for name in self.names:
            x = getattr(self.synthesis, name)(x, w, update_emas)
        return x.float() * 0.25

    def magnitude_emas(self):
        return [getattr(self.synthesis, n).magnitude_ema for n in self.names]


class Discriminator(nn.Module):
    """NVlabs' resnet D, unconditional, as the repository's layers write it:
    ``from_rgb``, ResBlocks down to 4 x 4 (the blocks of input resolution >=
    ``2**(log2(res) + 1 - num_fp16_res)`` in bfloat16 unless ``precision``
    is "float32"), the float32 head (minibatch stddev of groups of
    ``mbstd_group``, a 3x3 conv, a dense layer with leaky ReLU x sqrt(2),
    the score)."""

    def __init__(self, res: int, channel_multiplier: int, channel_max: int, mbstd_group: int = 4,
                 num_fp16_res: int = 4, precision: str = "float32"):
        super().__init__()
        chans = {r: min(c, channel_max) for r, c in {
            4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * channel_multiplier, 128: 128 * channel_multiplier,
            256: 64 * channel_multiplier, 512: 32 * channel_multiplier, 1024: 16 * channel_multiplier}.items()}
        low_from = max(2 ** (int(math.log2(res)) + 1 - num_fp16_res), 8)

        def dtype(r):
            return torch.bfloat16 if precision != "float32" and r >= low_from else torch.float32

        self.mbstd_group, self.log_size = mbstd_group, int(math.log2(res))
        self.low_from = low_from if precision == "float8" else None
        self.from_rgb = ConvLayer(3, chans[res], 1, dtype=dtype(res))
        in_ch = chans[res]
        for i in range(self.log_size, 2, -1):
            setattr(self, f"res{i}", ResBlock(in_ch, chans[2 ** (i - 1)], dtype=dtype(2**i)))
            in_ch = chans[2 ** (i - 1)]
        self.final_conv = ConvLayer(in_ch + 1, chans[4], 3)
        self.final_dense = EqualLinear(chans[4] * 16, chans[4], activation=True, apply_sqrt2=True)
        self.out = EqualLinear(chans[4], 1)

    def _low(self, res, block, x):
        """``block(x)``; under the control, at resolution >= ``low_from``,
        in float8: operands in the block, its output and gradient here."""
        if self.low_from is None or res < self.low_from:
            return block(x)
        with ops.lower_precision():
            return Fp8Round.apply(block(x))

    def forward(self, image):
        """image: (B, R, R, 3) -> (B, 1)."""
        x = self._low(2**self.log_size, self.from_rgb, image.permute(0, 3, 1, 2).contiguous())
        for i in range(self.log_size, 2, -1):
            x = self._low(2**i, getattr(self, f"res{i}"), x)
        x = ops.minibatch_stddev(x.float(), self.mbstd_group, 1)
        x = self.final_conv(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.out(self.final_dense(x))
