"""FLOP accounting and MFU for the train step (port of
:mod:`gif_tpu.utils.flops`).

Primary source: PyTorch's FLOP counter on the program as it runs
(:func:`compiled_flops`: ``torch.utils.flop_counter.FlopCounterMode``
around one call counts every matmul and convolution it dispatches,
forward and backward, double backwards included).  Cross-check: the
analytic convolution count in :func:`analytic_generator_forward_flops`
(``gif_tpu_torch.scripts.mfu_report`` compares both on the same program).
The counter counts the dense products only (matmuls, convolutions and
their gradients); elementwise work, the blur and the render are not in it.

Peak numbers are per-card dense bf16 tensor-core peaks from NVIDIA's data
sheets; MFU is reported against the bf16 peak (the model's conv stacks run
in bfloat16, ``TrainConfig.compute_dtype``).
"""

from __future__ import annotations

from typing import Optional

# Dense bf16 tensor-core FLOP/s per card: NVIDIA data-sheet figures
# (without sparsity), at each part's full power limit.  A card set below
# its limit (nvidia-smi's power.limit) reaches less.
PEAK_FLOPS_BF16 = {
    "NVIDIA H100 80GB HBM3": 989.4e12,  # H100 SXM5, data sheet
    "NVIDIA H100 PCIe": 756e12,  # data sheet
    "NVIDIA H200": 989.4e12,  # data sheet (SXM)
    "NVIDIA A100-SXM4-80GB": 312e12,  # data sheet
    "NVIDIA A100-SXM4-40GB": 312e12,  # data sheet
}


def device_peak_flops(device=None) -> Optional[float]:
    """Dense bf16 peak (data sheet) of a CUDA ``device`` (default: the
    current card), by ``torch.cuda.get_device_name``; None on the CPU or
    for a card not in :data:`PEAK_FLOPS_BF16`."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    # Longest-prefix match ("NVIDIA H100 80GB HBM3" before a shorter name).
    best = None
    for k, v in PEAK_FLOPS_BF16.items():
        if name.startswith(k) and (best is None or len(k) > best[0]):
            best = (len(k), v)
    return best[1] if best else None


class _GlobalScopeOnly:
    """Stands in for ``FlopCounterMode``'s module tracker: every count goes
    to the global scope only.  The tracker's backward hooks refuse
    ``torch.autograd.grad`` over leaf inputs (R1's and the path length's
    input gradients), which the train step takes; only the total is read
    here."""

    parents = ("Global",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def compiled_flops(fn, *args, **kwargs) -> Optional[float]:
    """Total FLOPs of one call ``fn(*args, **kwargs)`` as PyTorch's FLOP
    counter sees the ops it dispatches (multiply + add = 2), or None when
    it counts none.  The call runs once, for real: a train step updates its
    state."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    counter.mod_tracker = _GlobalScopeOnly()
    with counter:
        fn(*args, **kwargs)
    total = counter.get_total_flops()
    return float(total) if total > 0 else None


def mfu(flops_per_step: float, steps_per_sec: float, device=None) -> Optional[float]:
    """Model FLOPs utilization in [0, 1] against the card's bf16 peak."""
    peak = device_peak_flops(device)
    if not peak or not flops_per_step:
        return None
    return flops_per_step * steps_per_sec / peak


def analytic_generator_forward_flops(cfg, batch: int) -> float:
    """Analytic conv/matmul FLOPs of ONE generator forward (multiply+add =
    2 FLOPs), mirroring the synthesis structure of
    gif_tpu_torch/models/generator.py: per scale 4..max_size, two modulated 3x3
    convs + the 3-conv condition-injection nets + a 1x1 ToRGB, plus the
    z->w mapping MLP.  Used as the cross-check on
    :func:`compiled_flops` (gif_tpu_torch.scripts.mfu_report); small terms
    (demodulation, upfirdn blur taps, biases) are deliberately ignored.
    """
    import math

    def ch(res_log2: int) -> int:
        # models/generator.py channel map: 512 down to 32 at 256px, capped.
        raw = {2: 512, 3: 512, 4: 512, 5: 512, 6: 256 * cfg.channel_multiplier,
               7: 128 * cfg.channel_multiplier, 8: 64 * cfg.channel_multiplier,
               9: 32 * cfg.channel_multiplier, 10: 16 * cfg.channel_multiplier}
        return min(raw[res_log2], cfg.max_channels)

    style_dim = 512
    total = 0.0
    # Mapping MLP: nmlp layers of 512x512 per sample.
    total += 2.0 * batch * cfg.nmlp_for_z_to_w * style_dim * style_dim
    max_log2 = int(math.log2(cfg.max_size))
    cond_c = cfg.cond_channels
    for log2res in range(2, max_log2 + 1):
        res = 2 ** log2res
        c_in = ch(log2res if log2res == 2 else log2res - 1)
        c_out = ch(log2res)
        hw = res * res
        if log2res > 2:
            # Upsampling StyledConv: stride-2 conv_transpose — each INPUT
            # pixel (hw/4 of them) contributes k*k MACs per channel pair.
            total += 2.0 * batch * (hw / 4) * c_in * c_out * 9
        total += 2.0 * batch * hw * c_out * c_out * 9
        # Style->scale EqualLinear per conv: style_dim x c_in.
        total += 2.0 * batch * style_dim * (c_in + c_out)
        # Condition-injection conv nets (NoiseInjection re-design,
        # gif_tpu_torch/models/layers.py): per StyledConv a 3-layer conv stack
        # cond_c -> 2*cond_c -> 4*cond_c -> c_out at this resolution.
        n_inject = 1 if log2res == 2 else 2
        inj = (
            hw * cond_c * (2 * cond_c) * 9
            + hw * (2 * cond_c) * (4 * cond_c) * 9
            + hw * (4 * cond_c) * c_out * 9
        )
        total += 2.0 * batch * n_inject * inj
        # ToRGB 1x1.
        total += 2.0 * batch * hw * c_out * 3
    return total


def analytic_stylegan3_generator_forward_flops(cfg, batch: int) -> float:
    """Dense FLOPs of one StyleGAN3 G forward over ``batch`` rows
    (:mod:`gif_tpu_torch.models.stylegan3`): the mapping MLP and the
    input's affine, the input's 1x1 channel mixing, and per synthesis
    layer its style affine and its modulated convolution (full padding: a
    k x k conv producing an (in + k - 1)-sized map).  The filtered leaky
    ReLU's FIR passes are not counted, as the blur is not above."""
    from gif_tpu_torch.models.stylegan3 import W_DIM, synthesis_schedule

    sched = synthesis_schedule(cfg.max_size, cfg.channel_base, cfg.max_channels, num_fp16_res=cfg.num_fp16_res)
    first = sched[0]
    total = 2.0 * cfg.nmlp_for_z_to_w * W_DIM * W_DIM + 2.0 * W_DIM * 4
    total += 2.0 * first["size"] ** 2 * first["channels"] ** 2
    for s in sched[1:]:
        out = s["in_size"] + s["kernel"] - 1
        total += 2.0 * W_DIM * s["in_channels"]
        total += 2.0 * out * out * s["out_channels"] * s["in_channels"] * s["kernel"] ** 2
    return batch * total
