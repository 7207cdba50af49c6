"""The yardstick's operation counts and the card's peaks.

Dense operations only (convolutions and matrix products, multiply + add =
2), counted from the configuration's shapes, never from what the program
dispatches: a change that drops or adds work does not move the
denominator.  The blur, the render, elementwise work and demodulation are
left out.  The generator's forward count is a copy of the program's
``utils/flops.analytic_generator_forward_flops``; the discriminator's and
the step's are this file's own.

A train step, per its parts (B data rows, G over ``g_rows`` rows: 2B - 1
under the fused interpolation loss, else B):

- G forward over ``g_rows``; G's backward, 2 forwards (input and weight
  gradients);
- D's update: D forward over 2B rows (reals and fakes) and its backward,
  2 forwards each;
- G's update through D: D forward over B fakes and the input gradient
  through it, 1 forward each;
- on an R1 step, R1: D forward over B reals, the input gradient kept for a
  second pass (1 forward), and the backward through both (2 x 2
  forwards): 6 forwards of D over B rows.

A step of the R1 schedule on average: a plain step plus R1 / r1_interval.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
PEAK_BF16_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12


def _g_channels(cfg: dict, log2res: int) -> int:
    m = cfg["channel_multiplier"]
    raw = {2: 512, 3: 512, 4: 512, 5: 512, 6: 256 * m, 7: 128 * m, 8: 64 * m, 9: 32 * m, 10: 16 * m}
    return min(raw[log2res], cfg["max_channels"])


def cond_channels(cfg: dict) -> int:
    return 3 * int(cfg["rendered_flame_as_condition"]) + 3 * int(cfg["normal_maps_as_cond"])


def generator_forward(cfg: dict, rows: int) -> float:
    """FLOPs of one G forward over ``rows`` rows: the mapping MLP, per scale
    the modulated convs (the up one a stride-2 transposed conv), their
    style linears, the condition-injection stacks and the ToRGB."""
    style = 512
    total = 2.0 * rows * cfg["nmlp_for_z_to_w"] * style * style
    cc = cond_channels(cfg)
    for log2res in range(2, int(math.log2(cfg["max_size"])) + 1):
        hw = (2**log2res) ** 2
        c_in = _g_channels(cfg, log2res if log2res == 2 else log2res - 1)
        c_out = _g_channels(cfg, log2res)
        if log2res > 2:
            total += 2.0 * rows * (hw / 4) * c_in * c_out * 9
        total += 2.0 * rows * hw * c_out * c_out * 9
        total += 2.0 * rows * style * (c_in + c_out)
        n_inject = 1 if log2res == 2 else 2
        inj = hw * cc * (2 * cc) * 9 + hw * (2 * cc) * (4 * cc) * 9 + hw * (4 * cc) * c_out * 9
        total += 2.0 * rows * n_inject * inj
        total += 2.0 * rows * hw * c_out * 3
    return total


def _d_channels(cfg: dict, res: int) -> int:
    m = cfg["channel_multiplier"]
    raw = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * m, 128: 128 * m, 256: 64 * m, 512: 32 * m, 1024: 16 * m}
    return min(raw[res], cfg["max_channels"])


def discriminator_forward(cfg: dict, rows: int) -> float:
    """FLOPs of one D forward over ``rows`` rows: the 1x1 ``from_rgb``, per
    ResBlock a 3x3 conv, a stride-2 3x3 conv and the stride-2 1x1 skip,
    then the 3x3 final conv and the two dense layers."""
    size = cfg["max_size"]
    in_ch = _d_channels(cfg, size)
    total = size * size * (3 + cond_channels(cfg)) * in_ch
    for log2res in range(int(math.log2(size)), 2, -1):
        res = 2**log2res
        out_ch = _d_channels(cfg, res // 2)
        total += res * res * in_ch * in_ch * 9
        total += (res // 2) ** 2 * in_ch * out_ch * (9 + 1)
        in_ch = out_ch
    c4 = _d_channels(cfg, 4)
    total += 16 * (in_ch + 1) * c4 * 9 + 16 * c4 * c4 + c4
    return 2.0 * rows * total


def train_step(cfg: dict, batch: int) -> dict:
    """FLOPs of a plain step, of R1's extra work and of a step of the R1
    schedule on average."""
    fused = cfg["apply_texture_space_interpolation_loss"]
    g_rows = 2 * batch - 1 if fused else batch
    d = discriminator_forward(cfg, batch)
    plain = 3 * generator_forward(cfg, g_rows) + 2 * 3 * d + 2 * d
    r1 = 6 * d
    return {"plain": plain, "r1": r1, "mean": plain + r1 / cfg["r1_interval"]}
