"""The yardstick's counts for the StyleGAN3-T cells: a train step's dense
operations, and the filtered leaky ReLU's operations and bytes per
launch.

Dense operations (convolutions and matrix products, multiply + add = 2)
from the configuration's shapes (:func:`..reference.stylegan3.layer_specs`),
as :mod:`.flops` counts GIF's: G's forward is the mapping net, the input's
1x1 mixing, and per layer its style linear and its modulated convolution
(full padding: a k x k conv of an (in + k - 1)-sized output); the filtered
leaky ReLU, like the blur there, is left out.  D's forward is
:func:`.flops.discriminator_forward` (3 input channels).  A step, B rows:

- G's phase: G forward and its backward (2 forwards), D forward over the
  fakes and the input gradient through it (1 forward): 3 G + 2 D;
- D's phase: G forward without a gradient, D forward over 2B rows and its
  backward (2 forwards each): G + 6 D;
- on an R1 step, R1: 6 D (:mod:`.flops`).

The filtered leaky ReLU's counts are the work its separable polyphase form
needs for one launch (6 taps a sample a direction in the zero-stuffed up
pass, ``6 down`` in the down pass; the backward the transposes plus the
up pass again for the derivative): 2 operations a multiply-add, each input
read once and each output written once.
"""

from __future__ import annotations

from ..reference.stylegan3 import layer_specs
from .flops import HBM_BYTES_PER_S, discriminator_forward  # noqa: F401 (the bound's bandwidth)

# NVIDIA H100 SXM data sheet, float32 outside the tensor cores, at 700 W.
PEAK_F32_FLOPS = 67e12
TAPS = 6


def generator_forward(cfg: dict, rows: int) -> float:
    first, specs = layer_specs(cfg["max_size"], cfg["channel_base"], cfg["max_channels"], cfg["num_fp16_res"])
    total = 2.0 * cfg["nmlp_for_z_to_w"] * 512 * 512 + 2.0 * 512 * 4
    total += 2.0 * first["size"] ** 2 * first["channels"] ** 2
    size = first["size"]
    for s in specs:
        out = size + s["k"] - 1
        total += 2.0 * 512 * s["cin"] + 2.0 * out * out * s["cout"] * s["cin"] * s["k"] ** 2
        size = int(s["name"].split("_")[1])
    return rows * total


def train_step(cfg: dict, batch: int) -> dict:
    """FLOPs of a plain step, of R1's extra work and of a step of the R1
    schedule on average."""
    g = generator_forward(cfg, batch)
    d = discriminator_forward(cfg, batch)
    plain = 4 * g + 8 * d
    r1 = 6 * d
    return {"plain": plain, "r1": r1, "mean": plain + r1 / cfg["r1_interval"]}


def _tmp(out: int, down: int) -> int:
    """Upsampled samples an axis that the outputs read."""
    return (out - 1) * down + TAPS * down


def launch_counts(kind: str, shape: tuple, out_hw: tuple, up: int, down: int, itemsize: int) -> tuple:
    """(operations, bytes) of one launch: ``kind`` "forward" or "backward",
    ``shape`` the input (N, C, H, W), ``out_hw`` the output's (OH, OW)."""
    n, c, h, w = shape
    oh, ow = out_hw
    th, tw = _tmp(oh, down), _tmp(ow, down)
    up_pass = h * tw * TAPS + th * tw * TAPS
    down_pass = th * ow * TAPS * down + oh * ow * TAPS * down
    if kind == "forward":
        macs, elems = up_pass + down_pass, h * w + oh * ow
    else:
        da = oh * tw * TAPS + th * tw * TAPS
        dx = th * w * TAPS * up + h * w * TAPS * up
        macs, elems = up_pass + da + dx, 2 * h * w + oh * ow
    return 2.0 * n * c * macs, float(n * c * elems * itemsize)
