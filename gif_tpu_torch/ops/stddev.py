"""Minibatch standard-deviation feature of the discriminator.

Port of :mod:`gif_tpu.ops.stddev`: split the batch into groups of (at
most) ``group_size`` over the *leading* axis (sample ``i`` belongs to
group slot ``i // (n // g)``), take the biased std over the group per
(feature chunk, channel, h, w), average it to one scalar per group member
and feature, and append it as ``num_features`` constant channels.  It
computes on the NHWC view of its NCHW-shaped input, as the reference
does, and returns a channels-last map (:mod:`gif_tpu_torch.ops.layout`):
a channels-last input is read without a copy, and the discriminator's
head stays channels-last, its gradient included.
"""

from __future__ import annotations

import torch


def minibatch_stddev(
    x: torch.Tensor, group_size: int = 4, num_features: int = 1, eps: float = 1e-8
) -> torch.Tensor:
    """Append the group-stddev channels.  x: (N, C, H, W) -> (N, C+F, H, W),
    channels-last."""
    n, c, h, w = x.shape
    g = min(n, group_size)
    f = num_features
    if n % g or c % f:
        raise ValueError(
            f"minibatch_stddev needs batch divisible by min(batch, group_size)={g} and "
            f"channels divisible by num_features={f}; got batch {n}, channels {c}"
        )
    xh = x.permute(0, 2, 3, 1)
    y = xh.reshape(g, n // g, h, w, f, c // f)
    var = torch.var(y, dim=0, correction=0)
    std = torch.sqrt(var + eps)
    avg = std.mean(dim=(1, 2, 4))  # (n//g, F)
    avg = avg[None].expand(g, -1, -1).reshape(n, 1, 1, f)
    feat = avg.expand(n, h, w, f).to(x.dtype)
    return torch.cat([xh, feat], dim=-1).permute(0, 3, 1, 2)
