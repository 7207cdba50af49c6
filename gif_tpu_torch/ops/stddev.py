"""Minibatch standard-deviation feature of the discriminator, NCHW.

Port of :mod:`gif_tpu.ops.stddev`: split the batch into groups of (at
most) ``group_size`` over the *leading* axis (sample ``i`` belongs to
group slot ``i // (n // g)``), take the biased std over the group per
(feature chunk, channel, h, w), average it to one scalar per group member
and feature, and append it as ``num_features`` constant channels.
"""

from __future__ import annotations

import torch


def minibatch_stddev(
    x: torch.Tensor, group_size: int = 4, num_features: int = 1, eps: float = 1e-8
) -> torch.Tensor:
    """Append the group-stddev channels.  x: (N, C, H, W) -> (N, C+F, H, W)."""
    n, c, h, w = x.shape
    g = min(n, group_size)
    f = num_features
    if n % g or c % f:
        raise ValueError(
            f"minibatch_stddev needs batch divisible by min(batch, group_size)={g} and "
            f"channels divisible by num_features={f}; got batch {n}, channels {c}"
        )
    y = x.reshape(g, n // g, f, c // f, h, w)
    var = torch.var(y, dim=0, correction=0)
    std = torch.sqrt(var + eps)
    avg = std.mean(dim=(2, 3, 4))  # (n//g, F)
    avg = avg[None].expand(g, -1, -1).reshape(n, f, 1, 1)
    feat = avg.expand(n, f, h, w).to(x.dtype)
    return torch.cat([x, feat], dim=1)
