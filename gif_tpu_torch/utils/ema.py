"""Exponential moving average of parameters (port of :mod:`gif_tpu.utils.ema`).

StyleGAN2's decay 0.5 ** (32 / 10_000).  The update is in place on the
EMA tensors, with the reference's arithmetic ``e * decay + p * (1 - decay)``
(two products, one sum), as one ``torch._foreach`` pass per call.
"""

from __future__ import annotations

import torch

STYLEGAN2_EMA_DECAY = 0.5 ** (32 / (10 * 1000))


@torch.no_grad()
def ema_update(ema_params, new_params, decay: float = STYLEGAN2_EMA_DECAY) -> None:
    """ema <- decay * ema + (1 - decay) * new, tensor by tensor, in place."""
    ema_params, new_params = list(ema_params), list(new_params)
    if len(ema_params) != len(new_params):
        raise ValueError(f"{len(ema_params)} EMA tensors for {len(new_params)} parameters")
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, torch._foreach_mul(new_params, 1.0 - decay))
