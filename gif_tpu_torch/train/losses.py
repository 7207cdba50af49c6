"""GAN losses of the run_id-8 step (port of ``d_ns_loss``, ``g_ns_loss`` and
``r1_penalty`` in :mod:`gif_tpu.train.losses`): the non-saturating softplus
losses and the R1 penalty, weight 5, on the real images only.  The other
regularizers wait for the slices that run them."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def d_ns_loss(real_scores: torch.Tensor, fake_scores: torch.Tensor) -> torch.Tensor:
    """softplus(-real).mean() + softplus(fake).mean()."""
    return F.softplus(-real_scores).mean() + F.softplus(fake_scores).mean()


def g_ns_loss(fake_scores: torch.Tensor) -> torch.Tensor:
    return F.softplus(-fake_scores).mean()


def r1_from_scores(real_scores: torch.Tensor, real_image: torch.Tensor, weight: float) -> torch.Tensor:
    """weight * ||d sum(D(x)) / d x||^2 per sample, meaned, for scores
    already computed from ``real_image`` (which requires grad).  The graph
    is kept, so the penalty backpropagates into D's parameters."""
    (g,) = torch.autograd.grad(real_scores.sum(), real_image, create_graph=True)
    return weight * g.reshape(g.shape[0], -1).square().sum(1).mean()


def r1_penalty(d_apply, real_image: torch.Tensor, condition, weight: float = 5.0) -> torch.Tensor:
    """R1 with its own D forward: ``d_apply(image, condition) -> (B, 1)``.
    Differentiable a second time."""
    real = real_image.detach().requires_grad_(True)
    return r1_from_scores(d_apply(real, condition), real, weight)
