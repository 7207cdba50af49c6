"""The scaled-orthographic camera in plain PyTorch (a frozen copy of the
measured program's arithmetic)."""

from __future__ import annotations

import torch


def batch_orth_proj(X: torch.Tensor, camera: torch.Tensor) -> torch.Tensor:
    """Scaled orthographic projection: (B,N,3), (B,3)=(s,bx,by) ->
    s * [x + bx, y + by, z]."""
    cam = camera.reshape(-1, 1, 3)
    xy = X[:, :, :2] + cam[:, :, 1:]
    return cam[:, :, 0:1] * torch.cat([xy, X[:, :, 2:]], dim=2)
