"""Kernel 6: the bilinear scatter, the image gradient of point sampling.

Replaces the TPU kernel ``gif_tpu/render/sampler_pallas.py::_scatter_kernel``
(reached through ``scatter_bilinear_mxu`` in the backward of
``sample_at_points``).  The CUDA source is ``gif_tpu_torch/csrc/scatter.cu``;
its header says what bounds it on the H100 (memory) and how the design
meets that.  Its plain version is
:func:`gif_tpu_torch.render.sampling_ops.scatter_bilinear_plain`.
"""

from __future__ import annotations

import torch

from gif_tpu_torch import kernels
from gif_tpu_torch.render.sampling_ops import scatter_bilinear_plain


def scatter_bilinear_cuda(g: torch.Tensor, pts: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Launch the CUDA scatter (CUDA float32 tensors only): (B, P, C)
    cotangents at (B, P, 2) points -> (B, h, w, C) float32 image."""
    if g.dtype != torch.float32 or pts.dtype != torch.float32:
        raise ValueError(f"scatter kernel takes float32, got {g.dtype} / {pts.dtype}")
    b, p, c = g.shape
    if tuple(pts.shape) != (b, p, 2):
        raise ValueError(f"points {tuple(pts.shape)} do not match cotangents {tuple(g.shape)}")
    g = g.contiguous()
    pts = pts.contiguous()
    out = torch.zeros((b, h, w, c), dtype=torch.float32, device=g.device)
    fn = kernels.function("gif_scatter_bilinear", 3, 5)
    err = fn(
        g.data_ptr(), pts.data_ptr(), out.data_ptr(),
        b, p, h, w, c, kernels.stream_ptr(g),
    )
    kernels.check(err, "gif_scatter_bilinear")
    scatter_bilinear.launches += 1
    return out


def scatter_bilinear(g: torch.Tensor, pts: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Accumulate (B, P, C) cotangents at the bilinear taps of (B, P, 2)
    points into a zeroed (B, h, w, C) float32 image.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if g.is_cuda:
        return scatter_bilinear_cuda(g, pts, h, w)
    return scatter_bilinear_plain(g, pts, h, w)


scatter_bilinear.launches = 0
