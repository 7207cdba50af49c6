"""Kernel 2: the albedo sampler (bilinear ``grid_sample``, forward).

Replaces the TPU kernel ``gif_tpu/render/sampler_pallas.py::_sampler_kernel``
(reached through ``grid_sample_bilinear_mxu``).  The CUDA source is
``gif_tpu_torch/csrc/sampler.cu``; its header says what bounds it on the
H100 (memory) and how the design meets that.  The TPU sampled a bf16
texture through its matrix unit; the port samples float32, as the JAX
package's CPU path does.
"""

from __future__ import annotations

import torch

from gif_tpu_torch import kernels
from gif_tpu_torch.render.shading import grid_sample_bilinear


def grid_sample_cuda(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA sampler (CUDA float32 tensors only)."""
    if img.dtype != torch.float32 or grid.dtype != torch.float32:
        raise ValueError(f"sampler kernel takes float32, got {img.dtype} / {grid.dtype}")
    b, h, w, c = img.shape
    if grid.shape[0] != b or grid.shape[-1] != 2:
        raise ValueError(f"grid {tuple(grid.shape)} does not match image {tuple(img.shape)}")
    img = img.contiguous()
    grid = grid.contiguous()
    ho, wo = grid.shape[1], grid.shape[2]
    out = torch.empty((b, ho, wo, c), device=img.device)
    fn = kernels.function("gif_sampler_forward", 3, 5)
    err = fn(
        img.data_ptr(), grid.data_ptr(), out.data_ptr(),
        b, h, w, c, ho * wo, kernels.stream_ptr(img),
    )
    kernels.check(err, "gif_sampler_forward")
    grid_sample.launches += 1
    return out


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of (B,H,W,C) images at (B,Ho,Wo,2) [-1,1] coords
    (zeros padding, align_corners=False).  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if img.is_cuda:
        return grid_sample_cuda(img, grid)
    return grid_sample_bilinear(img, grid)


grid_sample.launches = 0
