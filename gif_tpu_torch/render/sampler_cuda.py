"""Kernel 2: the albedo sampler (bilinear ``grid_sample``, forward).

Replaces the TPU kernel ``gif_tpu/render/sampler_pallas.py::_sampler_kernel``
(reached through ``grid_sample_bilinear_mxu``).  The CUDA source is
``gif_tpu_torch/csrc/sampler.cu``; its header says what bounds it on the
H100 (memory) and how the design meets that.  The TPU sampled a bf16
texture through its matrix unit; the port samples float32, as the JAX
package's CPU path does.

The kernel reads the image through its element strides, so a strided view
goes in without a copy: the renderer's NHWC-contiguous albedo map and the
texture steal's NHWC view of the generator's NCHW output (a batch slice
of it, ``train/step.py``) are two cases of one launch.

:func:`grid_sample` is differentiable: it runs through
:class:`gif_tpu_torch.render.sampling_ops.SampleAtPoints`, whose image
gradient is kernel 6 and whose grid gradient is plain torch (XLA's
``grid_sample`` VJP in JAX, ``_gsm_bwd``).
"""

from __future__ import annotations

import torch

from gif_tpu_torch import kernels

_INT32_MAX = 2**31 - 1


def sampler_strides(img: torch.Tensor, grid: torch.Tensor) -> tuple:
    """The kernel's view of its inputs: the image's element strides
    (batch, row, column, channel) and the grid's (batch, point) strides,
    the grid read as (B, Ho * Wo) points of two adjacent floats.  A
    dimension of size 1 gets stride 0 (it is never stepped).  Raises
    ValueError on what the kernel does not take: another dtype or device,
    another rank, mismatched shapes, more than 4 channels, a zero or
    negative stride, a grid whose points are not adjacent float pairs on
    8-byte boundaries or cannot be walked with one stride, and offsets past
    32-bit indices.  Never copies."""
    if img.dtype != torch.float32 or grid.dtype != torch.float32:
        raise ValueError(f"sampler kernel takes float32, got {img.dtype} / {grid.dtype}")
    if img.device != grid.device:
        raise ValueError(f"sampler kernel takes one device, got {img.device} / {grid.device}")
    if img.ndim != 4 or grid.ndim != 4:
        raise ValueError(f"sampler kernel takes (B,H,W,C) and (B,Ho,Wo,2), got {tuple(img.shape)} / "
                         f"{tuple(grid.shape)}")
    b, h, w, c = img.shape
    if grid.shape[0] != b or grid.shape[-1] != 2:
        raise ValueError(f"grid {tuple(grid.shape)} does not match image {tuple(img.shape)}")
    if not 1 <= c <= 4:
        raise ValueError(f"sampler kernel takes 1-4 channels, got {c}")

    def walked(t):
        return tuple(0 if n == 1 else s for n, s in zip(t.shape, t.stride()))

    s_img = walked(img)
    if any(s <= 0 for n, s in zip(img.shape, s_img) if n > 1):
        raise ValueError(f"sampler kernel takes positive strides, got {img.stride()}")
    _, ho, wo, _ = grid.shape
    gs = walked(grid)
    if grid.stride(-1) != 1:
        raise ValueError(f"sampler kernel reads a point's (x, y) as adjacent floats, got strides {grid.stride()}")
    # One stride walks the Ho * Wo points: the column's, or the row's when
    # a row holds one point.
    gp = gs[2] if wo > 1 else gs[1]
    if ho > 1 and wo > 1 and gs[1] != wo * gs[2]:
        raise ValueError(f"sampler kernel walks the grid's points with one stride, got {grid.stride()}")
    gb = gs[0]
    if any(s <= 0 for n, s in ((b, gb), (ho * wo, gp)) if n > 1):
        raise ValueError(f"sampler kernel takes positive strides, got {grid.stride()}")
    if gb % 2 or gp % 2 or grid.data_ptr() % 8:
        raise ValueError(f"sampler kernel loads each point as one 8-byte float2, got strides "
                         f"{grid.stride()} at address {grid.data_ptr()}")
    span_img = sum((n - 1) * s for n, s in zip(img.shape, s_img))
    span_grid = (b - 1) * gb + (ho * wo - 1) * gp + 1
    if max(span_img, span_grid, b * ho * wo) > _INT32_MAX:
        raise ValueError("sampler kernel indexes in 32 bits")
    return s_img, (gb, gp)


def grid_sample_cuda(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA sampler (CUDA float32 tensors only, read in place
    through their strides)."""
    s_img, (gb, gp) = sampler_strides(img, grid)
    b, h, w, c = img.shape
    ho, wo = grid.shape[1], grid.shape[2]
    if b * ho * wo == 0:
        raise ValueError(f"sampler kernel takes a non-empty grid, got {tuple(grid.shape)}")
    out = torch.empty((b, ho, wo, c), device=img.device)
    fn = kernels.function("gif_sampler_forward", 3, 11)
    err = fn(
        img.data_ptr(), grid.data_ptr(), out.data_ptr(), b, h, w, c, ho * wo, *s_img, gb, gp,
        kernels.stream_ptr(img),
    )
    kernels.check(err, "gif_sampler_forward")
    grid_sample.launches += 1
    return out


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of (B,H,W,C) images at (B,Ho,Wo,2) [-1,1] coords
    (zeros padding, align_corners=False), differentiable in the image (by
    kernel 6) and the grid.  CPU tensors take the plain versions; CUDA
    tensors launch the kernels."""
    # Imported here: sampling_ops imports this module for the launch.
    from gif_tpu_torch.render.sampling_ops import sample_at_points

    b, ho, wo, _ = grid.shape
    return sample_at_points(img, grid.reshape(b, ho * wo, 2), pts_grad=True).reshape(b, ho, wo, -1)


grid_sample.launches = 0
