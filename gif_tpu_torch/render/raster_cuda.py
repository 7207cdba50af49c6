"""Kernel 1: the rasterizer with fused attribute interpolation.

Replaces the TPU kernel ``gif_tpu/render/raster_pallas.py::_raster_group_kernel``
(reached through ``rasterize_pallas_with_attrs``).  The CUDA source is
``gif_tpu_torch/csrc/raster.cu``; its header says what bounds it on the
H100 (f32 ALU work over binned candidates x pixels) and how the design
meets that (candidates staged once per CTA in shared memory, the winner in
registers).  Binning and the per-face setup table stay in PyTorch
(:mod:`gif_tpu_torch.render.raster`), shared with the plain version.

Binning is face-granular (the reference's XLA rasterizer's contract, not
the Pallas kernel's 32-face chunks): a tile overflows when more than
``max_tris_per_tile`` front-facing faces overlap it, and the flag is per
tile.

:func:`morton_face_order` is the JAX package's one-time spatial face
permutation, kept for callers that want spatially coherent face ids; the
port's face-granular binning does not need it, so the renderer keeps the
mesh's own face order (face ids then match the reference's CPU path).
"""

from __future__ import annotations

import numpy as np
import torch

from gif_tpu_torch import kernels
from gif_tpu_torch.render.raster import (
    RasterOutput,
    bin_faces,
    face_table,
    rasterize_plain,
)


def morton_face_order(faces: np.ndarray, verts: np.ndarray) -> np.ndarray:
    """Spatial (Morton / z-order) permutation of the face list, by the
    interleaved-bit code of each face centroid's (x, y) on the template."""
    cent = verts[faces].mean(axis=1)
    bits = 10

    def quant(a):
        lo, hi = float(a.min()), float(a.max())
        return np.clip(
            ((a - lo) / (hi - lo + 1e-9) * (2**bits - 1)).astype(np.int64),
            0,
            2**bits - 1,
        )

    xi, yi = quant(cent[:, 0]), quant(cent[:, 1])
    code = np.zeros(faces.shape[0], np.int64)
    for b in range(bits):
        code |= ((xi >> b) & 1) << (2 * b) | ((yi >> b) & 1) << (2 * b + 1)
    return np.argsort(code, kind="stable").astype(np.int32)


def rasterize_cuda(face_verts_pix, face_attrs, h, w, tile, max_tris_per_tile):
    """Launch the CUDA kernel (CUDA tensors only); same contract as
    :func:`gif_tpu_torch.render.raster.rasterize_plain`."""
    if h % tile or w % tile or tile * tile > 1024:
        raise ValueError(f"image {h}x{w} / tile {tile} not supported by the kernel")
    fv = face_verts_pix.detach().float().contiguous()
    b, f = fv.shape[:2]
    d = 0 if face_attrs is None else face_attrs.shape[-1]
    attrs = (
        torch.zeros((b, f, 3, 0), device=fv.device)
        if face_attrs is None
        else face_attrs.detach().float().contiguous()
    )
    if attrs.shape[:3] != (b, f, 3):
        raise ValueError(f"face_attrs {tuple(attrs.shape)} does not match faces {(b, f)}")
    ids, counts, overflow = bin_faces(fv, tile, max_tris_per_tile, h, w)
    depth, tri, bary, attr_img = launch_kernel(face_table(fv), attrs, ids, counts, h, w, tile)
    rast = RasterOutput(depth, tri, bary, overflow)
    return rast, (attr_img if face_attrs is not None else None)


def launch_kernel(tab, attrs, ids, counts, h, w, tile):
    """The per-pixel kernel alone, on a prepared face table (B, F, 16),
    corner attributes (B, F, 3, D) and binned ids (B, T, K) / counts
    (B, T): returns depth, tri_id, bary and the (B, H, W, D) attributes."""
    b, f = tab.shape[:2]
    d = attrs.shape[-1]
    dev = tab.device
    depth = torch.empty((b, h, w), device=dev)
    tri = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    bary = torch.empty((b, h, w, 3), device=dev)
    attr_img = torch.empty((b, h, w, d), device=dev)
    fn = kernels.function("gif_raster_forward", 8, 7)
    err = fn(
        tab.data_ptr(), attrs.data_ptr(), ids.data_ptr(), counts.data_ptr(),
        depth.data_ptr(), tri.data_ptr(), bary.data_ptr(), attr_img.data_ptr(),
        b, f, ids.shape[2], h, w, tile, d, kernels.stream_ptr(tab),
    )
    kernels.check(err, "gif_raster_forward")
    rasterize_with_attrs.launches += 1
    return depth, tri, bary, attr_img


def rasterize_with_attrs(
    face_verts_pix: torch.Tensor,
    face_attrs: torch.Tensor | None,
    h: int,
    w: int,
    tile: int = 32,
    max_tris_per_tile: int = 512,
):
    """Rasterize (B, F, 3, 3) pixel-space faces and interpolate their
    (B, F, 3, D) corner attributes: returns (RasterOutput, attr_img
    (B, H, W, D)).  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if face_verts_pix.is_cuda:
        return rasterize_cuda(face_verts_pix, face_attrs, h, w, tile, max_tris_per_tile)
    return rasterize_plain(
        face_verts_pix, face_attrs, h=h, w=w, tile=tile, max_tris_per_tile=max_tris_per_tile
    )


rasterize_with_attrs.launches = 0
