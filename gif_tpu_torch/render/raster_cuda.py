"""Kernel 1: the rasterizer with fused attribute interpolation, binning
included.

Replaces the TPU kernel ``gif_tpu/render/raster_pallas.py::_raster_group_kernel``
(reached through ``rasterize_pallas_with_attrs``) and the binning around
it.  The CUDA source is ``gif_tpu_torch/csrc/raster.cu``; its header says
what bounds it on the H100 (memory: the per-pixel key buffer and outputs)
and how the design meets that: bin by ballot into a per-tile bitset, rank
by prefix popcount, cover face-parallel with a 64-bit ``atomicMax`` of
(depth, face id) keys, resolve per pixel.  Every size comes from the
shapes, so the whole call is queued on the stream and never waits on the
host.

Binning is face-granular (the reference's XLA rasterizer's contract, not
the Pallas kernel's 32-face chunks): a tile overflows when more than
``max_tris_per_tile`` front-facing faces overlap it, and the flag is per
tile.  The plain version (:func:`gif_tpu_torch.render.raster.rasterize_plain`)
bins with ``bin_faces`` / ``face_table``; the kernel equals it bit for bit.

:func:`rasterize_with_attrs` is an autograd Function
(:class:`RasterizeWithAttrs`) on either device: the interpolated attributes
are differentiable in the corner attributes through
:func:`face_attrs_vjp`, an ``index_add_`` of ``bary * g`` over the winning
faces (the port of JAX's ``_rwa_bwd``, an XLA segment-sum there).  Its
``backend`` (:func:`raster_backend`, ``GIF_TPU_TORCH_RASTER``) can force
the plain version onto CUDA tensors for the renderer-numerics experiment;
the default never does.

:func:`morton_face_order` is the JAX package's one-time spatial face
permutation, kept for callers that want spatially coherent face ids; the
port's face-granular binning does not need it, so the renderer keeps the
mesh's own face order (face ids then match the reference's CPU path).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gif_tpu_torch import kernels
from gif_tpu_torch.render.raster import RasterOutput, rasterize_plain

# Steps of one call (csrc/raster.cu), one bit each: clear the keys, bin,
# rank, cover, the listed large walks, resolve.  A call runs them all; a
# timing may run one at a time.
STEPS = ("clear", "bin", "ranks", "cover", "wide", "resolve")
ALL_PASSES = (1 << len(STEPS)) - 1


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
    fv, attrs = kernel_inputs(face_verts_pix, face_attrs, h, w, tile)
    bufs = raster_buffers(fv, attrs.shape[-1], h, w, tile)
    launch_kernel(fv, attrs, bufs, max_tris_per_tile, h, w, tile)
    rast = RasterOutput(bufs["depth"], bufs["tri"], bufs["bary"], bufs["overflow"])
    return rast, (bufs["attr_img"] if face_attrs is not None else None)


def rasterize(face_verts_pix: torch.Tensor, h: int, w: int, tile: int = 32,
              max_tris_per_tile: int = 512) -> RasterOutput:
    """Rasterize (B, F, 3, 3) pixel-space faces without attributes: kernel
    1 on CUDA tensors, :func:`rasterize_plain` on CPU ones."""
    if face_verts_pix.is_cuda:
        return rasterize_cuda(face_verts_pix, None, h, w, tile, max_tris_per_tile)[0]
    return rasterize_plain(face_verts_pix, None, h=h, w=w, tile=tile, max_tris_per_tile=max_tris_per_tile)[0]


def kernel_inputs(face_verts_pix, face_attrs, h, w, tile):
    """(B, F, 3, 3) corners and (B, F, 3, D) attributes (D = 0 without
    attributes) as contiguous float32, checked against what the kernel
    takes."""
    if h % tile or w % tile or tile > 512:
        raise ValueError(f"image {h}x{w} / tile {tile} not supported by the kernel")
    fv = face_verts_pix.detach().float().contiguous()
    if fv.ndim != 4 or fv.shape[2:] != (3, 3):
        raise ValueError(f"faces {tuple(fv.shape)} are not (B, F, 3, 3)")
    b, f = fv.shape[:2]
    attrs = (
        torch.zeros((b, f, 3, 0), device=fv.device)
        if face_attrs is None
        else face_attrs.detach().float().contiguous()
    )
    if attrs.ndim != 4 or attrs.shape[:3] != (b, f, 3):
        raise ValueError(f"face_attrs {tuple(attrs.shape)} does not match faces {(b, f)}")
    t = (h // tile) * (w // tile)
    if max(b * h * w, 8 * b * f, 64 * b * t, b * t * ((f + 31) // 32)) >= 2**31:
        raise ValueError(f"{b} x {f} faces at {h}x{w} exceed the kernel's 32-bit indexing")
    return fv, attrs


def raster_buffers(fv, d, h, w, tile) -> dict:
    """Outputs and scratch of one call, allocated without initialisation
    (the kernel writes every element it reads): keys (B, H, W) int64; per
    (batch, tile) the membership bitset and prefix counts over ceil(F / 32)
    words and the candidate count (left unwritten when the capacity is the
    face count); the list of large walks (a count, a pad
    word, room for B * F / 4 + 4096 (face, tile) pairs) — one int32
    allocation."""
    b, f = fv.shape[:2]
    rows, words = b * (h // tile) * (w // tile), (f + 31) // 32
    wide_cap = b * f // 4 + 4096
    dev = fv.device
    sizes = [2 * b * h * w, 2 + 2 * wide_cap, rows * words, rows * words, rows]  # 8-byte parts first
    keys, wide, bits, prefix, counts = torch.split(torch.empty(sum(sizes), dtype=torch.int32, device=dev), sizes)
    return {
        "keys": keys, "wide": wide, "wide_cap": wide_cap, "bits": bits, "prefix": prefix, "counts": counts,
        "depth": torch.empty((b, h, w), device=dev),
        "tri": torch.empty((b, h, w), dtype=torch.int32, device=dev),
        "bary": torch.empty((b, h, w, 3), device=dev),
        "attr_img": torch.empty((b, h, w, d), device=dev),
        "overflow": torch.empty((b, rows // b), dtype=torch.bool, device=dev),
    }


def launch_kernel(fv, attrs, bufs, max_tris_per_tile, h, w, tile, passes=ALL_PASSES):
    """Queue the steps ``passes`` selects (a bit per entry of ``STEPS``) on
    the current stream, on the prepared inputs and buffers; every step reads
    what the earlier ones left in ``bufs``."""
    b, f = fv.shape[:2]
    fn = kernels.function("gif_raster_forward", 12, 9)
    err = fn(
        fv.data_ptr(), attrs.data_ptr(), bufs["keys"].data_ptr(), bufs["bits"].data_ptr(),
        bufs["prefix"].data_ptr(), bufs["counts"].data_ptr(), bufs["wide"].data_ptr(), bufs["depth"].data_ptr(),
        bufs["tri"].data_ptr(), bufs["bary"].data_ptr(), bufs["attr_img"].data_ptr(),
        bufs["overflow"].data_ptr(), b, f, min(max_tris_per_tile, f), h, w, tile,
        attrs.shape[-1], bufs["wide_cap"], passes, kernels.stream_ptr(fv),
    )
    kernels.check(err, "gif_raster_forward")
    if passes == ALL_PASSES:
        rasterize_with_attrs.launches += 1


def face_attrs_vjp(tri_id: torch.Tensor, bary: torch.Tensor, g: torch.Tensor, n_faces: int) -> torch.Tensor:
    """The attribute gradient of kernel 1's interpolation (JAX's ``_rwa_bwd``,
    ``gif_tpu/render/raster_pallas.py:593-611``, an XLA segment-sum there):
    ``d face_attrs[b, f, k, :]`` is the sum of ``bary[k] * g`` over the
    pixels face ``f`` won; background pixels add nothing.  (B, H, W) ids,
    (B, H, W, 3) barycentrics, (B, H, W, D) cotangents -> (B, F, 3, D)."""
    b, d = g.shape[0], g.shape[-1]
    hit = tri_id >= 0
    rows = (tri_id.long() + torch.arange(b, device=g.device)[:, None, None] * n_faces)[hit]
    contrib = (bary[..., :, None] * g[..., None, :])[hit]  # (N, 3, D)
    out = torch.zeros((b * n_faces, 3 * d), dtype=g.dtype, device=g.device)
    out.index_add_(0, rows, contrib.reshape(-1, 3 * d))
    return out.reshape(b, n_faces, 3, d)


RASTER_BACKENDS = ("auto", "cuda", "plain")


def raster_backend(requested: str = "auto") -> str:
    """The rasterizer a render takes: ``GIF_TPU_TORCH_RASTER`` when it is
    set, else ``requested`` (the port of JAX's ``GIF_TPU_RASTER`` /
    ``raster_backend`` switch, ``gif_tpu/render/renderer.py:131-135``).

    - ``auto``: kernel 1 on CUDA tensors, :func:`rasterize_plain` on CPU
      ones (the main path; nothing on it sets another value);
    - ``cuda``: kernel 1; CPU tensors raise;
    - ``plain``: :func:`rasterize_plain` on whatever device the tensors are
      on, with the same attribute VJP.  It exists for the renderer-numerics
      experiment (``gif_tpu_torch.scripts.raster_sensitivity``).

    Any other value raises."""
    backend = os.environ.get("GIF_TPU_TORCH_RASTER", requested)
    if backend not in RASTER_BACKENDS:
        raise ValueError(f"raster backend must be one of {RASTER_BACKENDS}, got {backend!r}")
    return backend


class RasterizeWithAttrs(torch.autograd.Function):
    """Kernel 1 (its plain version on the CPU, or where ``backend`` is
    ``plain``) with the attribute VJP: differentiable in ``face_attrs``;
    the positions get no gradient, as in the reference rasterizer."""

    @staticmethod
    def forward(ctx, face_verts_pix, face_attrs, h, w, tile, max_tris_per_tile, backend="auto"):
        if backend not in RASTER_BACKENDS:
            raise ValueError(f"raster backend must be one of {RASTER_BACKENDS}, got {backend!r}")
        if backend == "cuda" and not face_verts_pix.is_cuda:
            raise ValueError("raster backend 'cuda' needs CUDA tensors: kernel 1 has no CPU mode")
        if backend == "plain" or not face_verts_pix.is_cuda:
            rast, attr_img = rasterize_plain(
                face_verts_pix, face_attrs, h=h, w=w, tile=tile, max_tris_per_tile=max_tris_per_tile
            )
        else:
            rast, attr_img = rasterize_cuda(face_verts_pix, face_attrs, h, w, tile, max_tris_per_tile)
        ctx.save_for_backward(rast.tri_id, rast.bary)
        ctx.n_faces, ctx.attr_dtype = face_attrs.shape[1], face_attrs.dtype
        ctx.mark_non_differentiable(*rast)
        return (*rast, attr_img)

    @staticmethod
    def backward(ctx, *grads):
        if not ctx.needs_input_grad[1]:
            return (None,) * 7
        tri_id, bary = ctx.saved_tensors
        d_attrs = face_attrs_vjp(tri_id, bary, grads[-1].float(), ctx.n_faces)
        return None, d_attrs.to(ctx.attr_dtype), None, None, None, None, None


def rasterize_with_attrs(
    face_verts_pix: torch.Tensor,
    face_attrs: torch.Tensor,
    h: int,
    w: int,
    tile: int = 32,
    max_tris_per_tile: int = 512,
    backend: str = "auto",
):
    """Rasterize (B, F, 3, 3) pixel-space faces and interpolate their
    (B, F, 3, D) corner attributes: returns (RasterOutput, attr_img
    (B, H, W, D)), differentiable in ``face_attrs``.  Under ``backend``
    ``auto`` CPU tensors take the plain version and CUDA tensors launch the
    kernel (:func:`raster_backend` for the others)."""
    *rast, attr_img = RasterizeWithAttrs.apply(face_verts_pix, face_attrs, h, w, tile, max_tris_per_tile, backend)
    return RasterOutput(*rast), attr_img


rasterize_with_attrs.launches = 0
