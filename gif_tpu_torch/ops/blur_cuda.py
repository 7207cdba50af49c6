"""Kernel 4: the separable 4-tap FIR blur with static pads, and its VJP.

Replaces the TPU kernel ``gif_tpu/ops/blur_pallas.py::_blur_slab_kernel``
(reached through ``_blur4_fwd_impl`` / ``blur4_pallas`` and its
``custom_vjp``).  The CUDA source is ``gif_tpu_torch/csrc/blur.cu``; its
header says what bounds it on the H100 (memory) and how the design meets
that (both passes fused, the pads never materialized; NCHW maps up to 24
px staged whole, several planes a CTA, in shared memory; larger NCHW maps
in register-tiled strips of 8 columns by 8 or 16 rows, 16-byte row loads
with the halo from neighbour lanes where the rows are aligned,
:func:`blur4_launch_geometry` picking the path and the grid from the map's
size; channels-last maps, the discriminator's, by a thread per 16 bytes of
channels walking a strip of one output row, :func:`blur4_nhwc_geometry`).
:func:`blur4_cuda` takes the input's own memory format
(:mod:`gif_tpu_torch.ops.layout`) and the output keeps it.  Call sites: the upsampling modulated
conv (``ops/conv.py``: gain 4, pads (1, 1) on the odd ``2H+1``
transposed-conv outputs) and the discriminator's down-blurs
(``models/layers.py`` ``ConvLayer``: pads (2, 2) before a 3x3 and (1, 1)
before the 1x1 skip).

The blur is linear, so its VJP is the same kernel on the incoming gradient
with the taps reversed and each pad ``p`` replaced by ``3 - p`` (the
full-correlation transpose).  :class:`Blur4Function` expresses that VJP
through itself, so every differentiation order stays inside the rule — R1
takes grad-of-grad through the discriminator's blurs — as
``blur_pallas.py:241-252`` does for JAX; a VJP takes its gradient in the
memory format of the map it differentiates.  Forward and VJP launches are
counted apart, and so are the two formats (``blur4.launches``,
``blur4_vjp.launches`` for NCHW maps; ``blur4_cl.launches``,
``blur4_vjp_cl.launches`` for channels-last ones).
"""

from __future__ import annotations

import functools
import types

import numpy as np
import torch
import torch.nn.functional as F

from gif_tpu_torch import kernels
from gif_tpu_torch.ops import layout


@functools.cache
def taps_1d(taps: tuple, gain: float) -> tuple:
    """Per-axis factor of the 2-D FIR ``outer(t, t) * gain``: normalised
    taps scaled by sqrt(gain), so the two separable passes compose to the
    2-D blur exactly."""
    t = np.asarray(taps, dtype=np.float32)
    t = t / t.sum() * np.sqrt(gain)
    return tuple(float(v) for v in t)


def _out_shape(x: torch.Tensor, pads: tuple) -> tuple:
    p0y, p1y, p0x, p1x = pads
    return x.shape[2] + p0y + p1y - 3, x.shape[3] + p0x + p1x - 3


def blur4_plain(x: torch.Tensor, taps: tuple, pads: tuple) -> torch.Tensor:
    """Plain version: ``sum_ij taps[i] taps[j] xpad[y+i, x+j]`` on NCHW,
    vertical pass then horizontal, f32 math, cast back to ``x``'s dtype.
    ``taps`` here are applied as given (correlation)."""
    p0y, p1y, p0x, p1x = pads
    ho, wo = _out_shape(x, pads)
    t0, t1, t2, t3 = taps
    xp = F.pad(x.float(), (p0x, p1x, p0y, p1y))
    v = t0 * xp[:, :, 0:ho] + t1 * xp[:, :, 1 : ho + 1] + t2 * xp[:, :, 2 : ho + 2] + t3 * xp[:, :, 3 : ho + 3]
    o = t0 * v[..., 0:wo] + t1 * v[..., 1 : wo + 1] + t2 * v[..., 2 : wo + 2] + t3 * v[..., 3 : wo + 3]
    return o.to(x.dtype)


# Kernel 4's launch geometry (csrc/blur.cu), 256 threads a CTA.  Maps of
# at most PLANE_MAP x PLANE_MAP outputs go whole-plane: a CTA stages about
# PLANE_OUTPUTS outputs' worth of consecutive planes (at most PLANE_SMEM
# bytes of f32 inputs) in shared memory.
# Larger maps go in strips: a thread walks 8 output columns by ``rows``
# output rows of one plane, ``rows`` one of BLUR_ROWS.
BLUR_THREADS = 256
BLUR_COLS = 8
BLUR_ROWS = (8, 16)
PLANE_MAP = 24
PLANE_OUTPUTS = 2048
PLANE_SMEM = 48 * 1024
MODES = {"strips": 0, "strips_vec": 1, "planes": 2}


def blur4_launch_geometry(planes: int, ho: int, wo: int) -> dict:
    """Kernel 4's launch geometry for ``planes`` (n, c) planes of ho x wo
    outputs.  Small maps (``mode`` "planes"): ``per_cta`` consecutive planes
    a CTA — a contiguous span in and out, so one CTA's loads and stores are
    coalesced across planes.  Larger maps (``mode`` "strips"): ``rows`` per
    thread strip (the one of BLUR_ROWS that loads the fewest input rows
    per column, ``row_strips * (rows + 3)``), the column groups and row
    strips of a plane and the thread count; threads walk column group
    fastest, then row strip, then plane (:func:`blur4_thread_tiles`), so a
    warp covers 256 output columns of a wide map.  ``blocks``: CTAs."""
    if max(ho, wo) <= PLANE_MAP:
        # Inputs are at most 3 larger than outputs (pads in [0, 3]).
        per_cta = max(1, min(PLANE_OUTPUTS // (ho * wo), PLANE_SMEM // (4 * (ho + 3) * (wo + 3))))
        return dict(mode="planes", per_cta=per_cta, blocks=-(-planes // per_cta))
    rows = min(BLUR_ROWS, key=lambda r: -(-ho // r) * (r + 3))
    col_groups = -(-wo // BLUR_COLS)
    row_strips = -(-ho // rows)
    threads = planes * col_groups * row_strips
    return dict(mode="strips", rows=rows, col_groups=col_groups, row_strips=row_strips, threads=threads,
                blocks=-(-threads // BLUR_THREADS))


def blur4_thread_tiles(geom: dict, t: np.ndarray):
    """The strip kernels' mapping of global thread indices ``t`` to tiles:
    (plane, first output row, first output column) of each; a thread whose
    plane is past the last writes nothing (``csrc/blur.cu`` computes the
    same)."""
    cg = t % geom["col_groups"]
    strip = t // geom["col_groups"]
    return strip // geom["row_strips"], (strip % geom["row_strips"]) * geom["rows"], cg * BLUR_COLS


# Kernel 4's channels-last geometry (csrc/blur.cu, blur4_nhwc): a thread
# owns ``vec`` channels of one output row and a strip of ``cols`` output
# columns; the strip is the longest of NHWC_COLS that still gives
# NHWC_THREADS threads (about four waves of the H100's 132 SMs at two
# 256-thread CTAs each), so small maps keep the card full.
NHWC_COLS = (16, 8, 4, 2, 1)
NHWC_THREADS = 1 << 18


@functools.cache
def blur4_nhwc_geometry(n: int, c: int, ho: int, wo: int, vec: int) -> dict:
    """Kernel 4's launch geometry for a channels-last (n, c, ho, wo) output
    with ``vec`` channels a thread (``c`` a multiple of it): ``cb`` channel
    groups a block (the largest divisor of c / vec up to a warp's 32 lanes),
    ``cblocks`` blocks, ``cols`` output columns a thread in ``col_strips``
    strips, ``threads`` and ``blocks`` (CTAs).  Cached: the main path
    launches the same few shapes every step (callers do not mutate it)."""
    groups = c // vec
    cb = max(d for d in range(1, 33) if groups % d == 0)
    for cols in NHWC_COLS:
        col_strips = -(-wo // cols)
        threads = n * ho * groups * col_strips
        if threads >= NHWC_THREADS:
            break
    return dict(vec=vec, cb=cb, cblocks=groups // cb, ho=ho, cols=cols, col_strips=col_strips, threads=threads,
                blocks=-(-threads // BLUR_THREADS))


def blur4_nhwc_thread_tiles(geom: dict, t: np.ndarray):
    """The channels-last kernel's mapping of global thread indices ``t`` to
    (image, output row, first channel, first output column);
    ``csrc/blur.cu`` computes the same."""
    cg = t % geom["cb"]
    r = t // geom["cb"]
    oy = r % geom["ho"]
    r = r // geom["ho"]
    blk = r % geom["cblocks"]
    r = r // geom["cblocks"]
    return r // geom["col_strips"], oy, (blk * geom["cb"] + cg) * geom["vec"], (r % geom["col_strips"]) * geom["cols"]


def blur4_cuda(x: torch.Tensor, taps: tuple, pads: tuple) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA bf16 / f32 4-D tensors only) in ``x``'s
    memory format: NCHW planes, or a channels-last map; the output keeps it.
    The caller counts the launch."""
    if x.dtype not in (torch.bfloat16, torch.float32) or x.ndim != 4:
        raise ValueError(f"blur kernel takes 4-D bf16/f32, got {x.dtype} {tuple(x.shape)}")
    if len(taps) != 4 or min(pads) < 0 or max(pads) > 3:
        raise ValueError(f"blur kernel takes 4 taps and pads in [0, 3], got {taps} {pads}")
    cl = layout.is_channels_last(x)
    x = layout.dense(x, cl)
    n, c, h, w = x.shape
    ho, wo = _out_shape(x, pads)
    if min(n * c, ho, wo) <= 0 or max(x.numel(), n * c * ho * wo) >= 2**31:
        raise ValueError(f"blur kernel takes a non-empty output and 32-bit indices, got {tuple(x.shape)} {pads}")
    if cl:
        return _blur4_nhwc(x, taps, pads, ho, wo)
    out = torch.empty((n, c, ho, wo), dtype=x.dtype, device=x.device)
    g = blur4_launch_geometry(n * c, ho, wo)
    if g["mode"] == "planes":
        mode, count, rows, groups, strips = MODES["planes"], n * c, g["per_cta"], 0, 0
    else:
        # 16-byte row loads need every input row on a 16-byte boundary and
        # whole 8-column groups.
        vec_load = w % BLUR_COLS == 0 and x.data_ptr() % 16 == 0
        mode = MODES["strips_vec" if vec_load else "strips"]
        count, rows, groups, strips = g["threads"], g["rows"], g["col_groups"], g["row_strips"]
    if count >= 2**31:
        raise ValueError(f"blur kernel indexes threads in 32 bits, got {count}")
    # 16-byte row stores: whole 8-column groups on 16-byte boundaries.
    vec_store = wo % BLUR_COLS == 0 and out.data_ptr() % 16 == 0
    fn = kernels.function("gif_blur4_forward", 2, 14, 4)
    err = fn(
        x.data_ptr(), out.data_ptr(), mode, g["blocks"], count, rows, groups, strips, h, w, ho, wo,
        pads[0], pads[2], int(x.dtype == torch.bfloat16), int(vec_store), *taps, kernels.stream_ptr(x),
    )
    kernels.check(err, "gif_blur4_forward")
    return out


def _blur4_nhwc(x: torch.Tensor, taps: tuple, pads: tuple, ho: int, wo: int) -> torch.Tensor:
    """The channels-last launch of :func:`blur4_cuda` (``x`` dense NHWC)."""
    n, c, h, w = x.shape
    out = torch.empty((n, c, ho, wo), dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    vec = 16 // x.element_size()
    if c % vec or x.data_ptr() % 16 or out.data_ptr() % 16:
        vec = 1
    g = blur4_nhwc_geometry(n, c, ho, wo, vec)
    if g["threads"] >= 2**31:
        raise ValueError(f"blur kernel indexes threads in 32 bits, got {g['threads']}")
    fn = kernels.function("gif_blur4_forward_nhwc", 2, 15, 4)
    err = fn(
        x.data_ptr(), out.data_ptr(), g["blocks"], g["threads"], g["cb"], g["cblocks"], g["col_strips"], g["cols"],
        h, w, ho, wo, c, pads[0], pads[2], int(x.dtype == torch.bfloat16), vec, *taps, kernels.stream_ptr(x),
    )
    kernels.check(err, "gif_blur4_forward_nhwc")
    return out


def _launch(x: torch.Tensor, taps: tuple, pads: tuple, counter) -> torch.Tensor:
    """Correlate ``x`` with ``taps``: the kernel on a CUDA tensor, counted
    on ``counter`` (``blur4`` or ``blur4_vjp``) for NCHW planes and on its
    channels-last twin for a channels-last map; the plain version on a CPU
    tensor."""
    if not x.is_cuda:
        return blur4_plain(x, taps, pads)
    cl = layout.is_channels_last(x)
    out = blur4_cuda(x, taps, pads)
    if cl:
        counter = blur4_cl if counter is blur4 else blur4_vjp_cl
    counter.launches += 1
    return out


class Blur4Function(torch.autograd.Function):
    """Correlation of ``x`` (NCHW-shaped, either memory format) with
    ``taps`` under ``pads``; the VJP is this Function again (taps reversed,
    pads ``3 - p``) on the gradient in ``x``'s format, counted on
    ``blur4_vjp``."""

    @staticmethod
    def forward(ctx, x, taps, pads, counter):
        ctx.taps, ctx.pads = taps, pads
        ctx.channels_last = layout.is_channels_last(x)
        return _launch(x, taps, pads, counter)

    @staticmethod
    def backward(ctx, g):
        tpads = tuple(3 - p for p in ctx.pads)
        if g.is_cuda:
            g = layout.dense(g, ctx.channels_last)
        return Blur4Function.apply(g, ctx.taps[::-1], tpads, blur4_vjp), None, None, None


def blur4(x: torch.Tensor, taps: tuple, pads: tuple) -> torch.Tensor:
    """4-tap separable FIR blur of NCHW ``x``: ``upfirdn2d(x, outer(taps,
    taps), pad=pads)`` for taps already normalised and sqrt(gain)-scaled
    per axis (:func:`taps_1d`); ``pads`` = (p0y, p1y, p0x, p1x), each in
    [0, 3].  A true convolution, i.e. a correlation with the flipped taps.
    Differentiable to any order.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    return Blur4Function.apply(x, tuple(taps)[::-1], tuple(pads), blur4)


# The launch counter of kernel 4's VJP launches (forward launches count on
# ``blur4.launches``).
blur4_vjp = types.SimpleNamespace(launches=0)
blur4.launches = 0
# The same two counters for launches on channels-last maps.
blur4_cl = types.SimpleNamespace(launches=0)
blur4_vjp_cl = types.SimpleNamespace(launches=0)
