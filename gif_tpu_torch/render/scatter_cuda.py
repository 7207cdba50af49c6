"""Kernel 6: the bilinear scatter, the image gradient of point sampling.

Replaces the TPU kernel ``gif_tpu/render/sampler_pallas.py::_scatter_kernel``
(reached through ``scatter_bilinear_mxu`` in the backward of
``sample_at_points``).  The CUDA source is ``gif_tpu_torch/csrc/scatter.cu``;
its header says what bounds it on the H100 (memory) and how the design
meets that: the points are first listed under the windows of image rows
their taps land in, then one CTA per window accumulates its points' taps
in shared memory and writes the window once, so the image is written once
and no global atomic touches it.  Its plain version is
:func:`gif_tpu_torch.render.sampling_ops.scatter_bilinear_plain`.

Under ``torch.use_deterministic_algorithms(True)`` (the port's
``device.set_deterministic``) the accumulate step is the source's
fixed-order variant: each pixel adds its taps in point-id order, the plain
version's order, with no float atomics, so two calls give the same bits.
"""

from __future__ import annotations

import functools

import torch

from gif_tpu_torch import kernels
from gif_tpu_torch.render.sampling_ops import scatter_bilinear_plain

# Shared memory of one window, windows per batch row and channels
# (csrc/scatter.cu).
WINDOW_BYTES = 24 * 1024
MAX_WINDOWS = 1024
MAX_CHANNELS = 4
# Steps of one call, one bit each: clear the per-window counts, bin the
# points, accumulate the windows.
STEPS = ("clear", "bin", "accumulate")
ALL_PASSES = (1 << len(STEPS)) - 1
# The accumulate step in its fixed-order form (a modifier bit).
FIXED_ORDER = 1 << len(STEPS)


def scatter_launch_geometry(b: int, h: int, w: int, c: int, n_sm: int) -> dict:
    """Windows of the (b, h, w, c) image, one CTA each: whole rows where a
    row of c float32 channels fits the window (else columns split too), and
    rows cut so that the grid holds at least about ``n_sm`` CTAs.  Every
    pixel of a batch row lies in exactly one window."""
    budget = WINDOW_BYTES // 4
    if c > budget:
        raise ValueError(f"{c} channels do not fit a {WINDOW_BYTES}-byte window")
    win_cols = w if w * c <= budget else budget // c
    n_col = -(-w // win_cols)
    bands = max(1, -(-n_sm // (max(b, 1) * n_col)))
    win_rows = max(1, min(budget // (win_cols * c), -(-h // bands)))
    n_row = -(-h // win_rows)
    if n_row * n_col > MAX_WINDOWS:
        raise ValueError(f"a {h}x{w}x{c} image needs {n_row * n_col} windows, more than {MAX_WINDOWS}")
    return {"win_rows": win_rows, "win_cols": win_cols, "n_row_windows": n_row,
            "n_col_windows": n_col, "smem_bytes": 4 * win_rows * win_cols * c}


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def scatter_bilinear_cuda(g: torch.Tensor, pts: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Launch the CUDA scatter (CUDA float32 tensors only): (B, P, C)
    cotangents at (B, P, 2) points -> (B, h, w, C) float32 image, zero
    where no tap lands."""
    g, pts, bufs = scatter_buffers(g, pts, h, w, fixed_order=torch.are_deterministic_algorithms_enabled())
    launch_kernel(g, pts, bufs)
    scatter_bilinear.launches += 1
    return bufs["out"]


def scatter_buffers(g, pts, h, w, fixed_order: bool = False):
    """Checked, contiguous inputs and the output, window geometry and
    scratch of one call: per (row, window) a point count and a list of up
    to P point ids, one int32 allocation; with ``fixed_order`` a second
    list per (row, window) for the fixed-order accumulate step."""
    if g.dtype != torch.float32 or pts.dtype != torch.float32:
        raise ValueError(f"scatter kernel takes float32, got {g.dtype} / {pts.dtype}")
    b, p, c = g.shape
    if tuple(pts.shape) != (b, p, 2):
        raise ValueError(f"points {tuple(pts.shape)} do not match cotangents {tuple(g.shape)}")
    if c > MAX_CHANNELS:
        raise ValueError(f"scatter kernel takes at most {MAX_CHANNELS} channels, got {c}")
    g = g.contiguous()
    pts = pts.contiguous()
    index = g.device.index if g.device.index is not None else torch.cuda.current_device()
    geo = scatter_launch_geometry(b, h, w, c, _sm_count(index))
    n_win = geo["n_row_windows"] * geo["n_col_windows"]
    n_lists = 2 if fixed_order else 1
    counts, lists, *cells = torch.empty(b * n_win * (n_lists * p + 1), dtype=torch.int32, device=g.device).split(
        [b * n_win] + [b * n_win * p] * n_lists)
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=g.device)  # every element written
    return g, pts, {"out": out, "counts": counts, "lists": lists, "cells": cells[0] if cells else None, **geo}


def launch_kernel(g, pts, bufs, passes=ALL_PASSES):
    """Queue the steps ``passes`` selects (a bit per entry of ``STEPS``) on
    the current stream; every step reads what the earlier ones left in
    ``bufs``.  Buffers made with ``fixed_order`` run the fixed-order
    accumulate step."""
    b, p, c = g.shape
    _, h, w, _ = bufs["out"].shape
    cells = bufs["cells"]
    if cells is not None:
        passes |= FIXED_ORDER
    fn = kernels.function("gif_scatter_bilinear", 6, 10)
    err = fn(
        g.data_ptr(), pts.data_ptr(), bufs["out"].data_ptr(), bufs["counts"].data_ptr(), bufs["lists"].data_ptr(),
        None if cells is None else cells.data_ptr(),
        b, p, h, w, c, bufs["win_rows"], bufs["win_cols"], bufs["n_row_windows"], bufs["n_col_windows"], passes,
        kernels.stream_ptr(g),
    )
    kernels.check(err, "gif_scatter_bilinear")


def scatter_bilinear(g: torch.Tensor, pts: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Accumulate (B, P, C) cotangents at the bilinear taps of (B, P, 2)
    points into a zeroed (B, h, w, C) float32 image.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if g.is_cuda:
        return scatter_bilinear_cuda(g, pts, h, w)
    return scatter_bilinear_plain(g, pts, h, w)


scatter_bilinear.launches = 0
