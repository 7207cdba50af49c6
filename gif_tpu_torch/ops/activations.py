"""Kernel 3: fused bias + leaky-relu(0.2) + sqrt(2) gain, in Triton.

Port of :mod:`gif_tpu.ops.activations` ``fused_leaky_relu``; replaces the
TPU kernel ``gif_tpu/ops/activations.py::_flr_fwd_kernel`` (reached
through ``_pallas_rows_call`` / ``fused_leaky_relu(use_pallas=True)``).
The port keeps NCHW inside the networks, so the per-channel bias runs
along dim 1.

What bounds it on the H100: memory — one read and one write of the
activation for ~4 flops an element.  The kernel is one elementwise pass
(bf16 in and out, f32 math), each program a contiguous block of
``_BLOCK`` elements so loads and stores coalesce; the bias (<= 512 floats)
stays in L1/L2.  Forward only: the backward kernel (``_flr_bwd_kernel``)
belongs to the training slice.
"""

from __future__ import annotations

import functools
import math

import torch

_NEG_SLOPE = 0.2
_SCALE = math.sqrt(2.0)
_BLOCK = 2048


def fused_leaky_relu_plain(
    x: torch.Tensor, bias: torch.Tensor, negative_slope: float = _NEG_SLOPE, scale: float = _SCALE
) -> torch.Tensor:
    """Plain version: ``lrelu(x + bias[c]) * scale`` in f32, cast back to
    ``x``'s dtype.  x: (N, C, ...), bias: (C,)."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = x.float() + bias.float().reshape(shape)
    return (torch.where(y >= 0, y, y * negative_slope) * scale).to(x.dtype)


@functools.cache
def _triton_kernel():
    # Triton resolves the names a kernel body uses in its module's globals,
    # so ``tl`` is bound there — on first launch, never at import (CPU
    # machines have no triton).
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def flr_fwd(x_ptr, b_ptr, o_ptr, n, hw, c, neg, scale, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        x = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
        ch = (offs // hw) % c
        b = tl.load(b_ptr + ch, mask=m, other=0.0)
        y = x + b
        y = tl.where(y >= 0, y, y * neg) * scale
        tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=m)

    return flr_fwd


def fused_leaky_relu_triton(
    x: torch.Tensor, bias: torch.Tensor, negative_slope: float = _NEG_SLOPE, scale: float = _SCALE
) -> torch.Tensor:
    """Launch the Triton kernel (CUDA tensors only)."""
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"fused_leaky_relu kernel does not take {x.dtype}")
    if x.ndim < 2 or bias.shape != (x.shape[1],):
        raise ValueError(f"bias {tuple(bias.shape)} does not match x {tuple(x.shape)} on dim 1")
    x = x.contiguous()
    b = bias.float().contiguous()
    out = torch.empty_like(x)
    n = x.numel()
    hw = n // (x.shape[0] * x.shape[1]) if n else 1
    # Triton raises on a refused launch, the counterpart of the CUDA
    # wrappers' cudaGetLastError check.
    _triton_kernel()[(-(-n // _BLOCK),)](
        x, b, out, n, hw, x.shape[1], float(negative_slope), float(scale),
        BLOCK=_BLOCK, num_warps=4,
    )
    fused_leaky_relu.launches += 1
    return out


def fused_leaky_relu(
    x: torch.Tensor, bias: torch.Tensor, negative_slope: float = _NEG_SLOPE, scale: float = _SCALE
) -> torch.Tensor:
    """(x + bias[c]) -> leaky_relu -> * scale, bias along dim 1.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if x.is_cuda:
        return fused_leaky_relu_triton(x, bias, negative_slope, scale)
    return fused_leaky_relu_plain(x, bias, negative_slope, scale)


fused_leaky_relu.launches = 0
