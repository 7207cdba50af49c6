"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib
import os

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and no
    GPU is present — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


def second_order_safe(device: torch.device):
    """Context for a backward pass that differentiates convolutions twice
    (R1's grad-of-grad).  On the CPU it turns oneDNN off: its bf16 conv
    double backward is wrong for stride-1 convs whose output is the size
    of their input (the 3x3 pad-1 convs of D; ~50% error in the weight
    gradient of R1, seen with PyTorch 2.13's CPU build), while PyTorch's
    native CPU convolution is right.  Elsewhere it changes nothing."""
    if device.type == "cpu":
        return torch.backends.mkldnn.flags(enabled=False)
    return contextlib.nullcontext()


def set_tf32_policy() -> None:
    """Full-precision float32 on the card: TF32 off for both cuBLAS matmuls
    and cuDNN convolutions (cuDNN defaults to TF32).  The bf16 conv stack
    is unaffected; f32 work (FLAME, demodulation, ToRGB skips, render)
    keeps float32 accuracy, as the JAX reference computes it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# cuBLAS workspace settings under which its matmuls are deterministic
# (CUDA's reproducibility notes; PyTorch checks the same two).
DETERMINISTIC_CUBLAS = (":4096:8", ":16:8")


def set_deterministic(enabled: bool) -> None:
    """Make every run of the same step give the same bits on the card, or
    stop doing so.  On: cuDNN picks deterministic algorithms and no
    benchmarked ones, and ``torch.use_deterministic_algorithms(True)``
    makes ``index_add_`` take its sorted path, raises on any op that has
    no deterministic form, and sends kernel 6 (the bilinear scatter) to
    its fixed-order variant.

    cuBLAS reads ``CUBLAS_WORKSPACE_CONFIG`` once, when it creates its
    handle, so the variable must be set before the process's first
    matmul; this raises when it is not one of :data:`DETERMINISTIC_CUBLAS`
    rather than set it too late to matter.  Off restores PyTorch's
    defaults (cuDNN's ``benchmark`` stays off, as the port never sets
    it)."""
    if enabled and os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in DETERMINISTIC_CUBLAS:
        raise RuntimeError(
            "deterministic mode needs CUBLAS_WORKSPACE_CONFIG set to one of "
            f"{DETERMINISTIC_CUBLAS} before the process starts (cuBLAS reads it when it "
            f"creates its handle); it is {os.environ.get('CUBLAS_WORKSPACE_CONFIG')!r}"
        )
    torch.backends.cudnn.deterministic = enabled
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(enabled)
