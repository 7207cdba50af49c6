"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib

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
