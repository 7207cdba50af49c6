"""The run's surroundings: caches inside the checkout, the card check, the
card's name and power limit, and the guard against JAX."""

from __future__ import annotations

import os
import subprocess
import sys

from .registry import ROOT

CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "gif_tpu")


class NoCard(RuntimeError):
    """The machine holds fewer GPUs than the cell asks for."""


def pin_caches() -> None:
    """Keep every build and kernel cache in fixed directories inside the
    checkout, so only a checkout's first run builds and compiles (the CUDA
    kernels build into the program's own ``gif_tpu_torch/_build/``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"


def require_cards(count: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < count:
        raise NoCard(f"{torch.cuda.device_count()} GPU(s), the cell needs {count}")


def card_power_limit() -> str:
    """``name, power.limit`` as nvidia-smi reports them, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable: {e}"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``gif_tpu_torch`` is not ``gif_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))
