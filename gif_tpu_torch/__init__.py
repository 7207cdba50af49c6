"""gif_tpu_torch — GIF (Generative Interpretable Faces) in PyTorch + CUDA.

The PyTorch port of :mod:`gif_tpu`, which stays in the repository as the
reference it is held against.  The subpackages mirror ``gif_tpu``'s layout
(``flame/``, ``render/``, ``ops/``, ``models/``, ``eval/``, ``data/``,
``train/``, ``utils/``, ``serve.py``) so each counterpart is easy to find.

Conventions:

- imports ``torch`` and never JAX or anything of ``gif_tpu``;
- NCHW inside the networks; public functions keep ``gif_tpu``'s layout
  (condition maps and images NHWC, images in [-1, 1]);
- every TPU kernel of ``gif_tpu`` (six kernel functions, reached by the
  serving path and the run_id-8 and run_id-0 train steps) is a
  hand-written Hopper kernel (CUDA C++ under ``csrc/`` or Triton) with a
  plain PyTorch version beside it: a wrapper takes the plain
  version for CPU tensors only and launches the kernel for CUDA tensors;
  gradients are ``torch.autograd.Function``s whose backward is a kernel
  too (or, where the JAX package's VJP was plain XLA, plain torch),
  differentiable again where R1 and G's regularizers need it;
- entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
  and raise when no GPU is present (no silent CPU fallback).
"""

__version__ = "0.1.0"
