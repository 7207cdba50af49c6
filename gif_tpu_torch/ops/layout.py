"""The two memory formats of the kernels' 4-D maps, and the copies between
them.

The generator keeps its maps NCHW-contiguous.  The discriminator runs
channels-last: NCHW-shaped tensors with NHWC strides
(``torch.channels_last``), which cuDNN convolves, forward and backward to
any order, on its NHWC kernels without converting.  Kernels 3, 4 and 5
take either format natively and pick their device code by the input's
own strides (:func:`is_channels_last`); an operand in neither format, or
a gradient in another format than the input it belongs to, is copied by
:func:`dense`, and every such copy counts on ``layout_copies.copies``.
A conv weight's gradient is brought back to its parameter's strides by
:func:`like`, counted apart.
"""

from __future__ import annotations

import types

import torch


def is_channels_last(t: torch.Tensor) -> bool:
    """True for a 4-D tensor with dense NHWC strides that is not also
    NCHW-contiguous (one that is both, as with a single channel or 1 x 1
    maps, has one memory order and takes the NCHW path)."""
    return t.dim() == 4 and not t.is_contiguous() and t.is_contiguous(memory_format=torch.channels_last)


def dense(t: torch.Tensor, channels_last: bool) -> torch.Tensor:
    """``t`` itself when it is dense in the format asked for (NHWC strides
    when ``channels_last``, else NCHW), else a copy in that format, counted
    on ``layout_copies.copies``."""
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    if t.is_contiguous(memory_format=fmt):
        return t
    layout_copies.copies += 1
    return t.contiguous(memory_format=fmt)


def like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it has ``ref``'s strides, else a copy with them,
    counted on ``layout_copies.weight_grads`` (a conv weight's gradient
    from a channels-last map, brought to its OIHW parameter's strides)."""
    if t.stride() == ref.stride():
        return t
    layout_copies.weight_grads += 1
    return torch.empty_like(ref, dtype=t.dtype).copy_(t)


# ``copies``: the copies the kernel wrappers made to bring an operand to a
# kernel's format; ``weight_grads``: the copies :func:`like` made.
layout_copies = types.SimpleNamespace(copies=0, weight_grads=0)
