"""Dataset augmentations with the reference's exact semantics (port of
:mod:`gif_tpu.data.augment`).

``same_padding_crop`` shifts an image by (row_crop, col_crop) pixels: for a
positive crop the content shifts up / left and the vacated band is filled
with the ORIGINAL row / column at index ``size - crop`` (a quirk of the
reference, kept exactly); for a negative crop the content shifts down /
right and the band is filled with row / column 0.

The train step renders condition maps on the device, so the same pixel
transform is applied to the rendered maps there
(``train.step.apply_condition_augment``): ``same_padding_crop_torch`` is the
batched torch twin, and horizontal flips are per-sample selects of the
width-reversed maps.
"""

from __future__ import annotations

import numpy as np
import torch

FLIPPED_LABEL_SENTINEL = -9999.0  # the label value of a flipped sample


def same_padding_crop(img: np.ndarray, row_crop: int, col_crop: int) -> np.ndarray:
    """(H, W, C) -> (H, W, C), the reference's shift-and-fill rule."""
    rows, cols = img.shape[:2]
    out = img.copy()
    if row_crop > 0:  # shift up
        out[: rows - row_crop] = img[row_crop:]
        out[rows - row_crop :] = img[rows - row_crop : rows - row_crop + 1]
    elif row_crop < 0:  # shift down
        rc = -row_crop
        out[rc:] = img[: rows - rc]
        out[:rc] = img[0:1]
    img = out.copy()
    if col_crop > 0:  # shift left
        out[:, : cols - col_crop] = img[:, col_crop:]
        out[:, cols - col_crop :] = img[:, cols - col_crop : cols - col_crop + 1]
    elif col_crop < 0:  # shift right
        cc = -col_crop
        out[:, cc:] = img[:, : cols - cc]
        out[:, :cc] = img[:, 0:1]
    return out


def shift_indices(n: int, crop: torch.Tensor) -> torch.Tensor:
    """Per-sample source indices of the shift-and-fill rule: (B,) integer
    crops -> (B, n) int64 gather indices.  A positive shift fills with row
    ``n - c``, a negative one with row 0."""
    r = torch.arange(n, device=crop.device)[None, :]
    c = crop.long()[:, None]
    pos = torch.where(r + c <= n - 1, r + c, n - c)
    neg = torch.clamp(r + c, min=0)
    return torch.clamp(torch.where(c > 0, pos, neg), 0, n - 1)


def same_padding_crop_torch(x: torch.Tensor, crops: torch.Tensor) -> torch.Tensor:
    """Batched same-padding crop: x (B, H, W, C), crops (B, 2) integers
    (row_crop, col_crop)."""
    b, h, w, c = x.shape
    row_idx = shift_indices(h, crops[:, 0])
    col_idx = shift_indices(w, crops[:, 1])
    x = torch.gather(x, 1, row_idx[:, :, None, None].expand(b, h, w, c))
    return torch.gather(x, 2, col_idx[:, None, :, None].expand(b, h, w, c))

