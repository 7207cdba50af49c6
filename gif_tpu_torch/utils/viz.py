"""Sample grids, image-set dumps and animations (port of
:mod:`gif_tpu.utils.viz`).

``VisualizationSaver`` writes 10x5 grids of fixed-condition samples with
the iteration, resolution and FID in the filename —
``{iter:06d}_res{res}_fid_{fid:.2f}.png`` under ``sample/{run_id}/``, the
reference's naming, which tooling parses to plot FID curves.
``save_set_of_images`` dumps a batch as numbered PNGs and
``save_animation`` writes frames as an animated GIF.
"""

from __future__ import annotations

import os

import numpy as np


def to_uint8(images_m1p1: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8."""
    x = (np.asarray(images_m1p1) + 1.0) * 127.5
    return np.clip(x, 0, 255).astype(np.uint8)


def make_grid(images: np.ndarray, rows: int, cols: int, pad: int = 2) -> np.ndarray:
    """(N, H, W, C) -> one (rows*H', cols*W', C) grid image; unused cells
    stay 0."""
    n, h, w, c = images.shape
    grid = np.zeros((rows * (h + pad) - pad, cols * (w + pad) - pad, c), images.dtype)
    for i in range(min(n, rows * cols)):
        r, cc = divmod(i, cols)
        grid[r * (h + pad) : r * (h + pad) + h, cc * (w + pad) : cc * (w + pad) + w] = images[i]
    return grid


def save_png(path: str, img_uint8: np.ndarray) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(img_uint8).save(path)


class VisualizationSaver:
    """Fixed-condition sample grids with the FID in the filename."""

    def __init__(self, out_root: str, run_id: int, gen_i: int = 10, gen_j: int = 5):
        self.dir = os.path.join(out_root, "sample", str(run_id))
        os.makedirs(self.dir, exist_ok=True)
        self.gen_i = gen_i
        self.gen_j = gen_j
        self.flame_params = None
        self.indices = None

    def set_flame_params(self, flame_params, indices):
        self.flame_params = np.asarray(flame_params)[: self.gen_i * self.gen_j]
        self.indices = np.asarray(indices)[: self.gen_i * self.gen_j]

    def save_samples(self, iteration: int, sample_fn, resolution: int, fid: float) -> str:
        """``sample_fn(flame_params, indices)`` -> images in [-1, 1]; the
        grid is named after ``iteration + 1``."""
        imgs = sample_fn(self.flame_params, self.indices)
        grid = make_grid(to_uint8(imgs), self.gen_i, self.gen_j)
        path = os.path.join(self.dir, f"{iteration + 1:06d}_res{resolution}_fid_{fid:.2f}.png")
        save_png(path, grid)
        return path


def save_set_of_images(path: str, prefix: str, images_01: np.ndarray) -> None:
    """Numbered PNG dump ``{path}/{prefix}{i}.png`` of [0, 1] images."""
    os.makedirs(path, exist_ok=True)
    imgs = np.clip(np.asarray(images_01) * 255, 0, 255).astype(np.uint8)
    for i, img in enumerate(imgs):
        save_png(os.path.join(path, f"{prefix}{i}.png"), img)


def save_animation(frames, path: str, fps: int = 15) -> None:
    """Write uint8 frames (arrays or PIL Images) as an animated GIF; only
    ``.gif`` output is supported (no ffmpeg)."""
    from PIL import Image

    imgs = [f if isinstance(f, Image.Image) else Image.fromarray(f) for f in frames]
    if not imgs:
        raise ValueError("save_animation got no frames")
    if not path.endswith(".gif"):
        raise ValueError("only .gif output is supported without ffmpeg")
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=int(1000 / fps), loop=0)
