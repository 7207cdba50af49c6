"""Mesh rendering in PyTorch + CUDA (port of ``gif_tpu.render``).

- ``raster``: binning, per-face setup and the plain rasterizer;
- ``raster_cuda``: kernel 1, the rasterizer with fused attribute
  interpolation, and its CPU/CUDA dispatching wrapper;
- ``shading``: SH9 shading, PCA albedo and the plain bilinear sampler;
- ``sampler_cuda``: kernel 2, the albedo sampler, and its wrapper;
- ``sampling_ops``: ``sample_at_points``, the texture steal's
  differentiable point sampler (kernel 2 forward, kernel 6 backward);
- ``scatter_cuda``: kernel 6, the bilinear scatter, and its wrapper;
- ``renderer``: ``render_tex_and_normal``, FLAME codes -> condition maps,
  and the ``FlameRenderer`` façade.
"""

from gif_tpu_torch.render.raster import (
    get_visibility,
    get_visibility_z,
    interpolate_face_attributes,
    to_pixel_space,
)
from gif_tpu_torch.render.raster_cuda import rasterize
from gif_tpu_torch.render.renderer import FlameRenderer, render_tex_and_normal
from gif_tpu_torch.render.shading import albedo_from_tex_code, grid_sample_bilinear, sh9_shading

__all__ = [
    "rasterize",
    "interpolate_face_attributes",
    "to_pixel_space",
    "get_visibility",
    "get_visibility_z",
    "sh9_shading",
    "albedo_from_tex_code",
    "grid_sample_bilinear",
    "render_tex_and_normal",
    "FlameRenderer",
]
