"""Condition-map rendering for the generator (port of the render half of
:mod:`gif_tpu.train.step`: ``render_flame_maps``, ``quantize_condition``
and ``render_condition_maps``).  The train step itself is not ported yet.
"""

from __future__ import annotations

import torch

from gif_tpu_torch import constants as cnst
from gif_tpu_torch.render.renderer import RenderedMaps, render_tex_and_normal
from gif_tpu_torch.train.config import TrainConfig
from gif_tpu_torch.utils.image import resize_bilinear


def render_flame_maps(
    res, flame_params: torch.Tensor, image_size: int, max_tris_per_tile: int | None = None
) -> RenderedMaps:
    """Raster the 236-d DECA layout (shape/exp/pose/cam/tex/lit slices of
    ``constants.DECA_IDX``) into raw textured + normal maps."""
    b = flame_params.shape[0]
    tex0, tex1 = cnst.DECA_IDX["tex"]
    lit0, lit1 = cnst.DECA_IDX["lit"]
    cam0, cam1 = cnst.DECA_IDX["cam"]
    return render_tex_and_normal(
        res,
        flame_params[:, 0:100],
        flame_params[:, 100:150],
        flame_params[:, 150:156],
        flame_params[:, tex0:tex1],
        flame_params[:, lit0:lit1].reshape(b, 9, 3),
        flame_params[:, cam0:cam1],
        image_size=image_size,
        max_tris_per_tile=max_tris_per_tile,
    )


def quantize_condition(textured, normal, cfg: TrainConfig) -> torch.Tensor:
    """Raw render maps -> [-1, 1] condition maps floored onto the 8-bit
    grid (the reference's PNG round trip), resized first to the training
    resolution when ``render_image_size != max_size``."""
    if cfg.render_image_size != cfg.max_size:
        textured = resize_bilinear(textured, cfg.max_size, cfg.max_size)
        normal = resize_bilinear(normal, cfg.max_size, cfg.max_size)
    rend = torch.floor(torch.clamp(textured, 0.0, 1.0) * 255.0) / 255.0
    norm = torch.floor(torch.clamp(normal, 0.0, 1.0) * 255.0) / 255.0
    parts = []
    if cfg.rendered_flame_as_condition:
        parts.append(rend * 2.0 - 1.0)
    if cfg.normal_maps_as_cond:
        parts.append(norm * 2.0 - 1.0)
    return torch.cat(parts, dim=-1)


def render_condition_maps(
    res,
    flame_params: torch.Tensor,
    cfg: TrainConfig,
    max_tris_per_tile: int | None = None,
    return_overflow: bool = False,
):
    """FLAME 236-d params -> quantized [-1, 1] NHWC condition maps; with
    ``return_overflow`` also the per-sample (B,) raster overflow flags."""
    maps = render_flame_maps(res, flame_params, cfg.render_image_size, max_tris_per_tile)
    cond = quantize_condition(maps.textured, maps.normal, cfg)
    if return_overflow:
        return cond, maps.overflow
    return cond
