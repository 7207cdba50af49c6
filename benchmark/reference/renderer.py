"""FLAME codes -> textured + normal conditioning maps, in plain PyTorch:
decode, scaled-orthographic projection (y and z flipped), the plain
tile-binned rasterizer with the normals and UVs interpolated, the PCA
albedo sampled at the UVs, SH9 shading."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .camera import batch_orth_proj
from .decoder import flame_decode
from .mesh import face_vertices, vertex_normals
from .raster import auto_max_tris_per_tile, rasterize_plain, to_pixel_space
from .shading import albedo_from_tex_code, grid_sample_bilinear, sh9_shading


class RenderedMaps(NamedTuple):
    textured: torch.Tensor  # (B, H, W, 3) in [0, 1]
    normal: torch.Tensor  # (B, H, W, 3) in [0, 1]
    overflow: torch.Tensor  # (B,) bool: a tile dropped candidate faces


def render_tex_and_normal(res, shapecode, expcode, posecode, texcode, lightcode, cam, *,
                          image_size=256, tile=32, max_tris_per_tile=None) -> RenderedMaps:
    b = shapecode.shape[0]
    dev, dtype = shapecode.device, shapecode.dtype
    if lightcode.ndim == 2:
        lightcode = lightcode.reshape(b, 9, 3)
    verts = flame_decode(res, shapecode, expcode, posecode)
    trans = batch_orth_proj(verts, cam)
    trans = torch.cat([trans[:, :, :1], -trans[:, :, 1:]], dim=2)
    faces = res.tensor("faces", dev, torch.long)
    if max_tris_per_tile is None:
        max_tris_per_tile = auto_max_tris_per_tile(faces.shape[0], (image_size // tile) ** 2)
    fv = face_vertices(to_pixel_space(trans, image_size, image_size), faces)
    face_norm = face_vertices(vertex_normals(trans, faces), faces)
    face_uv = res.tensor("uv_coords", dev, dtype)[faces].expand(b, -1, -1, -1)
    attrs = torch.cat([face_norm, face_uv], dim=-1)
    rast, interp = rasterize_plain(fv, attrs, h=image_size, w=image_size, tile=tile,
                                   max_tris_per_tile=max_tris_per_tile)
    pix_norm = interp[..., :3]
    pix_norm = pix_norm / torch.clamp(torch.linalg.norm(pix_norm, dim=-1, keepdim=True), min=1e-6)
    grid = interp[..., 3:5] * 2.0 - 1.0
    albedo_map = albedo_from_tex_code(res.tensor("tex_mean", dev, dtype), res.tensor("tex_dirs", dev, dtype), texcode)
    albedo = grid_sample_bilinear(albedo_map, grid)
    m3 = (rast.tri_id >= 0)[..., None]
    textured = torch.where(m3, albedo * sh9_shading(pix_norm, lightcode), 0.0)
    normal = torch.where(m3, pix_norm * 0.5 + 0.5, 0.0)
    return RenderedMaps(textured, normal, rast.tile_overflow.any(-1))
