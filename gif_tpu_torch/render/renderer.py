"""The FLAME renderer: codes -> textured + normal conditioning maps.

Port of :mod:`gif_tpu.render.renderer` (``render_tex_and_normal``): decode
FLAME, project with the scaled-orthographic camera (y and z flipped),
rasterize once with the normals and UVs interpolated in the same pass
(kernel 1 on the card), sample the PCA albedo at the UVs (kernel 2 on the
card), and emit

  textured = albedo  *  SH9 shading                       in [0, 1]
  normal   = interpolated unit normals mapped to [0, 1]
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gif_tpu_torch.flame.camera import batch_orth_proj
from gif_tpu_torch.flame.decoder import flame_decode
from gif_tpu_torch.flame.mesh import face_vertices, vertex_normals
from gif_tpu_torch.render.raster import auto_max_tris_per_tile, to_pixel_space
from gif_tpu_torch.render.raster_cuda import rasterize_with_attrs
from gif_tpu_torch.render.sampler_cuda import grid_sample
from gif_tpu_torch.render.shading import albedo_from_tex_code, sh9_shading


class RenderedMaps(NamedTuple):
    textured: torch.Tensor  # (B, H, W, 3) in [0, 1]
    normal: torch.Tensor  # (B, H, W, 3) in [0, 1]
    mask: torch.Tensor  # (B, H, W) bool foreground
    depth: torch.Tensor  # (B, H, W)
    # True where a rasterizer tile dropped candidate triangles (its
    # max_tris_per_tile capacity overflowed) for that sample.
    overflow: torch.Tensor  # (B,) bool


def render_tex_and_normal(
    res,
    shapecode: torch.Tensor,
    expcode: torch.Tensor,
    posecode: torch.Tensor,
    texcode: torch.Tensor,
    lightcode: torch.Tensor,
    cam: torch.Tensor,
    *,
    image_size: int = 256,
    tile: int = 32,
    max_tris_per_tile: int | None = 384,
) -> RenderedMaps:
    """Render textured + normal-map conditioning images from FLAME codes.

    Args:
      res: FlameResources.
      shapecode: (B, 100); expcode: (B, 50); posecode: (B, 6).
      texcode: (B, 50) PCA texture coefficients.
      lightcode: (B, 9, 3) or (B, 27) SH lighting.
      cam: (B, 3) orthographic (s, tx, ty).
      max_tris_per_tile: per-tile candidate capacity; ``None`` sizes it from
        the mesh (raster.auto_max_tris_per_tile).  Overflow is reported per
        sample in ``RenderedMaps.overflow``.
    """
    b = shapecode.shape[0]
    dev, dtype = shapecode.device, shapecode.dtype
    if lightcode.ndim == 2:
        lightcode = lightcode.reshape(b, 9, 3)

    verts = flame_decode(res, shapecode, expcode, posecode)
    trans = batch_orth_proj(verts, cam)
    # Screen convention: flip y (and z for depth ordering).
    trans = torch.cat([trans[:, :, :1], -trans[:, :, 1:]], dim=2)

    faces = res.tensor("faces", dev, torch.long)
    if max_tris_per_tile is None:
        max_tris_per_tile = auto_max_tris_per_tile(faces.shape[0], (image_size // tile) ** 2)
    pix = to_pixel_space(trans, image_size, image_size)
    fv = face_vertices(pix, faces)

    # Attributes: normals (of the projected mesh) and UV, (B, F, 3, 5).
    normals = vertex_normals(trans, faces)
    face_norm = face_vertices(normals, faces)
    face_uv = res.tensor("uv_coords", dev, dtype)[faces].expand(b, -1, -1, -1)
    attrs = torch.cat([face_norm, face_uv], dim=-1)

    rast, interp = rasterize_with_attrs(fv, attrs, image_size, image_size, tile, max_tris_per_tile)
    pix_norm = interp[..., :3]
    pix_uv = interp[..., 3:5]
    pix_norm = pix_norm / torch.clamp(torch.linalg.norm(pix_norm, dim=-1, keepdim=True), min=1e-6)

    albedo_map = albedo_from_tex_code(
        res.tensor("tex_mean", dev, dtype), res.tensor("tex_dirs", dev, dtype), texcode
    )
    # UV in [0,1] -> grid in [-1,1].
    albedo = grid_sample(albedo_map, pix_uv * 2.0 - 1.0)

    textured = albedo * sh9_shading(pix_norm, lightcode)
    mask = rast.tri_id >= 0
    m3 = mask[..., None]
    textured = torch.where(m3, textured, 0.0)
    normal_img = torch.where(m3, pix_norm * 0.5 + 0.5, 0.0)
    return RenderedMaps(textured, normal_img, mask, rast.depth, rast.tile_overflow.any(-1))
