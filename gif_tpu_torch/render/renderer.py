"""The FLAME renderer: codes -> textured + normal conditioning maps.

Port of :mod:`gif_tpu.render.renderer` (``render_tex_and_normal``): decode
FLAME, project with the scaled-orthographic camera (y and z flipped),
rasterize once with the normals and UVs interpolated in the same pass
(kernel 1 on the card), sample the PCA albedo at the UVs (kernel 2 on the
card), and emit

  textured = albedo  *  SH9 shading                       in [0, 1]
  normal   = interpolated unit normals mapped to [0, 1]

``constant_albedo`` replaces the PCA albedo with a grey level: the
bilinear lookup of a constant map is the level times the weight of the
taps inside the map, computed here without a texture (no kernel-2
launch).  :class:`FlameRenderer` is the reference ``OverLayViz`` façade.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gif_tpu_torch.flame.camera import batch_orth_proj
from gif_tpu_torch.flame.decoder import flame_decode
from gif_tpu_torch.flame.mesh import face_vertices, vertex_normals
from gif_tpu_torch.render.raster import auto_max_tris_per_tile, to_pixel_space
from gif_tpu_torch.render.raster_cuda import raster_backend as _resolve_backend
from gif_tpu_torch.render.raster_cuda import rasterize_with_attrs
from gif_tpu_torch.render.sampler_cuda import grid_sample
from gif_tpu_torch.render.shading import albedo_from_tex_code, sh9_shading


OVERFLOW_MESSAGE = (
    "rasterizer tile overflow: candidate triangles were dropped; "
    "raise max_tris_per_tile (or pass max_tris_per_tile=None for "
    "mesh-derived auto-sizing)"
)


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
    constant_albedo: float | None = None,
    assert_no_overflow: bool = False,
    raster_backend: str = "auto",
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
      constant_albedo: if set, this grey level replaces the PCA albedo.
      assert_no_overflow: raise ``RuntimeError`` if any tile dropped
        triangles; the check reads the flags back to the host, so only
        this switch makes the call wait on the device.
      raster_backend: ``auto`` (kernel 1 on CUDA tensors, the plain
        rasterizer on CPU ones), or force ``cuda`` / ``plain``; the
        environment variable ``GIF_TPU_TORCH_RASTER`` overrides it, for
        entry points that do not pass it
        (:func:`gif_tpu_torch.render.raster_cuda.raster_backend`).
    """
    backend = _resolve_backend(raster_backend)
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

    rast, interp = rasterize_with_attrs(fv, attrs, image_size, image_size, tile, max_tris_per_tile, backend)
    pix_norm = interp[..., :3]
    pix_uv = interp[..., 3:5]
    pix_norm = pix_norm / torch.clamp(torch.linalg.norm(pix_norm, dim=-1, keepdim=True), min=1e-6)

    # UV in [0,1] -> grid in [-1,1].
    grid = pix_uv * 2.0 - 1.0
    if constant_albedo is None:
        albedo_map = albedo_from_tex_code(
            res.tensor("tex_mean", dev, dtype), res.tensor("tex_dirs", dev, dtype), texcode
        )
        albedo = grid_sample(albedo_map, grid)
    else:
        albedo = constant_map_sample(float(constant_albedo), grid, res.tex_mean.shape[0])

    textured = albedo * sh9_shading(pix_norm, lightcode)
    mask = rast.tri_id >= 0
    m3 = mask[..., None]
    textured = torch.where(m3, textured, 0.0)
    normal_img = torch.where(m3, pix_norm * 0.5 + 0.5, 0.0)
    overflow = rast.tile_overflow.any(-1)
    if assert_no_overflow and bool(overflow.any()):
        raise RuntimeError(OVERFLOW_MESSAGE)
    return RenderedMaps(textured, normal_img, mask, rast.depth, overflow)


def constant_map_sample(value: float, grid: torch.Tensor, r: int) -> torch.Tensor:
    """The bilinear lookup (zeros padding, ``align_corners=False``) of an
    (r, r, 3) map filled with ``value`` at ``grid`` (B, H, W, 2): each tap
    of :func:`shading.grid_sample_bilinear` contributes ``value`` where it
    lies inside the map, 0 outside, in the same order.  (B, H, W, 3)."""
    gx = (grid[..., 0] + 1.0) * (r / 2.0) - 0.5
    gy = (grid[..., 1] + 1.0) * (r / 2.0) - 0.5
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    dx = (gx - x0)[..., None]
    dy = (gy - y0)[..., None]

    def tap(yy, xx):
        inside = (yy >= 0) & (yy <= r - 1) & (xx >= 0) & (xx <= r - 1)
        return torch.where(inside, value, 0.0)[..., None]

    out = (
        tap(y0, x0) * (1 - dx) * (1 - dy)
        + tap(y0, x0 + 1) * dx * (1 - dy)
        + tap(y0 + 1, x0) * (1 - dx) * dy
        + tap(y0 + 1, x0 + 1) * dx * dy
    )
    return out.expand(out.shape[:-1] + (3,))


class FlameRenderer:
    """The reference ``OverLayViz`` façade over
    :func:`render_tex_and_normal`."""

    def __init__(self, res, image_size: int = 256):
        self.res = res
        self.image_size = image_size

    def get_flame_faces(self) -> torch.Tensor:
        return self.res.tensor("faces", "cpu", torch.long)

    def get_rendered_mesh(self, flame_params, camera_params, constant_albedo=None):
        """(shape, exp, pose, light, tex), cam -> (normal, textured), both
        floored onto the 8-bit grid in [0, 1]."""
        shape, exp, pose, light, tex = flame_params
        maps = render_tex_and_normal(
            self.res, shape, exp, pose, tex, light, camera_params,
            image_size=self.image_size, constant_albedo=constant_albedo,
        )
        textured = torch.floor(torch.clamp(maps.textured, 0.0, 1.0) * 255.0) / 255.0
        normal = torch.floor(torch.clamp(maps.normal, 0.0, 1.0) * 255.0) / 255.0
        return normal, textured
