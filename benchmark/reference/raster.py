"""The tile-binned barycentric rasterizer in plain PyTorch (a frozen copy
of the measured program's plain version): per-tile candidate faces by
bbox overlap, capped at ``max_tris_per_tile`` with a per-tile overflow
flag; each pixel keeps the inside hit with the largest perspective depth
denominator, the lowest face id on ties.  Pixel centres at integer
coordinates, dot-product barycentrics with the degenerate guard, inside
test ``w0 > 0 and v >= 0 and u >= 0``, signed-area back-face cull.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BIG_DEPTH = 1e6
# Per-face setup table columns (csrc/raster.cu computes the same values
# per face, in the same order).
N_COEF = 16


class RasterOutput(NamedTuple):
    depth: torch.Tensor  # (B, H, W) float; BIG_DEPTH where empty
    tri_id: torch.Tensor  # (B, H, W) int32; -1 where empty
    bary: torch.Tensor  # (B, H, W, 3) float [w0, v, u]
    tile_overflow: torch.Tensor  # (B, n_tiles) bool — candidates dropped


def to_pixel_space(verts_ndc: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NDC [-1,1] -> pixel coords with positive z (min z shifted to 1)."""
    x = verts_ndc[..., 0] * (w / 2) + w / 2
    y = verts_ndc[..., 1] * (h / 2) + h / 2
    z = verts_ndc[..., 2] - verts_ndc[..., 2].amin(dim=-1, keepdim=True) + 1.0
    return torch.stack([x, y, z], dim=-1)


def _front_facing(fv: torch.Tensor) -> torch.Tensor:
    """Signed-area front-face test.  fv: (..., 3, 3) pixel-space corners."""
    p0, p1, p2 = fv[..., 0, :], fv[..., 1, :], fv[..., 2, :]
    return (p2[..., 1] - p0[..., 1]) * (p1[..., 0] - p0[..., 0]) < (
        p1[..., 1] - p0[..., 1]
    ) * (p2[..., 0] - p0[..., 0])


def auto_max_tris_per_tile(n_faces: int, n_tiles: int) -> int:
    """Mesh-derived per-tile candidate capacity: ~half the faces survive
    back-face culling, and an 8x concentration factor covers close-ups;
    rounded up to a multiple of 128, clamped to [256, n_faces]."""
    est = 8 * max(1, n_faces // max(1, n_tiles))
    est = (est + 127) // 128 * 128
    return int(min(n_faces, max(256, est)))


def bin_faces(fv: torch.Tensor, tile: int, max_per_tile: int, h: int, w: int):
    """Per-tile candidate face ids by bbox overlap.

    fv: (B, F, 3, 3) pixel-space corners.  Returns ``ids`` (B, T, K) int32
    (the first ``counts`` slots hold the tile's candidates in ascending face
    id; the rest are 0), ``counts`` (B, T) int32 and ``overflow`` (B, T)
    bool, with T = (h / tile) * (w / tile) tiles in row-major order and
    K = min(max_per_tile, F).
    """
    b, f = fv.shape[:2]
    n_ty, n_tx = h // tile, w // tile
    k = min(max_per_tile, f)
    xs, ys = fv[..., 0], fv[..., 1]
    x_min = torch.clamp(torch.ceil(xs.amin(-1)), min=0)
    x_max = torch.clamp(torch.floor(xs.amax(-1)), max=w - 1)
    y_min = torch.clamp(torch.ceil(ys.amin(-1)), min=0)
    y_max = torch.clamp(torch.floor(ys.amax(-1)), max=h - 1)
    alive = _front_facing(fv) & (x_min <= x_max) & (y_min <= y_max)

    ty = (torch.arange(n_ty, device=fv.device) * tile).to(fv.dtype)
    tx = (torch.arange(n_tx, device=fv.device) * tile).to(fv.dtype)
    oy = (y_min[:, None, :] <= ty[None, :, None] + (tile - 1)) & (
        y_max[:, None, :] >= ty[None, :, None]
    )  # (B, n_ty, F)
    ox = (x_min[:, None, :] <= tx[None, :, None] + (tile - 1)) & (
        x_max[:, None, :] >= tx[None, :, None]
    )  # (B, n_tx, F)
    mask = (oy[:, :, None, :] & ox[:, None, :, :] & alive[:, None, None, :]).reshape(
        b, n_ty * n_tx, f
    )
    n = mask.sum(-1)
    # Stable first-K compaction over the (few) overlapping pairs only:
    # nonzero() lists them row-major, i.e. ascending face id within each
    # tile, so a pair's slot is its rank inside its tile's run; pairs past
    # the cap are dropped (and flagged by ``n > k``).
    nz = mask.nonzero()  # (N, 3): batch, tile, face
    row = nz[:, 0] * (n_ty * n_tx) + nz[:, 1]
    flat_n = n.reshape(-1)
    start = torch.cumsum(flat_n, 0) - flat_n  # first pair of each tile
    slot = torch.arange(nz.shape[0], device=fv.device) - start[row]
    keep = slot < k
    ids = torch.zeros((b * n_ty * n_tx, k), dtype=torch.int32, device=fv.device)
    ids[row[keep], slot[keep]] = nz[keep, 2].to(torch.int32)
    counts = torch.clamp(n, max=k).to(torch.int32)
    return ids.reshape(b, n_ty * n_tx, k), counts, n > k


def face_table(fv: torch.Tensor) -> torch.Tensor:
    """Per-face barycentric setup, (B, F, 3, 3) -> (B, F, N_COEF) float32.

    Columns: p0x p0y v0x v0y v1x v1y dot00 dot01 dot11 inv degenerate rz0
    rz1 rz2 0 0, with v0 = p2 - p0, v1 = p1 - p0 (the reference's
    dot-product formula), inv = 1/det (0 for det == 0) and rz_i = 1/z_i.
    """
    p0, p1, p2 = fv[..., 0, :], fv[..., 1, :], fv[..., 2, :]
    v0x, v0y = p2[..., 0] - p0[..., 0], p2[..., 1] - p0[..., 1]
    v1x, v1y = p1[..., 0] - p0[..., 0], p1[..., 1] - p0[..., 1]
    dot00 = v0x * v0x + v0y * v0y
    dot01 = v0x * v1x + v0y * v1y
    dot11 = v1x * v1x + v1y * v1y
    det = dot00 * dot11 - dot01 * dot01
    degenerate = det == 0
    inv = torch.where(degenerate, 0.0, 1.0 / torch.where(degenerate, 1.0, det))
    cols = [
        p0[..., 0], p0[..., 1], v0x, v0y, v1x, v1y, dot00, dot01, dot11, inv,
        degenerate.to(det.dtype), 1.0 / p0[..., 2], 1.0 / p1[..., 2], 1.0 / p2[..., 2],
    ]
    cols += [torch.zeros_like(det)] * (N_COEF - len(cols))
    return torch.stack(cols, dim=-1).float().contiguous()


def _tile_winners(q, valid, px, py):
    """Winners of Tc tiles.  q: (Tc, K, N_COEF) candidate rows, valid:
    (Tc, K), px/py: (Tc, 1, P).  Returns (hit, slot, zd, w0, v, u), each
    (Tc, P).  Same op order as csrc/raster.cu."""
    c = [q[..., i, None] for i in range(14)]
    p0x, p0y, v0x, v0y, v1x, v1y, d00, d01, d11, inv, degen, rz0, rz1, rz2 = c
    v2x = px - p0x
    v2y = py - p0y
    dot02 = v0x * v2x + v0y * v2y
    dot12 = v1x * v2x + v1y * v2y
    u = (d11 * dot02 - d01 * dot12) * inv
    v = (d00 * dot12 - d01 * dot02) * inv
    w0 = torch.where(degen != 0, -1.0, (1.0 - u) - v)
    inside = (w0 > 0) & (v >= 0) & (u >= 0) & valid[..., None]
    zd = w0 * rz0 + v * rz1 + u * rz2
    # zdenom > 0 for every hit (z >= 1), so 0 marks "no candidate"; argmax
    # returns the first (lowest-slot = lowest face id) maximum.
    slot = torch.where(inside, zd, 0.0).argmax(dim=1, keepdim=True)  # (Tc, 1, P)

    def pick(a):
        return torch.gather(a, 1, slot).squeeze(1)

    return inside.any(dim=1), slot.squeeze(1), pick(zd), pick(w0), pick(v), pick(u)


def interpolate_face_attributes(
    tri_id: torch.Tensor, bary: torch.Tensor, face_attrs: torch.Tensor
) -> torch.Tensor:
    """Per-pixel attribute interpolation ``w0*a0 + v*a1 + u*a2``.

    tri_id: (B, H, W) int, -1 for background (which gets 0); bary:
    (B, H, W, 3); face_attrs: (B, F, 3, D).  Returns (B, H, W, D)."""
    b = tri_id.shape[0]
    safe = torch.clamp(tri_id, min=0).long().reshape(b, -1)
    corner = torch.gather(
        face_attrs.reshape(b, face_attrs.shape[1], -1),
        1,
        safe[..., None].expand(-1, -1, 3 * face_attrs.shape[-1]),
    ).reshape(tri_id.shape + face_attrs.shape[2:])  # (B, H, W, 3, D)
    out = (
        bary[..., 0:1] * corner[..., 0, :]
        + bary[..., 1:2] * corner[..., 1, :]
        + bary[..., 2:3] * corner[..., 2, :]
    )
    return torch.where((tri_id >= 0)[..., None], out, 0.0)


def rasterize_plain(
    face_verts_pix: torch.Tensor,
    face_attrs: torch.Tensor | None,
    *,
    h: int,
    w: int,
    tile: int = 32,
    max_tris_per_tile: int = 512,
    tiles_per_step: int = 8,
):
    """Plain PyTorch rasterizer.

    Args:
      face_verts_pix: (B, F, 3, 3) pixel-space corners, z > 0.
      face_attrs: None or (B, F, 3, D) per-corner attributes.
      h, w: output size (multiples of ``tile``).

    Returns:
      (RasterOutput, attr_img (B, H, W, D) or None).  ``attr_img`` is
      differentiable in ``face_attrs`` (autograd of the gather); the
      positions get no gradient.
    """
    if h % tile or w % tile:
        raise ValueError(f"image {h}x{w} is not a multiple of tile {tile}")
    fv = face_verts_pix.detach().float()
    b = fv.shape[0]
    n_tx = w // tile
    ids, counts, overflow = bin_faces(fv, tile, max_tris_per_tile, h, w)
    tab = face_table(fv)
    n_tiles = ids.shape[1]
    p = tile * tile
    dev = fv.device
    lin = torch.arange(p, device=dev)
    tix = torch.arange(n_tiles, device=dev)
    px_all = ((tix[:, None] % n_tx) * tile + lin[None, :] % tile).float()  # (T, P)
    py_all = ((tix[:, None] // n_tx) * tile + lin[None, :] // tile).float()

    zd_t = torch.zeros((b, n_tiles, p), device=dev)
    tri_t = torch.full((b, n_tiles, p), -1, dtype=torch.int32, device=dev)
    bary_t = torch.zeros((b, n_tiles, p, 3), device=dev)
    for bi in range(b):
        for t0 in range(0, n_tiles, tiles_per_step):
            sl = slice(t0, min(n_tiles, t0 + tiles_per_step))
            # Only the slots some tile of this group fills (at least one).
            kk = max(1, int(counts[bi, sl].max()))
            cid = ids[bi, sl, :kk].long()  # (Tc, kk)
            q = tab[bi][cid]  # (Tc, K, N_COEF)
            valid = torch.arange(kk, device=dev)[None, :] < counts[bi, sl, None]
            hit, slot, zd, w0, v, u = _tile_winners(
                q, valid, px_all[sl, None, :], py_all[sl, None, :]
            )
            zd_t[bi, sl] = torch.where(hit, zd, 0.0)
            tri_t[bi, sl] = torch.where(hit, torch.gather(cid, 1, slot).int(), -1)
            bary_t[bi, sl] = torch.where(hit[..., None], torch.stack([w0, v, u], -1), 0.0)

    def detile(x):
        extra = x.shape[3:]
        x = x.reshape((b, h // tile, n_tx, tile, tile) + extra)
        return x.transpose(2, 3).reshape((b, h, w) + extra)

    zd_img = detile(zd_t)
    tri = detile(tri_t)
    bary = detile(bary_t)
    depth = torch.where(tri >= 0, 1.0 / torch.where(tri >= 0, zd_img, 1.0), BIG_DEPTH)
    rast = RasterOutput(depth, tri, bary, overflow)
    attr_img = None
    if face_attrs is not None:
        attr_img = interpolate_face_attributes(tri, bary, face_attrs.float())
    return rast, attr_img
