"""FLAME texture-space inverse rendering, "texture stealing", in plain
PyTorch (a frozen copy of the measured program's arithmetic): project
each valid texel's surface point, sample the image there, place the
values in UV space; visibility from the blended vertex normal.
"""

from __future__ import annotations

import numpy as np
import torch

from .camera import batch_orth_proj
from .decoder import flame_decode
from .mesh import vertex_normals
from .sampling import sample_at_points


def texel_inverse_map(res, device):
    """(texels (K,) long, entries (K,) long): the K texels of the R x R UV
    map that some valid-texel entry lands on, each with the entry it takes
    (the last one listed, as numpy's fancy assignment leaves it; the JAX
    package builds the same map).  Built with numpy once per resource set
    and device.  Both lists are free of repeats, so placing entries with
    them gathers and scatters without collisions in either direction."""
    cache = res.__dict__.get("_texel_inverse_map")
    if cache is None:
        cache = {}
        object.__setattr__(res, "_texel_inverse_map", cache)
    key = str(torch.device(device))
    if key not in cache:
        tex_res = res.tex_mean.shape[0]
        ys = np.asarray(res.texture_y_coords)
        xs = np.asarray(res.texture_x_coords)
        inv = np.full(tex_res * tex_res, -1, np.int64)
        inv[ys * tex_res + xs] = np.arange(len(ys))  # last write wins
        texels = np.flatnonzero(inv >= 0)
        cache[key] = (torch.as_tensor(texels, device=device), torch.as_tensor(inv[texels], device=device))
    return cache[key]


def steal_texture(res, source_img: torch.Tensor, verts, vnorm, cam):
    """The texture steal given decoded geometry: barycentric-blend the
    valid texels' surface points and normals, project, sample the source
    image (B, H, W, 3) at the projections, place the samples in UV space.
    Returns the texture (B, R, R, 3) in the image's dtype and the
    visibility (B, R, R, 1) bool."""
    b = source_img.shape[0]
    dev = source_img.device
    vf = res.tensor("texture_valid_faces", dev, torch.long)
    bw = res.tensor("texture_valid_bary", dev, verts.dtype)

    def blend(per_vertex):  # (B, V, D) -> (B, P, D)
        return torch.einsum("bpcd,pc->bpd", per_vertex[:, vf], bw)

    proj = batch_orth_proj(blend(verts), cam)[:, :, :2]
    proj = torch.stack([proj[..., 0], -proj[..., 1]], dim=-1)
    vals = sample_at_points(source_img, proj)  # (B, P, 3)

    tex_res = res.tex_mean.shape[0]
    texels, entries = texel_inverse_map(res, dev)

    def place(per_entry):  # (B, P, D) -> (B, R, R, D), zero off the valid set
        flat = per_entry.new_zeros((b, tex_res * tex_res) + per_entry.shape[2:])
        return flat.index_copy(1, texels, per_entry.index_select(1, entries)).reshape(
            (b, tex_res, tex_res) + per_entry.shape[2:]
        )

    texture_img = place(vals)
    vis = place(blend(vnorm)[:, :, 2:3] < 0)  # camera-facing under the y/z flip
    return texture_img, vis


def flame_texture_space(res, source_img: torch.Tensor, flame_params_full: torch.Tensor):
    """Project (B, H, W, 3) images aligned with the meshes of
    ``flame_params_full`` (B, >= 159: shape 100 | exp 50 | pose 6 | cam 3)
    back into FLAME UV space.  Returns (texture (B, R, R, 3), visibility
    (B, R, R, 1) bool)."""
    cam = flame_params_full[:, 156:159]
    verts = flame_decode(
        res, flame_params_full[:, 0:100], flame_params_full[:, 100:150], flame_params_full[:, 150:156]
    )
    trans = batch_orth_proj(verts, cam)
    trans = torch.cat([trans[:, :, :1], -trans[:, :, 1:]], dim=2)
    vnorm = vertex_normals(trans, res.tensor("faces", verts.device, torch.long))
    return steal_texture(res, source_img, verts, vnorm, cam)
