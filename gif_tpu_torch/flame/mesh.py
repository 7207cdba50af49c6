"""Mesh math: face gathers, face / vertex normals, OBJ IO.

Port of :mod:`gif_tpu.flame.mesh`; the per-vertex accumulation is
``index_add_`` where the reference used ``segment_sum``.  ``load_obj`` /
``save_obj`` read and write the same text as the reference's.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _faces_tensor(faces, device) -> torch.Tensor:
    if isinstance(faces, torch.Tensor):
        return faces.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(faces), dtype=torch.long, device=device)


def face_vertices(vertices: torch.Tensor, faces) -> torch.Tensor:
    """Gather per-face corner values.  (B,V,D),(F,3) -> (B,F,3,D)."""
    return vertices[:, _faces_tensor(faces, vertices.device)]


def face_normals(vertices: torch.Tensor, faces, normalize: bool = True) -> torch.Tensor:
    """(B, F, 3) face normals: the cross product of two edges, unit
    length (plus 1e-10 in the norm) unless ``normalize`` is False."""
    tri = face_vertices(vertices, faces)
    n = torch.linalg.cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0])
    if normalize:
        n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-10)
    return n


def vertex_normals(vertices: torch.Tensor, faces, eps: float = 1e-6) -> torch.Tensor:
    """Area-weighted unit vertex normals.

    Args:
      vertices: (B, V, 3).
      faces: (F, 3) int, shared across the batch.

    Returns:
      (B, V, 3).  Per corner k, cross(v_{k+1}-v_k, v_{k-1}-v_k) is
      accumulated into vertex k (twice the face area times the face normal).
    """
    faces_t = _faces_tensor(faces, vertices.device)
    b, v, _ = vertices.shape
    tri = vertices[:, faces_t]  # (B, F, 3, 3)
    c0 = torch.linalg.cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0])
    c1 = torch.linalg.cross(tri[:, :, 2] - tri[:, :, 1], tri[:, :, 0] - tri[:, :, 1])
    c2 = torch.linalg.cross(tri[:, :, 0] - tri[:, :, 2], tri[:, :, 1] - tri[:, :, 2])
    contrib = torch.stack([c0, c1, c2], dim=2).reshape(b, -1, 3)  # (B, F*3, 3)
    normals = torch.zeros((b, v, 3), dtype=vertices.dtype, device=vertices.device)
    normals.index_add_(1, faces_t.reshape(-1), contrib)
    norm = torch.linalg.norm(normals, dim=-1, keepdim=True)
    return normals / torch.clamp(norm, min=eps)


def load_obj(path: str):
    """Minimal OBJ reader: (vertices (V, 3) f32, faces (F, 3) int32, uvs
    (T, 2) f32 or None, uv faces (F, 3) int32 or None), 0-based."""
    verts, uvs, faces, uv_faces = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(p) for p in parts[1:4]])
            elif parts[0] == "vt":
                uvs.append([float(p) for p in parts[1:3]])
            elif parts[0] == "f":
                fv, ft = [], []
                for p in parts[1:4]:
                    comps = p.split("/")
                    fv.append(int(comps[0]) - 1)
                    if len(comps) > 1 and comps[1]:
                        ft.append(int(comps[1]) - 1)
                faces.append(fv)
                if ft:
                    uv_faces.append(ft)
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32),
        np.asarray(uvs, np.float32) if uvs else None,
        np.asarray(uv_faces, np.int32) if uv_faces else None,
    )


def save_obj(
    path: str,
    vertices,
    faces,
    vertex_colors=None,
    texture=None,
    uvcoords=None,
    uvfaces=None,
) -> None:
    """Write a mesh as OBJ (arrays or CPU tensors):

    - plain geometry: ``save_obj(p, v, f)``;
    - per-vertex colours in [0, 1]: ``vertex_colors=rgb`` (the MeshLab
      ``v x y z r g b`` extension);
    - a textured surface: ``texture=img01, uvcoords=vt, uvfaces=ft``,
      which also writes a sibling ``.mtl`` and ``.png``.
    """
    vertices = np.asarray(vertices)
    faces = np.asarray(faces)
    textured = texture is not None
    if textured and (uvcoords is None or uvfaces is None):
        raise ValueError("texture output needs uvcoords and uvfaces")

    mtl_path = None
    if textured:
        from PIL import Image

        base = path[:-4] if path.endswith(".obj") else path
        mtl_path, png_path = base + ".mtl", base + ".png"
        img = (np.clip(np.asarray(texture), 0.0, 1.0) * 255).astype(np.uint8)
        Image.fromarray(img).save(png_path)
        with open(mtl_path, "w") as f:
            f.write("newmtl material_1\n")
            f.write(f"map_Kd {os.path.basename(png_path)}\n")

    with open(path, "w") as f:
        if textured:
            f.write(f"mtllib {os.path.basename(mtl_path)}\n")
        if vertex_colors is not None:
            for v, c in zip(vertices, np.asarray(vertex_colors)):
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f}\n")
        else:
            for v in vertices:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if textured:
            for uv in np.asarray(uvcoords).reshape(-1, 2):
                f.write(f"vt {uv[0]:.6f} {uv[1]:.6f}\n")
            f.write("usemtl material_1\n")
            for face, uvf in zip(faces, np.asarray(uvfaces)):
                f.write(f"f {face[0]+1}/{uvf[0]+1} {face[1]+1}/{uvf[1]+1} {face[2]+1}/{uvf[2]+1}\n")
        else:
            for face in faces:
                f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")
