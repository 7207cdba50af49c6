"""Mesh math: face gathers and area-weighted vertex normals.

Port of :mod:`gif_tpu.flame.mesh` (``face_vertices``, ``vertex_normals``);
the per-vertex accumulation is ``index_add_`` where the reference used
``segment_sum``.
"""

from __future__ import annotations

import numpy as np
import torch


def _faces_tensor(faces, device) -> torch.Tensor:
    if isinstance(faces, torch.Tensor):
        return faces.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(faces), dtype=torch.long, device=device)


def face_vertices(vertices: torch.Tensor, faces) -> torch.Tensor:
    """Gather per-face corner values.  (B,V,D),(F,3) -> (B,F,3,D)."""
    return vertices[:, _faces_tensor(faces, vertices.device)]


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
