"""Orthographic camera and the eye-centering camera solver.

Port of :mod:`gif_tpu.flame.camera`: ``batch_orth_proj`` shifts xy and then
multiplies ALL THREE coordinates (z included) by the scale;
``position_to_given_location`` decodes the mesh and solves the eye-centring
camera for the whole batch with one batched pseudo-inverse.  The legacy
perspective-camera parameter dicts (``camera_ringnet``,
``camera_dynamic``, ``camera_ringnetpp``) are carried for API parity.
"""

from __future__ import annotations

import numpy as np
import torch

from gif_tpu_torch import constants as cnst
from gif_tpu_torch.flame.decoder import flame_decode

# Desired normalized eye-centre positions (x1, x2, y1, y2).
_DESIRED = np.array([-0.2419, 0.2441, 0.0501 - 0.1, 0.0509 - 0.1], np.float32)


def batch_orth_proj(X: torch.Tensor, camera: torch.Tensor) -> torch.Tensor:
    """Scaled orthographic projection: (B,N,3), (B,3)=(s,bx,by) ->
    s * [x + bx, y + by, z]."""
    cam = camera.reshape(-1, 1, 3)
    xy = X[:, :, :2] + cam[:, :, 1:]
    return cam[:, :, 0:1] * torch.cat([xy, X[:, :, 2:]], dim=2)


def solve_eye_camera(verts: torch.Tensor, eye_left: int, eye_right: int) -> torch.Tensor:
    """Solve (s, bx, by) so the two eye centres project to fixed NDC coords.

    Per sample, the least-squares solution (pseudo-inverse) of
        [e1x e2x e1y e2y]^T s + [1 1 0 0]^T s·bx + [0 0 1 1]^T s·by = desired;
    the returned scale is negated (the renderer's y-flip convention).
    Returns (B, 3) camera params.
    """
    # Clamped like the reference's gather: meshes smaller than FLAME (the
    # 503-vertex synthetic test mesh) use their last vertex for both eyes.
    last = verts.shape[1] - 1
    e1 = verts[:, min(eye_left, last), :]
    e2 = verts[:, min(eye_right, last), :]
    b = verts.shape[0]
    col_s = torch.stack([e1[:, 0], e2[:, 0], e1[:, 1], e2[:, 1]], dim=1)
    ones = verts.new_tensor([1.0, 1.0, 0.0, 0.0]).expand(b, 4)
    col_by = verts.new_tensor([0.0, 0.0, 1.0, 1.0]).expand(b, 4)
    A = torch.stack([col_s, ones, col_by], dim=2)  # (B, 4, 3)
    target = torch.as_tensor(_DESIRED, dtype=verts.dtype, device=verts.device)
    # The reference's pinv cutoff: 10 * max(m, n) * eps relative.
    pinv = torch.linalg.pinv(A, rtol=10 * 4 * torch.finfo(A.dtype).eps)
    sol = pinv @ target  # (B, 3)
    s, s_bx, s_by = sol[:, 0], sol[:, 1], sol[:, 2]
    return torch.stack([-s, s_bx / s, s_by / s], dim=1)


def position_to_given_location(res, flame_batch: torch.Tensor) -> torch.Tensor:
    """A copy of the (B, >=159) FLAME batch with the camera slice 156:159
    replaced by the eye-centring camera of its decoded mesh."""
    sh0, sh1 = cnst.INDICES["SHAPE"]
    ex0, ex1 = cnst.INDICES["EXP"]
    po0, po1 = cnst.INDICES["POSE"]
    verts = flame_decode(
        res,
        flame_batch[:, sh0:sh1],
        flame_batch[:, ex0:ex1],
        flame_batch[:, po0:po1],
    )
    cfg = cnst.DEFAULT_FLAME_CONFIG
    cam = solve_eye_camera(verts, cfg.eye_left_vertex, cfg.eye_right_vertex)
    out = flame_batch.clone()
    out[:, 156:159] = cam.to(flame_batch.dtype)
    return out


# --- Legacy perspective-camera parameter dicts -------------------------------
#
# OpenCV-style camera parameter dicts of the reference's older overlay path;
# the shipped GIF configs use only the orthographic (s, bx, by) camera above.
# Keys: c (principal point), k (distortion), f (focal), t (translation),
# r (rotation, Rodrigues).


def camera_ringnet(cam) -> dict:
    """RingNet camera vector (f, cx, cy) -> parameter dict."""
    cam = np.asarray(cam)
    return {"c": cam[1:3], "k": np.zeros(5), "f": cam[0] * np.ones(2), "t": np.zeros(3), "r": np.zeros(3)}


def camera_dynamic(h_w, translation) -> dict:
    """Resolution-scaled fixed-intrinsics camera."""
    h, w = h_w
    fscale = h / 256
    return {
        "c": np.array([w / 2, h / 2]),
        "k": np.array([-0.19816071, 0.92822711, 0.0, 0.0, 0.0]),
        "f": np.array([fscale * 4754.97941935, fscale * 4754.97941935]),
        "t": np.asarray(translation),
        "r": np.array([np.pi, 0.0, 0.0]),
    }


def camera_ringnetpp(h_w, trans, focal) -> dict:
    """RingNet++ camera with an explicit focal length."""
    h, w = h_w
    return {
        "c": np.array([w / 2, h / 2]),
        "k": np.zeros(5),
        "f": focal * np.ones(2),
        "t": np.asarray(trans),
        "r": np.array([0.0, np.pi, 0.0]),
    }
