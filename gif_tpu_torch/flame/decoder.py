"""FLAME decode: blendshapes + pose correctives + linear blend skinning.

Port of :mod:`gif_tpu.flame.decoder`: ``flame_decode`` maps
``(shape(B,100), exp(B,50), pose(B,6))`` to verts (B,V,3), where pose is
[global(3) | jaw(3)] and neck/eyeball rotations default to zero;
``flame_decode_full`` adds the landmarks, ``(verts, lmk2d, lmk3d)``, with
the yaw-dependent jawline contour in ``lmk2d``.  Every stage is one
batched einsum / matmul / gather, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch


def rodrigues(rot_vecs: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3)."""
    angle = torch.linalg.norm(rot_vecs + eps, dim=-1, keepdim=True)
    axis = rot_vecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1
    ).reshape(rot_vecs.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return eye + sin * K + (1.0 - cos) * (K @ K)


def _rigid_transforms(rot_mats, joints, parents):
    """Forward-kinematics skinning transforms, SMPL/FLAME convention.

    Args:
      rot_mats: (B, J, 3, 3)
      joints: (B, J, 3) rest-pose joint locations
      parents: (J,) numpy int array

    Returns:
      A: (B, J, 4, 4) world transforms with the rest joint location
      factored out, and the posed joints (B, J, 3).
    """
    j = rot_mats.shape[1]
    rel_joints = joints.clone()
    rel_joints[:, 1:] -= joints[:, np.asarray(parents[1:])]

    top = torch.cat([rot_mats, rel_joints[..., None]], dim=-1)  # (B, J, 3, 4)
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=rot_mats.dtype, device=rot_mats.device
    ).expand(top.shape[:-2] + (1, 4))
    tfs = torch.cat([top, bottom], dim=-2)  # (B, J, 4, 4)
    # The kinematic chain is tiny (5 joints) and static — unrolled loop.
    world = [tfs[:, 0]]
    for i in range(1, j):
        world.append(world[parents[i]] @ tfs[:, i])
    world = torch.stack(world, dim=1)  # (B, J, 4, 4)

    posed_joints = world[..., :3, 3]
    # Factor out the rest joint position:  A = W - [0 | W_rot @ j_rest]
    correct = (world[..., :3, :3] @ joints[..., None])[..., 0]
    A = world.clone()
    A[..., :3, 3] -= correct
    return A, posed_joints


def flame_decode(
    res,
    shape_params: torch.Tensor,
    expression_params: torch.Tensor,
    pose_params: torch.Tensor,
    neck_pose: torch.Tensor | None = None,
    eye_pose: torch.Tensor | None = None,
) -> torch.Tensor:
    """Decode FLAME parameters to mesh vertices.

    Args:
      res: :class:`FlameResources`; its arrays are moved to the parameters'
        device once and memoized there.
      shape_params: (B, 100)
      expression_params: (B, 50)
      pose_params: (B, 6) = [global_rot(3) | jaw_rot(3)]
      neck_pose / eye_pose: optional (B, 3) / (B, 6) overrides (default 0).

    Returns:
      verts: (B, V, 3) in the parameters' dtype.
    """
    b = shape_params.shape[0]
    dtype, dev = shape_params.dtype, shape_params.device
    v_template = res.tensor("v_template", dev, dtype)
    shapedirs = res.tensor("shapedirs", dev, dtype)
    expdirs = res.tensor("expdirs", dev, dtype)
    posedirs = res.tensor("posedirs", dev, dtype)
    j_regressor = res.tensor("j_regressor", dev, dtype)
    lbs_weights = res.tensor("lbs_weights", dev, dtype)
    parents = np.asarray(res.parents)

    if neck_pose is None:
        neck_pose = torch.zeros((b, 3), dtype=dtype, device=dev)
    if eye_pose is None:
        eye_pose = torch.zeros((b, 6), dtype=dtype, device=dev)
    full_pose = torch.cat(
        [pose_params[:, :3], neck_pose, pose_params[:, 3:6], eye_pose], dim=1
    )  # (B, 15): [global, neck, jaw, eye_l, eye_r]

    v_shaped = (
        v_template[None]
        + torch.einsum("vcs,bs->bvc", shapedirs, shape_params)
        + torch.einsum("vcs,bs->bvc", expdirs, expression_params)
    )
    joints = torch.einsum("jv,bvc->bjc", j_regressor, v_shaped)

    rot_mats = rodrigues(full_pose.reshape(b, 5, 3))
    eye = torch.eye(3, dtype=dtype, device=dev)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(b, 36)
    v_posed = v_shaped + (pose_feature @ posedirs).reshape(b, -1, 3)

    A, _ = _rigid_transforms(rot_mats, joints, parents)
    # Per-vertex skinning transform: (B, V, 4, 4) = lbs_weights @ A
    T = torch.einsum("vj,bjrc->bvrc", lbs_weights, A)
    return torch.einsum("bvrc,bvc->bvr", T[..., :3, :3], v_posed) + T[..., :3, 3]


def flame_decode_landmarks(res, verts: torch.Tensor) -> torch.Tensor:
    """3-D landmarks (B, L, 3) from decoded vertices via the static (face,
    barycentric) embedding."""
    dev = verts.device
    tri = res.tensor("faces", dev, torch.long)[res.tensor("lmk_faces", dev, torch.long)]  # (L, 3)
    corner = verts[:, tri]  # (B, L, 3, 3)
    return torch.einsum("blcd,lc->bld", corner, res.tensor("lmk_bary", dev, verts.dtype))


def _dynamic_contour_bucket(pose_params: torch.Tensor, neck_pose: torch.Tensor) -> torch.Tensor:
    """Yaw bucket (B,) in [0, 78] of the jawline contour: the head yaw read
    off the neck chain's world rotation R_global @ R_neck, in 1-degree
    steps clamped to +/-39, laid out [0..39] for yaw >= 0 and [40..78]
    for yaw in [-1, -39]."""
    rel = rodrigues(pose_params[:, :3]) @ rodrigues(neck_pose)
    # Euler yaw: atan2(-R[2,0], sqrt(R[0,0]^2 + R[1,0]^2)).
    yaw = torch.atan2(-rel[:, 2, 0], torch.sqrt(rel[:, 0, 0] ** 2 + rel[:, 1, 0] ** 2))
    deg = torch.round(torch.clamp(-yaw * (180.0 / np.pi), max=39.0)).to(torch.int64)
    neg_vals = torch.where(deg < -39, 78, 39 - deg)
    return torch.where(deg < 0, neg_vals, deg)


def flame_decode_full(
    res,
    shape_params: torch.Tensor,
    expression_params: torch.Tensor,
    pose_params: torch.Tensor,
    neck_pose: torch.Tensor | None = None,
    eye_pose: torch.Tensor | None = None,
):
    """The full FLAME call: ``(verts, lmk2d, lmk3d)``.

    ``lmk3d`` is the static 68-point embedding; ``lmk2d`` replaces its 17
    jawline points with the yaw-dependent dynamic contour (the set used
    for 2-D image fitting and the landmark re-inference metric).  Both are
    3-D model-space points; callers project them with the camera.
    Resources without a dynamic contour return ``lmk3d`` twice."""
    b = shape_params.shape[0]
    if neck_pose is None:
        neck_pose = torch.zeros((b, 3), dtype=shape_params.dtype, device=shape_params.device)
    verts = flame_decode(res, shape_params, expression_params, pose_params, neck_pose, eye_pose)
    lmk3d = flame_decode_landmarks(res, verts)
    if res.dynamic_lmk_faces is None:
        return verts, lmk3d, lmk3d

    dev = verts.device
    bucket = _dynamic_contour_bucket(pose_params, neck_pose)
    dyn_faces = res.tensor("dynamic_lmk_faces", dev, torch.long)[bucket]  # (B, 17)
    dyn_bary = res.tensor("dynamic_lmk_bary", dev, verts.dtype)[bucket]  # (B, 17, 3)
    tri = res.tensor("faces", dev, torch.long)[dyn_faces]  # (B, 17, 3) vertex ids
    corner = torch.gather(
        verts, 1, tri.reshape(b, -1, 1).expand(-1, -1, 3)
    ).reshape(b, -1, 3, 3)  # (B, 17, 3, 3)
    contour = torch.einsum("blcd,blc->bld", corner, dyn_bary)
    return verts, torch.cat([contour, lmk3d[:, 17:]], dim=1), lmk3d
