"""FLAME decode: blendshapes + pose correctives + linear blend skinning.

Port of :mod:`gif_tpu.flame.decoder` (``flame_decode`` and its helpers):
``flame(shape(B,100), exp(B,50), pose(B,6)) -> verts(B,V,3)`` where pose is
[global(3) | jaw(3)] and neck/eyeball rotations default to zero.  Every
stage is one batched einsum / matmul, as in the reference.
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
