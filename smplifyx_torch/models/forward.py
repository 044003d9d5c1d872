"""Batched SMPL-X forward: blendshapes + skinning + landmarks, on tensors.

Counterpart of `smplifyx_tpu/models/forward.py`.  Skinning goes through
`ops/lbs.py::lbs_apply` (the CUDA kernel K1 on the card).  The JAX package
picks the vertex extras, the static landmarks and the annotation joints
with one-hot matmuls, a detour around slow TPU gathers; here they are
plain indexing, which computes the same values.

Output joints follow the canonical SMPL-X order: 55 skeleton joints, 21
vertex-picked extras, 51 static face landmarks, 17 contour landmarks
(= 144), optionally permuted to an annotation format by `joint_map`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import torch

from smplifyx_torch.models.bodymodel import SMPLXModel
from smplifyx_torch.ops.lbs import lbs_apply
from smplifyx_torch.ops.rotation import batch_rodrigues
from smplifyx_torch.utils.device import resolve_device
from smplifyx_torch.utils.tensors import TensorFields


@dataclass
class BodyParams(TensorFields):
    """Batched SMPL-X parameters, all [B, ...]."""

    global_orient: torch.Tensor    # [B, 3] axis-angle
    body_pose: torch.Tensor        # [B, 63] axis-angle (21 joints)
    betas: torch.Tensor            # [B, num_betas]
    expression: torch.Tensor       # [B, num_expr]
    jaw_pose: torch.Tensor         # [B, 3]
    leye_pose: torch.Tensor        # [B, 3]
    reye_pose: torch.Tensor        # [B, 3]
    left_hand_pose: torch.Tensor   # [B, C] PCA coeffs ([B, 45] without PCA)
    right_hand_pose: torch.Tensor  # [B, C]

    @classmethod
    def zeros(cls, batch: int, num_betas: int = 10, num_expr: int = 10,
              num_pca: int = 12, device="cuda") -> "BodyParams":
        dev = resolve_device(device)

        def z(*s):
            return torch.zeros((batch, *s), dtype=torch.float32, device=dev)

        return cls(
            global_orient=z(3), body_pose=z(63), betas=z(num_betas),
            expression=z(num_expr), jaw_pose=z(3), leye_pose=z(3),
            reye_pose=z(3), left_hand_pose=z(num_pca),
            right_hand_pose=z(num_pca),
        )


@dataclass
class SMPLXOutput:
    vertices: Optional[torch.Tensor]  # [B, V, 3], None if return_verts=False
    joints: torch.Tensor              # [B, K, 3] (mapped) joints
    full_pose: torch.Tensor           # [B, 3 * J] axis-angle
    body_pose: torch.Tensor           # [B, 63]
    betas: torch.Tensor
    expression: torch.Tensor
    jaw_pose: torch.Tensor
    left_hand_pose: torch.Tensor      # PCA coeffs as given
    right_hand_pose: torch.Tensor


@lru_cache(maxsize=None)
def _tree_levels(parents: tuple) -> tuple:
    """Joints grouped by tree depth: ((level_idxs, their_parents), ...)."""
    depth = [0] * len(parents)
    for j in range(1, len(parents)):
        depth[j] = depth[parents[j]] + 1
    levels = []
    for d in range(1, max(depth) + 1):
        idxs = tuple(j for j in range(len(parents)) if depth[j] == d)
        levels.append((idxs, tuple(parents[j] for j in idxs)))
    return tuple(levels)


@lru_cache(maxsize=None)
def _chain_indices(parents: tuple, device: torch.device):
    """Index tensors of the level-batched chain, made once per device so the
    hot loop issues no host-to-device copies."""
    levels = _tree_levels(parents)
    bfs_order = [0] + [j for idxs, _ in levels for j in idxs]
    pos_of = {j: i for i, j in enumerate(bfs_order)}

    def t(v):
        return torch.as_tensor(v, dtype=torch.int64, device=device)

    steps = tuple((t([pos_of[p] for p in pars]), t(list(idxs)))
                  for idxs, pars in levels)
    inverse = t([pos_of[j] for j in range(len(parents))])
    par_of = t(list(parents[1:]))
    return steps, inverse, par_of


def _rigid_transform_chain(rot_mats: torch.Tensor, joints: torch.Tensor,
                           parents) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics along the static parent tree, one batched 4x4
    product per tree level.

    rot_mats [B, J, 3, 3], joints [B, J, 3] rest positions ->
    (posed_joints [B, J, 3], A [B, J, 4, 4]) where A maps rest-pose
    vertices to posed space.
    """
    B, J = joints.shape[:2]
    steps, inverse, par_of = _chain_indices(tuple(parents), joints.device)
    rel = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, par_of]], dim=1)
    T_local = torch.cat([rot_mats, rel[..., None]], dim=-1)     # [B, J, 3, 4]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot_mats.dtype,
                          device=rot_mats.device).expand(B, J, 1, 4)
    T_local = torch.cat([T_local, bottom], dim=-2)              # [B, J, 4, 4]

    acc = T_local[:, :1]
    for par_pos, idxs in steps:
        updated = acc[:, par_pos] @ T_local[:, idxs]
        acc = torch.cat([acc, updated], dim=1)
    T_global = acc[:, inverse]

    posed_joints = T_global[..., :3, 3]
    correction = torch.einsum("bjmn,bjn->bjm", T_global[..., :3], joints)
    A = torch.cat(
        [T_global[..., :3], (T_global[..., 3] - correction)[..., None]], dim=-1
    )
    return posed_joints, A


def _head_yaw_bucket(rot_mats: torch.Tensor, neck_chain,
                     num_buckets: int) -> torch.Tensor:
    """Yaw bucket [B] for the dynamic contour landmark tables.

    Ancestors apply on the LEFT (R_global = R_root ... R_neck R_head, with
    neck_chain ordered head -> root), and the key is
    round(clamp(deg(atan2(R[2,0], sy)), max=39)) as in the public smplx
    package's find_dynamic_lmk_idx_and_bcoords.  torch.round rounds half to
    even, as jnp.round does.
    """
    B = rot_mats.shape[0]
    R = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device).expand(B, 3, 3)
    for idx in neck_chain:
        R = rot_mats[:, int(idx)] @ R
    yaw = torch.atan2(R[:, 2, 0], torch.sqrt(R[:, 0, 0] ** 2 + R[:, 1, 0] ** 2))
    deg = torch.round(torch.clamp(yaw * (180.0 / math.pi), max=39.0)).to(torch.int64)
    neg_vals = torch.where(deg < -39, torch.full_like(deg, 78), 39 - deg)
    bucket = torch.where(deg < 0, neg_vals, deg)
    return torch.clamp(bucket, 0, num_buckets - 1)


def _full_pose(params: BodyParams, J: int, components, means, use_pca: bool,
               flat_hand_mean: bool) -> torch.Tensor:
    """Family-specific full pose: SMPL-X (55 joints), SMPL-H (52), SMPL (24)."""
    if J in (52, 55):
        if use_pca:
            lhand = params.left_hand_pose @ components[0]
            rhand = params.right_hand_pose @ components[1]
        else:
            lhand, rhand = params.left_hand_pose, params.right_hand_pose
        if not flat_hand_mean:
            lhand = lhand + means[0]
            rhand = rhand + means[1]
    if J == 55:
        parts = [params.global_orient, params.body_pose, params.jaw_pose,
                 params.leye_pose, params.reye_pose, lhand, rhand]
    elif J == 52:
        parts = [params.global_orient, params.body_pose, lhand, rhand]
    elif J == 24:
        if params.body_pose.shape[-1] != 69:
            raise ValueError("SMPL expects a 69-dof body pose (23 joints)")
        parts = [params.global_orient, params.body_pose]
    else:
        raise ValueError(f"Unsupported joint count {J}")
    return torch.cat(parts, dim=-1)


def smplx_forward(
    model: SMPLXModel,
    params: BodyParams,
    *,
    use_pca: bool = True,
    flat_hand_mean: bool = False,
    use_face_contour: bool = True,
    joint_map: Optional[torch.Tensor] = None,
    return_verts: bool = True,
) -> SMPLXOutput:
    """Batched SMPL-X forward; all params [B, ...]."""
    B = params.global_orient.shape[0]
    V = model.num_verts
    J = model.num_joints
    full_pose = _full_pose(
        params, J, (model.left_hand_components, model.right_hand_components),
        (model.left_hand_mean, model.right_hand_mean), use_pca, flat_hand_mean,
    )

    shape_coeffs = torch.cat([params.betas, params.expression], dim=-1)
    shape_dirs = torch.cat([model.shapedirs, model.exprdirs], dim=-1)
    v_shaped = model.v_template + torch.einsum(
        "bk,vck->bvc", shape_coeffs, shape_dirs)
    joints_rest = torch.einsum("jv,bvc->bjc", model.J_regressor, v_shaped)

    rot_mats = batch_rodrigues(full_pose.reshape(B, J, 3))
    eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(B, (J - 1) * 9)
    v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(B, V, 3)

    posed_joints, A = _rigid_transform_chain(rot_mats, joints_rest,
                                             model.parents)

    vertices = None
    joints_out = posed_joints
    if return_verts:
        vertices = lbs_apply(model.lbs_weights, A.reshape(B, J, 16), v_posed)
        parts = [posed_joints, vertices[:, model.extra_joint_vids]]
        if model.lmk_faces_idx.shape[0] > 0:
            tri = vertices[:, model.faces[model.lmk_faces_idx]]  # [B, 51, 3, 3]
            parts.append(torch.einsum("lc,blcx->blx", model.lmk_bary_coords, tri))
        if use_face_contour and model.dyn_lmk_faces_idx.shape[1] > 0:
            bucket = _head_yaw_bucket(rot_mats, model.neck_kin_chain,
                                      model.dyn_lmk_faces_idx.shape[0])
            tri_vids = model.faces[model.dyn_lmk_faces_idx[bucket]]  # [B, 17, 3]
            lanes = torch.arange(B, device=vertices.device)[:, None, None]
            tri_d = vertices[lanes, tri_vids]                        # [B, 17, 3, 3]
            parts.append(torch.einsum(
                "blc,blcx->blx", model.dyn_lmk_bary_coords[bucket], tri_d))
        joints_out = torch.cat(parts, dim=1)

    if joint_map is not None:
        joints_out = joints_out[:, joint_map]

    return SMPLXOutput(
        vertices=vertices, joints=joints_out, full_pose=full_pose,
        body_pose=params.body_pose, betas=params.betas,
        expression=params.expression, jaw_pose=params.jaw_pose,
        left_hand_pose=params.left_hand_pose,
        right_hand_pose=params.right_hand_pose,
    )
