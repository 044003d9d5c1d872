"""Joints-only SMPL-X forward: the full joint set without full-mesh skinning.

Counterpart of `smplifyx_tpu/models/sparse.py`.  The mapped joint set
depends on the skeleton plus a small static vertex subset (the extra-joint
vertices and the corners of every static and dynamic landmark triangle),
and rest-pose joints are linear in the shape/expression coefficients.
`build_joints_model` precomputes that reduction; `joints_forward` then runs
blendshapes, pose correctives and skinning on the subset only.  The subset
skinning is the same function as the full-mesh one, so it goes through
`ops/lbs.py::lbs_apply` (kernel K1 on the card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from smplifyx_torch.models.bodymodel import SMPLXModel
from smplifyx_torch.models.forward import (
    BodyParams,
    _full_pose,
    _head_yaw_bucket,
    _rigid_transform_chain,
)
from smplifyx_torch.ops.lbs import lbs_apply
from smplifyx_torch.ops.rotation import batch_rodrigues
from smplifyx_torch.utils.tensors import TensorFields


@dataclass
class JointsModel(TensorFields):
    """Reduced model for joints-only forwards (S = subset size)."""

    jr_template: torch.Tensor   # [J, 3] rest joints of the template
    jr_dirs: torch.Tensor       # [J, 3, K+E] rest-joint blendshape directions
    sub_template: torch.Tensor  # [S, 3]
    sub_shapedirs: torch.Tensor  # [S, 3, K+E]
    sub_posedirs: torch.Tensor  # [P, S*3]
    sub_lbs: torch.Tensor       # [S, J]
    left_hand_components: torch.Tensor
    right_hand_components: torch.Tensor
    left_hand_mean: torch.Tensor
    right_hand_mean: torch.Tensor
    extra_idx: torch.Tensor     # [21] positions within the subset
    lmk_tri_sub: torch.Tensor   # [51, 3] subset positions of landmark corners
    lmk_bary: torch.Tensor      # [51, 3]
    dyn_tri_sub: torch.Tensor   # [L, 17, 3]
    dyn_bary: torch.Tensor      # [L, 17, 3]
    parents: tuple
    neck_kin_chain: tuple
    num_joints: int


def build_joints_model(model: SMPLXModel) -> JointsModel:
    """Precompute the vertex subset and the contracted joint regressor, on
    the model's device."""
    faces = model.faces
    extra_vids = model.extra_joint_vids
    lmk_tris = faces[model.lmk_faces_idx]         # [51, 3]
    dyn_tris = faces[model.dyn_lmk_faces_idx]     # [L, 17, 3]
    subset = torch.unique(torch.cat(
        [extra_vids.reshape(-1), lmk_tris.reshape(-1), dyn_tris.reshape(-1)]))

    def to_sub(a):
        return torch.searchsorted(subset, a.contiguous())

    shape_dirs = torch.cat([model.shapedirs, model.exprdirs], dim=-1)
    jr_template = model.J_regressor @ model.v_template
    jr_dirs = torch.einsum("jv,vck->jck", model.J_regressor, shape_dirs)
    sub_cols = (subset[:, None] * 3
                + torch.arange(3, device=subset.device)[None]).reshape(-1)
    return JointsModel(
        jr_template=jr_template,
        jr_dirs=jr_dirs,
        sub_template=model.v_template[subset],
        sub_shapedirs=shape_dirs[subset],
        sub_posedirs=model.posedirs[:, sub_cols].contiguous(),
        sub_lbs=model.lbs_weights[subset].contiguous(),
        left_hand_components=model.left_hand_components,
        right_hand_components=model.right_hand_components,
        left_hand_mean=model.left_hand_mean,
        right_hand_mean=model.right_hand_mean,
        extra_idx=to_sub(extra_vids),
        lmk_tri_sub=to_sub(lmk_tris),
        lmk_bary=model.lmk_bary_coords,
        dyn_tri_sub=to_sub(dyn_tris),
        dyn_bary=model.dyn_lmk_bary_coords,
        parents=model.parents,
        neck_kin_chain=model.neck_kin_chain,
        num_joints=model.num_joints,
    )


def joints_forward(
    jm: JointsModel,
    params: BodyParams,
    *,
    use_pca: bool = True,
    flat_hand_mean: bool = False,
    use_face_contour: bool = True,
    joint_map: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B, ...] params -> mapped joints [B, K, 3], equal to
    smplx_forward(...).joints without skinning the full mesh."""
    B = params.global_orient.shape[0]
    J = jm.num_joints
    full_pose = _full_pose(
        params, J, (jm.left_hand_components, jm.right_hand_components),
        (jm.left_hand_mean, jm.right_hand_mean), use_pca, flat_hand_mean,
    )
    coeffs = torch.cat([params.betas, params.expression], dim=-1)

    joints_rest = jm.jr_template + torch.einsum("bk,jck->bjc", coeffs, jm.jr_dirs)
    rot_mats = batch_rodrigues(full_pose.reshape(B, J, 3))
    posed_joints, A = _rigid_transform_chain(rot_mats, joints_rest, jm.parents)

    eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(B, (J - 1) * 9)
    S = jm.sub_template.shape[0]
    v_shaped = jm.sub_template + torch.einsum("bk,vck->bvc", coeffs,
                                              jm.sub_shapedirs)
    v_posed = v_shaped + (pose_feature @ jm.sub_posedirs).reshape(B, S, 3)
    verts_sub = lbs_apply(jm.sub_lbs, A.reshape(B, J, 16), v_posed)

    parts = [posed_joints, verts_sub[:, jm.extra_idx]]
    if jm.lmk_tri_sub.shape[0] > 0:
        tri = verts_sub[:, jm.lmk_tri_sub]                 # [B, 51, 3, 3]
        parts.append(torch.einsum("lc,blcx->blx", jm.lmk_bary, tri))
    if use_face_contour and jm.dyn_tri_sub.shape[1] > 0:
        bucket = _head_yaw_bucket(rot_mats, jm.neck_kin_chain,
                                  jm.dyn_tri_sub.shape[0])
        lanes = torch.arange(B, device=verts_sub.device)[:, None, None]
        tri_d = verts_sub[lanes, jm.dyn_tri_sub[bucket]]   # [B, 17, 3, 3]
        parts.append(torch.einsum("blc,blcx->blx", jm.dyn_bary[bucket], tri_d))
    joints = torch.cat(parts, dim=1)
    if joint_map is not None:
        joints = joints[:, joint_map]
    return joints
