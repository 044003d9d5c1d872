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
    _rigid_transform_chain,
    contour_bucket,
    keypoints,
    landmark_rows,
)
from smplifyx_torch.ops.lbs import LBSPlan, check_plan, lbs_apply, lbs_plan
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
    lbs_plan: LBSPlan           # column plan of sub_lbs (kernel K1)
    left_hand_components: torch.Tensor
    right_hand_components: torch.Tensor
    left_hand_mean: torch.Tensor
    right_hand_mean: torch.Tensor
    # The landmark tables under SMPLXModel's names, over the subset's rows,
    # so that forward.py's landmark functions read either model.
    extra_joint_vids: torch.Tensor  # [21] positions within the subset
    faces: torch.Tensor         # [51 + L * 17, 3] the landmark triangles
    lmk_faces_idx: torch.Tensor     # [51] rows of faces
    lmk_bary_coords: torch.Tensor   # [51, 3]
    dyn_lmk_faces_idx: torch.Tensor     # [L, 17] rows of faces
    dyn_lmk_bary_coords: torch.Tensor   # [L, 17, 3]
    parents: tuple
    neck_kin_chain: tuple
    num_joints: int

    def __post_init__(self):
        check_plan(self.sub_lbs, self.lbs_plan, "JointsModel")


def landmark_tables(lmk_tris: torch.Tensor, dyn_tris: torch.Tensor) -> dict:
    """A JointsModel's `faces`, `lmk_faces_idx` and `dyn_lmk_faces_idx`
    from the landmark triangles [51, 3] and the contour's [L, 17, 3] in
    subset positions."""
    n, (L, C) = lmk_tris.shape[0], dyn_tris.shape[:2]
    dev = lmk_tris.device
    return {"faces": torch.cat([lmk_tris, dyn_tris.reshape(-1, 3)]),
            "lmk_faces_idx": torch.arange(n, device=dev),
            "dyn_lmk_faces_idx": n + torch.arange(L * C, device=dev).reshape(L, C)}


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
    sub_lbs = model.lbs_weights[subset].contiguous()
    return JointsModel(
        jr_template=jr_template,
        jr_dirs=jr_dirs,
        sub_template=model.v_template[subset],
        sub_shapedirs=shape_dirs[subset],
        sub_posedirs=model.posedirs[:, sub_cols].contiguous(),
        sub_lbs=sub_lbs,
        lbs_plan=lbs_plan(sub_lbs),
        left_hand_components=model.left_hand_components,
        right_hand_components=model.right_hand_components,
        left_hand_mean=model.left_hand_mean,
        right_hand_mean=model.right_hand_mean,
        extra_joint_vids=to_sub(extra_vids),
        **landmark_tables(to_sub(lmk_tris), to_sub(dyn_tris)),
        lmk_bary_coords=model.lmk_bary_coords,
        dyn_lmk_bary_coords=model.dyn_lmk_bary_coords,
        parents=model.parents,
        neck_kin_chain=model.neck_kin_chain,
        num_joints=model.num_joints,
    )


def pose_blends(jm: JointsModel, params: BodyParams, use_pca: bool = True,
                flat_hand_mean: bool = False) -> tuple:
    """The joints-only forward up to skinning, in the layout of
    `forward.pose_blends`: (full_pose, rot_mats, posed_joints, A, (v_posed
    [B, S, 3] of the subset,))."""
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
    return full_pose, rot_mats, posed_joints, A, (v_posed,)


def skin(jm: JointsModel, A: torch.Tensor, v_posed: tuple) -> torch.Tensor:
    """The subset's skinned vertices [B, S, 3], by kernel K1 on the card."""
    B, J = A.shape[:2]
    return lbs_apply(jm.sub_lbs, A.reshape(B, J, 16), v_posed[0], jm.lbs_plan)


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
    _, rot_mats, posed_joints, A, v_posed = pose_blends(
        jm, params, use_pca, flat_hand_mean)
    joints = keypoints(jm, posed_joints, landmark_rows(
        jm, skin(jm, A, v_posed),
        contour_bucket(jm, rot_mats, use_face_contour)))
    if joint_map is not None:
        joints = joints[:, joint_map]
    return joints
