"""Fitting energies: the SMPLify objective and the camera-init objective.

Counterpart of `smplifyx_tpu/fitting/energy.py`, batched: every function
takes flat parameters x [B, D] and per-frame data [B, ...] and returns one
value per lane [B].  Lanes are independent, so the gradient of the sum over
lanes gives each lane its own gradient.

Terms (reference SMPLifyLoss.forward, fitting.py:375-461):
  data        sum(w^2 * gmof(gt - proj)) * data_weight^2, w = joint_w * conf
  pose prior  l2 on the pose (or deviation from a regression prior, or GMM)
  shape       sum(betas^2) * w^2
  bending     angle_prior(body pose) * bending_w   (NOT squared)
  hands       sum(pca^2) * w^2 each side (or a GMM)
  expression  sum(expr^2) * w^2
  jaw         sum((jaw * jaw_w_vec)^2)
  collision   coll_loss_weight * cone penalty of the surviving triangle
              pairs (ops/collision.py), on the full mesh
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from smplifyx_torch.fitting.params import FitSettings, body_params_from_flat
from smplifyx_torch.models.bodymodel import SMPLXModel
from smplifyx_torch.models.forward import smplx_forward
from smplifyx_torch.models.sparse import joints_forward
from smplifyx_torch.ops.camera import CameraParams, project_points
from smplifyx_torch.ops.robustifier import gmof
from smplifyx_torch.priors.priors import GMMPrior, angle_prior
from smplifyx_torch.utils.tensors import TensorFields


@dataclass
class StageWeights(TensorFields):
    """Per-stage loss weights.  A schedule stacks them to [S, ...];
    `stage(k)` picks one stage (scalars, jaw [3])."""

    body_pose_weight: torch.Tensor
    shape_weight: torch.Tensor
    bending_prior_weight: torch.Tensor  # 3.17 * body_pose_weight
    hand_prior_weight: torch.Tensor
    expr_prior_weight: torch.Tensor
    jaw_prior_weight: torch.Tensor      # [3] elementwise jaw weight
    coll_loss_weight: torch.Tensor
    hand_weight: torch.Tensor           # 2D-keypoint weight for hand slots
    face_weight: torch.Tensor           # 2D-keypoint weight for face slots

    @property
    def num_stages(self) -> int:
        return self.body_pose_weight.shape[0]

    def stage(self, k: int) -> "StageWeights":
        return self.map(lambda a: a[k])


@dataclass
class FrameData(TensorFields):
    """Per-frame observations, batched [B, ...]."""

    gt_joints: torch.Tensor         # [B, K, 2] 2D keypoints
    conf: torch.Tensor              # [B, K] detection confidences
    joint_weights: torch.Tensor     # [B, K] base weights
    focal: torch.Tensor             # [B, 2]
    center: torch.Tensor            # [B, 2]
    data_weight: torch.Tensor       # [B] 1000/H
    init_joints_mask: torch.Tensor  # [B, K] 1.0 on the camera-init joints
    trans_estimation: torch.Tensor  # [B, 3] depth-regularizer target
    depth_loss_weight: torch.Tensor  # [B]
    regression_body: torch.Tensor   # [B, body_dim]


def make_camera(frames: FrameData, cam_t: torch.Tensor) -> CameraParams:
    B = cam_t.shape[0]
    eye = torch.eye(3, dtype=cam_t.dtype, device=cam_t.device).expand(B, 3, 3)
    return CameraParams(rotation=eye, translation=cam_t, focal=frames.focal,
                        center=frames.center)


def stage_joint_weights(settings: FitSettings, frames: FrameData,
                        w: StageWeights) -> torch.Tensor:
    """Per-keypoint weights [B, K] of a stage: body slots keep the base
    weights; hand and face slots are assigned the stage's hand/face weights
    wholesale (reference fit_single_frame.py:569-574)."""
    wvec = frames.joint_weights
    K = wvec.shape[-1]
    nb = settings.num_body_kp
    idx = torch.arange(K, device=wvec.device)
    if settings.use_hands:
        in_hand = (idx >= nb) & (idx < nb + 42)
        wvec = torch.where(in_hand, w.hand_weight, wvec)
    if settings.use_face:
        wvec = torch.where(idx >= nb + 42, w.face_weight, wvec)
    return wvec


def _mapped_joints(settings: FitSettings, model, params, joint_map,
                   joints_model=None) -> torch.Tensor:
    """Mapped joints via the joints-only forward when a JointsModel is given."""
    kw = dict(use_pca=settings.use_pca, flat_hand_mean=settings.flat_hand_mean,
              use_face_contour=settings.use_face_contour, joint_map=joint_map)
    if joints_model is not None:
        return joints_forward(joints_model, params, **kw)
    return smplx_forward(model, params, return_verts=True, **kw).joints


def smplify_energy_terms(
    x: torch.Tensor,
    settings: FitSettings,
    model: SMPLXModel,
    frames: FrameData,
    w: StageWeights,
    stage_idx: int,
    num_stages: int,
    decode_body: Callable[[torch.Tensor], torch.Tensor],
    joint_map: torch.Tensor,
    gmm: Optional[GMMPrior] = None,
    joints_model=None,
    lhand_gmm: Optional[GMMPrior] = None,
    rhand_gmm: Optional[GMMPrior] = None,
    collision_fn=None,
    collision_aux=None,
) -> dict:
    """Per-term SMPLify objective, each term [B] (w is one stage).

    With settings.interpenetration the full-mesh forward runs and, given a
    collision_fn, the collision term scores its vertices: on the pair list
    `collision_aux` (a broad phase hoisted out of the line search) or, when
    that is None, on a broad phase run in this evaluation.  Without it
    every term reads only the params and the mapped joints, so the
    joints-only forward serves whenever a JointsModel is given."""
    params, cam_t, body_raw = body_params_from_flat(settings, x, decode_body)
    vertices = None
    if settings.interpenetration:
        out = smplx_forward(model, params, use_pca=settings.use_pca,
                            flat_hand_mean=settings.flat_hand_mean,
                            use_face_contour=settings.use_face_contour,
                            joint_map=joint_map, return_verts=True)
        joints, vertices = out.joints, out.vertices
    else:
        joints = _mapped_joints(settings, model, params, joint_map,
                                joints_model)
    proj = project_points(make_camera(frames, cam_t), joints)   # [B, K, 2]

    joint_w = stage_joint_weights(settings, frames, w)
    weights = joint_w * frames.conf if settings.use_joints_conf else joint_w
    diff = gmof(frames.gt_joints - proj, settings.rho)
    joint_loss = (torch.sum(weights[..., None] ** 2 * diff, dim=(1, 2))
                  * frames.data_weight ** 2)

    def sq(a):
        return torch.sum(a * a, dim=-1)

    pw2 = w.body_pose_weight ** 2
    if settings.use_vposer:
        if settings.has_regression_prior and stage_idx == num_stages - 1:
            pprior = sq(body_raw - frames.regression_body) * pw2
        else:
            pprior = sq(body_raw) * pw2
    elif settings.has_regression_prior:
        pprior = sq(body_raw - frames.regression_body) * pw2
    elif settings.body_prior_type == "gmm" and gmm is not None:
        pprior = gmm(params.body_pose) * pw2
    else:
        pprior = sq(body_raw) * pw2

    shape_loss = sq(params.betas) * w.shape_weight ** 2
    bend = angle_prior(params.body_pose) * w.bending_prior_weight

    zero = torch.zeros_like(joint_loss)

    def hand_term(coeffs, prior_type, hand_gmm):
        if not settings.use_hands or prior_type == "none":
            return zero
        if prior_type == "gmm" and hand_gmm is not None:
            return hand_gmm(coeffs) * w.hand_prior_weight ** 2
        return sq(coeffs) * w.hand_prior_weight ** 2

    hand_loss = (
        hand_term(params.left_hand_pose, settings.left_hand_prior_type, lhand_gmm)
        + hand_term(params.right_hand_pose, settings.right_hand_prior_type,
                    rhand_gmm)
    )
    expr_loss = jaw_loss = zero
    if settings.use_face:
        expr_loss = sq(params.expression) * w.expr_prior_weight ** 2
        if settings.jaw_prior_type != "none":
            jaw_loss = sq(params.jaw_pose * w.jaw_prior_weight)

    pen_loss = zero
    if settings.interpenetration and collision_fn is not None:
        pen = (collision_fn(vertices) if collision_aux is None
               else collision_fn.apply(vertices, collision_aux))
        pen_loss = w.coll_loss_weight * pen

    return {
        "data": joint_loss, "pose_prior": pprior, "shape": shape_loss,
        "bending": bend, "hands": hand_loss, "expression": expr_loss,
        "jaw": jaw_loss, "collision": pen_loss,
    }


def smplify_energy(*args, **kwargs) -> torch.Tensor:
    """Full SMPLify objective per lane [B]: the sum of the terms."""
    terms = smplify_energy_terms(*args, **kwargs)
    return (terms["data"] + terms["pose_prior"] + terms["shape"]
            + terms["bending"] + terms["hands"] + terms["expression"]
            + terms["jaw"] + terms["collision"])


def camera_init_energy(
    x: torch.Tensor,
    settings: FitSettings,
    model: SMPLXModel,
    frames: FrameData,
    decode_body: Callable[[torch.Tensor], torch.Tensor],
    joint_map: torch.Tensor,
    joints_model=None,
) -> torch.Tensor:
    """Stage-0 camera objective per lane [B] (reference
    SMPLifyCameraInitLoss): squared 2D error over the camera-init joints,
    conf-weighted per `camera_conf_mode`, times data_weight^2, plus the
    squared-depth pull towards the similar-triangles estimate."""
    params, cam_t, _ = body_params_from_flat(settings, x, decode_body)
    joints = _mapped_joints(settings, model, params, joint_map, joints_model)
    proj = project_points(make_camera(frames, cam_t), joints)

    masked = (frames.gt_joints - proj) ** 2 * frames.init_joints_mask[..., None]
    if settings.camera_conf_mode == "per_joint":
        joint_loss = torch.sum(masked * frames.conf[..., None] ** 2, dim=(1, 2))
    elif settings.camera_conf_mode == "global_scale":
        # Bug-for-bug with the reference broadcast (fitting.py:509-511): the
        # conf^2 factor becomes a global scale on the data term.
        conf_sq = torch.sum((frames.conf * frames.init_joints_mask) ** 2, dim=-1)
        joint_loss = torch.sum(masked, dim=(1, 2)) * conf_sq
    else:
        joint_loss = torch.sum(masked, dim=(1, 2))
    joint_loss = joint_loss * frames.data_weight ** 2
    depth = frames.depth_loss_weight ** 2 * (
        cam_t[:, 2] - frames.trans_estimation[:, 2]) ** 2
    return joint_loss + depth


def guess_camera_depth(
    settings: FitSettings,
    model: SMPLXModel,
    x0: torch.Tensor,
    gt_joints: torch.Tensor,
    edge_idxs: torch.Tensor,
    focal_length: torch.Tensor,
    decode_body: Callable[[torch.Tensor], torch.Tensor],
    joint_map: torch.Tensor,
    joints_model=None,
) -> torch.Tensor:
    """Similar-triangles depth init (reference guess_init,
    fitting.py:36-110): x0 [B, D], gt_joints [B, K, 2], edge_idxs [E, 2],
    focal_length [B] -> [B, 3] = (0, 0, f * mean|edge3d| / mean|edge2d|)."""
    params, _, _ = body_params_from_flat(settings, x0, decode_body)
    j3d = _mapped_joints(settings, model, params, joint_map, joints_model)
    d3 = j3d[:, edge_idxs[:, 0]] - j3d[:, edge_idxs[:, 1]]
    d2 = gt_joints[:, edge_idxs[:, 0]] - gt_joints[:, edge_idxs[:, 1]]
    len3 = torch.sqrt(torch.sum(d3 ** 2, dim=-1))
    len2 = torch.sqrt(torch.sum(d2 ** 2, dim=-1))
    est_d = focal_length * (len3.mean(-1) / torch.clamp(len2.mean(-1), min=1e-9))
    zero = torch.zeros_like(est_d)
    return torch.stack([zero, zero, est_d], dim=-1)
