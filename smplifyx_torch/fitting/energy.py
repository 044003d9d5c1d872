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

from smplifyx_torch.fitting.params import (
    FitSettings,
    body_params_from_flat,
    unpack,
)
from smplifyx_torch.models import forward, sparse
from smplifyx_torch.models.bodymodel import SMPLXModel
from smplifyx_torch.ops.camera import CameraParams, project_points
from smplifyx_torch.ops.robustifier import gmof
from smplifyx_torch.priors.priors import GMMPrior, angle_prior
from smplifyx_torch.utils.graphs import segment
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


def _identity(z):
    return z


def _params(settings: FitSettings, x: torch.Tensor, body: tuple):
    """`body_params_from_flat` of x, its body pose the decoded `body[0]`,
    or x's own body segment where `body` is empty."""
    return body_params_from_flat(
        settings, x, (lambda z: body[0]) if body else _identity)


def _skinned(settings: FitSettings, model, joints_model, full_mesh: bool,
             x: torch.Tensor, decode_body, joint_map, rows_apart: bool):
    """An evaluation up to the segment that scores its keypoints: (body,
    args, mapped, verts).

    The decode (a `vposer` segment under VPoser) gives `body`: () where it
    returns x's body segment itself, which the segments then read from x,
    else the decoded pose.  The `skin_inputs` segment takes x to the
    skinning's inputs, kernel K1 skins the full mesh or, given a JointsModel
    and not `full_mesh`, the landmark subset.  `args` are the next
    segment's tensors after x and `mapped(*args)` its mapped joints: the
    skinned vertices `verts`, or with `rows_apart` the rows the keypoints
    read, gathered outside it (the collision term reads the vertices too,
    and their gradient then adds up in the eager order)."""
    z = unpack(settings, x)["body"]
    decoded = decode_body(z)
    body = () if decoded is z else (decoded,)
    fwd, fm = ((forward, model) if full_mesh or joints_model is None
               else (sparse, joints_model))
    contour = forward.has_contour(fm, settings.use_face_contour)

    def skin_inputs(x, *body):
        params, _, _ = _params(settings, x, body)
        _, rot_mats, posed_joints, A, v_posed = fwd.pose_blends(
            fm, params, settings.use_pca, settings.flat_hand_mean)
        bucket = forward.contour_bucket(fm, rot_mats, settings.use_face_contour)
        return (A, posed_joints, *(() if bucket is None else (bucket,)),
                *v_posed)

    out = segment("skin_inputs", skin_inputs, x, *body)
    A, posed_joints = out[:2]
    buckets = out[2:2 + contour]
    verts = fwd.skin(fm, A, out[2 + contour:])

    def mapped(posed_joints, *rows):
        joints = forward.keypoints(fm, posed_joints, rows)
        return joints if joint_map is None else joints[:, joint_map]

    if rows_apart:
        rows = forward.landmark_rows(fm, verts, *buckets)
        return body, (posed_joints, *rows), mapped, verts

    def mapped_verts(posed_joints, verts, *buckets):
        return mapped(posed_joints, *forward.landmark_rows(fm, verts, *buckets))

    return body, (posed_joints, verts, *buckets), mapped_verts, verts


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
    *,
    total: bool = False,
):
    """Per-term SMPLify objective, each term [B] (w is one stage); with
    `total` their sum [B] instead (`smplify_energy`).

    With settings.interpenetration the full-mesh forward runs and, given a
    collision_fn, the collision term scores its vertices: on the pair list
    `collision_aux` (a broad phase hoisted out of the line search) or, when
    that is None, on a broad phase run in this evaluation.  Without it
    every term reads only the params and the mapped joints, so the
    joints-only forward serves whenever a JointsModel is given.

    The evaluation runs as segments (utils/graphs.py); the sum is the last
    one's output, the collision term added after it, while the per-term
    dict comes from an eager last stretch (a segment gives tensors)."""
    coll = settings.interpenetration and collision_fn is not None
    body, args, mapped, verts = _skinned(
        settings, model, joints_model, settings.interpenetration, x,
        decode_body, joint_map, rows_apart=coll)
    nb = len(body)

    def energy(x, *rest):
        body, args = rest[:nb], rest[nb:]
        params, cam_t, body_raw = _params(settings, x, body)
        joints = mapped(*args)
        terms = _smplify_terms(settings, frames, w, stage_idx, num_stages,
                               gmm, lhand_gmm, rhand_gmm, params, cam_t,
                               body_raw, joints)
        if not total:
            return terms
        e = (terms["data"] + terms["pose_prior"] + terms["shape"]
             + terms["bending"] + terms["hands"] + terms["expression"]
             + terms["jaw"])
        return e if coll else e + terms["collision"]

    out = (segment("energy", energy, x, *body, *args) if total
           else energy(x, *body, *args))
    if not coll:
        return out
    pen = (collision_fn(verts) if collision_aux is None
           else collision_fn.apply(verts, collision_aux))
    pen_loss = w.coll_loss_weight * pen
    if total:
        return out + pen_loss
    out["collision"] = pen_loss
    return out


def _smplify_terms(settings, frames, w, stage_idx, num_stages, gmm,
                   lhand_gmm, rhand_gmm, params, cam_t, body_raw, joints):
    """Every term but the collision's (a zero there), each [B]."""
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

    return {
        "data": joint_loss, "pose_prior": pprior, "shape": shape_loss,
        "bending": bend, "hands": hand_loss, "expression": expr_loss,
        "jaw": jaw_loss, "collision": zero,
    }


def smplify_energy(*args, **kwargs) -> torch.Tensor:
    """Full SMPLify objective per lane [B]: the sum of the terms of
    `smplify_energy_terms`, the collision term last."""
    return smplify_energy_terms(*args, total=True, **kwargs)


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
    body, args, mapped, _ = _skinned(
        settings, model, joints_model, False, x, decode_body, joint_map,
        rows_apart=False)
    nb = len(body)

    def energy(x, *rest):
        body, args = rest[:nb], rest[nb:]
        _, cam_t, _ = _params(settings, x, body)
        joints = mapped(*args)
        proj = project_points(make_camera(frames, cam_t), joints)

        masked = ((frames.gt_joints - proj) ** 2
                  * frames.init_joints_mask[..., None])
        if settings.camera_conf_mode == "per_joint":
            joint_loss = torch.sum(masked * frames.conf[..., None] ** 2,
                                   dim=(1, 2))
        elif settings.camera_conf_mode == "global_scale":
            # Bug-for-bug with the reference broadcast (fitting.py:509-511):
            # the conf^2 factor becomes a global scale on the data term.
            conf_sq = torch.sum((frames.conf * frames.init_joints_mask) ** 2,
                                dim=-1)
            joint_loss = torch.sum(masked, dim=(1, 2)) * conf_sq
        else:
            joint_loss = torch.sum(masked, dim=(1, 2))
        joint_loss = joint_loss * frames.data_weight ** 2
        depth = frames.depth_loss_weight ** 2 * (
            cam_t[:, 2] - frames.trans_estimation[:, 2]) ** 2
        return joint_loss + depth

    return segment("energy", energy, x, *body, *args)


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
    _, args, mapped, _ = _skinned(settings, model, joints_model, False, x0,
                                  decode_body, joint_map, rows_apart=False)
    j3d = mapped(*args)
    d3 = j3d[:, edge_idxs[:, 0]] - j3d[:, edge_idxs[:, 1]]
    d2 = gt_joints[:, edge_idxs[:, 0]] - gt_joints[:, edge_idxs[:, 1]]
    len3 = torch.sqrt(torch.sum(d3 ** 2, dim=-1))
    len2 = torch.sqrt(torch.sum(d2 ** 2, dim=-1))
    est_d = focal_length * (len3.mean(-1) / torch.clamp(len2.mean(-1), min=1e-9))
    zero = torch.zeros_like(est_d)
    return torch.stack([zero, zero, est_d], dim=-1)
