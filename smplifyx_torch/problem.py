"""Synthetic fitting problem: the port's counterpart of the JAX package's
`bench.py::build_problem`, and the port's one configuration (the slice).

Ground-truth parameters and cameras come from numpy's `default_rng(seed)`
in the same order as there, the model from `synthetic_model` (or
`smooth_synthetic_model`), and the 2D keypoints from the port's own
forward and projection.

The slice is the combined coco25 preset, collision term included (body
stages 1-2), with the guess-init camera path, on `slice_model`: the
vertices and skinning of `smooth_synthetic_model` (capsules around a
human skeleton) with a locally triangulated surface, and a part
segmentation derived from its skinning (`slice_part_segm`), passed as
`part_segm_fn` the way a user passes `smplx_parts_segm.pkl`.  The
generators' own faces join vertices of equal height across the whole body
(`smooth_synthetic_model`) or at random (`synthetic_model`), so their
triangles overlap by the ten thousand and every broad-phase budget
saturates; with random parts, so do the overlaps where neighbouring
capsules meet.  Saturated, the surviving pair set hangs on f32 noise.  `slice_config` loads it,
`slice_session` builds its session and model, and `build_slice` assembles
session, model, joints model, frames and x0 through the entry points a
user calls.  With `interpenetration=False` among the overrides it is the
collision-off fit on `synthetic_model`.

`write_app_inputs` writes the same problem as the files a user of the app
has (an SMPL-X .npz, a part segmentation, a VPoser checkpoint, images,
OpenPose keypoint JSONs, ExPose and PIXIE results), for `app.run` and
`python -m smplifyx_torch.cli`.

`video_problem` builds the JAX package's batched video-sequence example
(`examples/video_batch.py`) on the example's synthetic model or, at full
width, on the slice's model.
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
import pickle
import struct
import tempfile
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from smplifyx_torch.evaluation.metrics import procrustes_v2v
from smplifyx_torch.fitting.energy import FrameData
from smplifyx_torch.fitting.lbfgs import LBFGSConfig
from smplifyx_torch.fitting.params import FitSettings, pack
from smplifyx_torch.fitting.pipeline import FitOptions
from smplifyx_torch.fitting.stages import build_stage_schedule
from smplifyx_torch.models.bodymodel import (
    SHAPE_SPACE_DIM,
    SMPLXModel,
    load_body_model,
    smooth_synthetic_model,
    synthetic_model,
)
from smplifyx_torch.models.forward import BodyParams, smplx_forward
from smplifyx_torch.models.joint_mapping import model_to_annotation
from smplifyx_torch.models.sparse import build_joints_model
from smplifyx_torch.models.vposer import random_params
from smplifyx_torch.ops.camera import CameraParams, project_points
from smplifyx_torch.ops.collision import make_collision_fn, synthetic_part_segm
from smplifyx_torch.ops.rotation import batch_rodrigues
from smplifyx_torch.session import _identity, build_fit_session
from smplifyx_torch.utils.config import load_config
from smplifyx_torch.utils.device import full_f32_matmuls, resolve_device

SLICE_PRESET = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                        "cfg", "fit_smplx_combined_coco25.yaml")
SLICE_OVERRIDES = dict(synthetic_model=True, use_camera_prior=False,
                       use_gender_classifier=False)
SLICE_BATCH = 128
SLICE_VERTS = 10475     # full SMPL-X width

FOCAL = 1498.0
CENTER = (400.0, 300.0)
IMG_H = 600.0
IMG_W = 800.0
APP_PRESET = osp.join(osp.dirname(SLICE_PRESET),
                      "fit_smplx_combined_vposer_coco25.yaml")
INIT_JOINTS = (9, 12, 2, 5)
# The same four joints (hips, shoulders) in each keypoint format.
INIT_JOINTS_BY_FORMAT = {"coco25": INIT_JOINTS, "halpe": (12, 11, 6, 5)}


def _ground_truth(rng, B, dev):
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    gt = dataclasses.replace(
        BodyParams.zeros(B, device=dev),
        body_pose=t(rng.normal(0, 0.12, (B, 63))),
        betas=t(rng.normal(0, 0.5, (B, 10))),
        global_orient=t(rng.normal(0, 0.1, (B, 3))),
    )
    cam_t = t(np.concatenate(
        [rng.normal(0, 0.05, (B, 2)), rng.uniform(3.5, 5.5, (B, 1))], -1))
    return gt, cam_t


def ground_truth(B: int, device="cuda") -> BodyParams:
    """The ground-truth body parameters of `build_problem`'s B frames."""
    return _ground_truth(np.random.default_rng(0), B, resolve_device(device))[0]


def ground_truth_meshes(model, B: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(vertices [B, V, 3], skeleton joints [B, J, 3]) of the first B
    ground-truth poses on `model`, on the model's device."""
    dev = model.lbs_weights.device
    with torch.no_grad():
        out = smplx_forward(model, ground_truth(B, dev))
    return out.vertices, out.joints[:, :model.num_joints]


def fit_meshes(model, settings: FitSettings, decode_body,
               x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(vertices, skeleton joints) of fitted flat parameters x [B, D]."""
    from smplifyx_torch.fitting.pipeline import recover_outputs

    out, _, _ = recover_outputs(model, settings, x, decode_body,
                                device=x.device)
    return out.vertices, out.joints[:, :model.num_joints]


def lane_errors_mm(fit_v, gt_v, fit_j, gt_j, parts) -> dict:
    """Per-lane errors in mm on the inputs' device: PA-V2V over all
    vertices and over each part of `parts` (a PartVertexIds; each part
    aligned on its own, as the EHF protocol does), and PA-MPJPE over the
    joints."""
    def pa(a, b):
        return 1000.0 * procrustes_v2v(a, b).mean(-1)

    out = {"pa_v2v": pa(fit_v, gt_v)}
    for name in ("body", "face", "left_hand", "right_hand"):
        ids = torch.as_tensor(getattr(parts, name), device=fit_v.device)
        out[f"pa_v2v_{name}"] = pa(fit_v[:, ids], gt_v[:, ids])
    out["pa_mpjpe"] = pa(fit_j, gt_j)
    return out


def build_problem(B: int, V: int = 10475, smooth: bool = False,
                  settings: FitSettings | None = None, device="cuda",
                  model=None, keypoint_format: str = "coco25"):
    """(model, settings, frames, x0, joint_map) for B synthetic frames of
    the coco25 format with hands, face and contour (K = 135), on `model`
    or, without one, on the synthetic (smooth) model of V vertices.
    `keypoint_format="halpe"` projects the Halpe-26 body joints instead
    (K = 136)."""
    dev = resolve_device(device)
    full_f32_matmuls()
    if model is None:
        make = smooth_synthetic_model if smooth else synthetic_model
        model = make(num_verts=V, seed=0, device=dev)
    settings = settings or FitSettings(use_face_contour=True)
    joint_map = torch.as_tensor(
        model_to_annotation("smplx", True, True, True, keypoint_format),
        dtype=torch.int64, device=dev)
    K = joint_map.shape[0]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    rng = np.random.default_rng(0)
    gt, cam_t = _ground_truth(rng, B, dev)
    focal = t(np.full((B, 2), FOCAL))
    center = t(np.broadcast_to(np.asarray(CENTER), (B, 2)))
    with torch.no_grad():
        joints = smplx_forward(model, gt, joint_map=joint_map).joints
        eye = torch.eye(3, device=dev).expand(B, 3, 3)
        gt2d = project_points(CameraParams(eye, cam_t, focal, center), joints)
    conf = t(rng.uniform(0.3, 1.0, (B, K)))

    frames = FrameData(
        gt_joints=gt2d, conf=conf, joint_weights=t(np.ones((B, K))),
        focal=focal, center=center,
        data_weight=t(np.full((B,), 1000.0 / IMG_H)),
        init_joints_mask=t(np.isin(np.arange(K),
                                   INIT_JOINTS_BY_FORMAT[keypoint_format])
                           .astype(np.float32)[None].repeat(B, 0)),
        trans_estimation=t(np.zeros((B, 3))),
        depth_loss_weight=t(np.full((B,), 1e2)),
        regression_body=t(np.zeros((B, 63))),
    )
    z3 = t(np.zeros((B, 3)))
    x0 = pack(settings, cam_t=z3, global_orient=z3, body=t(np.zeros((B, 63))))
    return model, settings, frames, x0, joint_map


def family_problem(model, settings: FitSettings, joint_map: torch.Tensor,
                   B: int, seed: int = 0):
    """(frames, x0) of B synthetic frames for a model of any family (SMPL-X,
    SMPL-H or SMPL), on the model's device: the inputs of the JAX
    package's family fits (tests/test_model_families.py::_fit_family).
    Ground-truth body poses from `default_rng(seed)` (settings.body_pose_dof
    of them), the camera 4 m away (focal 1000, centre (320, 240)), every
    keypoint of `joint_map` seen with confidence 1."""
    dev = model.faces.device
    dof, K = settings.body_pose_dof, joint_map.shape[0]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    rng = np.random.default_rng(seed)
    gt = dataclasses.replace(BodyParams.zeros(B, device=dev),
                             body_pose=t(rng.normal(0, 0.1, (B, dof))))
    focal = t(np.full((B, 2), 1000.0))
    center = t(np.broadcast_to(np.asarray([320.0, 240.0]), (B, 2)))
    with torch.no_grad():
        joints = smplx_forward(model, gt, joint_map=joint_map,
                               use_face_contour=False).joints
        cam = CameraParams(torch.eye(3, device=dev).expand(B, 3, 3),
                           t(np.tile([[0.0, 0.0, 4.0]], (B, 1))), focal, center)
        gt2d = project_points(cam, joints)
    frames = FrameData(
        gt_joints=gt2d, conf=t(np.ones((B, K))), joint_weights=t(np.ones((B, K))),
        focal=focal, center=center, data_weight=t(np.full((B,), 1000.0 / 480)),
        init_joints_mask=t(np.isin(np.arange(K), INIT_JOINTS)
                           .astype(np.float32)[None].repeat(B, 0)),
        trans_estimation=t(np.zeros((B, 3))),
        depth_loss_weight=t(np.full((B,), 1e2)),
        regression_body=t(np.zeros((B, dof))),
    )
    z3 = t(np.zeros((B, 3)))
    x0 = pack(settings, cam_t=z3, global_orient=z3, body=t(np.zeros((B, dof))))
    return frames, x0


def multihost_problem(batch: int, num_verts: int = 64, device="cuda") -> dict:
    """The global problem of the multi-host dry run, the inputs of the JAX
    package's `__graft_entry__.py::dryrun_multihost`: `batch` frames on
    `synthetic_model(num_verts, seed=0)`, ground-truth body poses from
    `default_rng(0)` seen 4 m away (focal 1000, centre (320, 240)), every
    coco25 keypoint with confidence 1, the two-stage schedule and two
    L-BFGS iterations per stage.  Every rank builds it whole from the seed
    and keeps its own rows.  Returns `fit_batch`'s arguments by name
    (model, settings, options, stage_weights, frames, x0, decode_body,
    joint_map, edge_idxs)."""
    dev = resolve_device(device)
    full_f32_matmuls()
    B = batch
    model = synthetic_model(num_verts=num_verts, seed=0, device=dev)
    settings = FitSettings(use_face_contour=True)
    joint_map = torch.as_tensor(
        model_to_annotation("smplx", True, True, True, "coco25"),
        dtype=torch.int64, device=dev)
    K = joint_map.shape[0]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    rng = np.random.default_rng(0)
    gt = dataclasses.replace(BodyParams.zeros(B, device=dev),
                             body_pose=t(rng.normal(0, 0.1, (B, 63))))
    focal = t(np.full((B, 2), 1000.0))
    center = t(np.tile([[320.0, 240.0]], (B, 1)))
    with torch.no_grad():
        joints = smplx_forward(model, gt, joint_map=joint_map).joints
        cam = CameraParams(torch.eye(3, device=dev).expand(B, 3, 3),
                           t(np.tile([[0.0, 0.0, 4.0]], (B, 1))), focal, center)
        gt2d = project_points(cam, joints)
    frames = FrameData(
        gt_joints=gt2d, conf=t(np.ones((B, K))), joint_weights=t(np.ones((B, K))),
        focal=focal, center=center, data_weight=t(np.full((B,), 1000.0 / 480)),
        init_joints_mask=t(np.isin(np.arange(K), INIT_JOINTS)
                           .astype(np.float32)[None].repeat(B, 0)),
        trans_estimation=t(np.zeros((B, 3))),
        depth_loss_weight=t(np.full((B,), 1e2)),
        regression_body=t(np.zeros((B, 63))),
    )
    z3 = t(np.zeros((B, 3)))
    lbfgs = LBFGSConfig(max_iters=2, history=4, max_ls=4)
    return dict(
        model=model, settings=settings,
        options=FitOptions(lbfgs=lbfgs, camera_lbfgs=lbfgs),
        stage_weights=build_stage_schedule(
            [4.04e2, 4.78], shape_weights=[1e2, 5.0], expr_weights=[1e2, 5.0],
            hand_pose_prior_weights=[1e2, 5.0], hand_joints_weights=[0.0, 1.0],
            face_joints_weights=[0.0, 1.0], device=dev),
        frames=frames,
        x0=pack(settings, cam_t=z3, global_orient=z3,
                body=t(np.zeros((B, 63)))),
        decode_body=_identity, joint_map=joint_map,
        edge_idxs=torch.as_tensor([[5, 12], [2, 9]], device=dev))


VIDEO_EDGES = ((5, 12), (2, 9))     # the guess-init torso edges


@dataclass
class VideoProblem:
    """A batched video sequence and everything `fit_batch` takes for it
    (`video_problem`)."""

    model: SMPLXModel
    joints_model: object
    settings: FitSettings
    options: FitOptions
    schedule: object            # StageWeights, 3 body stages
    frames: FrameData
    x0: torch.Tensor            # [B, D] zeros
    joint_map: torch.Tensor     # [K] coco25 with hands, face and contour
    edge_idxs: torch.Tensor     # [2, 2]
    collision_fn: object        # ops/collision.py CollisionFn
    gt: BodyParams              # the sequence's poses
    camera: CameraParams        # the cameras that saw them
    x_gt: torch.Tensor          # [B, D] the poses and camera translations packed
    gt_vertices: torch.Tensor   # [B, V, 3] ground-truth meshes
    gt_joints: torch.Tensor     # [B, J, 3] ground-truth skeleton joints
    decode_body: object = _identity

    @property
    def device(self) -> torch.device:
        return self.x0.device


def video_problem(num_frames: int, num_verts: int = 1024,
                  model_kind: str = "synthetic", device="cuda") -> VideoProblem:
    """The batched video sequence of the JAX package's
    `examples/video_batch.py`, built in its order: a smooth sinusoidal
    body-pose track over `num_frames` frames (`freq` and `phase` from
    `default_rng(0)` and `(1)`, 0.15 sin(freq t + phase) over
    linspace(0, 2 pi, B)) seen 4 m away (focal 1000, centre (320, 240)),
    its 2D joints through `smplx_forward` and `project_points`, every
    keypoint with confidence 1, a zero x0, three body stages with the
    collision term in each (`coll_loss_weights` [0, 0.1, 1]), the JAX
    LBFGSConfig defaults (strong Wolfe, a broad phase every iteration) at
    40 iterations per stage (20 for the camera), and the collision term at
    sigma 1e-3 with the part pairs "9,16" and "9,17" ignored.

    `model_kind` "synthetic" is the example itself:
    `synthetic_model(num_verts, seed=0)` and `synthetic_part_segm(F,
    seed=2)`; its random faces saturate the broad phase's budgets at the
    example's width, as in JAX.  "slice" puts the sequence on
    `slice_model(num_verts)` with `slice_part_segm`, whose local faces keep
    every budget below saturation at full width (V=10475)."""
    dev = resolve_device(device)
    full_f32_matmuls()
    B = num_frames
    if model_kind == "synthetic":
        model = synthetic_model(num_verts=num_verts, seed=0, device=dev)
        segm, parents = synthetic_part_segm(int(model.faces.shape[0]), seed=2)
    elif model_kind == "slice":
        model = slice_model(num_verts, dev)
        segm, parents = slice_part_segm(model)
    else:
        raise ValueError(f"model_kind={model_kind!r}: 'synthetic' or 'slice'")
    settings = FitSettings(interpenetration=True)
    joint_map = torch.as_tensor(
        model_to_annotation("smplx", True, True, True, "coco25"),
        dtype=torch.int64, device=dev)
    K = joint_map.shape[0]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    # ---- animate: smooth sinusoidal pose trajectory
    tt = np.linspace(0, 2 * np.pi, B, dtype=np.float32)[:, None]
    freq = np.random.default_rng(0).uniform(0.5, 2.0, (1, 63)).astype(np.float32)
    phase = np.random.default_rng(1).uniform(0, np.pi, (1, 63)).astype(np.float32)
    poses = 0.15 * np.sin(freq * tt + phase)
    gt = dataclasses.replace(BodyParams.zeros(B, device=dev), body_pose=t(poses))
    cam_t = t(np.tile([[0.0, 0.0, 4.0]], (B, 1)))
    focal = t(np.full((B, 2), 1000.0))
    center = t(np.broadcast_to(np.asarray([320.0, 240.0]), (B, 2)))
    camera = CameraParams(torch.eye(3, device=dev).expand(B, 3, 3), cam_t,
                          focal, center)
    with torch.no_grad():
        out = smplx_forward(model, gt, joint_map=joint_map)
        gt2d = project_points(camera, out.joints)
        skeleton = smplx_forward(model, gt).joints[:, :model.num_joints]

    frames = FrameData(
        gt_joints=gt2d, conf=t(np.ones((B, K))), joint_weights=t(np.ones((B, K))),
        focal=focal, center=center, data_weight=t(np.full((B,), 1000.0 / 480)),
        init_joints_mask=t(np.isin(np.arange(K), INIT_JOINTS)
                           .astype(np.float32)[None].repeat(B, 0)),
        trans_estimation=t(np.zeros((B, 3))),
        depth_loss_weight=t(np.full((B,), 1e2)),
        regression_body=t(np.zeros((B, 63))),
    )
    z3 = t(np.zeros((B, 3)))
    collision_fn = make_collision_fn(
        model.faces, segm=segm, parents=parents,
        ign_part_pairs=["9,16", "9,17"], sigma=1e-3)
    schedule = build_stage_schedule(
        [4.04e2, 57.4, 4.78], coll_loss_weights=[0.0, 0.1, 1.0],
        hand_joints_weights=[0.0, 0.0, 1.0],
        face_joints_weights=[0.0, 0.0, 1.0], device=dev)
    options = FitOptions(
        lbfgs=LBFGSConfig(max_iters=40, history=12, ls_soft_accept=6),
        camera_lbfgs=LBFGSConfig(max_iters=20, history=8, ls_soft_accept=6))
    return VideoProblem(
        model=model, joints_model=build_joints_model(model),
        settings=settings, options=options, schedule=schedule,
        frames=frames,
        x0=pack(settings, cam_t=z3, global_orient=z3, body=t(np.zeros((B, 63)))),
        joint_map=joint_map,
        edge_idxs=torch.as_tensor(VIDEO_EDGES, device=dev),
        collision_fn=collision_fn, gt=gt, camera=camera,
        x_gt=pack(settings, cam_t=cam_t, global_orient=z3, body=gt.body_pose),
        gt_vertices=out.vertices, gt_joints=skeleton)


def slice_model(num_verts: int = SLICE_VERTS, device="cuda"):
    """`smooth_synthetic_model(num_verts, seed=0)` with each face rebuilt
    from its first vertex and that vertex's two nearest rest-pose
    neighbours (float64 numpy on the host, so every device gets the same
    faces): small triangles on the capsules' surfaces."""
    model = smooth_synthetic_model(num_verts=num_verts, seed=0, device="cpu")
    vt = model.v_template.numpy().astype(np.float64)
    f0 = model.faces[:, 0].numpy()
    sq = (vt * vt).sum(1)
    nearest = np.empty((len(f0), 2), np.int64)
    for lo in range(0, len(f0), 1024):
        a = f0[lo:lo + 1024]
        d2 = sq[a][:, None] + sq[None, :] - 2.0 * vt[a] @ vt.T
        d2[np.arange(len(a)), a] = np.inf
        part = np.argpartition(d2, 2, axis=1)[:, :2]
        dist = np.take_along_axis(d2, part, 1)
        nearest[lo:lo + 1024] = np.take_along_axis(
            part, np.argsort(dist, axis=1, kind="stable"), 1)
    faces = torch.as_tensor(np.stack([f0, nearest[:, 0], nearest[:, 1]], 1))
    return dataclasses.replace(model, faces=faces).to(resolve_device(device))


def slice_part_segm(model):
    """Part of each face: the joint that skins its first vertex most; its
    parent part: that joint's kinematic parent (the root is its own), the
    schema of smplx_parts_segm.pkl.  Faces where two capsules meet then
    belong to a part and its parent, which FilterFaces drops."""
    part = model.lbs_weights.argmax(1)[model.faces[:, 0]].cpu().numpy()
    parents = np.maximum(np.asarray(model.parents), 0)[part]
    return part.astype(np.int32), parents.astype(np.int32)


def slice_config(num_verts: int = SLICE_VERTS, **overrides):
    """The slice's Config; `overrides` go on top (e.g. `maxiters`)."""
    return load_config(SLICE_PRESET, **{**SLICE_OVERRIDES,
                                        "synthetic_num_verts": num_verts,
                                        **overrides})


def slice_session(num_verts: int = SLICE_VERTS, device="cuda", **overrides):
    """(session, model) of the slice, built through `build_fit_session`.
    With the collision term on, the model is `slice_model` and its part
    segmentation is read from a pickle written for the purpose."""
    cfg = slice_config(num_verts, **overrides)
    if not cfg.interpenetration:
        session = build_fit_session(cfg, device=device)
        return session, session.get_model("neutral")
    model = slice_model(num_verts, device)
    segm, parents = slice_part_segm(model)
    with tempfile.TemporaryDirectory() as tmp:
        path = osp.join(tmp, "parts_segm.pkl")
        with open(path, "wb") as f:
            pickle.dump({"segm": segm, "parents": parents}, f)
        session = build_fit_session(
            dataclasses.replace(cfg, part_segm_fn=path), model=model,
            device=device)
    return session, model


def build_slice(batch: int = SLICE_BATCH, num_verts: int = SLICE_VERTS,
                device="cuda", **overrides):
    """(session, model, joints_model, frames, x0) for `batch` synthetic
    frames of the slice."""
    session, model = slice_session(num_verts, device, **overrides)
    _, _, frames, x0, _ = build_problem(
        batch, num_verts, settings=session.settings, device=device,
        model=model)
    return session, model, build_joints_model(model), frames, x0


# ---------------------------------------------------------------- app inputs


def write_smplx_npz(model: SMPLXModel, path: str) -> None:
    """`model` in the published SMPL-X .npz layout (shape and expression
    packed in `shapedirs` at columns 0 and SHAPE_SPACE_DIM, `posedirs`
    [V, 3, P], `kintree_table`, `weights`, `f`, hand PCA, landmark
    tables); `load_body_model` reads its arrays back exactly.  Extra joint
    vertex ids are not part of the layout: the loader takes the family's."""
    m = model.to("cpu")
    V, K, E = m.num_verts, m.num_betas, m.num_expr
    shapedirs = np.zeros((V, 3, SHAPE_SPACE_DIM + E), np.float32)
    shapedirs[..., :K] = m.shapedirs.numpy()
    shapedirs[..., SHAPE_SPACE_DIM:] = m.exprdirs.numpy()
    parents = np.asarray(m.parents, np.int64)
    np.savez(
        path, v_template=m.v_template.numpy(), shapedirs=shapedirs,
        posedirs=m.posedirs.numpy().T.reshape(V, 3, -1),
        J_regressor=m.J_regressor.numpy(), weights=m.lbs_weights.numpy(),
        f=m.faces.numpy().astype(np.uint32),
        kintree_table=np.stack([np.where(parents < 0, 2**32 - 1, parents),
                                np.arange(len(parents))]).astype(np.uint32),
        hands_componentsl=m.left_hand_components.numpy(),
        hands_componentsr=m.right_hand_components.numpy(),
        hands_meanl=m.left_hand_mean.numpy(),
        hands_meanr=m.right_hand_mean.numpy(),
        lmk_faces_idx=m.lmk_faces_idx.numpy(),
        lmk_bary_coords=m.lmk_bary_coords.numpy(),
        dynamic_lmk_faces_idx=m.dyn_lmk_faces_idx.numpy(),
        dynamic_lmk_bary_coords=m.dyn_lmk_bary_coords.numpy(),
    )


def png_bytes(width: int, height: int) -> bytes:
    """A valid PNG of a black RGB image."""
    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    row = b"\x00" * (1 + 3 * width)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(row * height))
            + chunk(b"IEND", b""))


def openpose_person(kp: np.ndarray, **extra) -> dict:
    """Keypoints [K, 3] of the coco25 (or halpe) format with hands, face
    and contour (25 (26) body, 21 + 21 hand, 51 landmark, 17 contour rows)
    -> one person of an OpenPose JSON: face rows 0:17 the contour, 17:68
    the landmarks, 68:70 (pupils) zero."""
    kp = np.asarray(kp, np.float32)
    n = len(kp) - 110       # body rows
    face = np.zeros((70, 3), np.float32)
    face[17:68], face[:17] = kp[n + 42:n + 93], kp[n + 93:n + 110]

    def flat(a):
        return [float(v) for v in a.reshape(-1)]

    return {"person_id": [-1], "pose_keypoints_2d": flat(kp[:n]),
            "hand_left_keypoints_2d": flat(kp[n:n + 21]),
            "hand_right_keypoints_2d": flat(kp[n + 21:n + 42]),
            "face_keypoints_2d": flat(face), **extra}


@dataclass
class AppInputs:
    overrides: dict     # config fields that point the app at the files
    names: list         # frame names, in the dataset's order
    model: SMPLXModel   # the model as load_body_model reads it back (CPU)
    frames: object      # FrameData of the problem the files hold (CPU)


def write_app_inputs(root: str, batch: int = SLICE_BATCH,
                     num_verts: int = SLICE_VERTS, seed: int = 0,
                     genders=None, keypoint_format: str = "coco25"
                     ) -> AppInputs:
    """Write `batch` frames of the slice's problem as a user's files under
    `root`:

        models/smplx/SMPLX_NEUTRAL.npz   slice_model(num_verts)
        parts_segm.pkl                   its part segmentation
        vposer.pt                        a VPoser v1 state_dict, random_params(seed)
        data/images/<name>.png           800x600 headers
        data/keypoints/<name>_keypoints.json
        expose/<name>.jpg/<name>.jpg_params.npz
        pixie/<name>/<name>_param.pkl

    The keypoints and confidences are `build_problem`'s on the model read
    back from the .npz.  The regression results are the ground-truth
    poses (as rotation matrices) and cameras with noise from `seed`:
    ExPose's translation in its f=5000 convention, PIXIE's camera and box
    consistent with FOCAL.  `genders` (one per frame) adds `gender_pd`.
    `keypoint_format="halpe"` writes Halpe-26 body keypoints (the presets
    with `format: halpe` read them)."""
    model_dir = osp.join(root, "models", "smplx")
    for d in ("models/smplx", "data/images", "data/keypoints", "expose", "pixie"):
        os.makedirs(osp.join(root, d), exist_ok=True)
    model = slice_model(num_verts, "cpu")
    npz = osp.join(model_dir, "SMPLX_NEUTRAL.npz")
    write_smplx_npz(model, npz)
    loaded = load_body_model(npz, "smplx", device="cpu")
    segm, parents = slice_part_segm(model)
    segm_path = osp.join(root, "parts_segm.pkl")
    with open(segm_path, "wb") as f:
        pickle.dump({"segm": segm, "parents": parents}, f)
    vposer_path = osp.join(root, "vposer.pt")
    torch.save(random_params(seed), vposer_path)

    _, _, frames, _, _ = build_problem(batch, model=loaded, device="cpu",
                                       keypoint_format=keypoint_format)
    gt, cam_t = _ground_truth(np.random.default_rng(0), batch, "cpu")
    rng = np.random.default_rng(seed)
    body = gt.body_pose.numpy().reshape(batch, 21, 3)
    orient = gt.global_orient.numpy()
    cam = cam_t.numpy().astype(np.float64)
    kps = torch.cat([frames.gt_joints, frames.conf[..., None]], -1).numpy()
    png = png_bytes(int(IMG_W), int(IMG_H))

    def rotmats(aa):
        return batch_rodrigues(torch.as_tensor(aa, dtype=torch.float32)).numpy()

    names = [f"frame_{i:04d}" for i in range(batch)]
    for i, name in enumerate(names):
        with open(osp.join(root, "data", "images", name + ".png"), "wb") as f:
            f.write(png)
        extra = {} if genders is None else {"gender_pd": genders[i]}
        with open(osp.join(root, "data", "keypoints",
                           name + "_keypoints.json"), "w") as f:
            json.dump({"version": 1.3,
                       "people": [openpose_person(kps[i], **extra)]}, f)
        noisy = body[i] + rng.normal(0, 0.05, (21, 3))
        tx, ty, tz = cam[i] + rng.normal(0, 0.02, 3)
        exp_dir = osp.join(root, "expose", name + ".jpg")
        os.makedirs(exp_dir, exist_ok=True)
        np.savez(osp.join(exp_dir, name + ".jpg_params.npz"),
                 body_pose=rotmats(noisy),
                 global_orient=rotmats(orient[i][None]),
                 transl=np.array([tx, ty, tz * 5000.0 / FOCAL], np.float32),
                 center=np.asarray(CENTER, np.float32))
        # A square box of side b about the image centre and a scale s with
        # 2 * FOCAL / (s * int(1.1 * b)) = tz.
        b = 400.0
        s = 2.0 * FOCAL / (tz * int(b * 1.1))
        pix_dir = osp.join(root, "pixie", name)
        os.makedirs(pix_dir, exist_ok=True)
        with open(osp.join(pix_dir, name + "_param.pkl"), "wb") as f:
            pickle.dump({
                "body_pose": rotmats(body[i] + rng.normal(0, 0.05, (21, 3))),
                "global_pose": rotmats(orient[i][None])[0],
                "bbox": np.array([CENTER[0] - b / 2, CENTER[1] - b / 2,
                                  CENTER[0] + b / 2, CENTER[1] + b / 2],
                                 np.float32),
                "body_cam": np.array([s, tx, ty], np.float32),
            }, f)
    overrides = dict(
        data_folder=osp.join(root, "data"),
        model_folder=osp.join(root, "models"),
        part_segm_fn=segm_path,
        expose_results_directory=osp.join(root, "expose"),
        pixie_results_directory=osp.join(root, "pixie"),
        vposer_ckpt=vposer_path,
        use_gender_classifier=False,
    )
    return AppInputs(overrides=overrides, names=names, model=loaded,
                     frames=frames)
