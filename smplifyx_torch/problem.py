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
"""

from __future__ import annotations

import dataclasses
import os.path as osp
import pickle
import tempfile

import numpy as np
import torch

from smplifyx_torch.fitting.energy import FrameData
from smplifyx_torch.fitting.params import FitSettings, pack
from smplifyx_torch.models.bodymodel import smooth_synthetic_model, synthetic_model
from smplifyx_torch.models.forward import BodyParams, smplx_forward
from smplifyx_torch.models.joint_mapping import model_to_annotation
from smplifyx_torch.models.sparse import build_joints_model
from smplifyx_torch.ops.camera import CameraParams, project_points
from smplifyx_torch.session import build_fit_session
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
INIT_JOINTS = (9, 12, 2, 5)


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


def build_problem(B: int, V: int = 10475, smooth: bool = False,
                  settings: FitSettings | None = None, device="cuda",
                  model=None):
    """(model, settings, frames, x0, joint_map) for B synthetic frames of
    the coco25 format with hands, face and contour (K = 135), on `model`
    or, without one, on the synthetic (smooth) model of V vertices."""
    dev = resolve_device(device)
    full_f32_matmuls()
    if model is None:
        make = smooth_synthetic_model if smooth else synthetic_model
        model = make(num_verts=V, seed=0, device=dev)
    settings = settings or FitSettings(use_face_contour=True)
    joint_map = torch.as_tensor(
        model_to_annotation("smplx", True, True, True, "coco25"),
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
        init_joints_mask=t(np.isin(np.arange(K), INIT_JOINTS)
                           .astype(np.float32)[None].repeat(B, 0)),
        trans_estimation=t(np.zeros((B, 3))),
        depth_loss_weight=t(np.full((B,), 1e2)),
        regression_body=t(np.zeros((B, 63))),
    )
    z3 = t(np.zeros((B, 3)))
    x0 = pack(settings, cam_t=z3, global_orient=z3, body=t(np.zeros((B, 63))))
    return model, settings, frames, x0, joint_map


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
