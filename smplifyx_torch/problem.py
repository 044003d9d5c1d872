"""Synthetic fitting problem: the port's counterpart of the JAX package's
`bench.py::build_problem`, and the port's one configuration (the slice).

Ground-truth parameters and cameras come from numpy's `default_rng(seed)`
in the same order as there, the model from `synthetic_model` (or
`smooth_synthetic_model`), and the 2D keypoints from the port's own
forward and projection.

The slice is the combined coco25 preset without the collision term, on a
synthetic model, with the guess-init camera path: `slice_config` loads it
and `build_slice` assembles session, model, joints model, frames and x0
through the entry points a user calls.
"""

from __future__ import annotations

import dataclasses
import os.path as osp

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
SLICE_OVERRIDES = dict(interpenetration=False, synthetic_model=True,
                       use_camera_prior=False, use_gender_classifier=False)
SLICE_BATCH = 128
SLICE_VERTS = 10475     # full SMPL-X width

FOCAL = 1498.0
CENTER = (400.0, 300.0)
IMG_H = 600.0
INIT_JOINTS = (9, 12, 2, 5)


def build_problem(B: int, V: int = 10475, smooth: bool = False,
                  settings: FitSettings | None = None, device="cuda"):
    """(model, settings, frames, x0, joint_map) for B synthetic frames of
    the coco25 format with hands, face and contour (K = 135)."""
    dev = resolve_device(device)
    full_f32_matmuls()
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
    gt = dataclasses.replace(
        BodyParams.zeros(B, device=dev),
        body_pose=t(rng.normal(0, 0.12, (B, 63))),
        betas=t(rng.normal(0, 0.5, (B, 10))),
        global_orient=t(rng.normal(0, 0.1, (B, 3))),
    )
    cam_t = t(np.concatenate(
        [rng.normal(0, 0.05, (B, 2)), rng.uniform(3.5, 5.5, (B, 1))], -1))
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


def slice_config(num_verts: int = SLICE_VERTS, **overrides):
    """The slice's Config; `overrides` go on top (e.g. `maxiters`)."""
    return load_config(SLICE_PRESET, **{**SLICE_OVERRIDES,
                                        "synthetic_num_verts": num_verts,
                                        **overrides})


def build_slice(batch: int = SLICE_BATCH, num_verts: int = SLICE_VERTS,
                device="cuda", **overrides):
    """(session, model, joints_model, frames, x0) for `batch` synthetic
    frames of the slice, built through `build_fit_session`."""
    session = build_fit_session(slice_config(num_verts, **overrides),
                                device=device)
    model = session.get_model("neutral")
    _, _, frames, x0, _ = build_problem(batch, num_verts,
                                        settings=session.settings,
                                        device=device)
    return session, model, build_joints_model(model), frames, x0
