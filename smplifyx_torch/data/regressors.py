"""Regression-prior loading: ExPose / PIXIE / PARE results as pose and
camera initialisers.

The port's copy of `smplifyx_tpu/data/regressors.py` (reference main.py:
283-293, fit_single_frame.py:209-235, 359-401):
  * result files: PIXIE `<img>/<img>_param.pkl`, ExPose
    `<img>.jpg/<img>.jpg_params.npz`, PARE `<img>.pkl`;
  * rotation matrices -> intrinsic-xyz Euler pose, through the port's
    `ops/rotation.py::euler_xyz_from_rotmat` on CPU tensors;
  * the 'combined' splice: ExPose body joints [:19] + PIXIE [19:21];
  * camera-translation initialisers from the regressors' weak-perspective
    cameras.
"""

from __future__ import annotations

import os.path as osp
import pickle
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from smplifyx_torch.ops.rotation import euler_xyz_from_rotmat


@dataclass
class RegressionPrior:
    """Per-frame regression-prior data, host-side."""

    body_pose: np.ndarray           # [63] intrinsic-xyz Euler pose
    global_orient: np.ndarray       # [3]
    init_translation: Optional[np.ndarray] = None  # [3] camera init
    center: Optional[np.ndarray] = None            # [2] principal point


def rotmats_to_pose(rotmats: np.ndarray) -> np.ndarray:
    """[J, 3, 3] -> [J*3] intrinsic-xyz Euler pose (reference pose
    extraction, fit_single_frame.py:211-234)."""
    R = torch.as_tensor(np.asarray(rotmats, np.float32))
    return euler_xyz_from_rotmat(R).numpy().reshape(-1)


def _load_pickle(path: str):
    try:
        import joblib

        return joblib.load(path)
    except Exception:
        with open(path, "rb") as f:
            return pickle.load(f, encoding="latin1")


def load_expose(expose_dir: str, img_name: str, ext: str = ".jpg") -> dict:
    """ExPose names its folder and file after `<img>.jpg` whatever the
    image's own extension (kept from the JAX package)."""
    path = osp.join(expose_dir, img_name + ext, img_name + ext + "_params.npz")
    return dict(np.load(path, allow_pickle=True))


def load_pixie(pixie_dir: str, img_name: str) -> dict:
    return _load_pickle(osp.join(pixie_dir, img_name, img_name + "_param.pkl"))


def load_pare(pare_dir: str, img_name: str) -> dict:
    return _load_pickle(osp.join(pare_dir, img_name + ".pkl"))


def pixie_bbox_camera(pixie: dict, focal_length: float) -> tuple[np.ndarray, np.ndarray]:
    """PIXIE weak-perspective -> (init_t [3], center [2])
    (fit_single_frame.py:370-390)."""
    left, top, right, bottom = np.asarray(pixie["bbox"], np.float64)
    old_size = max(right - left, bottom - top)
    center = np.array([right - (right - left) / 2.0,
                       bottom - (bottom - top) / 2.0])
    b = int(old_size * 1.1)
    pred = np.asarray(pixie["body_cam"]).reshape(-1)
    s = float(pred[0])
    tz = 2.0 * focal_length / (s * b + 1e-9)
    return (np.array([pred[1], pred[2], tz], np.float32),
            np.array([center[0], center[1]], np.float32))


def pare_camera(pare: dict, focal_length: float) -> tuple[np.ndarray, np.ndarray]:
    """PARE weak-perspective -> (init_t, center) (fit_single_frame.py:360-369)."""
    RES = 224
    cx, cy, b, _ = np.asarray(pare["bboxes"][0], np.float64)
    pred_cam = np.asarray(pare["pred_cam"][0], np.float64)
    r = b / RES
    tz = (2.0 * focal_length) / (r * RES * pred_cam[0])
    return (np.array([pred_cam[1], pred_cam[2], tz], np.float32),
            np.array([cx, cy], np.float32))


def expose_camera(expose: dict, focal_length: float) -> tuple[np.ndarray, np.ndarray]:
    """ExPose translation rescaled from its f=5000 convention
    (fit_single_frame.py:391-398)."""
    transl = np.asarray(expose["transl"], np.float64).reshape(-1).copy()
    transl[-1] /= 5000.0 / focal_length
    center = np.asarray(expose["center"], np.float32).reshape(2)
    return transl.astype(np.float32), center


def build_regression_prior(
    kind: str,
    focal_length: float,
    expose: Optional[dict] = None,
    pixie: Optional[dict] = None,
    pare: Optional[dict] = None,
    use_camera_prior: bool = True,
) -> RegressionPrior:
    """Assemble the pose and camera initialiser of a frame; kind in
    {'ExPose', 'PIXIE', 'PARE', 'combined'}."""
    if kind not in ("ExPose", "PIXIE", "PARE", "combined"):
        raise ValueError(f"Unknown regression prior: {kind}")

    def need(name, value):
        if value is None:
            raise ValueError(f"regression prior {kind!r} needs {name} results")
        return value

    if kind in ("PIXIE", "combined"):
        pixie = need("PIXIE", pixie)
        pixie_pose_e = rotmats_to_pose(
            np.asarray(pixie["body_pose"], np.float32)).reshape(21, 3)
        global_pose = rotmats_to_pose(
            np.asarray(pixie["global_pose"], np.float32).reshape(1, 3, 3))
    if kind in ("ExPose", "combined"):
        expose = need("ExPose", expose)
        expose_pose_e = rotmats_to_pose(
            np.asarray(expose["body_pose"], np.float32)).reshape(21, 3)
        global_pose = rotmats_to_pose(
            np.asarray(expose["global_orient"], np.float32).reshape(1, 3, 3))
    if kind == "PARE":
        pred = np.asarray(need("PARE", pare)["pred_pose"], np.float32)  # [1, 24, 3, 3]
        body = rotmats_to_pose(pred[0, 1:22]).reshape(21, 3)
        global_pose = rotmats_to_pose(pred[0, :1])
    elif kind == "PIXIE":
        body = pixie_pose_e
    elif kind == "ExPose":
        body = expose_pose_e
    else:
        body = np.concatenate([expose_pose_e[:19], pixie_pose_e[19:]], axis=0)

    init_t, center = None, None
    if use_camera_prior:
        if kind == "PARE":
            init_t, center = pare_camera(pare, focal_length)
        elif kind == "PIXIE":
            init_t, center = pixie_bbox_camera(pixie, focal_length)
        else:  # ExPose or combined
            init_t, center = expose_camera(expose, focal_length)

    return RegressionPrior(
        body_pose=body.reshape(-1).astype(np.float32),
        global_orient=np.asarray(global_pose, np.float32).reshape(3),
        init_translation=init_t,
        center=center,
    )
