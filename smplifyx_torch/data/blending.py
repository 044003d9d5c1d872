"""OpenPose+MMPose keypoint blending with confidence calibration.

The port's copy of `smplifyx_tpu/data/blending.py` (reference
smplifyx/keypoints_blending.py:276-381 and the notebook version of the same
loop):
  * MMPose confidences are z-score calibrated into the OpenPose confidence
    distribution per keypoint:  c' = clip(((c - mu_mm)/sigma_mm) * sigma_op
    + mu_op, 0, 1)  (keypoints_blending.py:357-362), with per-keypoint
    means and stds estimated on SHHQ;
  * each non-face keypoint takes whichever detector is more confident after
    calibration (:364-371); face landmarks always come from OpenPose
    (:346-351);
  * the output is in the OpenPose BODY_25(+hands+face) layout, written back
    as OpenPose-format JSON (:373-381).

This is host-side file preprocessing on a few hundred floats per frame, so
it stays numpy: a device round trip would cost more than the arithmetic.
The reference's per-keypoint loop is one gather and `where` over index
tables.  The reference module writes only the last image (an indentation
slip); this writes every image, as the notebook does.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from glob import glob
from typing import Dict, Optional, Tuple

import numpy as np

# Body keypoint correspondences: name -> (MMPose-Halpe idx, OpenPose-BODY25 idx)
# (reference keypoints_blending.py:288-312).
BODY_PAIRS: Dict[str, Tuple[int, int]] = {
    "Nose": (0, 0), "LEye": (1, 16), "REye": (2, 15), "LEar": (3, 18),
    "REar": (4, 17), "LShoulder": (5, 5), "RShoulder": (6, 2),
    "LElbow": (7, 6), "RElbow": (8, 3), "LWrist": (9, 7), "RWrist": (10, 4),
    "LHip": (11, 12), "RHip": (12, 9), "LKnee": (13, 13), "RKnee": (14, 10),
    "LAnkle": (15, 14), "RAnkle": (16, 11), "Neck": (18, 1), "Hip": (19, 8),
    "LBigToe": (20, 19), "RBigToe": (21, 22), "LSmallToe": (22, 20),
    "RSmallToe": (23, 23), "LHeel": (24, 21), "RHeel": (25, 24),
}

OPENPOSE_BODY_LEN = 25
MMPOSE_BODY_LEN = 26
NUM_HAND = 21
NUM_FACE = 68
OPENPOSE_TOTAL = OPENPOSE_BODY_LEN + 2 * NUM_HAND + NUM_FACE  # 135
MMPOSE_TOTAL = MMPOSE_BODY_LEN + 2 * NUM_HAND + NUM_FACE      # 136


def pair_names() -> list[str]:
    """All blendable keypoint names in table order (body, hands, face)."""
    names = list(BODY_PAIRS.keys())
    names += [f"left_hand_{i+1}" for i in range(NUM_HAND)]
    names += [f"right_hand_{i+1}" for i in range(NUM_HAND)]
    names += [f"face_{i+1}" for i in range(NUM_FACE)]
    return names


def _index_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mm_idx, op_idx, is_face) aligned with pair_names()."""
    mm, op, face = [], [], []
    for name in BODY_PAIRS:
        m, o = BODY_PAIRS[name]
        mm.append(m), op.append(o), face.append(False)
    for i in range(NUM_HAND):
        mm.append(MMPOSE_BODY_LEN + i), op.append(OPENPOSE_BODY_LEN + i)
        face.append(False)
    for i in range(NUM_HAND):
        mm.append(MMPOSE_BODY_LEN + NUM_HAND + i)
        op.append(OPENPOSE_BODY_LEN + NUM_HAND + i)
        face.append(False)
    for i in range(NUM_FACE):
        mm.append(MMPOSE_BODY_LEN + 2 * NUM_HAND + i)
        op.append(OPENPOSE_BODY_LEN + 2 * NUM_HAND + i)
        face.append(True)
    return (np.asarray(mm, np.int32), np.asarray(op, np.int32),
            np.asarray(face, bool))


MM_IDX, OP_IDX, IS_FACE = _index_tables()


def calibrate_confidences(
    mm_conf: np.ndarray,
    mm_mean: np.ndarray, mm_std: np.ndarray,
    op_mean: np.ndarray, op_std: np.ndarray,
) -> np.ndarray:
    """Z-score re-scaling of MMPose confidences into the OpenPose scale,
    clipped to [0, 1].  All arrays are per-keypoint, broadcastable."""
    z = (mm_conf - mm_mean) / mm_std
    return np.clip(z * op_std + op_mean, 0.0, 1.0)


def load_heuristics(heuristics_dir: str) -> dict[str, np.ndarray]:
    """Load the four SHHQ calibration JSONs into table-ordered arrays."""
    out = {}
    for key in ("openpose_means", "openpose_stds", "mmpose_means", "mmpose_stds"):
        with open(osp.join(heuristics_dir, key + ".json")) as f:
            d = json.load(f)
        out[key] = np.asarray(
            [d[name] for name in pair_names()], np.float32
        )
    return out


def identity_heuristics() -> dict[str, np.ndarray]:
    """Calibration that maps MMPose confidences through unchanged.

    Useful when the SHHQ-derived statistics JSONs are unavailable: blending
    then degrades gracefully to raw argmax-confidence selection (z-scoring
    with equal means/stds is the identity map)."""
    n = len(pair_names())
    return {
        "openpose_means": np.full(n, 0.5, np.float32),
        "openpose_stds": np.full(n, 1.0, np.float32),
        "mmpose_means": np.full(n, 0.5, np.float32),
        "mmpose_stds": np.full(n, 1.0, np.float32),
    }


def blend_keypoints(
    openpose_kp: np.ndarray,   # [135, 3] or [P, 135, 3]
    mmpose_kp: np.ndarray,     # [136, 3] or [P, 136, 3]
    heuristics: dict[str, np.ndarray],
) -> np.ndarray:
    """Blend one (or a batch of) frame's detections -> OpenPose layout [.., 135, 3]."""
    single = openpose_kp.ndim == 2
    if single:
        openpose_kp = openpose_kp[None]
        mmpose_kp = mmpose_kp[None]

    op = openpose_kp[:, OP_IDX]    # [P, J, 3] gathered to table order
    mm = mmpose_kp[:, MM_IDX]

    op_conf = np.clip(op[..., 2], 0.0, 1.0)
    mm_conf = calibrate_confidences(
        mm[..., 2],
        heuristics["mmpose_means"], heuristics["mmpose_stds"],
        heuristics["openpose_means"], heuristics["openpose_stds"],
    )

    take_mm = (mm_conf > op_conf) & ~IS_FACE
    xy = np.where(take_mm[..., None], mm[..., :2], op[..., :2])
    conf = np.where(take_mm, mm_conf, op_conf)

    blended = np.zeros((openpose_kp.shape[0], OPENPOSE_TOTAL, 3), np.float32)
    blended[:, OP_IDX, :2] = xy
    blended[:, OP_IDX, 2] = conf
    return blended[0] if single else blended


def write_openpose_json(blended: np.ndarray, path: str) -> None:
    """Write a [135, 3] blended frame as OpenPose-format JSON
    (reference layout, keypoints_blending.py:373-381)."""
    flat = blended.astype(float).flatten().tolist()
    person = {
        "person_id": [-1],
        "pose_keypoints_2d": flat[: OPENPOSE_BODY_LEN * 3],
        "hand_left_keypoints_2d": flat[OPENPOSE_BODY_LEN * 3 : 46 * 3],
        "hand_right_keypoints_2d": flat[46 * 3 : 67 * 3],
        "face_keypoints_2d": flat[67 * 3 :],
    }
    with open(path, "w") as f:
        json.dump({"people": [person]}, f, indent=2)


def _read_raw(keypoint_fn: str) -> np.ndarray:
    """Read an OpenPose/MMPose-format JSON as a flat [K, 3] array in
    body+hands+face(68) order (reference keypoints_blending read_keypoints)."""
    with open(keypoint_fn) as f:
        data = json.load(f)
    person = data["people"][0]
    body = np.asarray(person["pose_keypoints_2d"], np.float32).reshape(-1, 3)
    lh = np.asarray(person["hand_left_keypoints_2d"], np.float32).reshape(-1, 3)
    rh = np.asarray(person["hand_right_keypoints_2d"], np.float32).reshape(-1, 3)
    face = np.asarray(person["face_keypoints_2d"], np.float32).reshape(-1, 3)[:68]
    return np.concatenate([body, lh, rh, face], axis=0)


def blend_directory(
    images_dir: str,
    openpose_dir: str,
    mmpose_dir: str,
    out_dir: str,
    heuristics_dir: Optional[str] = None,
) -> list[str]:
    """Batch driver mirroring reference blending() — every image written.

    Without a heuristics dir the identity calibration is used."""
    heur = (load_heuristics(heuristics_dir) if heuristics_dir
            else identity_heuristics())
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for fn in sorted(glob(osp.join(images_dir, "*"))):
        img_name = osp.splitext(osp.basename(fn))[0]
        op = _read_raw(osp.join(openpose_dir, img_name + "_keypoints.json"))
        mm = _read_raw(osp.join(mmpose_dir, img_name + "_mmpose.json"))
        blended = blend_keypoints(op, mm, heur)
        out_path = osp.join(out_dir, img_name + "_blended.json")
        write_openpose_json(blended, out_path)
        written.append(out_path)
    return written
