"""Annotation-format joint permutations.

Maps the model's canonical output joint order (55 skeleton + 21 vertex extras
+ 51 face + 17 contour = 144 for SMPL-X) to 2D pose-annotation formats.
Capability parity with reference `smpl_to_annotation` (smplifyx/utils.py:98-250)
— the tables are the public OpenPose/Halpe/COCO-Wholebody <-> SMPL-X joint
correspondences.

Format layouts (rows of the returned permutation):
  coco25:          25 body + [2x21 hands] + [51 face (+17 contour)]
  coco19:          19 body + ...
  halpe:           26 body + ...
  coco_wholebody:  23 body + ...
"""

from __future__ import annotations

import numpy as np

# SMPL-X canonical joint-name indices used below (see models/bodymodel.py):
#   0..54 skeleton; 55 nose, 56 R eye, 57 L eye, 58 R ear, 59 L ear,
#   60..62 L toes/heel, 63..65 R toes/heel, 66..75 finger tips (L then R),
#   76..126 face, 127..143 contour.

_SMPLX_LHAND = [20, 37, 38, 39, 66, 25, 26, 27, 67, 28, 29, 30, 68,
                34, 35, 36, 69, 31, 32, 33, 70]
_SMPLX_RHAND = [21, 52, 53, 54, 71, 40, 41, 42, 72, 43, 44, 45, 73,
                49, 50, 51, 74, 46, 47, 48, 75]
# SMPL-H canonical layout: 52 skeleton + 21 extras (nose/eyes/ears 52-56,
# toes/heels 57-62, finger tips L 63-67 / R 68-72); the reference's coco25
# smplh tables (utils.py:171-182) use exactly this layout.
_SMPLH_LHAND = [20, 34, 35, 36, 63, 22, 23, 24, 64, 25, 26, 27, 65,
                31, 32, 33, 66, 28, 29, 30, 67]
_SMPLH_RHAND = [21, 49, 50, 51, 68, 37, 38, 39, 69, 40, 41, 42, 70,
                46, 47, 48, 71, 43, 44, 45, 72]

# NOTE on coco19: the reference builds its coco19 models WITHOUT the six
# foot vertex-joints, which shifts its fingertip indices to 60-69 and face
# to 70 (utils.py:211-250).  This framework keeps ONE canonical layout per
# family (feet always present), so coco19 reuses the coco25 hand tables and
# the face block at 76 — the selected landmarks are identical.
_BODY = {
    ("smplx", "coco25"): [55, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
                          56, 57, 58, 59, 60, 61, 62, 63, 64, 65],
    ("smplx", "coco19"): [55, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
                          56, 57, 58, 59],
    ("smplx", "halpe"): [55, 57, 56, 59, 58, 16, 17, 18, 19, 20, 21,
                         1, 2, 4, 5, 7, 8, 15, 12, 0, 60, 63, 61, 64, 62, 65],
    ("smplx", "coco_wholebody"): [55, 57, 56, 59, 58, 16, 17, 18, 19, 20, 21,
                                  1, 2, 4, 5, 7, 8, 60, 61, 62, 63, 64, 65],
    ("smplh", "coco25"): [52, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
                          53, 54, 55, 56, 57, 58, 59, 60, 61, 62],
    ("smplh", "coco19"): [52, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
                          53, 54, 55, 56],
    ("smpl", "coco25"): [24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
                         25, 26, 27, 28, 29, 30, 31, 32, 33, 34],
    ("smpl", "coco19"): [24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
                         25, 26, 27, 28],
}

NUM_BODY_JOINTS_BY_FORMAT = {"coco25": 25, "coco19": 19, "halpe": 26,
                             "coco_wholebody": 23}
# 2D shoulder keypoint indices per format (reference data_parser.py:153-157,
# 247-251, 278-282) used for the side-view dual-orientation test.
SHOULDER_IDXS_BY_FORMAT = {"coco25": (2, 5), "coco19": (2, 5),
                           "halpe": (5, 6), "coco_wholebody": (5, 6)}


def model_to_annotation(
    model_type: str = "smplx",
    use_hands: bool = True,
    use_face: bool = True,
    use_face_contour: bool = False,
    format: str = "coco25",
) -> np.ndarray:
    """Permutation indices from canonical model joints to annotation order."""
    fmt = format.lower()
    key = (model_type, fmt)
    if key not in _BODY:
        raise ValueError(f"Unsupported mapping {model_type}/{format}")
    parts = [np.asarray(_BODY[key], dtype=np.int32)]
    if use_hands and model_type in ("smplx", "smplh"):
        lhand, rhand = {
            "smplx": (_SMPLX_LHAND, _SMPLX_RHAND),
            "smplh": (_SMPLH_LHAND, _SMPLH_RHAND),
        }[model_type]
        parts += [np.asarray(lhand, dtype=np.int32),
                  np.asarray(rhand, dtype=np.int32)]
    if use_face and model_type == "smplx":
        # Face block of the canonical layout (76..126, + contour); see the
        # coco19 layout note above.
        parts.append(
            np.arange(76, 76 + 51 + 17 * use_face_contour, dtype=np.int32)
        )
    return np.concatenate(parts)


def num_keypoints(format: str, use_hands: bool, use_face: bool,
                  use_face_contour: bool) -> int:
    n = NUM_BODY_JOINTS_BY_FORMAT[format.lower()]
    if use_hands:
        n += 42
    if use_face:
        n += 51 + 17 * use_face_contour
    return n
