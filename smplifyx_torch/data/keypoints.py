"""Dataset and keypoint-file reading (host-side, pure numpy).

The port's copy of `smplifyx_tpu/data/keypoints.py` (reference
smplifyx/data_parser.py):
  * OpenPose-style JSON -> [P, K, 3] arrays: 25/26/23 body keypoints by
    format, 21+21 hand keypoints, 51 face landmarks (+17 contour) (the face
    block is rows 17:68 of the 70-landmark OpenPose output, contour rows
    0:17);
  * base joint weights: ones with `joints_to_ign` zeroed;
  * folder datasets yielding `FrameRecord`s.  Image decode is optional:
    the fit needs only (H, W), read from the PNG or JPEG header.

`KeypointFolderDataset` reads the JSONs with the native parser
(data/native.py) when it builds, as the JAX package does: `use_native_parser`
None picks it when it builds, True requires it (raising with the
compiler's output when it cannot be built), False keeps the Python reader.
Files that carry a gender annotation always take the Python reader, which
keeps it.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import struct as _struct
from dataclasses import dataclass, field
from glob import glob
from typing import Iterator, Optional

import numpy as np

from smplifyx_torch.data import native
from smplifyx_torch.models.joint_mapping import (
    NUM_BODY_JOINTS_BY_FORMAT,
    SHOULDER_IDXS_BY_FORMAT,
)


@dataclass
class Keypoints:
    keypoints: np.ndarray           # [P, K, 3] (x, y, conf)
    gender_gt: list = field(default_factory=list)
    gender_pd: list = field(default_factory=list)


def read_keypoints(
    keypoint_fn: str,
    use_hands: bool = True,
    use_face: bool = True,
    use_face_contour: bool = False,
) -> Keypoints:
    """Read one OpenPose-format JSON into stacked [P, K, 3]."""
    with open(keypoint_fn) as f:
        data = json.load(f)

    people, gender_pd, gender_gt = [], [], []
    for person in data.get("people", []):
        body = np.asarray(person["pose_keypoints_2d"], np.float32).reshape(-1, 3)
        parts = [body]
        if use_hands:
            parts.append(np.asarray(person["hand_left_keypoints_2d"],
                                    np.float32).reshape(-1, 3))
            parts.append(np.asarray(person["hand_right_keypoints_2d"],
                                    np.float32).reshape(-1, 3))
        if use_face:
            face = np.asarray(person["face_keypoints_2d"],
                              np.float32).reshape(-1, 3)
            parts.append(face[17:17 + 51])
            if use_face_contour:
                parts.append(face[:17])
        people.append(np.concatenate(parts, axis=0))
        if "gender_pd" in person:
            gender_pd.append(person["gender_pd"])
        if "gender_gt" in person:
            gender_gt.append(person["gender_gt"])

    kp = np.stack(people) if people else np.zeros((0, 0, 3), np.float32)
    return Keypoints(keypoints=kp, gender_pd=gender_pd, gender_gt=gender_gt)


def _jpeg_png_size(path: str) -> Optional[tuple[int, int]]:
    """(H, W) from the image header without a full decode; None if unknown."""
    with open(path, "rb") as f:
        head = f.read(32)
        if head[:8] == b"\x89PNG\r\n\x1a\n":
            w, h = _struct.unpack(">II", head[16:24])
            return h, w
        if head[:2] == b"\xff\xd8":  # JPEG: scan for an SOFn marker
            f.seek(2)
            while True:
                marker = f.read(2)
                if len(marker) < 2 or marker[0] != 0xFF:
                    return None
                code = marker[1]
                seg = f.read(2)
                if len(seg) < 2:
                    return None
                (length,) = _struct.unpack(">H", seg)
                if 0xC0 <= code <= 0xCF and code not in (0xC4, 0xC8, 0xCC):
                    _, h, w = _struct.unpack(">BHH", f.read(5))
                    return h, w
                f.seek(length - 2, os.SEEK_CUR)
    return None


def load_image(path: str) -> np.ndarray:
    """RGB float image in [0, 1] (cv2 if available, else PIL)."""
    try:
        import cv2

        img = cv2.imread(path)
        return img.astype(np.float32)[:, :, ::-1] / 255.0
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


@dataclass
class FrameRecord:
    fn: str
    img_path: str
    keypoints: np.ndarray            # [P, K, 3]
    img_size: tuple[int, int]        # (H, W)
    img: Optional[np.ndarray] = None
    gender_gt: list = field(default_factory=list)
    gender_pd: list = field(default_factory=list)
    keyp_path: Optional[str] = None  # source JSON (Homogenus wants it)


class KeypointFolderDataset:
    """images/ + keypoints/ folder dataset, indexable and iterable."""

    def __init__(
        self,
        data_folder: str,
        img_folder: str = "images",
        keyp_folder: str = "keypoints",
        use_hands: bool = True,
        use_face: bool = True,
        use_face_contour: bool = False,
        joints_to_ign: Optional[list[int]] = None,
        format: str = "coco25",
        load_images: bool = False,
        use_native_parser: Optional[bool] = None,
        **_,
    ):
        self.format = format.lower()
        self.use_hands = use_hands
        self.use_face = use_face
        self.use_face_contour = use_face_contour
        self.joints_to_ign = joints_to_ign
        self.load_images = load_images
        if use_native_parser is None:
            use_native_parser = native.is_available()
        elif use_native_parser:
            native.load()           # raises with the compiler's output
        self.use_native_parser = bool(use_native_parser)

        self.num_body_joints = NUM_BODY_JOINTS_BY_FORMAT[self.format]
        self.left_shoulder, self.right_shoulder = SHOULDER_IDXS_BY_FORMAT[self.format]

        self.img_folder = osp.join(data_folder, img_folder)
        self.keyp_folder = osp.join(data_folder, keyp_folder)
        self.img_paths = sorted(
            osp.join(self.img_folder, fn)
            for fn in os.listdir(self.img_folder)
            if fn.lower().endswith((".png", ".jpg", ".jpeg"))
            and not fn.startswith(".")
        )

    @property
    def num_joints(self) -> int:
        n = self.num_body_joints
        if self.use_hands:
            n += 42
        if self.use_face:
            n += 51 + 17 * self.use_face_contour
        return n

    def get_joint_weights(self) -> np.ndarray:
        w = np.ones(self.num_joints, np.float32)
        if self.joints_to_ign and -1 not in self.joints_to_ign:
            w[np.asarray(self.joints_to_ign)] = 0.0
        return w

    def __len__(self) -> int:
        return len(self.img_paths)

    def __getitem__(self, idx: int) -> FrameRecord:
        return self.read_item(self.img_paths[idx])

    def __iter__(self) -> Iterator[FrameRecord]:
        for p in self.img_paths:
            yield self.read_item(p)

    def read_item(self, img_path: str) -> FrameRecord:
        img_fn = osp.splitext(osp.basename(img_path))[0]
        matches = glob(osp.join(self.keyp_folder, img_fn + "_*.json"))
        if not matches:
            raise FileNotFoundError(f"Keypoint file for {img_fn} does not exist")
        flags = dict(use_hands=self.use_hands, use_face=self.use_face,
                     use_face_contour=self.use_face_contour)
        # The native parser skips gender annotations: files carrying them
        # take the Python reader (a substring probe).
        native_ok = self.use_native_parser
        if native_ok:
            with open(matches[0], "rb") as f:
                native_ok = b"gender" not in f.read()
        if native_ok:
            kp = Keypoints(keypoints=native.read_keypoints_native(matches[0],
                                                                  **flags))
        else:
            kp = read_keypoints(matches[0], **flags)
        img = load_image(img_path) if self.load_images else None
        size = img.shape[:2] if img is not None else _jpeg_png_size(img_path)
        if size is None:
            raise ValueError(f"cannot determine image size of {img_path}")
        return FrameRecord(
            fn=img_fn, img_path=img_path, keypoints=kp.keypoints,
            img_size=tuple(size), img=img,
            gender_gt=kp.gender_gt, gender_pd=kp.gender_pd,
            keyp_path=matches[0],
        )


def create_dataset(format: str = "coco25", data_folder: str = "data", **kwargs):
    """Factory mirroring reference create_dataset (data_parser.py:46-54)."""
    fmt = format.lower()
    if fmt not in NUM_BODY_JOINTS_BY_FORMAT:
        raise ValueError(f"Unknown dataset format: {format}")
    return KeypointFolderDataset(data_folder, format=fmt, **kwargs)
