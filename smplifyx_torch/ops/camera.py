"""Pinhole perspective camera as a plain function on tensors.

Counterpart of `smplifyx_tpu/ops/camera.py`: points go through the
extrinsics (R p + t), are divided by depth, scaled by the focal lengths and
shifted by the principal point.  Also the cropped-EHF ground-truth camera
of the evaluation protocol (reference PerspectiveCameraCroppedEHFGT,
smplifyx/camera.py:119-128).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from smplifyx_torch.utils.device import resolve_device

DEFAULT_FOCAL_LENGTH = 5000.0


class CameraParams(NamedTuple):
    """Per-frame camera; every field broadcasts over the batch.

    rotation [..., 3, 3], translation [..., 3], focal [..., 2] (fx, fy),
    center [..., 2] principal point in pixels.
    """

    rotation: torch.Tensor
    translation: torch.Tensor
    focal: torch.Tensor
    center: torch.Tensor


def project_points(camera: CameraParams, points: torch.Tensor) -> torch.Tensor:
    """Project 3D points [..., N, 3] to pixels [..., N, 2]."""
    p_cam = torch.einsum("...ij,...nj->...ni", camera.rotation, points)
    p_cam = p_cam + camera.translation[..., None, :]
    z = p_cam[..., 2:3]
    # Keep the divide finite when a line-search probe puts a point on the
    # camera plane; the sign is kept so the gradient still repels.
    tiny = torch.where(z < 0, torch.full_like(z, -1e-6), torch.full_like(z, 1e-6))
    z = torch.where(torch.abs(z) < 1e-6, tiny, z)
    uv = p_cam[..., :2] / z
    return uv * camera.focal[..., None, :] + camera.center[..., None, :]


def identity_camera(batch_shape: tuple = (),
                    focal_length: float = DEFAULT_FOCAL_LENGTH,
                    center: torch.Tensor | None = None, device="cuda",
                    dtype=torch.float32) -> CameraParams:
    """Identity rotation, zero translation, one focal length; the centre
    defaults to the origin."""
    dev = resolve_device(device)
    rot = torch.eye(3, dtype=dtype, device=dev).expand(*batch_shape, 3, 3)
    transl = torch.zeros((*batch_shape, 3), dtype=dtype, device=dev)
    focal = torch.full((*batch_shape, 2), focal_length, dtype=dtype,
                       device=dev)
    if center is None:
        center = torch.zeros((*batch_shape, 2), dtype=dtype, device=dev)
    return CameraParams(rot, transl, focal, center)


# Cropped-EHF ground-truth extrinsics and intrinsics (reference
# camera.py:119-128).
EHF_GT_ROTATION = (
    (0.9992447, -0.0048801, 0.0385517),
    (-0.0107200, -0.9882044, 0.1527655),
    (0.0373514, -0.1530633, -0.9875103),
)
EHF_GT_TRANSLATION = (-0.03609917, 0.43416458, 2.37101226)
EHF_GT_CENTER = (790.263706, 578.90334)
EHF_GT_FOCAL = 1498.22426237
EHF_IMG_SIZE = (800, 600)  # (width, height) visibility bound of the eval


def ehf_gt_camera(xmin: float = 0.0, ymin: float = 0.0, device="cuda",
                  dtype=torch.float32) -> CameraParams:
    """The EHF ground-truth camera, its principal point shifted by a crop
    box's corner."""
    dev = resolve_device(device)

    def t(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    return CameraParams(
        t(EHF_GT_ROTATION), t(EHF_GT_TRANSLATION),
        t([EHF_GT_FOCAL, EHF_GT_FOCAL]),
        t([EHF_GT_CENTER[0] - xmin, EHF_GT_CENTER[1] - ymin]))
