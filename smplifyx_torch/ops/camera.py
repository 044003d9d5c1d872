"""Pinhole perspective camera as a plain function on tensors.

Counterpart of `smplifyx_tpu/ops/camera.py`: points go through the
extrinsics (R p + t), are divided by depth, scaled by the focal lengths and
shifted by the principal point.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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
