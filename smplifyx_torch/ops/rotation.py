"""Rotation representations and conversions on torch tensors.

Counterpart of `smplifyx_tpu/ops/rotation.py`: axis-angle -> matrix
(Rodrigues), matrix -> axis-angle (log map), matrix -> intrinsic-xyz Euler
angles, and the 180-degree flip about y used by the dual-orientation retry.
Every function takes arbitrary leading batch dimensions and is
differentiable by autograd.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def batch_rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3].

    R = I + sin(t) K + (1 - cos(t)) K^2 with the angle smoothed as
    sqrt(|aa|^2 + eps^2), so the gradient stays finite at zero angle.
    """
    batch_shape = aa.shape[:-1]
    aa = aa.reshape(-1, 3)
    angle = torch.sqrt(torch.sum(aa * aa, dim=-1) + _EPS * _EPS)
    axis = aa / angle[..., None]
    sin = torch.sin(angle)
    cos = torch.cos(angle)
    kx, ky, kz = axis[..., 0], axis[..., 1], axis[..., 2]
    c1 = 1.0 - cos
    xx, yy, zz = c1 * kx * kx, c1 * ky * ky, c1 * kz * kz
    xy, xz, yz = c1 * kx * ky, c1 * kx * kz, c1 * ky * kz
    sx, sy, sz = sin * kx, sin * ky, sin * kz
    R = torch.stack(
        [
            cos + xx, xy - sz, xz + sy,
            xy + sz, cos + yy, yz - sx,
            xz - sy, yz + sx, cos + zz,
        ],
        dim=-1,
    )
    return R.reshape(*batch_shape, 3, 3)


def rotmat_to_aa(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> axis-angle [..., 3] (log map).

    Safe at angle ~ 0 (the skew part) and near pi (axis from the diagonal
    of R + I, signs from the off-diagonals).
    """
    batch_shape = R.shape[:-2]
    R = R.reshape(-1, 3, 3)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)

    skew = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin = 0.5 * torch.sqrt(torch.sum(skew * skew, dim=-1) + _EPS * _EPS)
    angle = torch.atan2(sin, cos)
    generic = skew * (angle / (2.0 * sin + _EPS))[..., None]

    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_abs = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    s01 = R[..., 0, 1] + R[..., 1, 0]
    s02 = R[..., 0, 2] + R[..., 2, 0]
    s12 = R[..., 1, 2] + R[..., 2, 1]
    # First index of the largest component, as jnp.argmax picks ties.
    major = torch.argmax(axis_abs, dim=-1)
    one = torch.ones_like(s01)
    sign0 = torch.where(major == 0, one,
                        torch.where(major == 1, torch.sign(s01), torch.sign(s02)))
    sign1 = torch.where(major == 0, torch.sign(s01),
                        torch.where(major == 1, one, torch.sign(s12)))
    sign2 = torch.where(major == 0, torch.sign(s02),
                        torch.where(major == 1, torch.sign(s12), one))
    sign = torch.stack([sign0, sign1, sign2], dim=-1)
    sign = torch.where(sign == 0.0, torch.ones_like(sign), sign)
    axis_pi = axis_abs * sign
    overall = torch.sign(torch.sum(axis_pi * skew, dim=-1, keepdim=True))
    overall = torch.where(overall == 0.0, torch.ones_like(overall), overall)
    near_pi = axis_pi * overall * angle[..., None]

    out = torch.where((math.pi - angle)[..., None] < 1e-3, near_pi, generic)
    return out.reshape(*batch_shape, 3)


def euler_xyz_from_rotmat(R: torch.Tensor) -> torch.Tensor:
    """Intrinsic-xyz Euler angles (a, b, c) with R = Rx(a) Ry(b) Rz(c);
    at gimbal lock (|cos b| ~ 0) the third angle is zero."""
    batch_shape = R.shape[:-2]
    R = R.reshape(-1, 3, 3)
    r02 = torch.clamp(R[..., 0, 2], -1.0, 1.0)
    b = torch.asin(r02)
    safe = torch.abs(r02) < 1.0 - 1e-7
    a_safe = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    c_safe = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
    a_lock = torch.atan2(R[..., 1, 0], R[..., 1, 1]) * torch.sign(r02)
    a = torch.where(safe, a_safe, a_lock)
    c = torch.where(safe, c_safe, torch.zeros_like(c_safe))
    return torch.stack([a, b, c], dim=-1).reshape(*batch_shape, 3)


def flip_global_orient_y(aa: torch.Tensor) -> torch.Tensor:
    """Compose a global orientation with a 180-degree rotation about y
    (reference fit_single_frame.py:528-535, the dual-orientation retry)."""
    R = batch_rodrigues(aa)
    flip = batch_rodrigues(
        torch.tensor([0.0, math.pi, 0.0], dtype=aa.dtype, device=aa.device)
    )
    return rotmat_to_aa(R @ flip)
