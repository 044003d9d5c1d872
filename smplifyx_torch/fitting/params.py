"""Flat parameter vector layout and per-stage free-parameter masks.

Counterpart of `smplifyx_tpu/fitting/params.py`: every optimizable quantity
of a frame (camera translation, global orientation, body pose, shape,
expression, jaw, eyes, hand PCA coefficients) is packed into one flat [D]
row, and stages free or freeze segments with 0/1 masks read by the masked
L-BFGS (fitting/lbfgs.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from smplifyx_torch.models.forward import BodyParams
from smplifyx_torch.utils.tensors import TensorFields


@dataclass(frozen=True)
class FitSettings(TensorFields):
    """Static fitting configuration (the same fields and defaults as the
    JAX package's FitSettings)."""

    use_vposer: bool = False
    latent_dim: int = 32
    num_betas: int = 10
    num_expr: int = 10
    num_pca: int = 12
    use_hands: bool = True
    use_face: bool = True
    use_face_contour: bool = True
    use_pca: bool = True
    flat_hand_mean: bool = False
    num_body_kp: int = 25
    use_joints_conf: bool = True
    rho: float = 100.0
    body_prior_type: str = "l2"          # 'gmm' | 'l2' | 'none'
    left_hand_prior_type: str = "l2"     # 'gmm' | 'l2' | 'none'
    right_hand_prior_type: str = "l2"
    jaw_prior_type: str = "l2"           # 'l2' | 'none'
    has_regression_prior: bool = False
    camera_conf_mode: str = "global_scale"  # 'global_scale'|'per_joint'|'none'
    interpenetration: bool = False
    body_pose_dof: int = 63              # 69 for SMPL (wrists included)
    optim_shape: bool = True
    optim_expression: bool = True
    optim_jaw: bool = True               # also gates the eye poses
    optim_hands: bool = True

    @property
    def body_dim(self) -> int:
        return self.latent_dim if self.use_vposer else self.body_pose_dof

    @property
    def hand_dim(self) -> int:
        return self.num_pca if self.use_pca else 45

    def segments(self) -> Dict[str, tuple[int, int]]:
        """Name -> (offset, size) of every segment in the flat vector."""
        sizes = [
            ("cam_t", 3), ("global_orient", 3), ("body", self.body_dim),
            ("betas", self.num_betas), ("expression", self.num_expr),
            ("jaw", 3), ("leye", 3), ("reye", 3),
            ("lhand", self.hand_dim), ("rhand", self.hand_dim),
        ]
        out, off = {}, 0
        for name, size in sizes:
            out[name] = (off, size)
            off += size
        return out

    @property
    def dim(self) -> int:
        off, size = self.segments()["rhand"]
        return off + size


def pack(settings: FitSettings, **values) -> torch.Tensor:
    """Pack named segments (each [B, size]) into flat [B, D]; missing -> 0."""
    some = next(iter(values.values()))
    B = some.shape[0]
    parts = []
    for name, (_, size) in settings.segments().items():
        v = values.get(name)
        if v is None:
            v = torch.zeros((B, size), dtype=some.dtype, device=some.device)
        parts.append(v.reshape(B, size))
    return torch.cat(parts, dim=-1)


def unpack(settings: FitSettings, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Flat [..., D] -> dict of segment views [..., size]."""
    return {name: x[..., off:off + size]
            for name, (off, size) in settings.segments().items()}


def body_params_from_flat(settings: FitSettings, x: torch.Tensor, decode_body
                          ) -> tuple[BodyParams, torch.Tensor, torch.Tensor]:
    """Flat [B, D] -> (BodyParams, cam_t [B, 3], body_raw [B, body_dim]).

    decode_body maps the packed body segment to the 63-dof axis-angle pose
    (the identity without VPoser).
    """
    seg = unpack(settings, x)
    params = BodyParams(
        global_orient=seg["global_orient"], body_pose=decode_body(seg["body"]),
        betas=seg["betas"], expression=seg["expression"], jaw_pose=seg["jaw"],
        leye_pose=seg["leye"], reye_pose=seg["reye"],
        left_hand_pose=seg["lhand"], right_hand_pose=seg["rhand"],
    )
    return params, seg["cam_t"], seg["body"]


def segment_mask(settings: FitSettings, names: list, device) -> torch.Tensor:
    """[D] mask with ones over the named segments."""
    segs = settings.segments()
    mask = np.zeros(settings.dim, dtype=np.float32)
    for n in names:
        off, size = segs[n]
        mask[off:off + size] = 1.0
    return torch.as_tensor(mask, device=device)


def camera_stage_mask(settings: FitSettings, device) -> torch.Tensor:
    """The camera stage frees camera translation and global orientation."""
    return segment_mask(settings, ["cam_t", "global_orient"], device)


def body_stage_mask(settings: FitSettings, device) -> torch.Tensor:
    """Body stages free every body-model parameter but not the camera,
    minus the groups frozen by optim_shape/expression/jaw/hands."""
    names = ["global_orient", "body"]
    if settings.optim_shape:
        names.append("betas")
    if settings.optim_expression:
        names.append("expression")
    if settings.optim_jaw:
        names += ["jaw", "leye", "reye"]
    if settings.use_hands and settings.optim_hands:
        names += ["lhand", "rhand"]
    return segment_mask(settings, names, device)
