"""Stage weight-schedule assembly from config lists.

Counterpart of `smplifyx_tpu/fitting/stages.py` (reference
fit_single_frame.py:330-353): the bending prior weight is always 3.17x the
body pose weight, and the defaults follow the reference's fallbacks.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from smplifyx_torch.fitting.energy import StageWeights
from smplifyx_torch.utils.device import resolve_device

BENDING_FACTOR = 3.17


def build_stage_schedule(
    body_pose_prior_weights: Sequence[float],
    shape_weights: Sequence[float] | None = None,
    expr_weights: Sequence[float] | None = None,
    hand_pose_prior_weights: Sequence[float] | None = None,
    jaw_pose_prior_weights: Sequence | None = None,
    hand_joints_weights: Sequence[float] | None = None,
    face_joints_weights: Sequence[float] | None = None,
    coll_loss_weights: Sequence[float] | None = None,
    device="cuda",
) -> StageWeights:
    """Per-stage weights stacked along a leading [S] axis.  Jaw entries are
    3-vectors, comma-separated strings or scalars (broadcast)."""
    S = len(body_pose_prior_weights)

    def dflt(x, default):
        x = default if x is None else x
        if len(x) != S:
            raise ValueError(f"schedule length mismatch: {len(x)} != {S}")
        return x

    shape_weights = dflt(shape_weights, [1e2, 5e1, 1e1, 0.5e1][:S] if S <= 4
                         else [1e2] * S)
    expr_weights = dflt(expr_weights, list(shape_weights))
    hand_pose_prior_weights = dflt(hand_pose_prior_weights,
                                   [1e2, 5e1, 1e1, 0.5e1][:S] if S <= 4
                                   else [1e2] * S)
    if jaw_pose_prior_weights is None:
        jaw_pose_prior_weights = [[x] * 3 for x in shape_weights]
    jaw = []
    for entry in jaw_pose_prior_weights:
        if isinstance(entry, str):
            entry = [float(v) for v in entry.split(",")]
        elif np.isscalar(entry):
            entry = [float(entry)] * 3
        jaw.append(list(entry))
    if len(jaw) != S:
        raise ValueError(f"schedule length mismatch: {len(jaw)} != {S}")
    hand_joints_weights = dflt(hand_joints_weights, [0.0] * (S - 1) + [1.0])
    face_joints_weights = dflt(face_joints_weights, [0.0] * (S - 1) + [1.0])
    coll_loss_weights = dflt(coll_loss_weights, [0.0] * S)

    dev = resolve_device(device)
    body = np.asarray(body_pose_prior_weights, np.float32)

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    return StageWeights(
        body_pose_weight=t(body), shape_weight=t(shape_weights),
        bending_prior_weight=t(BENDING_FACTOR * body),
        hand_prior_weight=t(hand_pose_prior_weights),
        expr_prior_weight=t(expr_weights), jaw_prior_weight=t(jaw),
        coll_loss_weight=t(coll_loss_weights), hand_weight=t(hand_joints_weights),
        face_weight=t(face_joints_weights),
    )
