"""The staged fitting pipeline: camera init -> (optional dual orientation)
-> body stages, over a batch of frames.

Counterpart of `smplifyx_tpu/fitting/pipeline.py` (reference
fit_single_frame, smplifyx/fit_single_frame.py:59-677).  Frames are lanes
of one batch; the stages are a Python loop over the weight schedule; the
180-degree dual-orientation retry doubles the batch to [2B] and keeps, per
frame, the orientation with the lower final loss where the frame's 2D
shoulder distance marks it as a possible side view.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from smplifyx_torch.fitting.energy import (
    FrameData,
    StageWeights,
    camera_init_energy,
    guess_camera_depth,
    smplify_energy,
)
from smplifyx_torch.fitting.lbfgs import LBFGSConfig, minimize
from smplifyx_torch.fitting.params import (
    FitSettings,
    body_params_from_flat,
    body_stage_mask,
    camera_stage_mask,
    pack,
    unpack,
)
from smplifyx_torch.models.bodymodel import SMPLXModel
from smplifyx_torch.models.forward import smplx_forward
from smplifyx_torch.ops.rotation import flip_global_orient_y
from smplifyx_torch.utils.device import full_f32_matmuls, resolve_device


@dataclass(frozen=True)
class FitOptions:
    """Pipeline options (the JAX package's FitOptions without the
    collision and TPU-precision fields)."""

    lbfgs: LBFGSConfig = field(default_factory=LBFGSConfig)
    camera_lbfgs: LBFGSConfig = field(default_factory=LBFGSConfig)
    try_both_orient: bool = False
    optim_type: str = "lbfgsls"
    side_view_thsh: float = 25.0
    left_shoulder_idx: int = 2
    right_shoulder_idx: int = 5
    use_camera_prior: bool = False


@dataclass
class FitResult:
    x: torch.Tensor             # [B, D] final flat params (winning orientation)
    loss: torch.Tensor          # [B] final total energy
    camera_loss: torch.Tensor   # [B] stage-0 final energy
    flipped: torch.Tensor       # [B] bool: the 180-degree orientation won
    stage_losses: torch.Tensor  # [S, B] energy after each body stage
    stage_evals: torch.Tensor   # [S, B] objective evaluations per body stage
    camera_evals: torch.Tensor  # [B] objective evaluations of stage 0
    host_reads: int             # device -> host reads steering the loops


def _check_device(dev: torch.device, **tensors):
    for name, t in tensors.items():
        if t.device.type != dev.type:
            raise ValueError(f"{name} lies on {t.device}, the fit runs on {dev}")


def fit_batch(
    model: SMPLXModel,
    settings: FitSettings,
    options: FitOptions,
    stage_weights: StageWeights,      # stacked: every field [S, ...]
    frames: FrameData,                # batched: every field [B, ...]
    x0: torch.Tensor,                 # [B, D] initial flat params
    decode_body: Callable[[torch.Tensor], torch.Tensor],
    joint_map: torch.Tensor,
    gmm=None,
    edge_idxs: Optional[torch.Tensor] = None,
    joints_model=None,
    coll_stage_mask: Optional[tuple] = None,
    lhand_gmm=None,
    rhand_gmm=None,
    device="cuda",
) -> FitResult:
    """Fit a batch of frames.

    `coll_stage_mask` (one bool per stage) marks the stages that apply the
    collision penalty; those wait for the collision port and raise.  Every
    other stage runs the joints-only energy when a JointsModel is given.
    """
    dev = resolve_device(device)
    _check_device(dev, x0=x0, gt_joints=frames.gt_joints,
                  lbs_weights=model.lbs_weights)
    full_f32_matmuls()
    if options.optim_type.lower() not in ("lbfgs", "lbfgsls"):
        raise NotImplementedError(
            f"optim_type={options.optim_type!r}: the first-order optimizers "
            "are not ported yet (ROADMAP queue 1 item 8)"
        )
    B = x0.shape[0]
    num_stages = stage_weights.num_stages
    if coll_stage_mask is None:
        coll_stage_mask = (settings.interpenetration,) * num_stages
    if len(coll_stage_mask) != num_stages:
        raise ValueError("coll_stage_mask needs one entry per stage")
    if any(coll_stage_mask):
        raise NotImplementedError(
            "collision stages are not ported yet (ROADMAP queue 1 item 7)"
        )
    reads = 0

    # ---- camera translation init (guess_init path)
    if not options.use_camera_prior:
        if edge_idxs is None:
            raise ValueError("the guess-init path needs edge_idxs")
        with torch.no_grad():
            init_t = guess_camera_depth(
                settings, model, x0, frames.gt_joints, edge_idxs,
                frames.focal[:, 0], decode_body, joint_map,
                joints_model=joints_model,
            )
        frames = dataclasses.replace(frames, trans_estimation=init_t)
        seg = unpack(settings, x0)
        seg["cam_t"] = init_t
        x0 = pack(settings, **seg)

    # ---- stage 0: camera
    cam_res = minimize(
        lambda x: camera_init_energy(x, settings, model, frames,
                                     decode_body, joint_map,
                                     joints_model=joints_model),
        x0, camera_stage_mask(settings, dev), options.camera_lbfgs,
    )
    reads += cam_res.host_reads
    x_cam = cam_res.x
    # Recorded before the doubling: a flipped winner shares this camera.
    camera_loss = cam_res.f
    camera_evals = cam_res.n_evals

    # ---- optional dual orientation: double the batch
    if options.try_both_orient:
        seg = unpack(settings, x_cam)
        seg["global_orient"] = flip_global_orient_y(seg["global_orient"])
        xs = torch.cat([x_cam, pack(settings, **seg)], dim=0)     # [2B, D]
        frames2 = frames.map(lambda a: torch.cat([a, a], dim=0))
    else:
        xs = x_cam
        frames2 = frames

    # ---- body stages
    # No stage carries the collision term, so every stage takes the
    # joints-only energy (settings.interpenetration would force the dense one).
    stage_settings = dataclasses.replace(settings, interpenetration=False)
    body_mask = body_stage_mask(settings, dev)
    x_cur = xs
    losses, evals = [], []
    for k in range(num_stages):
        w = stage_weights.stage(k)

        def fun(z, w=w, k=k):
            return smplify_energy(
                z, stage_settings, model, frames2, w, k, num_stages,
                decode_body, joint_map, gmm=gmm, joints_model=joints_model,
                lhand_gmm=lhand_gmm, rhand_gmm=rhand_gmm,
            )

        res = minimize(fun, x_cur, body_mask, options.lbfgs)
        reads += res.host_reads
        x_cur = res.x
        losses.append(res.f)
        evals.append(res.n_evals)
    stage_losses = torch.stack(losses)
    stage_evals = torch.stack(evals)
    final_loss = stage_losses[-1]

    # ---- orientation selection
    if options.try_both_orient:
        loss_orig, loss_flip = final_loss[:B], final_loss[B:]
        ls, rs = options.left_shoulder_idx, options.right_shoulder_idx
        shoulder_dist = torch.linalg.norm(
            frames.gt_joints[:, ls] - frames.gt_joints[:, rs], dim=-1)
        take_flip = (shoulder_dist < options.side_view_thsh) & (loss_flip < loss_orig)
        x_out = torch.where(take_flip[:, None], x_cur[B:], x_cur[:B])
        loss_out = torch.where(take_flip, loss_flip, loss_orig)
        stage_losses = torch.where(take_flip[None], stage_losses[:, B:],
                                   stage_losses[:, :B])
        stage_evals = torch.where(take_flip[None], stage_evals[:, B:],
                                  stage_evals[:, :B])
    else:
        take_flip = torch.zeros(B, dtype=torch.bool, device=dev)
        x_out, loss_out = x_cur, final_loss

    return FitResult(
        x=x_out, loss=loss_out, camera_loss=camera_loss, flipped=take_flip,
        stage_losses=stage_losses, stage_evals=stage_evals,
        camera_evals=camera_evals, host_reads=reads,
    )


def recover_outputs(
    model: SMPLXModel,
    settings: FitSettings,
    x: torch.Tensor,
    decode_body: Callable[[torch.Tensor], torch.Tensor],
    joint_map: Optional[torch.Tensor] = None,
    device="cuda",
):
    """Final forward pass on fitted params: (SMPLXOutput, BodyParams, cam_t).
    The mesh is skinned by kernel K1 on the card."""
    dev = resolve_device(device)
    _check_device(dev, x=x, lbs_weights=model.lbs_weights)
    full_f32_matmuls()
    with torch.no_grad():
        params, cam_t, _ = body_params_from_flat(settings, x, decode_body)
        out = smplx_forward(
            model, params, use_pca=settings.use_pca,
            flat_hand_mean=settings.flat_hand_mean,
            use_face_contour=settings.use_face_contour,
            joint_map=joint_map, return_verts=True,
        )
    return out, params, cam_t
