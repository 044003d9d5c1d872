"""The staged fitting pipeline: camera init -> (optional dual orientation)
-> body stages, over a batch of frames.

Counterpart of `smplifyx_tpu/fitting/pipeline.py` (reference
fit_single_frame, smplifyx/fit_single_frame.py:59-677).  Frames are lanes
of one batch; the stages are a Python loop over the weight schedule; the
180-degree dual-orientation retry doubles the batch to [2B] and keeps, per
frame, the orientation with the lower final loss where the frame's 2D
shoulder distance marks it as a possible side view.

While the span recorder records (`utils/timing.py`), a fit is a `fit` span
with its frames, and each stage's minimization a `stage` span with its
lanes and the per-lane evaluations it needed (a device scalar, of both
orientations: taken before the choice).

On the card each L-BFGS stage replays its evaluations' stretches of plain
PyTorch from CUDA graphs (`utils/graphs.py`) where `_graphed` admits it:
a model of one vertex block, and no broad phase inside the evaluations.  Elsewhere, the CPU included, every evaluation runs eagerly.
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
from smplifyx_torch.fitting.optimizers import make_optimizer, minimize_first_order
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
from smplifyx_torch.utils import graphs, timing
from smplifyx_torch.utils.device import full_f32_matmuls, resolve_device


@dataclass(frozen=True)
class FitOptions:
    """Pipeline options (the JAX package's FitOptions without its
    TPU-precision field)."""

    lbfgs: LBFGSConfig = field(default_factory=LBFGSConfig)
    camera_lbfgs: LBFGSConfig = field(default_factory=LBFGSConfig)
    try_both_orient: bool = False
    optim_type: str = "lbfgsls"
    # Run guess-init and the stage-0 camera fit.  Off to resume the body
    # stages from an x0 whose camera is already fitted (`fit_stages`).
    camera_stage: bool = True
    side_view_thsh: float = 25.0
    left_shoulder_idx: int = 2
    right_shoulder_idx: int = 5
    use_camera_prior: bool = False
    # Collision broad-phase refresh: "iter" builds the pair list once per
    # L-BFGS refresh period (`LBFGSConfig.aux_every` iterations) and reuses
    # it across the line searches, with an AABB recheck per evaluation;
    # "eval" runs the broad phase in every evaluation (exact reference
    # semantics).
    coll_broad_refresh: str = "iter"
    # Keep the parameters after every body stage (FitResult.stage_x): the
    # per-stage overlays of the reference (fit_single_frame.py:509-520).
    keep_stage_params: bool = False


@dataclass
class FitResult:
    x: torch.Tensor             # [B, D] final flat params (winning orientation)
    loss: torch.Tensor          # [B] final total energy
    camera_loss: torch.Tensor   # [B] stage-0 final energy
    flipped: torch.Tensor       # [B] bool: the 180-degree orientation won
    stage_losses: torch.Tensor  # [S, B] energy after each body stage
    stage_evals: torch.Tensor   # [S, B] objective evaluations per body stage
    camera_evals: torch.Tensor  # [B] evaluations of stage 0; 0 when skipped
    host_reads: int             # device -> host reads steering the loops
    # [S, B, D] params after each body stage (winning orientation); None
    # unless FitOptions.keep_stage_params
    stage_x: Optional[torch.Tensor] = None


def _check_device(dev: torch.device, **tensors):
    for name, t in tensors.items():
        if t.device.type != dev.type:
            raise ValueError(f"{name} lies on {t.device}, the fit runs on {dev}")


def _first_order(optim_type: str):
    """`minimize`'s signature over a first-order optimizer; an unknown name
    raises ValueError.  The aux hooks go unused: with no line search there
    is no broad phase to hoist, and fun runs its own in every evaluation
    (the reference's semantics)."""
    make_optimizer(optim_type, 1.0)

    def run(fun, x, mask, cfg, aux_fn=None, aux_refresh_fn=None):
        return minimize_first_order(
            fun, x, make_optimizer(optim_type, cfg.lr), mask=mask,
            max_iters=cfg.max_iters, ftol=cfg.ftol, gtol=cfg.gtol)

    return run


def _graphed(x: torch.Tensor, model, use_lbfgs: bool,
             broad_phase_per_eval: bool) -> bool:
    """Whether a stage's evaluations replay CUDA graphs: x on a card, the
    stage minimized by L-BFGS, a model of one vertex block, and no broad
    phase inside the evaluations (it reads the device to size its pairs).
    The decision reads only the stage's inputs."""
    return (x.device.type == "cuda" and use_lbfgs and len(model.blocks) == 1
            and not broad_phase_per_eval)


def _run_stage(run_min, stage, collision: bool, fun, x, mask, cfg,
               graphed: bool, **aux):
    """One stage's minimization, recorded as a `stage` span; with `graphed`
    its evaluations replay CUDA graphs from the second on
    (utils/graphs.py)."""
    with timing.span("stage", stage=stage, collision=collision,
                     lanes=x.shape[0]) as sp, graphs.stage(graphed):
        res = run_min(fun, x, mask, cfg, **aux)
        if sp is not None:
            sp.attrs["lane_evals"] = res.n_evals.sum()
    return res


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
    collision_fn=None,
    device="cuda",
) -> FitResult:
    """Fit a batch of frames.

    `coll_stage_mask` (one bool per stage) marks the stages that apply the
    collision penalty `collision_fn` (ops/collision.py) on the full-mesh
    forward; by default every stage does when settings.interpenetration is
    set and a collision_fn is given.  Every other stage runs the
    joints-only energy when a JointsModel is given.
    """
    with timing.span("fit", fit=True, frames=x0.shape[0]):
        return _fit_batch(
            model, settings, options, stage_weights, frames, x0, decode_body,
            joint_map, gmm, edge_idxs, joints_model, coll_stage_mask,
            lhand_gmm, rhand_gmm, collision_fn, device)


def _fit_batch(model, settings, options, stage_weights, frames, x0,
               decode_body, joint_map, gmm, edge_idxs, joints_model,
               coll_stage_mask, lhand_gmm, rhand_gmm, collision_fn,
               device) -> FitResult:
    use_lbfgs = options.optim_type.lower() in ("lbfgs", "lbfgsls")
    run_min = minimize if use_lbfgs else _first_order(options.optim_type)
    dev = resolve_device(device)
    _check_device(dev, x0=x0, gt_joints=frames.gt_joints, faces=model.faces)
    full_f32_matmuls()
    B = x0.shape[0]
    num_stages = stage_weights.num_stages
    if coll_stage_mask is None:
        coll_stage_mask = (settings.interpenetration
                           and collision_fn is not None,) * num_stages
    if len(coll_stage_mask) != num_stages:
        raise ValueError("coll_stage_mask needs one entry per stage")
    if any(coll_stage_mask) and (collision_fn is None
                                 or not settings.interpenetration):
        raise ValueError("collision stages need settings.interpenetration "
                         "and a collision_fn")
    if options.coll_broad_refresh not in ("iter", "eval"):
        raise ValueError(
            f"coll_broad_refresh={options.coll_broad_refresh!r}: 'iter' or 'eval'")
    reads = 0

    # ---- camera translation init (guess_init path)
    if not options.use_camera_prior and options.camera_stage:
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
    if options.camera_stage:
        cam_res = _run_stage(
            run_min, "camera", False,
            lambda x: camera_init_energy(x, settings, model, frames,
                                         decode_body, joint_map,
                                         joints_model=joints_model),
            x0, camera_stage_mask(settings, dev), options.camera_lbfgs,
            _graphed(x0, model, use_lbfgs, False),
        )
        reads += cam_res.host_reads
        x_cam = cam_res.x
        # Recorded before the doubling: a flipped winner shares this camera.
        camera_loss = cam_res.f
        camera_evals = cam_res.n_evals
    else:
        x_cam = x0
        camera_loss = torch.zeros(B, dtype=x0.dtype, device=dev)
        camera_evals = torch.zeros(B, dtype=torch.int64, device=dev)

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
    # A stage without the collision term takes the joints-only energy
    # (settings.interpenetration would force the full-mesh one).
    plain_settings = dataclasses.replace(settings, interpenetration=False)
    body_mask = body_stage_mask(settings, dev)

    def vertices_of(z):
        params, _, _ = body_params_from_flat(settings, z, decode_body)
        return smplx_forward(
            model, params, use_pca=settings.use_pca,
            flat_hand_mean=settings.flat_hand_mean,
            use_face_contour=settings.use_face_contour, return_verts=True,
        ).vertices

    x_cur = xs
    losses, evals, snaps = [], [], []
    for k in range(num_stages):
        w = stage_weights.stage(k)
        with_coll = coll_stage_mask[k]
        hoist = (with_coll and use_lbfgs
                 and options.coll_broad_refresh == "iter")

        def fun(z, aux=None, w=w, k=k, with_coll=with_coll):
            return smplify_energy(
                z, settings if with_coll else plain_settings, model, frames2,
                w, k, num_stages, decode_body, joint_map, gmm=gmm,
                joints_model=joints_model, lhand_gmm=lhand_gmm,
                rhand_gmm=rhand_gmm,
                collision_fn=collision_fn if with_coll else None,
                collision_aux=aux,
            )

        aux_fn = aux_refresh_fn = None
        if hoist:
            # A refresh keeps the stage's first Morton order (build_refresh):
            # exact up to the pair budgets for any order, and skips the sort.
            def aux_fn(z):
                return collision_fn.build(vertices_of(z))

            def aux_refresh_fn(z, aux):
                return collision_fn.build_refresh(vertices_of(z), aux)

        graphed = _graphed(x_cur, model, use_lbfgs, with_coll and not hoist)
        res = _run_stage(run_min, k, with_coll, fun, x_cur, body_mask,
                         options.lbfgs, graphed, aux_fn=aux_fn,
                         aux_refresh_fn=aux_refresh_fn)
        reads += res.host_reads
        x_cur = res.x
        losses.append(res.f)
        evals.append(res.n_evals)
        if options.keep_stage_params:
            # a copy: the next stage's L-BFGS may update x in place
            snaps.append(res.x.detach().clone())
    stage_x = torch.stack(snaps) if options.keep_stage_params else None
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
        if stage_x is not None:
            stage_x = torch.where(take_flip[None, :, None], stage_x[:, B:],
                                  stage_x[:, :B])
    else:
        take_flip = torch.zeros(B, dtype=torch.bool, device=dev)
        x_out, loss_out = x_cur, final_loss

    return FitResult(
        x=x_out, loss=loss_out, camera_loss=camera_loss, flipped=take_flip,
        stage_losses=stage_losses, stage_evals=stage_evals,
        camera_evals=camera_evals, host_reads=reads, stage_x=stage_x,
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
    _check_device(dev, x=x, faces=model.faces)
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
