"""Reusable fit session: config -> model, priors, schedule and options.

Counterpart of `smplifyx_tpu/session.py`: `build_fit_session` validates a
config and assembles everything `FitSession.fit` needs to run the staged
fit (fitting/pipeline.py::fit_batch) on a prepared batch: body models per
gender ({model_folder}/{family}/{FAMILY}_{GENDER}.npz, else .pkl), the
priors (GMMs, VPoser), the stage schedule, the optimizer options and the
collision term.  `FitSession.fit_stages` runs the same fit one stage per
call.

The collision tables are built from the model given to `build_fit_session`
or, without one, from the first model a fit receives (the gendered SMPL-X
models share one mesh topology), as the JAX package builds them: a model
folder needs only the genders a run fits.
"""

from __future__ import annotations

import dataclasses
import os.path as osp
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from smplifyx_torch.fitting.lbfgs import LBFGSConfig
from smplifyx_torch.fitting.optimizers import make_optimizer
from smplifyx_torch.fitting.params import FitSettings
from smplifyx_torch.fitting.pipeline import FitOptions, FitResult, fit_batch
from smplifyx_torch.fitting.prepare import _norm_prior, settings_from_config
from smplifyx_torch.fitting.stages import build_stage_schedule
from smplifyx_torch.models.bodymodel import load_body_model, synthetic_model
from smplifyx_torch.models.joint_mapping import (
    NUM_BODY_JOINTS_BY_FORMAT,
    SHOULDER_IDXS_BY_FORMAT,
    model_to_annotation,
)
from smplifyx_torch.models.vposer import (
    VPoser,
    load_vposer,
    random_params,
    vposer_from_state_dict,
)
from smplifyx_torch.ops.collision import load_part_segm, make_collision_fn
from smplifyx_torch.priors.priors import load_gmm_pickle
from smplifyx_torch.utils.config import Config
from smplifyx_torch.utils.device import device_for_platform, resolve_device


@dataclass
class FitSession:
    """Everything needed to fit prepared batches with one configuration."""

    cfg: Config
    settings: FitSettings
    options: FitOptions
    schedule: object            # StageWeights stacked [S, ...]
    joint_map: torch.Tensor
    edge_idxs: torch.Tensor
    decode_body: Callable
    vposer: Optional[VPoser]
    gmm: object
    lhand_gmm: object
    rhand_gmm: object
    coll_stage_mask: Optional[tuple]
    get_model: Callable[[str], object]
    device: torch.device
    # CollisionFn; None without interpenetration, or until the first fit
    # builds it from its model (`collision_for`)
    collision_fn: object
    # make_collision_fn's arguments besides the faces, kept for that build
    collision_args: Optional[dict] = field(default=None, repr=False)

    def collision_for(self, model):
        """The collision term, built from `model`'s faces on first use."""
        if self.collision_fn is None and self.collision_args is not None:
            self.collision_fn = make_collision_fn(model.faces,
                                                  **self.collision_args)
        return self.collision_fn

    def fit(self, model, joints_model, frames, x0) -> FitResult:
        """Run the staged fit on a prepared batch."""
        return fit_batch(
            model, self.settings, self.options, self.schedule, frames, x0,
            self.decode_body, self.joint_map, gmm=self.gmm,
            edge_idxs=self.edge_idxs, joints_model=joints_model,
            coll_stage_mask=self.coll_stage_mask,
            lhand_gmm=self.lhand_gmm, rhand_gmm=self.rhand_gmm,
            collision_fn=self.collision_for(model), device=self.device,
        )

    def fit_stages(self, model, joints_model, frames,
                   x0) -> Iterator[tuple[int, FitResult]]:
        """Yield (stage, FitResult) after the head (camera stage and body
        stage 0) and after every later body stage, as the JAX package's
        `FitSession.fit_stages` does.

        Each stage is one `fit_batch` over a one-stage schedule, so the
        dual-orientation choice is made after the head and later stages
        refine the winner only, and a VPoser fit with a regression prior
        takes the last stage's deviation prior in every stage (both as in
        the JAX package).  Later stages skip the camera stage
        (`FitOptions.camera_stage=False`) and start from the previous x.
        """
        num_stages = self.schedule.num_stages
        mask = self.coll_stage_mask or (False,) * num_stages
        body_options = dataclasses.replace(self.options, camera_stage=False,
                                           try_both_orient=False)
        collision_fn = self.collision_for(model)
        x = x0
        for k in range(num_stages):
            res = fit_batch(
                model, self.settings, self.options if k == 0 else body_options,
                self.schedule.map(lambda a, k=k: a[k:k + 1]), frames, x,
                self.decode_body, self.joint_map, gmm=self.gmm,
                edge_idxs=self.edge_idxs, joints_model=joints_model,
                coll_stage_mask=(mask[k],), lhand_gmm=self.lhand_gmm,
                rhand_gmm=self.rhand_gmm, collision_fn=collision_fn,
                device=self.device,
            )
            x = res.x
            yield k, res

    def joint_weights(self) -> np.ndarray:
        """Base per-keypoint weights of this config's format and flags:
        the dataset-free equivalent of `get_joint_weights()`."""
        cfg = self.cfg
        n = NUM_BODY_JOINTS_BY_FORMAT[cfg.format.lower()]
        if cfg.use_hands:
            n += 42
        if cfg.use_face:
            n += 51 + 17 * bool(cfg.use_face_contour)
        w = np.ones(n, np.float32)
        if cfg.joints_to_ign and -1 not in cfg.joints_to_ign:
            w[np.asarray(cfg.joints_to_ign)] = 0.0
        return w


def _identity(b):
    return b


def build_fit_session(cfg: Config, model=None, device=None) -> FitSession:
    """Validate the config and assemble a FitSession (no dataset IO).
    `device` overrides the config's `platform`."""
    dev = resolve_device(device or device_for_platform(cfg.platform))
    if cfg.float_dtype != "float32":
        raise NotImplementedError(
            f"float_dtype={cfg.float_dtype!r}: only float32 is supported")
    if cfg.camera_type != "persp":
        raise NotImplementedError(
            f"camera_type={cfg.camera_type!r}: only 'persp' is supported")
    if cfg.optim_type.lower() not in ("lbfgs", "lbfgsls"):
        make_optimizer(cfg.optim_type, cfg.lr)   # an unknown name raises

    settings = settings_from_config(cfg)

    def get_model(gender: str):
        if model is not None:
            return model
        if cfg.synthetic_model:
            return synthetic_model(
                num_verts=cfg.synthetic_num_verts, num_betas=cfg.num_betas,
                num_expression_coeffs=cfg.num_expression_coeffs,
                num_pca_comps=cfg.num_pca_comps, model_type=cfg.model_type,
                device=dev,
            )
        # The layout smplx.create resolves in the reference
        # (main.py:109-127): .npz first, then .pkl.
        stem = osp.join(cfg.model_folder, cfg.model_type,
                        f"{cfg.model_type.upper()}_{gender.upper()}")
        path = next((p for p in (stem + ".npz", stem + ".pkl")
                     if osp.exists(p)), stem + ".npz")
        return load_body_model(
            path, cfg.model_type, num_betas=cfg.num_betas,
            num_expression_coeffs=cfg.num_expression_coeffs,
            num_pca_comps=cfg.num_pca_comps, device=dev,
        )

    joint_map = torch.as_tensor(model_to_annotation(
        cfg.model_type, cfg.use_hands, cfg.use_face, cfg.use_face_contour,
        cfg.format,
    ), dtype=torch.int64, device=dev)

    gmm = None
    if cfg.body_prior_type == "gmm":
        gmm = load_gmm_pickle(
            osp.join(cfg.prior_folder, f"gmm_{cfg.num_gaussians:02d}.pkl"), dev)

    def hand_gmm(prior_type):
        if _norm_prior(prior_type) != "gmm":
            return None
        path = osp.join(cfg.prior_folder, f"gmm_{cfg.num_pca_comps:02d}.pkl")
        prior = load_gmm_pickle(path, dev)
        dim = prior.means.shape[-1]
        if dim != cfg.num_pca_comps:
            raise ValueError(
                f"hand GMM prior {path} models {dim}-dim poses but "
                f"num_pca_comps={cfg.num_pca_comps}"
            )
        return prior

    vposer = None
    decode_body = _identity
    if cfg.use_vposer:
        if str(cfg.vposer_ckpt).lower() in ("", "synthetic"):
            # Random weights when the licensed checkpoint is absent, like
            # synthetic_model (not the JAX package's random weights).
            vposer = vposer_from_state_dict(random_params(0), dev)
        else:
            vposer = load_vposer(osp.expandvars(cfg.vposer_ckpt), dev)
        decode_body = vposer.decode

    collision_fn = collision_args = coll_stage_mask = None
    if cfg.interpenetration:
        segm = parents = None
        if cfg.part_segm_fn:
            segm, parents = load_part_segm(osp.expandvars(cfg.part_segm_fn))
        # The narrow-phase budget honours at least the reference's
        # max_collisions.
        collision_args = dict(
            segm=segm, parents=parents, ign_part_pairs=cfg.ign_part_pairs,
            max_pairs=max(cfg.max_coll_pairs, cfg.max_collisions),
            sigma=cfg.df_cone_height,
            penalize_outside=cfg.penalize_outside,
            point2plane=cfg.point2plane,
        )
        if model is not None:
            collision_fn = make_collision_fn(model.faces, **collision_args)
        weights = cfg.coll_loss_weights or [0.0] * cfg.num_stages
        coll_stage_mask = tuple(float(v) > 0 for v in weights)
    schedule = build_stage_schedule(
        cfg.body_pose_prior_weights, cfg.shape_weights, cfg.expr_weights,
        cfg.hand_pose_prior_weights, cfg.jaw_pose_prior_weights,
        cfg.hand_joints_weights, cfg.face_joints_weights,
        cfg.coll_loss_weights, device=dev,
    )
    ls, rs = SHOULDER_IDXS_BY_FORMAT[cfg.format.lower()]
    soft = cfg.resolved_ls_soft_accept
    soft_kw = {} if soft is None else {"ls_soft_accept": soft}
    options = FitOptions(
        lbfgs=LBFGSConfig(
            max_iters=cfg.resolved_lbfgs_iters, history=cfg.history_size,
            max_ls=cfg.resolved_max_line_search, lr=cfg.lr,
            ftol=cfg.ftol, gtol=cfg.gtol, ls_mode=cfg.resolved_ls_mode,
            aux_every=cfg.resolved_coll_broad_every,
            max_evals=cfg.resolved_max_evals, **soft_kw,
        ),
        # The camera stage stays on strong Wolfe in both profiles; the fast
        # profile's soft accept applies.
        camera_lbfgs=LBFGSConfig(
            max_iters=cfg.maxiters * 2, history=8, lr=cfg.lr,
            ftol=cfg.ftol, gtol=cfg.gtol, **soft_kw,
        ),
        optim_type=cfg.optim_type,
        try_both_orient=cfg.try_both_orient,
        side_view_thsh=cfg.side_view_thsh,
        left_shoulder_idx=ls, right_shoulder_idx=rs,
        use_camera_prior=cfg.use_camera_prior and bool(cfg.regression_prior),
        # Per-stage snapshots feed the per-stage overlays (reference
        # fit_single_frame.py:509-520), kept only when the app draws them.
        keep_stage_params=cfg.visualize,
    )
    edge_idxs = torch.as_tensor(cfg.body_tri_pairs, dtype=torch.int64,
                                device=dev)
    return FitSession(
        cfg=cfg, settings=settings, options=options, schedule=schedule,
        joint_map=joint_map, edge_idxs=edge_idxs, decode_body=decode_body,
        vposer=vposer, gmm=gmm, lhand_gmm=hand_gmm(cfg.left_hand_prior_type),
        rhand_gmm=hand_gmm(cfg.right_hand_prior_type),
        coll_stage_mask=coll_stage_mask, get_model=get_model, device=dev,
        collision_fn=collision_fn, collision_args=collision_args,
    )
