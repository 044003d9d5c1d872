"""Reusable fit session: config -> model, priors, schedule and options.

Counterpart of `smplifyx_tpu/session.py`: `build_fit_session` validates a
config and assembles everything `FitSession.fit` needs to run the staged
fit (fitting/pipeline.py::fit_batch) on a prepared batch.
"""

from __future__ import annotations

import os.path as osp
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from smplifyx_torch.fitting.lbfgs import LBFGSConfig
from smplifyx_torch.fitting.params import FitSettings
from smplifyx_torch.fitting.pipeline import FitOptions, FitResult, fit_batch
from smplifyx_torch.fitting.prepare import _norm_prior, settings_from_config
from smplifyx_torch.fitting.stages import build_stage_schedule
from smplifyx_torch.models.bodymodel import load_body_model, synthetic_model
from smplifyx_torch.models.joint_mapping import (
    SHOULDER_IDXS_BY_FORMAT,
    model_to_annotation,
)
from smplifyx_torch.priors.priors import load_gmm_pickle
from smplifyx_torch.utils.config import Config
from smplifyx_torch.utils.device import resolve_device


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
    gmm: object
    lhand_gmm: object
    rhand_gmm: object
    coll_stage_mask: Optional[tuple]
    get_model: Callable[[str], object]
    device: torch.device

    def fit(self, model, joints_model, frames, x0) -> FitResult:
        """Run the staged fit on a prepared batch."""
        return fit_batch(
            model, self.settings, self.options, self.schedule, frames, x0,
            self.decode_body, self.joint_map, gmm=self.gmm,
            edge_idxs=self.edge_idxs, joints_model=joints_model,
            coll_stage_mask=self.coll_stage_mask,
            lhand_gmm=self.lhand_gmm, rhand_gmm=self.rhand_gmm,
            device=self.device,
        )


def _identity(b):
    return b


def build_fit_session(cfg: Config, model=None, device="cuda") -> FitSession:
    """Validate the config and assemble a FitSession (no dataset IO)."""
    dev = resolve_device(device)
    if cfg.float_dtype != "float32":
        raise NotImplementedError(
            f"float_dtype={cfg.float_dtype!r}: only float32 is supported")
    if cfg.camera_type != "persp":
        raise NotImplementedError(
            f"camera_type={cfg.camera_type!r}: only 'persp' is supported")
    if cfg.interpenetration:
        raise NotImplementedError(
            "interpenetration: true needs the collision term, which is not "
            "ported yet (ROADMAP queue 1 item 7); pass interpenetration=False"
        )
    if cfg.use_vposer:
        raise NotImplementedError(
            "use_vposer: true needs VPoser, which is not ported yet "
            "(ROADMAP queue 1 item 4)"
        )
    if cfg.optim_type.lower() not in ("lbfgs", "lbfgsls"):
        raise NotImplementedError(
            f"optim_type={cfg.optim_type!r}: the first-order optimizers are "
            "not ported yet (ROADMAP queue 1 item 8)"
        )

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
        path = osp.join(cfg.model_folder, cfg.model_type,
                        f"{cfg.model_type.upper()}_{gender.upper()}.npz")
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

    coll_stage_mask = None   # collision configs are refused above
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
    )
    edge_idxs = torch.as_tensor(cfg.body_tri_pairs, dtype=torch.int64,
                                device=dev)
    return FitSession(
        cfg=cfg, settings=settings, options=options, schedule=schedule,
        joint_map=joint_map, edge_idxs=edge_idxs, decode_body=_identity,
        gmm=gmm, lhand_gmm=hand_gmm(cfg.left_hand_prior_type),
        rhand_gmm=hand_gmm(cfg.right_hand_prior_type),
        coll_stage_mask=coll_stage_mask, get_model=get_model, device=dev,
    )
