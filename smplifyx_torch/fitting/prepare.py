"""Fit settings from a config.

Counterpart of the config half of `smplifyx_tpu/fitting/prepare.py`.
Batch assembly from keypoint files (`prepare_batch`) waits for the port of
the data modules.
"""

from __future__ import annotations

from smplifyx_torch.fitting.params import FitSettings
from smplifyx_torch.utils.config import Config


def _norm_prior(t) -> str:
    """Normalize prior-type strings: 'mog' is an alias for 'gmm' (the
    reference CLI's default spelling); None and '' mean none."""
    t = (t or "none").lower()
    return {"mog": "gmm", "": "none"}.get(t, t)


def settings_from_config(cfg: Config) -> FitSettings:
    return FitSettings(
        use_vposer=cfg.use_vposer,
        latent_dim=cfg.vposer_latent_dim,
        num_betas=cfg.num_betas,
        num_expr=cfg.num_expression_coeffs,
        num_pca=cfg.num_pca_comps,
        use_hands=cfg.use_hands,
        use_face=cfg.use_face,
        use_face_contour=cfg.use_face_contour,
        use_pca=cfg.use_pca,
        flat_hand_mean=cfg.flat_hand_mean,
        num_body_kp={"coco25": 25, "coco19": 19, "halpe": 26,
                     "coco_wholebody": 23}[cfg.format.lower()],
        body_pose_dof=69 if cfg.model_type == "smpl" else 63,
        use_joints_conf=cfg.use_joints_conf,
        rho=cfg.rho,
        body_prior_type=cfg.body_prior_type,
        left_hand_prior_type=_norm_prior(cfg.left_hand_prior_type),
        right_hand_prior_type=_norm_prior(cfg.right_hand_prior_type),
        jaw_prior_type=_norm_prior(cfg.jaw_prior_type),
        has_regression_prior=cfg.regression_prior is not None,
        camera_conf_mode=(
            "global_scale" if cfg.use_conf_for_camera_init else "none"
        ),
        interpenetration=cfg.interpenetration,
        optim_shape=cfg.optim_shape,
        optim_expression=cfg.optim_expression,
        optim_jaw=cfg.optim_jaw,
        optim_hands=cfg.optim_hands,
    )
