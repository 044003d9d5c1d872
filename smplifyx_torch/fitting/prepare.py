"""Fit settings from a config, and host-side assembly of frame batches.

Counterpart of `smplifyx_tpu/fitting/prepare.py` (reference main.py:
207-318 and fit_single_frame.py:119-294/359-411): keypoint selection
(person 0 only, main.py:245-246, or every person), per-image focal length
sqrt(W^2+H^2) (main.py:212-214), data_weight = 1000/H, the confidence
threshold on body keypoints (:285-287), camera-init joint trimming
(:289-294), regression-prior pose and camera initialisation (:209-235,
:359-411), and VPoser-latent or GMM-mean pose init (:237-252), batched:
every frame becomes a row of FrameData/x0.  Rows are assembled in numpy
and the batch moves to the fit's device once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from smplifyx_torch.data.keypoints import FrameRecord
from smplifyx_torch.data.regressors import RegressionPrior
from smplifyx_torch.fitting.energy import FrameData
from smplifyx_torch.fitting.params import FitSettings, pack
from smplifyx_torch.utils.config import Config
from smplifyx_torch.utils.device import resolve_device


@dataclass
class PreparedBatch:
    frames: FrameData          # batched [B, ...], on the fit's device
    x0: torch.Tensor           # [B, D], on the fit's device
    names: list[str]           # real frame names (<= B; the rest is padding)
    num_real: int
    img_sizes: list[tuple[int, int]]
    focals: list[float]


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


def prepare_batch(
    cfg: Config,
    records: Sequence[FrameRecord],
    base_joint_weights: np.ndarray,          # [K] from the dataset
    regression: Optional[Sequence[Optional[RegressionPrior]]] = None,
    vposer=None,
    gmm=None,
    batch_size: Optional[int] = None,
    person_id: int = 0,
    all_persons: bool = False,
    device="cuda",
) -> PreparedBatch:
    """Build FrameData and x0 for a list of frames (padded to batch_size
    with copies of the last row), on `device`.

    Only `person_id` (0) of each frame is fitted, the reference's quirk
    (main.py:245-246), unless `all_persons`: then every detected person
    (at most cfg.max_persons) is a row named `<frame>/p<idx>`.  Under
    VPoser the regression pose is encoded to its latent mean in one batch
    on the VPoser's device.
    """
    dev = resolve_device(device)
    settings = settings_from_config(cfg)
    K = len(base_joint_weights)
    nb = settings.num_body_kp
    names, rows, x0_rows = [], [], []
    img_sizes, focals = [], []

    work = []
    for i, rec in enumerate(records):
        if all_persons:
            n = rec.keypoints.shape[0]
            if cfg.max_persons > 0:
                n = min(n, cfg.max_persons)
            for pid in range(n):
                work.append((i, rec, pid, f"{rec.fn}/p{pid}" if n > 1 else rec.fn))
        elif rec.keypoints.shape[0] > person_id:
            work.append((i, rec, person_id, rec.fn))

    encode = []     # (row, regression pose) of the rows VPoser encodes
    for i, rec, pid, row_name in work:
        kp = rec.keypoints[pid]                  # [K, 3]
        if kp.shape[0] != K:
            raise ValueError(f"{rec.fn}: {kp.shape[0]} keypoints, the "
                             f"config's format and flags give {K}")
        H, W = rec.img_size
        focal = cfg.focal_length or float(np.sqrt(W * W + H * H))
        gt = kp[:, :2].astype(np.float32)
        conf = kp[:, 2].astype(np.float32)

        # the confidence threshold applies to body keypoints only (:285-287)
        low_conf = np.zeros(K, bool)
        low_conf[:nb] = conf[:nb] < cfg.confidence_threshold
        joint_w = base_joint_weights.copy()
        joint_w[low_conf] = 0.0

        # trimmed camera-init joints (:289-294)
        init_mask = np.zeros(K, np.float32)
        for idx in cfg.init_joints_idxs:
            if gt[idx, 0] != 0 and gt[idx, 1] != 0 and not low_conf[idx]:
                init_mask[idx] = 1.0

        reg = regression[i] if regression is not None else None
        center = np.array([W / 2.0, H / 2.0], np.float32)
        cam_t0 = np.zeros(3, np.float32)
        if reg is not None and cfg.use_camera_prior:
            if reg.init_translation is not None:
                cam_t0 = reg.init_translation.astype(np.float32)
            if reg.center is not None:
                center = reg.center.astype(np.float32)

        # --- body pose init (:237-252)
        if reg is not None:
            global0 = reg.global_orient.astype(np.float32)
            body0 = reg.body_pose.astype(np.float32)
            if cfg.use_vposer:
                encode.append((len(rows), body0))
        else:
            global0 = np.zeros(3, np.float32)
            if cfg.use_vposer:
                body0 = np.zeros(cfg.vposer_latent_dim, np.float32)
            elif cfg.body_prior_type == "gmm" and gmm is not None:
                body0 = gmm.mean_pose().cpu().numpy().astype(np.float32)
            else:
                body0 = np.zeros(settings.body_dim, np.float32)

        rows.append(dict(
            gt_joints=gt, conf=conf, joint_weights=joint_w.astype(np.float32),
            focal=np.array([focal, focal], np.float32), center=center,
            data_weight=np.float32(1000.0 / H),
            init_joints_mask=init_mask,
            trans_estimation=cam_t0,
            depth_loss_weight=np.float32(cfg.depth_loss_weight),
            regression_body=body0 if reg is not None
            else np.zeros(settings.body_dim, np.float32),
        ))
        x0_rows.append(dict(cam_t=cam_t0, global_orient=global0, body=body0))
        names.append(row_name)
        img_sizes.append((H, W))
        focals.append(focal)

    if encode:
        if vposer is None:
            raise ValueError("use_vposer requires a VPoser")
        vdev = next(vposer.parameters()).device
        poses = torch.as_tensor(np.stack([p for _, p in encode]), device=vdev)
        with torch.no_grad():
            latents = vposer.encode_mean(poses).cpu().numpy()
        for (r, _), z in zip(encode, latents):
            rows[r]["regression_body"] = z
            x0_rows[r]["body"] = z

    num_real = len(rows)
    if num_real == 0:
        raise ValueError("no fittable frames in batch")
    B = batch_size or num_real
    if B < num_real:
        raise ValueError(f"batch_size {B} is smaller than the {num_real} rows")
    rows += [rows[-1]] * (B - num_real)
    x0_rows += [x0_rows[-1]] * (B - num_real)

    def stack(table, key):
        return torch.as_tensor(np.stack([r[key] for r in table]))

    frames = FrameData(**{f: stack(rows, f) for f in rows[0]})
    x0 = pack(settings, **{f: stack(x0_rows, f) for f in x0_rows[0]})
    return PreparedBatch(
        frames=frames.to(dev), x0=x0.to(dev), names=names, num_real=num_real,
        img_sizes=img_sizes, focals=focals,
    )


def pad_prepared(batch: PreparedBatch, B: int) -> PreparedBatch:
    """Pad an assembled batch to B rows by repeating the last row.

    Used for batch-size bucketing (gender groups padded to a power of two,
    as the JAX package does to reuse compiled executables).  Only frames
    and x0 are padded; names and num_real keep describing the real rows."""
    cur = batch.x0.shape[0]
    if B <= cur:
        if B != cur and B < batch.num_real:
            raise ValueError(f"cannot pad {cur} rows to {B}")
        return batch
    reps = B - cur

    def pad(a):
        return torch.cat([a, a[-1:].expand(reps, *a.shape[1:])], dim=0)

    return PreparedBatch(
        frames=batch.frames.map(pad), x0=pad(batch.x0), names=batch.names,
        num_real=batch.num_real, img_sizes=batch.img_sizes,
        focals=batch.focals,
    )
