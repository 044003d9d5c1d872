"""Fit-state checkpointing and warm starts.

Counterpart of `smplifyx_tpu/fitting/checkpoint.py`:

  * `save_fit_state` / `load_fit_state`: the flat parameter matrix [B, D],
    the frame names and the stage index in one .npz;
  * `warm_start_from_results`: x0 rebuilt from a previous run's per-frame
    result pickles (the reference's schema, written by either package),
    so a new run continues from the earlier solution.
"""

from __future__ import annotations

import os.path as osp
from typing import Sequence

import numpy as np
import torch

from smplifyx_torch.fitting.params import FitSettings, pack
from smplifyx_torch.utils.io import load_result_pickle


def save_fit_state(path: str, x, names: Sequence[str], stage: int = -1) -> None:
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    np.savez(path, x=x, names=np.asarray(list(names)), stage=np.asarray(stage))


def load_fit_state(path: str) -> tuple[np.ndarray, list[str], int]:
    d = np.load(path, allow_pickle=False)
    return d["x"], [str(n) for n in d["names"]], int(d["stage"])


def warm_start_from_results(
    result_dir: str,
    names: Sequence[str],
    settings: FitSettings,
    vposer=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Assemble x0 [B, D] (numpy) from per-frame result pickles.

    Returns (x0, found_mask); frames without a pickle keep zeros and
    found=False.  Under VPoser the saved decoded pose is encoded back to
    its latent mean, in one batch on the VPoser's device.
    """
    B = len(names)
    found = np.zeros(B, bool)
    sizes = settings.segments()
    rows = {k: [] for k in ("cam_t", "global_orient", "body", "betas",
                            "expression", "jaw", "leye", "reye", "lhand",
                            "rhand")}
    for i, name in enumerate(names):
        pkl = osp.join(result_dir, name, "000.pkl")
        if osp.exists(pkl):
            d = load_result_pickle(pkl)
            found[i] = True

            def g(key, size):
                return np.asarray(d[key], np.float32).reshape(-1)[:size]

            # settings.body_pose_dof, not 63: SMPL carries 69 body dofs
            vals = {
                "cam_t": g("camera_translation", 3),
                "global_orient": g("global_orient", 3),
                "body": g("body_pose", settings.body_pose_dof),
                "betas": g("betas", settings.num_betas),
                "expression": g("expression", settings.num_expr),
                "jaw": g("jaw_pose", 3),
                "leye": g("leye_pose", 3),
                "reye": g("reye_pose", 3),
                "lhand": g("left_hand_pose", settings.hand_dim),
                "rhand": g("right_hand_pose", settings.hand_dim),
            }
        else:
            vals = {k: np.zeros(sizes[k][1], np.float32) for k in rows}
            if settings.use_vposer:     # a pose, encoded with the rest below
                vals["body"] = np.zeros(settings.body_pose_dof, np.float32)
        for k in rows:
            rows[k].append(vals[k])

    body = np.stack(rows.pop("body"))
    if settings.use_vposer:
        if vposer is None:
            raise ValueError("a VPoser fit needs the VPoser to warm-start")
        dev = next(vposer.parameters()).device
        with torch.no_grad():
            latents = vposer.encode_mean(torch.as_tensor(body, device=dev))
        body = latents.cpu().numpy()
        body[~found] = 0.0
    x0 = pack(settings, body=torch.as_tensor(body),
              **{k: torch.as_tensor(np.stack(v)) for k, v in rows.items()})
    return x0.numpy(), found
