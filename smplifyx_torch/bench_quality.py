"""Fit quality against synthetic ground truth on one CUDA card: the port's
counterpart of the JAX package's `bench_quality.py`.

    python -m smplifyx_torch.bench_quality [B] [wolfe|armijo] [platform]
        [out_path] [max_evals] [max_iters] [--device cuda|cpu]
        [--num-verts 10475]

The positional arguments are the JAX program's, in its order and with its
defaults (64 wolfe '' none 0 30); `platform` is `gpu`, `cuda` or `cpu`
(`utils/device.py::device_for_platform`), or empty for `--device`.  The
committed artifacts' protocol is `64 armijo '' <out> 90 60`.

The run (bench_quality.py:69-131): B frames of `bench.build(B, smooth=True)`
(`smooth_synthetic_model`, V=10475, whose shape the joints determine); the
init is the ground-truth pose plus noise from `default_rng(42)` (0.05 rad
on the global orientation, 0.1 on the body pose; shape and camera
unknown); bench.py's schedule; body stages `ls_mode` with `max_evals`,
`max_iters` iterations, history 10, 4 trials per line search under Armijo
and 25 under Wolfe; the camera stage strong Wolfe, max(15, max_iters // 2)
iterations; then `recover_outputs`.

The metrics (bench_quality.py:146-183, `quality_metrics`), per frame:
PA-V2V over all vertices; body, face and hands PA-V2V, each part aligned
on its own, a vertex's part the one of its dominant skinning joint (hands:
wrists and fingers, face: neck, head, jaw and eyes); PA-MPJPE over 14
skeleton joints (the LSP-14 stand-in for the J14 regressor); the 2D
reprojection error of the fitted joints in pixels.  One JSON line, the
JAX program's record (bench_quality.py:185-208) with `device`, `git` and
`options` beside it; `out_path` writes the same record.  An out_path
named like a JAX round artifact (`QUALITY_r*.json`) in the repository's
root is refused: the JAX package's tests read every such file there.
"""

from __future__ import annotations

import argparse
import dataclasses
import fnmatch
import json
import os.path as osp
import time

import numpy as np
import torch

from smplifyx_torch import bench
from smplifyx_torch.evaluation.metrics import procrustes_v2v
from smplifyx_torch.fitting.lbfgs import LBFGSConfig
from smplifyx_torch.fitting.params import FitSettings, pack, unpack
from smplifyx_torch.fitting.pipeline import FitOptions, recover_outputs
from smplifyx_torch.models.bodymodel import SMPLXModel
from smplifyx_torch.models.forward import BodyParams, smplx_forward
from smplifyx_torch.ops.camera import CameraParams, project_points
from smplifyx_torch.problem import ground_truth
from smplifyx_torch.utils.device import device_for_platform, resolve_device

BATCH = 64
REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
JAX_ARTIFACTS = "QUALITY_r*.json"
# Dominant skinning joints of each part (bench_quality.py:147-149).
LHAND_JOINTS = (20, *range(25, 40))
RHAND_JOINTS = (21, *range(40, 55))
FACE_JOINTS = (12, 15, 22, 23, 24)
# LSP-14 stand-in: ankles, knees, hips, wrists, elbows, shoulders, neck,
# head (bench_quality.py:166).
J14 = (8, 5, 2, 1, 4, 7, 21, 19, 17, 16, 18, 20, 12, 15)


def options(ls_mode: str = "wolfe", max_evals: int = 0,
            max_iters: int = 30) -> FitOptions:
    """The options of bench_quality.py:101-118."""
    return FitOptions(
        lbfgs=LBFGSConfig(max_iters=max_iters, history=10, ftol=1e-9,
                          gtol=1e-9, ls_soft_accept=6, ls_mode=ls_mode,
                          max_evals=max_evals,
                          max_ls=4 if ls_mode == "armijo" else 25),
        camera_lbfgs=LBFGSConfig(max_iters=max(15, max_iters // 2),
                                 history=8, ls_soft_accept=6))


def build(B: int = BATCH, V: int = bench.NUM_VERTS,
          device="cuda") -> tuple[bench.Problem, BodyParams]:
    """(problem with the regression-like init as x0, ground truth) of
    bench_quality.py:69-96."""
    dev = resolve_device(device)
    p = bench.build(B, V, smooth=True, device=dev)
    gt = ground_truth(B, dev)
    rng = np.random.default_rng(42)

    def noise(sd, shape):
        return torch.as_tensor(rng.normal(0, sd, shape).astype(np.float32),
                               device=dev)

    seg = unpack(p.settings, p.x0)
    seg["global_orient"] = gt.global_orient + noise(0.05, (B, 3))
    seg["body"] = gt.body_pose + noise(0.1, (B, 63))
    return dataclasses.replace(p, x0=pack(p.settings, **seg)), gt


def part_vertex_ids(model: SMPLXModel) -> dict:
    """{body, face, lhand, rhand: vertex ids} by dominant skinning joint."""
    dom = model.lbs_weights.argmax(dim=1)
    dev = dom.device

    def where(joints):
        return torch.nonzero(torch.isin(dom, torch.as_tensor(
            joints, device=dev))).flatten()

    parts = {"lhand": where(LHAND_JOINTS), "rhand": where(RHAND_JOINTS),
             "face": where(FACE_JOINTS)}
    taken = torch.zeros_like(dom, dtype=torch.bool)
    for ids in parts.values():
        taken[ids] = True
    parts["body"] = torch.nonzero(~taken).flatten()
    return parts


def quality_metrics(model: SMPLXModel, settings: FitSettings, x: torch.Tensor,
                    gt: BodyParams, frames, joint_map: torch.Tensor) -> dict:
    """Per-frame errors [B] of fitted flat parameters x against the ground
    truth, as numpy arrays: PA-V2V `v2v_mm`, `body_mm`, `face_mm`,
    `hands_mm` (the mean of the two hands), `pa_mpjpe14_mm` and
    `reproj_px`."""
    dev = x.device
    out, params, cam_t = recover_outputs(model, settings, x, lambda b: b,
                                         device=dev)
    with torch.no_grad():
        gt_out = smplx_forward(model, gt)

        def pa_mm(a, b):
            return 1000.0 * procrustes_v2v(a, b).mean(-1)

        parts = part_vertex_ids(model)

        def part_mm(name):
            ids = parts[name]
            return pa_mm(out.vertices[:, ids], gt_out.vertices[:, ids])

        j14 = torch.as_tensor(J14, device=dev)
        fit_j = smplx_forward(model, params).joints[:, j14]
        gt_j = gt_out.joints[:, j14]
        B = x.shape[0]
        cam = CameraParams(torch.eye(3, device=dev).expand(B, 3, 3), cam_t,
                           frames.focal, frames.center)
        proj = project_points(cam, smplx_forward(
            model, params, joint_map=joint_map).joints)
        reproj = torch.sqrt(((proj - frames.gt_joints) ** 2).sum(-1)).mean(-1)
        metrics = {"v2v_mm": pa_mm(out.vertices, gt_out.vertices),
                   "body_mm": part_mm("body"), "face_mm": part_mm("face"),
                   "hands_mm": 0.5 * (part_mm("lhand") + part_mm("rhand")),
                   "pa_mpjpe14_mm": pa_mm(fit_j, gt_j), "reproj_px": reproj}
    return {k: v.cpu().numpy() for k, v in metrics.items()}


def record(m: dict, ls_mode: str, max_evals: int, max_iters: int,
           dev: torch.device, stage_evals: np.ndarray, num_verts: int,
           elapsed_s: float) -> dict:
    """The JAX program's record (bench_quality.py:185-208) of
    `quality_metrics`' arrays."""
    v2v = m["v2v_mm"]
    return {
        "metric": "synthetic_gt_pa_v2v_mm",
        "value": round(float(v2v.mean()), 3),
        "unit": "mm",
        "ls_mode": ls_mode,
        "max_evals": max_evals,
        "max_iters": max_iters,
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "git": bench.git_sha(),
        "p90_mm": round(float(np.percentile(v2v, 90)), 3),
        "max_mm": round(float(v2v.max()), 3),
        "body_mm": round(float(m["body_mm"].mean()), 3),
        "face_mm": round(float(m["face_mm"].mean()), 3),
        "hands_mm": round(float(m["hands_mm"].mean()), 3),
        "pa_mpjpe14_mm": round(float(m["pa_mpjpe14_mm"].mean()), 3),
        "reproj_px_mean": round(float(m["reproj_px"].mean()), 3),
        "reproj_px_max": round(float(m["reproj_px"].max()), 3),
        "stage_evals_mean": [round(float(e), 1)
                             for e in stage_evals.mean(1)],
        "num_frames": int(v2v.shape[0]),
        "num_verts": num_verts,
        "elapsed_s": round(elapsed_s, 1),
    }


def check_out_path(out_path: str) -> None:
    """Refuse to write a JAX round artifact's name into the repository's
    root, where the JAX package's tests read every QUALITY_r*.json."""
    path = osp.abspath(out_path)
    if (osp.dirname(path) == REPO
            and fnmatch.fnmatch(osp.basename(path), JAX_ARTIFACTS)):
        raise ValueError(
            f"{out_path}: the repository's root holds the JAX package's "
            f"{JAX_ARTIFACTS} artifacts; write the port's record elsewhere")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", type=int, nargs="?", default=BATCH)
    ap.add_argument("ls_mode", nargs="?", default="wolfe")
    ap.add_argument("platform", nargs="?", default="")
    ap.add_argument("out_path", nargs="?", default="")
    ap.add_argument("max_evals", type=int, nargs="?", default=0)
    ap.add_argument("max_iters", type=int, nargs="?", default=30)
    ap.add_argument("--num-verts", type=int, default=bench.NUM_VERTS)
    bench.device_argument(ap)
    args = ap.parse_args(argv)
    device = device_for_platform(args.platform) if args.platform \
        else args.device
    dev = resolve_device(device)
    if args.out_path:
        check_out_path(args.out_path)

    p, gt = build(args.B, args.num_verts, dev)
    opts = options(args.ls_mode, args.max_evals, args.max_iters)
    t0 = time.time()
    res = bench.fit(p, opts, bench.schedule(device=dev))
    m = quality_metrics(p.model, p.settings, res.x, gt, p.frames,
                        p.joint_map)
    rec = {**record(m, args.ls_mode, args.max_evals, args.max_iters, dev,
                    res.stage_evals.cpu().numpy(), p.model.num_verts,
                    time.time() - t0),
           **bench.provenance(dev, opts)}
    print(json.dumps(rec), flush=True)
    if args.out_path:
        with open(args.out_path, "w") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")
    return rec


if __name__ == "__main__":
    main()
