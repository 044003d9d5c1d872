"""Cropped-EHF evaluation protocol: per-part Procrustes V2V on observed parts.

Counterpart of `smplifyx_tpu/evaluation/ehf.py` (reference
smplifyx/eval.py):
  * fitted and ground-truth meshes load from .ply trees (eval.py:46-58);
  * J14 joints come from a [14, V] regressor (:93-97);
  * visibility: the ground-truth vertices are projected with the EHF
    ground-truth camera shifted by the image's crop box, and those inside
    the 800x600 frame are kept (:60-66, :98-108);
  * the visible indices are intersected with the body, face and hand
    vertex-id sets (MANO_SMPLX_vertex_ids.pkl, SMPL-X__FLAME_vertex_ids.npy,
    SMPL-X__BODY_vertex_ids.npy; :71-76, :103-106);
  * per part, the Procrustes-aligned mean V2V and PA-MPJPE-14, in mm
    (:123-146).

The metrics run on the card unless `device` (`--platform cpu`) asks for
the CPU.  `synthetic_part_vertex_ids` stands in for the licensed id sets.

    python -m smplifyx_torch.evaluation.ehf --fitted_dir out/results \
        --gt_dir EHF --bbox_dir EHF/bbox --mano_smplx_pkl ... \
        --flame_vertex_ids ... --body_vertex_ids ... [--j14_regressor ...] \
        [--platform cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os.path as osp
import pickle
import re
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from smplifyx_torch.evaluation.metrics import procrustes_v2v
from smplifyx_torch.ops.camera import EHF_IMG_SIZE, ehf_gt_camera, project_points
from smplifyx_torch.utils.device import device_for_platform, resolve_device
from smplifyx_torch.utils.io import read_ply


@dataclass
class PartVertexIds:
    body: np.ndarray
    face: np.ndarray
    left_hand: np.ndarray
    right_hand: np.ndarray


def load_part_vertex_ids(
    mano_smplx_pkl: str,
    flame_vertex_ids_npy: str,
    body_vertex_ids_npy: str,
) -> PartVertexIds:
    """Load the published part vertex-id files (eval.py:71-76)."""
    with open(mano_smplx_pkl, "rb") as f:
        d = pickle.load(f, encoding="latin1")
    return PartVertexIds(
        body=np.asarray(np.load(body_vertex_ids_npy), np.int64),
        face=np.asarray(np.load(flame_vertex_ids_npy), np.int64),
        left_hand=np.asarray(d["left_hand"], np.int64),
        right_hand=np.asarray(d["right_hand"], np.int64),
    )


def synthetic_part_vertex_ids(num_verts: int, seed: int = 0) -> PartVertexIds:
    """Disjoint random part id sets with EHF-like proportions; the JAX
    package's for the same seed."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_verts)
    n_face = max(1, num_verts // 10)
    n_hand = max(1, num_verts // 14)
    face = perm[:n_face]
    lh = perm[n_face:n_face + n_hand]
    rh = perm[n_face + n_hand:n_face + 2 * n_hand]
    body = perm[n_face + 2 * n_hand:]
    return PartVertexIds(body=np.sort(body), face=np.sort(face),
                         left_hand=np.sort(lh), right_hand=np.sort(rh))


def load_j14_regressor(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return np.asarray(pickle.load(f, encoding="latin1"), np.float32)


def load_mesh_tree(root_dir: str, gt: bool = False) -> Dict[str, np.ndarray]:
    """Every .ply under root_dir keyed by image name (eval.py:46-58):
    ground-truth trees by '<prefix>_cropped' from the file name, fitted
    trees by the parent directory's name."""
    out = {}
    for f in sorted(glob.glob(osp.join(root_dir, "**/*.ply"), recursive=True)):
        if gt:
            key = re.split(r"/|\\", f)[-1].split("_")[0] + "_cropped"
        else:
            key = re.split(r"/|\\", f)[-2]
        out[key], _ = read_ply(f)
    return out


def visible_indices(gt_vertices, xmin: float, ymin: float,
                    bound: tuple[int, int] = EHF_IMG_SIZE,
                    device="cuda") -> np.ndarray:
    """Indices of the ground-truth vertices whose projection by the EHF
    ground-truth camera lies inside the (width, height) bound
    (eval.py:60-66, 98-108)."""
    dev = resolve_device(device)
    cam = ehf_gt_camera(xmin=xmin, ymin=ymin, device=dev)
    pts = torch.as_tensor(np.asarray(gt_vertices, np.float32), device=dev)
    proj = project_points(cam, pts)
    w, h = bound
    ok = ((proj[:, 0] >= 0) & (proj[:, 0] < w)
          & (proj[:, 1] >= 0) & (proj[:, 1] < h))
    return torch.nonzero(ok)[:, 0].cpu().numpy()


@dataclass
class EHFFrameMetrics:
    v2v_all: float
    v2v_body: Optional[float]
    v2v_face: Optional[float]
    v2v_left_hand: Optional[float]
    v2v_right_hand: Optional[float]
    pa_mpjpe14: Optional[float]


def _pa_mean(fitted: np.ndarray, gt: np.ndarray, dev) -> float:
    err = procrustes_v2v(torch.as_tensor(fitted, device=dev),
                         torch.as_tensor(gt, device=dev))
    return float(err.mean())


def evaluate_frame(
    fitted_vertices: np.ndarray,    # [V, 3]
    gt_vertices: np.ndarray,        # [V, 3]
    bbox_xmin: float,
    bbox_ymin: float,
    part_ids: PartVertexIds,
    j14_regressor: Optional[np.ndarray] = None,
    device="cuda",
) -> EHFFrameMetrics:
    """Per-part Procrustes V2V on the observed (in-crop) vertex subsets."""
    dev = resolve_device(device)
    fitted_vertices = np.asarray(fitted_vertices, np.float32)
    gt_vertices = np.asarray(gt_vertices, np.float32)
    vis = visible_indices(gt_vertices, bbox_xmin, bbox_ymin, device=dev)

    def part_err(ids):
        sel = np.intersect1d(vis, ids)
        if len(sel) < 3:  # Procrustes needs at least 3 points
            return None
        return _pa_mean(fitted_vertices[sel], gt_vertices[sel], dev)

    pa14 = None
    if j14_regressor is not None:
        gt_j14 = j14_regressor @ gt_vertices
        fit_j14 = j14_regressor @ fitted_vertices
        jvis = visible_indices(gt_j14, bbox_xmin, bbox_ymin, device=dev)
        if len(jvis) >= 3:
            pa14 = _pa_mean(fit_j14[jvis], gt_j14[jvis], dev)

    return EHFFrameMetrics(
        v2v_all=part_err(np.arange(len(gt_vertices))),
        v2v_body=part_err(part_ids.body),
        v2v_face=part_err(part_ids.face),
        v2v_left_hand=part_err(part_ids.left_hand),
        v2v_right_hand=part_err(part_ids.right_hand),
        pa_mpjpe14=pa14,
    )


def evaluate_ehf(
    fitted_dir: str,
    gt_dir: str,
    bbox_dir: str,
    part_ids: PartVertexIds,
    j14_regressor: Optional[np.ndarray] = None,
    device="cuda",
) -> Dict[str, float]:
    """The protocol over a results tree; means in mm
    (All/Body/Face/LHand/RHand/MPJPE-14, eval.py:140-146)."""
    dev = resolve_device(device)
    gt_all = load_mesh_tree(gt_dir, gt=True)
    fit_all = load_mesh_tree(fitted_dir, gt=False)

    agg: Dict[str, list] = {k: [] for k in
                            ("all", "body", "face", "lhand", "rhand", "j14")}
    for key in gt_all:
        if key not in fit_all:
            continue
        with open(osp.join(bbox_dir, key + ".txt")) as f:
            xmin, _, ymin, _ = [float(v) for v in f.read().split()]
        m = evaluate_frame(fit_all[key], gt_all[key], xmin, ymin, part_ids,
                           j14_regressor, device=dev)
        for name, val in (("all", m.v2v_all),
                          ("body", m.v2v_body), ("face", m.v2v_face),
                          ("lhand", m.v2v_left_hand),
                          ("rhand", m.v2v_right_hand), ("j14", m.pa_mpjpe14)):
            # a metric is None with fewer than 3 visible points in the
            # crop: left out of the mean
            if val is not None:
                agg[name].append(val)

    mm = {k: 1000.0 * float(np.mean(v)) if v else float("nan")
          for k, v in agg.items()}
    return {
        "pa_v2v_all_mm": mm["all"],
        "pa_v2v_body_mm": mm["body"],
        "pa_v2v_face_mm": mm["face"],
        "pa_v2v_left_hand_mm": mm["lhand"],
        "pa_v2v_right_hand_mm": mm["rhand"],
        "pa_mpjpe14_mm": mm["j14"],
        "num_frames": len(agg["all"]),
    }


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Cropped-EHF evaluation (reference eval.py protocol)")
    p.add_argument("--fitted_dir", required=True)
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--bbox_dir", required=True)
    p.add_argument("--mano_smplx_pkl", required=True)
    p.add_argument("--flame_vertex_ids", required=True)
    p.add_argument("--body_vertex_ids", required=True)
    p.add_argument("--j14_regressor", default=None)
    p.add_argument("--platform", default=None,
                   help="gpu (the default) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(device_for_platform(args.platform))
    part_ids = load_part_vertex_ids(
        args.mano_smplx_pkl, args.flame_vertex_ids, args.body_vertex_ids)
    j14 = load_j14_regressor(args.j14_regressor) if args.j14_regressor else None
    out = evaluate_ehf(args.fitted_dir, args.gt_dir, args.bbox_dir,
                       part_ids, j14, device=dev)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
