"""Application driver: config -> dataset -> batched fit -> result files.

Counterpart of `smplifyx_tpu/app.py` (reference main.py:51-328 and the
host-side parts of fit_single_frame): every frame is grouped by gender,
assembled into one FrameData batch per group, fitted in one
`FitSession.fit` on the card, and written per frame.

Kept from the reference and the JAX package:
  * the output folder is wiped on start (main.py:54-55) and the resolved
    config is dumped to conf.yaml (:59-61);
  * only person 0 of each frame is fitted unless `fit_all_persons`
    (:245-246);
  * the focal length defaults to sqrt(W^2+H^2) per image (:212-214);
  * results: a pickle of every camera and model parameter per frame, an
    OBJ mesh, and a vertices PLY when save_vertices is set
    (fit_single_frame.py:641-677);
  * each gender group is padded to a power of two (at least
    cfg.batch_size) with copies of its last frame, as the JAX package
    pads to reuse compiled executables; lanes are independent, so the
    real frames' results do not change;
  * with `visualize`, the fit keeps every body stage's parameters
    (FitResult.stage_x): each pickle gains them under "stages" (what the
    viewer scrubs), and images/<name>/ gets output.png (the final mesh over
    the image), stage_XX.png per body stage (fit_single_frame.py:509-520)
    and, under VPoser, pose_grid.png (the decoded pose on a neutral body,
    :263-271).  The meshes come from one forward per stage over the whole
    group on the card (`viz_forward` span); the host rasteriser draws them
    (`render` span).
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
import shutil
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from smplifyx_torch.data.gender import group_by_gender, load_homogenus
from smplifyx_torch.data.keypoints import create_dataset, load_image
from smplifyx_torch.data.regressors import (
    build_regression_prior,
    load_expose,
    load_pare,
    load_pixie,
)
from smplifyx_torch.fitting.checkpoint import warm_start_from_results
from smplifyx_torch.fitting.params import unpack
from smplifyx_torch.fitting.pipeline import recover_outputs
from smplifyx_torch.fitting.prepare import pad_prepared, prepare_batch
from smplifyx_torch.models.sparse import build_joints_model
from smplifyx_torch.ops.camera import CameraParams
from smplifyx_torch.session import build_fit_session
from smplifyx_torch.utils.config import Config, save_config
from smplifyx_torch.utils.io import (
    PARAM_KEYS,
    save_result_pickle,
    stage_record,
    write_obj,
    write_ply,
)
from smplifyx_torch.utils.timing import FitStats, Timer
from smplifyx_torch.viz.pose_grid import pose_vertices, render_vertex_grid
from smplifyx_torch.viz.render import render_mesh_overlay


@dataclass
class AppResult:
    names: list
    losses: np.ndarray
    result_files: list
    mesh_files: list
    elapsed_s: float
    frames_per_sec: float
    # aggregate work and quality stats (FitStats.summary()); None when the
    # groups' stage counts differ
    stats: Optional[dict] = None
    # wall seconds per span (Timer): setup, read, prepare, fit, recover,
    # write; device work is synchronised before a span closes
    spans: dict = field(default_factory=dict)
    host_reads: int = 0         # device -> host reads steering the fits


def regression_priors(cfg: Config, records):
    if not cfg.regression_prior:
        return None
    out = []
    for rec in records:
        H, W = rec.img_size
        focal = cfg.focal_length or float(np.sqrt(W * W + H * H))
        expose = pixie = pare = None
        if cfg.expose_results_directory:
            expose = load_expose(cfg.expose_results_directory, rec.fn)
        if cfg.pixie_results_directory:
            pixie = load_pixie(cfg.pixie_results_directory, rec.fn)
        if cfg.pare_results_directory:
            pare = load_pare(cfg.pare_results_directory, rec.fn)
        out.append(build_regression_prior(
            cfg.regression_prior, focal, expose=expose, pixie=pixie,
            pare=pare, use_camera_prior=cfg.use_camera_prior))
    return out


@dataclass
class StageOutputs:
    """Host copies of each body stage's results for a group's n frames."""

    segs: list          # per stage: {segment: [n, size]}
    body_pose: list     # per stage: [n, 63] decoded body poses
    vertices: list      # per stage: [n, V, 3]


def stage_outputs(sess, model, stage_x: torch.Tensor, n: int) -> StageOutputs:
    """One forward (recover_outputs) per body stage over the group's first
    n lanes of stage_x [S, B, D], each copied to the host once."""
    segs, body_pose, vertices = [], [], []
    for x in stage_x[:, :n]:
        out, params, _ = recover_outputs(model, sess.settings, x,
                                         sess.decode_body, joint_map=None,
                                         device=sess.device)
        segs.append({k: v.cpu().numpy()
                     for k, v in unpack(sess.settings, x).items()})
        body_pose.append(params.body_pose.cpu().numpy())
        vertices.append(out.vertices.cpu().numpy())
    return StageOutputs(segs, body_pose, vertices)


def render_frame(img_dir, img, img_size, camera, faces, vertices,
                 stages: Optional[StageOutputs], i, grid_vertices) -> None:
    """images/<name>/: output.png, stage_XX.png per body stage and, given
    the pose-grid vertices, pose_grid.png."""
    from PIL import Image

    os.makedirs(img_dir, exist_ok=True)

    def save(file, verts, cam):
        Image.fromarray(render_mesh_overlay(img, verts, faces, cam,
                                            img_size=img_size)
                        ).save(osp.join(img_dir, file))

    save("output.png", vertices, camera)
    for s, seg in enumerate(stages.segs if stages else ()):
        save(f"stage_{s:02d}.png", stages.vertices[s][i],
             camera._replace(translation=seg["cam_t"][i]))
    if grid_vertices is not None:
        Image.fromarray(render_vertex_grid(grid_vertices, faces, tile=256)
                        ).save(osp.join(img_dir, "pose_grid.png"))


def run(cfg: Config, model=None, max_frames: Optional[int] = None,
        device=None) -> AppResult:
    """Fit every frame in cfg.data_folder and write the results.

    `model` overrides body-model loading (e.g. a synthetic model when the
    licensed SMPL-X artifacts are absent); otherwise
    {model_folder}/{family}/{FAMILY}_{GENDER}.npz (or .pkl) is loaded per
    gender.  The fit runs on the card unless cfg.platform or `device`
    (which overrides it) asks for the CPU.
    """
    t_start = time.time()
    timer = Timer()
    with timer.span("setup"):
        sess = build_fit_session(cfg, model=model, device=device)
    settings, dev = sess.settings, sess.device

    # --- output dirs (wipe + conf dump, reference main.py:52-75)
    out = osp.expandvars(cfg.output_folder)
    if osp.exists(out):
        shutil.rmtree(out)
    os.makedirs(out)
    save_config(cfg, osp.join(out, "conf.yaml"))
    result_dir = osp.join(out, cfg.result_folder)
    mesh_dir = osp.join(out, cfg.mesh_folder)
    os.makedirs(result_dir, exist_ok=True)
    os.makedirs(mesh_dir, exist_ok=True)

    with timer.span("read"):
        dataset = create_dataset(
            format=cfg.format, data_folder=cfg.data_folder,
            img_folder=cfg.img_folder, keyp_folder=cfg.keyp_folder,
            use_hands=cfg.use_hands, use_face=cfg.use_face,
            use_face_contour=cfg.use_face_contour,
            joints_to_ign=cfg.joints_to_ign,
        )
        records = list(dataset)
        if max_frames:
            records = records[:max_frames]
        if not records:
            raise FileNotFoundError(f"no frames found under {cfg.data_folder}")
        # gender: annotation > classifier > cfg.gender
        classifier = None
        if cfg.use_gender_classifier and cfg.homogeneous_ckpt:
            classifier = load_homogenus(cfg.homogeneous_ckpt)
        gender_groups = group_by_gender(records, default=cfg.gender,
                                        classifier=classifier)

    names, losses, result_files, mesh_files = [], [], [], []
    evals, flipped = [], []
    host_reads = 0
    for gender, group_records in sorted(gender_groups.items()):
        with timer.span("setup"):
            group_model = sess.get_model(gender)
            joints_model = build_joints_model(group_model)
        with timer.span("read"):
            regression = regression_priors(cfg, group_records)
        with timer.span("prepare"):
            batch = prepare_batch(
                cfg, group_records, dataset.get_joint_weights(),
                regression=regression, vposer=sess.vposer, gmm=sess.gmm,
                all_persons=cfg.fit_all_persons, device=dev,
            )
            if cfg.resume_from:
                x_prev, found = warm_start_from_results(
                    osp.expandvars(cfg.resume_from), batch.names, settings,
                    vposer=sess.vposer)
                x0 = batch.x0.clone()
                hit = torch.as_tensor(found, device=dev)
                x0[:len(found)][hit] = torch.as_tensor(x_prev[found], device=dev)
                batch = dataclasses.replace(batch, x0=x0)
            target = max(batch.num_real, cfg.batch_size, 1)
            batch = pad_prepared(batch, 1 << (target - 1).bit_length())

        n = batch.num_real
        with timer.span("fit", block_on=batch.x0):
            res = sess.fit(group_model, joints_model, batch.frames, batch.x0)
        host_reads += res.host_reads
        with timer.span("recover"):
            out_fwd, _, cam_t = recover_outputs(
                group_model, settings, res.x, sess.decode_body,
                joint_map=None, device=dev)
            with torch.no_grad():
                seg = unpack(settings, res.x[:n])
                body_pose = sess.decode_body(seg["body"])
            # one copy of each result to the host
            host = {k: v.cpu().numpy() for k, v in dict(
                vertices=out_fwd.vertices[:n], cam_t=cam_t[:n],
                body_pose=body_pose, center=batch.frames.center[:n],
                loss=res.loss[:n], flipped=res.flipped[:n],
                stage_evals=res.stage_evals[:, :n],
                **{key: seg[s] for key, s in PARAM_KEYS.items()}).items()}
            faces = group_model.faces.cpu().numpy()

        stages = grid = None
        if cfg.visualize:
            with timer.span("viz_forward"):
                if res.stage_x is not None:
                    stages = stage_outputs(sess, group_model, res.stage_x, n)
                if sess.vposer is not None:
                    grid = pose_vertices(group_model, host["body_pose"])

        with timer.span("write"):
            for i, name in enumerate(batch.names):
                frame_result_dir = osp.join(result_dir, name)
                os.makedirs(frame_result_dir, exist_ok=True)
                H, W = batch.img_sizes[i]
                pkl_path = osp.join(frame_result_dir, "000.pkl")
                save_result_pickle(
                    pkl_path, camera_translation=host["cam_t"][i],
                    camera_center=host["center"][i],
                    focal_length=batch.focals[i], H=H, W=W,
                    params={key: host[key][i] for key in PARAM_KEYS},
                    body_pose=host["body_pose"][i],
                    loss=float(host["loss"][i]),
                    stages=None if stages is None else [
                        stage_record(seg, stages.body_pose[s], i)
                        for s, seg in enumerate(stages.segs)],
                )
                result_files.append(pkl_path)
                frame_mesh_dir = osp.join(mesh_dir, name)
                os.makedirs(frame_mesh_dir, exist_ok=True)
                if cfg.save_meshes:
                    obj_path = osp.join(frame_mesh_dir, "000.obj")
                    write_obj(obj_path, host["vertices"][i], faces)
                    mesh_files.append(obj_path)
                if cfg.save_vertices:
                    write_ply(osp.join(frame_result_dir, "vertices.ply"),
                              host["vertices"][i])
        if cfg.visualize:
            records = {rec.fn: rec for rec in group_records}
            with timer.span("render"):
                for i, name in enumerate(batch.names):
                    rec = records.get(name.split("/")[0])
                    img = None
                    if rec is not None:
                        img = rec.img if rec.img is not None else load_image(
                            rec.img_path)
                    camera = CameraParams(
                        rotation=np.eye(3, dtype=np.float32),
                        translation=host["cam_t"][i],
                        focal=np.full(2, batch.focals[i], np.float32),
                        center=host["center"][i])
                    render_frame(
                        osp.join(out, "images", name), img,
                        batch.img_sizes[i], camera, faces,
                        host["vertices"][i], stages, i,
                        None if grid is None else grid[i:i + 1])
        names.extend(batch.names)
        losses.append(host["loss"])
        evals.append(host["stage_evals"])
        flipped.append(host["flipped"])

    elapsed = time.time() - t_start
    losses_np = np.concatenate(losses)
    stats = None
    if all(e.shape[0] == evals[0].shape[0] for e in evals):
        stats = FitStats(losses=losses_np, flipped=np.concatenate(flipped),
                         stage_evals=np.concatenate(evals, axis=1)).summary()
    total = len(names)
    if cfg.interactive:
        evals_txt = (
            f", evals/stage: {[round(m, 1) for m in stats['stage_evals_mean']]}"
            if stats else "")
        print(f"fitted {total} frame(s) in {elapsed:.2f}s "
              f"({total / elapsed:.2f} frames/s), "
              f"losses: {np.round(losses_np, 2).tolist()}" + evals_txt)
    return AppResult(
        names=names, losses=losses_np, result_files=result_files,
        mesh_files=mesh_files, elapsed_s=elapsed,
        frames_per_sec=total / elapsed, stats=stats, spans=dict(timer.spans),
        host_reads=host_reads,
    )
