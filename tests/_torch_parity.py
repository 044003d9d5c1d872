"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

`run_both` runs one preset through both packages' `app.run` on the same
data folder, and `held_to_jax` holds the port's result to JAX's: the same
names and file trees, pickles of the same keys and shapes, and every
frame's final loss within LOSS_RTOL (whole fits agree at loss level, not
trajectory level).  `example_inputs` rebuilds the JAX package's batched
video-sequence example (examples/video_batch.py) with its own functions.
"""

import contextlib
import json
import os
import shutil

import numpy as np
import jax.numpy as jnp
import torch

from smplifyx_tpu.app import run as j_run
from smplifyx_tpu.fitting.energy import FrameData as JFrameData
from smplifyx_tpu.fitting.lbfgs import LBFGSConfig as JConfig
from smplifyx_tpu.fitting.params import FitSettings as JSettings
from smplifyx_tpu.fitting.params import pack as j_pack
from smplifyx_tpu.fitting.pipeline import FitOptions as JOptions
from smplifyx_tpu.fitting.stages import build_stage_schedule as j_schedule
from smplifyx_tpu.models.bodymodel import build_extra_lmk_matrix
from smplifyx_tpu.models.bodymodel import smooth_synthetic_model as j_smooth_model
from smplifyx_tpu.models.bodymodel import synthetic_model as j_synthetic_model
from smplifyx_tpu.models.forward import BodyParams as JBodyParams
from smplifyx_tpu.models.forward import smplx_forward as j_forward
from smplifyx_tpu.models.joint_mapping import model_to_annotation
from smplifyx_tpu.ops.camera import CameraParams as JCamera
from smplifyx_tpu.ops.camera import project_points as j_project
from smplifyx_tpu.ops.collision import make_collision_fn as j_collision_fn
from smplifyx_tpu.ops.collision import synthetic_part_segm as j_part_segm
from smplifyx_tpu.utils.config import load_config as j_load_config
from smplifyx_tpu.utils.io import load_result_pickle as j_load_result_pickle

from smplifyx_torch.app import run
from smplifyx_torch.problem import SLICE_PRESET, slice_model, slice_part_segm
from smplifyx_torch.utils.config import load_config
from smplifyx_torch.utils.io import read_ply

PRESETS = {name: os.path.join(os.path.dirname(SLICE_PRESET),
                              f"fit_smplx_{name}.yaml")
           for name in ("combined_coco25", "combined_vposer_coco25",
                        "smplifyx", "combined_halpe")}
ITERS = 2
LOSS_RTOL = 0.05


@contextlib.contextmanager
def torch_threads(n):
    """torch's intra-op thread count set to n inside the block.  The port's
    CPU fits at these tests' small shapes are many tiny ops; with a thread
    per core in every test worker, the workers' threads wait on each other
    and such a fit runs tens of times slower than alone."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def tree(out):
    return sorted(os.path.relpath(os.path.join(d, f), out)
                  for d, _, files in os.walk(out) for f in files)


def configs(preset, out, **overrides):
    kw = dict(maxiters=ITERS, interactive=False, **overrides)
    return (j_load_config(PRESETS[preset], output_folder=out + "_jax", **kw),
            load_config(PRESETS[preset], output_folder=out + "_torch", **kw))


def run_both(preset, out, models=None, max_frames=None, **overrides):
    """One config, both packages: (JAX result, port result, output dirs).
    `max_frames` keeps the data folder's first frames in both; the port
    fits on one thread (`torch_threads`)."""
    jcfg, tcfg = configs(preset, out, **overrides)
    jres = j_run(jcfg, model=None if models is None else models[0],
                 max_frames=max_frames)
    with torch_threads(1):
        tres = run(tcfg, model=None if models is None else models[1],
                   max_frames=max_frames, device="cpu")
    return jres, tres, (jcfg.output_folder, tcfg.output_folder)


def held_to_jax(jres, tres, outs):
    assert tres.names == jres.names
    assert tree(outs[1]) == tree(outs[0])
    assert np.isfinite(tres.losses).all()
    rel = np.abs(tres.losses - np.asarray(jres.losses)) / np.abs(jres.losses)
    assert (rel <= LOSS_RTOL).all(), rel
    for tf, jf in zip(tres.result_files, jres.result_files):
        got, want = j_load_result_pickle(tf), j_load_result_pickle(jf)
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            assert not isinstance(got[key], torch.Tensor), key
            assert np.shape(got[key]) == np.shape(value), key
        assert (got["H"], got["W"], got["focal_length"]) == \
            (want["H"], want["W"], want["focal_length"])
        verts, _ = read_ply(os.path.join(os.path.dirname(tf), "vertices.ply"))
        assert np.isfinite(verts).all()
    assert tres.stats["num_frames"] == len(tres.names)
    assert set(tres.spans) == {"setup", "read", "prepare", "fit", "recover",
                               "write"}
    return rel


def halpe_folder(src, dst):
    """The folder with a 26th body keypoint in every JSON (Halpe-26)."""
    shutil.copytree(src, dst)
    keyp = os.path.join(dst, "keypoints")
    for name in os.listdir(keyp):
        path = os.path.join(keyp, name)
        with open(path) as f:
            doc = json.load(f)
        for person in doc["people"]:
            person["pose_keypoints_2d"] += person["pose_keypoints_2d"][-3:]
        with open(path, "w") as f:
            json.dump(doc, f)
    return dst


def jax_model(V, kind):
    """The JAX package's model and part segmentation of `video_problem`'s
    `model_kind`: the example's synthetic model, or the smooth model with
    the faces of the port's `slice_model` (the JAX model's static
    landmarks are a matrix over its faces, rebuilt for them)."""
    if kind == "synthetic":
        model = j_synthetic_model(num_verts=V, seed=0)
        return (model, *j_part_segm(int(model.faces.shape[0]), seed=2))
    tslice = slice_model(V, device="cpu")
    model = j_smooth_model(num_verts=V, seed=0)
    faces = tslice.faces.numpy().astype(np.int32)
    lmk = build_extra_lmk_matrix(
        V, np.asarray(model.extra_joint_vids), faces,
        np.asarray(model.lmk_faces_idx), np.asarray(model.lmk_bary_coords))
    model = model.replace(faces=jnp.asarray(faces),
                          extra_lmk_matrix=jnp.asarray(lmk))
    return (model, *slice_part_segm(tslice))


def example_inputs(B, V, kind="synthetic", iters=40):
    """The JAX example's problem (examples/video_batch.py:39-91) on
    `jax_model(V, kind)`, with `iters` L-BFGS iterations per body stage
    (the example's 40 by default); its `window=16` dropped: the JAX
    package ignores it."""
    model, segm, parents = jax_model(V, kind)
    settings = JSettings(interpenetration=True)
    joint_map = jnp.asarray(model_to_annotation("smplx", True, True, True,
                                                "coco25"))
    K = joint_map.shape[0]
    t = np.linspace(0, 2 * np.pi, B, dtype=np.float32)[:, None]
    freq = np.random.default_rng(0).uniform(0.5, 2.0, (1, 63)).astype(np.float32)
    phase = np.random.default_rng(1).uniform(0, np.pi, (1, 63)).astype(np.float32)
    poses = 0.15 * np.sin(freq * t + phase)
    gt = JBodyParams.zeros(B).replace(body_pose=jnp.asarray(poses))
    cam_t = jnp.asarray(np.tile([[0.0, 0.0, 4.0]], (B, 1)), jnp.float32)
    out = j_forward(model, gt, joint_map=joint_map)
    cam = JCamera(
        rotation=jnp.broadcast_to(jnp.eye(3), (B, 3, 3)), translation=cam_t,
        focal=jnp.full((B, 2), 1000.0),
        center=jnp.broadcast_to(jnp.asarray([320.0, 240.0]), (B, 2)))
    frames = JFrameData(
        gt_joints=j_project(cam, out.joints), conf=jnp.ones((B, K)),
        joint_weights=jnp.ones((B, K)), focal=jnp.full((B, 2), 1000.0),
        center=jnp.broadcast_to(jnp.asarray([320.0, 240.0]), (B, 2)),
        data_weight=jnp.full((B,), 1000.0 / 480),
        init_joints_mask=jnp.asarray(
            np.isin(np.arange(K), [9, 12, 2, 5]).astype(np.float32)[None]
            .repeat(B, 0)),
        trans_estimation=jnp.zeros((B, 3)),
        depth_loss_weight=jnp.full((B,), 1e2),
        regression_body=jnp.zeros((B, 63)))
    x0 = j_pack(settings, cam_t=jnp.zeros((B, 3)),
                global_orient=jnp.zeros((B, 3)), body=jnp.zeros((B, 63)))
    collision_fn = j_collision_fn(
        model.faces, segm=segm, parents=parents,
        ign_part_pairs=["9,16", "9,17"], sigma=1e-3)
    schedule = j_schedule(
        [4.04e2, 57.4, 4.78], coll_loss_weights=[0.0, 0.1, 1.0],
        hand_joints_weights=[0.0, 0.0, 1.0],
        face_joints_weights=[0.0, 0.0, 1.0])
    options = JOptions(
        lbfgs=JConfig(max_iters=iters, history=12, ls_soft_accept=6),
        camera_lbfgs=JConfig(max_iters=20, history=8, ls_soft_accept=6))
    return dict(model=model, settings=settings, joint_map=joint_map,
                poses=poses, cam=cam, out=out, frames=frames, x0=x0,
                segm=segm, parents=parents, collision_fn=collision_fn,
                schedule=schedule, options=options)
