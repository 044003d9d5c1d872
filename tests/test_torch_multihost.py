"""Port parity for `smplifyx_torch/parallel/multihost.py` on the CPU: the
dry run's global problem against the JAX dry run's construction
(`__graft_entry__.py::dryrun_multihost`), ranks over gloo on 127.0.0.1
at 2x1 and 2x2 against the port's and JAX's `fit_batch`, the gather over
three ranks, and the launcher's failures.  Every wait on a rank has a
limit (`launch_ranks`'s `timeout_s`)."""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smplifyx_tpu.fitting.energy import FrameData as JFrameData
from smplifyx_tpu.fitting.lbfgs import LBFGSConfig as JLBFGSConfig
from smplifyx_tpu.fitting.params import FitSettings as JFitSettings
from smplifyx_tpu.fitting.params import pack as j_pack
from smplifyx_tpu.fitting.pipeline import FitOptions as JFitOptions
from smplifyx_tpu.fitting.pipeline import fit_batch as j_fit_batch
from smplifyx_tpu.fitting.stages import build_stage_schedule as j_schedule
from smplifyx_tpu.models.bodymodel import synthetic_model as j_synthetic_model
from smplifyx_tpu.models.forward import BodyParams as JBodyParams
from smplifyx_tpu.models.forward import smplx_forward as j_smplx_forward
from smplifyx_tpu.models.joint_mapping import model_to_annotation
from smplifyx_tpu.ops.camera import CameraParams as JCameraParams
from smplifyx_tpu.ops.camera import project_points as j_project_points

from smplifyx_torch.fitting.pipeline import fit_batch
from smplifyx_torch.parallel import (
    dryrun_multihost,
    fit_batch_multihost,
    launch_ranks,
    multihost,
    process_rows,
)
from smplifyx_torch.problem import multihost_problem

RANK_TIMEOUT_S = 120


def jax_problem(B):
    """The JAX dry run's global problem (`__graft_entry__.py`:318-365)."""
    model = j_synthetic_model(num_verts=64, seed=0)
    settings = JFitSettings(use_face_contour=True)
    joint_map = jnp.asarray(model_to_annotation("smplx", True, True, True,
                                                "coco25"))
    K = joint_map.shape[0]
    rng = np.random.default_rng(0)
    gt = JBodyParams.zeros(B).replace(
        body_pose=jnp.asarray(rng.normal(0, 0.1, (B, 63)), jnp.float32))
    out = j_smplx_forward(model, gt, joint_map=joint_map)
    cam = JCameraParams(
        rotation=jnp.broadcast_to(jnp.eye(3), (B, 3, 3)),
        translation=jnp.asarray(np.tile([[0.0, 0.0, 4.0]], (B, 1)),
                                jnp.float32),
        focal=jnp.full((B, 2), 1000.0),
        center=jnp.broadcast_to(jnp.asarray([320.0, 240.0]), (B, 2)))
    gt2d = np.asarray(j_project_points(cam, out.joints))
    frames = dict(
        gt_joints=gt2d.astype(np.float32),
        conf=np.ones((B, K), np.float32),
        joint_weights=np.ones((B, K), np.float32),
        focal=np.full((B, 2), 1000.0, np.float32),
        center=np.tile([[320.0, 240.0]], (B, 1)).astype(np.float32),
        data_weight=np.full((B,), 1000.0 / 480, np.float32),
        init_joints_mask=np.isin(np.arange(K), [9, 12, 2, 5])
        .astype(np.float32)[None].repeat(B, 0),
        trans_estimation=np.zeros((B, 3), np.float32),
        depth_loss_weight=np.full((B,), 1e2, np.float32),
        regression_body=np.zeros((B, 63), np.float32),
    )
    x0 = np.asarray(j_pack(settings, cam_t=jnp.zeros((B, 3)),
                           global_orient=jnp.zeros((B, 3)),
                           body=jnp.zeros((B, 63))))
    schedule = j_schedule(
        [4.04e2, 4.78], shape_weights=[1e2, 5.0], expr_weights=[1e2, 5.0],
        hand_pose_prior_weights=[1e2, 5.0], hand_joints_weights=[0.0, 1.0],
        face_joints_weights=[0.0, 1.0])
    options = JFitOptions(
        lbfgs=JLBFGSConfig(max_iters=2, history=4, max_ls=4),
        camera_lbfgs=JLBFGSConfig(max_iters=2, history=4, max_ls=4))
    return model, settings, options, schedule, frames, x0, joint_map


def jax_loss(B):
    model, settings, options, schedule, frames, x0, joint_map = jax_problem(B)
    fitted = jax.jit(lambda m, fr, x: j_fit_batch(
        m, settings, options, schedule, fr, x, lambda b: b, joint_map,
        edge_idxs=jnp.asarray([[5, 12], [2, 9]])))
    res = fitted(model, JFrameData(**{k: jnp.asarray(v)
                                      for k, v in frames.items()}),
                 jnp.asarray(x0))
    return np.asarray(res.loss)


def one_thread_blocks(B, block):
    """The port's fit_batch on each `block` frames of the global problem,
    built and fitted at one intra-op thread, as a CPU rank and its
    workers do."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        problem = multihost_problem(B, device="cpu")
        frames, x0 = problem.pop("frames"), problem.pop("x0")
        return [fit_batch(**problem, frames=frames.map(lambda a: a[lo:lo + block]),
                          x0=x0[lo:lo + block], device="cpu")
                for lo in range(0, B, block)]
    finally:
        torch.set_num_threads(threads)


def test_problem_matches_jax_dryrun_construction():
    B = 4
    port = multihost_problem(B, device="cpu")
    model, settings, options, schedule, frames, x0, joint_map = jax_problem(B)
    for f in dataclasses.fields(port["model"]):
        got = getattr(port["model"], f.name)
        if isinstance(got, torch.Tensor):
            assert np.array_equal(got.numpy(),
                                  np.asarray(getattr(model, f.name))), f.name
    for name, want in frames.items():
        got = getattr(port["frames"], name).numpy()
        if name == "gt_joints":
            np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
        else:
            assert np.array_equal(got, want), name
    assert np.array_equal(port["x0"].numpy(), x0)
    assert np.array_equal(port["joint_map"].numpy(), np.asarray(joint_map))
    for f in dataclasses.fields(schedule):
        assert np.array_equal(getattr(port["stage_weights"], f.name).numpy(),
                              np.asarray(getattr(schedule, f.name))), f.name
    assert port["settings"].use_face_contour and settings.use_face_contour
    for stage in ("lbfgs", "camera_lbfgs"):
        got, want = getattr(port["options"], stage), getattr(options, stage)
        assert (got.max_iters, got.history, got.max_ls) == \
            (want.max_iters, want.history, want.max_ls) == (2, 4, 4)
    assert port["edge_idxs"].tolist() == [[5, 12], [2, 9]]


@pytest.mark.parametrize("n_processes,n_local", [(2, 1), (2, 2)])
def test_dryrun_ranks_agree_and_match_fit_batch(n_processes, n_local):
    """Every rank gathers the same bits; they are the bits of the port's
    fit_batch on each device's block, and within 5% per lane of JAX's
    fit_batch on the whole problem (f32 L-BFGS: loss level)."""
    B = 2 * n_processes * n_local
    out = dryrun_multihost(n_processes, n_local, device="cpu",
                           timeout_s=RANK_TIMEOUT_S)
    for i, text in enumerate(out["outputs"]):
        assert f"SHARD process={i} local_rows={B // n_processes} of B={B}" \
            in text
    blocks = one_thread_blocks(B, 2)
    loss = torch.cat([b.loss for b in blocks])
    assert out["digest"] == multihost.digest(
        loss, torch.cat([b.x for b in blocks]))
    assert out["loss"] == loss.tolist()
    np.testing.assert_allclose(out["loss"], jax_loss(B), rtol=0.05)


RANK = "from smplifyx_torch.parallel import multihost as m; " \
       "import sys, torch; a = m.rank_parser().parse_args(sys.argv[1:]); " \
       "m.initialize(a.coordinator, a.num_processes, a.process_id, 30); "


def test_process_allgather_three_ranks():
    code = RANK + """
r = a.process_id
got = m.process_allgather(torch.tensor([r, r + 0.5]))
assert got.tolist() == [0, 0.5, 1, 1.5, 2, 2.5], got
got = m.process_allgather(torch.arange(12).reshape(1, 3, 4) + 100 * r)
assert got.shape == (3, 3, 4) and got.dtype == torch.int64
assert torch.equal(got, torch.stack([torch.arange(12).reshape(3, 4) + 100 * i
                                     for i in range(3)]))
got = m.process_allgather(torch.tensor([r == 1, True]))
assert got.dtype == torch.bool and got.tolist() == [False, True, True, True,
                                                    False, True]
assert m.process_rows(9) == (3 * r, 3 * r + 3)
try:
    m.process_allgather(torch.zeros(2 + (r == 2)))
except ValueError as e:
    print("MISMATCH", e)
m.shutdown()
"""
    outs = launch_ranks([["-c", code]] * 3, timeout_s=RANK_TIMEOUT_S)
    for out in outs:
        assert ("MISMATCH process_allgather: the ranks' tensors differ in "
                "shape or dtype: rank 0 (2,) torch.float32, rank 1 (2,) "
                "torch.float32, rank 2 (3,) torch.float32") in out


def test_process_rows_needs_a_batch_that_divides(monkeypatch):
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "process_index", lambda: 1)
    assert process_rows(6) == (3, 6)
    with pytest.raises(ValueError, match="5 frames do not divide over 2 "
                       "processes"):
        process_rows(5)


def _all_exited():
    run = launch_ranks.last_run
    assert None not in run["returncodes"]
    for pid in run["pids"]:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_missing_rank_fails_within_the_rendezvous_timeout():
    """A world of 3 with 2 ranks started: the rendezvous times out after
    initialization_timeout, and the launcher raises with the rank's
    output."""
    code = ("import sys; from smplifyx_torch.parallel.multihost import main; "
            "a = sys.argv[1:]; a[a.index('--num-processes') + 1] = '3'; "
            "sys.exit(main(a + ['--initialization-timeout', '3', "
            "'--platform', 'cpu']))")
    t0 = time.time()
    with pytest.raises(RuntimeError, match="(?s)rank [01] of 2 exited with "
                       "code [1-9].*Traceback.*initialize"):
        launch_ranks([["-c", code]] * 2, timeout_s=RANK_TIMEOUT_S)
    assert time.time() - t0 < 60
    _all_exited()


def test_rank_that_raises_stops_every_rank():
    code = RANK + """
if a.process_id == 1:
    raise RuntimeError("rank one gives up")
m.process_allgather(torch.zeros(1))
"""
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 exited with code "
                       "1.*rank one gives up"):
        launch_ranks([["-c", code]] * 2, timeout_s=RANK_TIMEOUT_S)
    _all_exited()


def test_launcher_timeout_kills_every_rank():
    with pytest.raises(RuntimeError, match=r"ranks \[0, 1\] of 2 still "
                       r"running after 3 s; killed"):
        launch_ranks([["-c", "import time; time.sleep(60)"]] * 2, timeout_s=3)
    _all_exited()


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    problem = multihost_problem(2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_batch_multihost(**problem)
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.main(["2", "1"])
    port = multihost._free_port()
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.main(["--coordinator", f"127.0.0.1:{port}",
                        "--num-processes", "1", "--process-id", "0",
                        "--initialization-timeout", "30"])
    assert not torch.distributed.is_initialized()


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="process_id 2 is not a rank of 2"):
        multihost.initialize("127.0.0.1:1", 2, 2)
    problem = multihost_problem(2, device="cpu")
    with pytest.raises(ValueError, match="`devices` places the fit"):
        fit_batch_multihost(**problem, devices=["cpu"], device="cpu")
