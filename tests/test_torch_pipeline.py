"""Port parity for the staged fit against the JAX package, on the CPU.

Whole fits are compared at loss level: f32 L-BFGS trajectories diverge
between implementations (docs/ARCHITECTURE.md "Numerics").  The slice's
configuration is the combined preset without collision and with the
guess-init camera path."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from smplifyx_tpu.fitting.lbfgs import LBFGSConfig as JConfig
from smplifyx_tpu.fitting.pipeline import FitOptions as JOptions
from smplifyx_tpu.fitting.pipeline import fit_batch as j_fit_batch
from smplifyx_tpu.fitting.pipeline import recover_outputs as j_recover
from smplifyx_tpu.fitting.prepare import settings_from_config as j_settings
from smplifyx_tpu.fitting.stages import build_stage_schedule as j_schedule
from smplifyx_tpu.models.sparse import build_joints_model as j_joints_model
from smplifyx_tpu.utils.config import load_config as j_load_config

from smplifyx_torch import convert
from smplifyx_torch.fitting.lbfgs import LBFGSConfig
from smplifyx_torch.fitting.pipeline import FitOptions, fit_batch, recover_outputs
from smplifyx_torch.models.sparse import build_joints_model
from smplifyx_torch.problem import (
    SLICE_OVERRIDES,
    SLICE_PRESET,
    build_problem,
    build_slice,
    slice_config,
)
from smplifyx_torch.session import build_fit_session

B, V, ITERS = 2, 96, 10


def jfields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name))
                     if hasattr(getattr(obj, f.name), "shape")
                     else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def schedule_args(cfg):
    return (cfg.body_pose_prior_weights, cfg.shape_weights, cfg.expr_weights,
            cfg.hand_pose_prior_weights, cfg.jaw_pose_prior_weights,
            cfg.hand_joints_weights, cfg.face_joints_weights,
            cfg.coll_loss_weights)


@pytest.fixture(scope="module")
def fits():
    """The same problem fitted by both packages, at <= ITERS per stage."""
    jcfg = j_load_config(SLICE_PRESET, **SLICE_OVERRIDES,
                         synthetic_num_verts=V)
    model, _, jframes, x0, jmap = bench.build_problem(B, V)
    js = j_settings(jcfg)
    edges = jnp.asarray(jcfg.body_tri_pairs)
    lb = dict(max_iters=ITERS, history=16, max_ls=4, ls_mode="armijo",
              ls_soft_accept=6, max_evals=3 * ITERS // 2)
    cam = dict(max_iters=ITERS, history=8, ls_soft_accept=6)
    jopt = JOptions(lbfgs=JConfig(**lb), camera_lbfgs=JConfig(**cam),
                    try_both_orient=True)
    jres = jax.jit(lambda m, jm, fr, x: j_fit_batch(
        m, js, jopt, j_schedule(*schedule_args(jcfg)), fr, x, lambda b: b,
        jmap, edge_idxs=edges, joints_model=jm))(
            model, j_joints_model(model), jframes, x0)

    tmodel = convert.smplx_model(jfields(model), "cpu")
    tframes = convert.frame_data(jfields(jframes), "cpu")
    topt = FitOptions(lbfgs=LBFGSConfig(**lb), camera_lbfgs=LBFGSConfig(**cam),
                      try_both_orient=True)
    tsched = convert.stage_weights(jfields(j_schedule(*schedule_args(jcfg))),
                                   "cpu")
    tres = fit_batch(
        tmodel, convert.fit_settings(jfields(js)), topt, tsched, tframes,
        torch.as_tensor(np.array(x0)), lambda b: b,
        torch.as_tensor(np.array(jmap), dtype=torch.int64),
        edge_idxs=torch.as_tensor(np.asarray(edges)),
        joints_model=build_joints_model(tmodel), device="cpu")
    return dict(model=model, tmodel=tmodel, js=js, jmap=jmap, jres=jres,
                tres=tres, jframes=jframes, x0=x0)


def test_problem_matches_bench(fits):
    _, settings, frames, x0, jmap = build_problem(B, V, device="cpu")
    ref = jfields(fits["jframes"])
    for name, got in dataclasses.asdict(frames).items():
        # gt_joints are projected pixels: f32 forwards in another order.
        atol = 1e-3 if name == "gt_joints" else 0
        np.testing.assert_allclose(got.numpy(), ref[name], atol=atol,
                                   rtol=0, err_msg=name)
    np.testing.assert_array_equal(x0.numpy(), np.asarray(fits["x0"]))
    np.testing.assert_array_equal(jmap.numpy(), np.asarray(fits["jmap"]))


def test_losses_match_at_loss_level(fits):
    j, t = fits["jres"], fits["tres"]
    # f32 L-BFGS trajectories diverge between implementations, so the
    # bound is at loss level (ROADMAP "Tolerances"): 5% per lane.
    np.testing.assert_allclose(t.camera_loss.numpy(),
                               np.asarray(j.camera_loss), rtol=0.05)
    np.testing.assert_allclose(t.loss.numpy(), np.asarray(j.loss), rtol=0.05)
    np.testing.assert_array_equal(t.flipped.numpy(), np.asarray(j.flipped))
    assert np.isfinite(t.stage_losses.numpy()).all()
    assert t.stage_losses.shape == (3, B) and t.stage_evals.shape == (3, B)
    assert int(t.stage_evals.max()) <= 3 * ITERS // 2 + 4
    assert t.host_reads > 0


def test_recover_outputs_matches(fits):
    x = np.asarray(fits["jres"].x)
    ref, _, ref_cam = j_recover(fits["model"], fits["js"], jnp.asarray(x),
                                lambda b: b, fits["jmap"])
    out, _, cam = recover_outputs(
        fits["tmodel"], convert.fit_settings(jfields(fits["js"])),
        torch.as_tensor(x), lambda b: b,
        torch.as_tensor(np.array(fits["jmap"]), dtype=torch.int64),
        device="cpu")
    np.testing.assert_allclose(out.vertices.numpy(), np.asarray(ref.vertices),
                               atol=1e-5)
    np.testing.assert_allclose(out.joints.numpy(), np.asarray(ref.joints),
                               atol=1e-5)
    np.testing.assert_array_equal(cam.numpy(), np.asarray(ref_cam))


def test_session_runs_the_slice_end_to_end():
    session, model, jm, frames, x0 = build_slice(B, V, device="cpu",
                                                 maxiters=3)
    res = session.fit(model, jm, frames, x0)
    assert np.isfinite(res.loss.numpy()).all()
    assert np.isfinite(res.camera_loss.numpy()).all()
    out, _, _ = recover_outputs(model, session.settings, res.x,
                                session.decode_body, session.joint_map,
                                device="cpu")
    assert out.vertices.shape == (B, V, 3)
    assert torch.isfinite(out.vertices).all()


@pytest.mark.parametrize("override,item", [
    (dict(interpenetration=True), "item 7"),
    (dict(use_vposer=True), "item 4"),
    (dict(optim_type="adam"), "item 8"),
])
def test_session_refuses_unported_paths(override, item):
    cfg = slice_config(V, **override)
    with pytest.raises(NotImplementedError, match=item):
        build_fit_session(cfg, device="cpu")
