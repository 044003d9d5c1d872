"""Port parity for the staged fit against the JAX package, on the CPU.

Whole fits are compared at loss level: f32 L-BFGS trajectories diverge
between implementations (docs/ARCHITECTURE.md "Numerics").  The fits use
the combined preset with the guess-init camera path, with the collision
term off (`fits`) and on (`fit_with_collision`)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from smplifyx_tpu.fitting.lbfgs import LBFGSConfig as JConfig
from smplifyx_tpu.models.bodymodel import build_extra_lmk_matrix
from smplifyx_tpu.fitting.pipeline import FitOptions as JOptions
from smplifyx_tpu.fitting.pipeline import fit_batch as j_fit_batch
from smplifyx_tpu.fitting.pipeline import recover_outputs as j_recover
from smplifyx_tpu.fitting.prepare import settings_from_config as j_settings
from smplifyx_tpu.fitting.stages import build_stage_schedule as j_schedule
from smplifyx_tpu.models.sparse import build_joints_model as j_joints_model
from smplifyx_tpu.ops.collision import make_collision_fn as j_collision_fn
from smplifyx_tpu.ops.collision import synthetic_part_segm
from smplifyx_tpu.utils.config import load_config as j_load_config

from smplifyx_torch import convert
from smplifyx_torch.fitting.lbfgs import LBFGSConfig
from smplifyx_torch.fitting.pipeline import FitOptions, fit_batch, recover_outputs
from smplifyx_torch.models.sparse import build_joints_model
from smplifyx_torch.ops.collision import make_collision_fn
from smplifyx_torch.problem import (
    SLICE_OVERRIDES,
    SLICE_PRESET,
    build_problem,
    build_slice,
    slice_config,
    slice_model,
    slice_part_segm,
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
                         interpenetration=False, synthetic_num_verts=V)
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
    assert session.coll_stage_mask == (False, True, True)
    assert session.cfg.part_segm_fn and session.cfg.ign_part_pairs
    assert session.collision_fn.segm is not None
    assert torch.equal(session.collision_fn.faces, model.faces)
    res = session.fit(model, jm, frames, x0)
    assert np.isfinite(res.loss.numpy()).all()
    assert np.isfinite(res.camera_loss.numpy()).all()
    out, _, _ = recover_outputs(model, session.settings, res.x,
                                session.decode_body, session.joint_map,
                                device="cpu")
    assert out.vertices.shape == (B, V, 3)
    assert torch.isfinite(out.vertices).all()


@pytest.mark.parametrize("override", [dict(optim_type="sgd"),
                                      dict(optim_type="adam")],
                         ids=["override0-item 8", "override1-item 8"])
def test_session_refuses_unported_paths(override):
    """The first-order optimizers build a session; a name that no
    optimizer has is refused, as the JAX package refuses it."""
    session = build_fit_session(slice_config(V, **override), device="cpu")
    assert session.options.optim_type == override["optim_type"]
    with pytest.raises(ValueError, match="not supported"):
        build_fit_session(slice_config(V, optim_type="adagrad"), device="cpu")


def fit_with_collision(refresh, slice_faces, V=V):
    """Collision-on fits by both packages: the preset's last two stages,
    collision in the second only, on the smooth V=96 model.  Its own faces
    take `synthetic_part_segm`; with `slice_faces`, the faces and parts of
    the slice (`slice_model`, `slice_part_segm`) go to both packages."""
    jcfg = j_load_config(SLICE_PRESET, **SLICE_OVERRIDES,
                         synthetic_num_verts=V)
    model, _, jframes, x0, jmap = bench.build_problem(B, V, smooth=True)
    js = j_settings(jcfg)
    assert js.interpenetration
    edges = jnp.asarray(jcfg.body_tri_pairs)
    sched_args = [a[1:] for a in schedule_args(jcfg)]
    mask = (False, True)
    if slice_faces:
        tslice = slice_model(V, device="cpu")
        np.testing.assert_array_equal(tslice.v_template.numpy(),
                                      np.asarray(model.v_template))
        faces = tslice.faces.numpy().astype(np.int32)
        # the JAX model's static landmarks are a matrix over its faces
        lmk = build_extra_lmk_matrix(
            V, np.asarray(model.extra_joint_vids), faces,
            np.asarray(model.lmk_faces_idx), np.asarray(model.lmk_bary_coords))
        model = model.replace(faces=jnp.asarray(faces),
                              extra_lmk_matrix=jnp.asarray(lmk))
        segm, parents = slice_part_segm(tslice)
    else:
        segm, parents = synthetic_part_segm(model.faces.shape[0], 27, seed=0)
    faces = np.asarray(model.faces)
    coll_kw = dict(segm=segm, parents=parents,
                   ign_part_pairs=jcfg.ign_part_pairs,
                   max_pairs=max(jcfg.max_coll_pairs, jcfg.max_collisions),
                   sigma=jcfg.df_cone_height,
                   penalize_outside=jcfg.penalize_outside)
    lb = dict(max_iters=ITERS, history=16, max_ls=4, ls_mode="armijo",
              ls_soft_accept=6, max_evals=3 * ITERS // 2, aux_every=4)
    cam = dict(max_iters=ITERS, history=8, ls_soft_accept=6)
    jopt = JOptions(lbfgs=JConfig(**lb), camera_lbfgs=JConfig(**cam),
                    try_both_orient=True, coll_broad_refresh=refresh)
    jfn = j_collision_fn(jnp.asarray(faces), **coll_kw)
    jres = jax.jit(lambda m, jm, fr, x: j_fit_batch(
        m, js, jopt, j_schedule(*sched_args), fr, x, lambda b: b, jmap,
        edge_idxs=edges, collision_fn=jfn, joints_model=jm,
        coll_stage_mask=mask))(model, j_joints_model(model), jframes, x0)

    tmodel = convert.smplx_model(jfields(model), "cpu")
    topt = FitOptions(lbfgs=LBFGSConfig(**lb), camera_lbfgs=LBFGSConfig(**cam),
                      try_both_orient=True, coll_broad_refresh=refresh)
    tres = fit_batch(
        tmodel, convert.fit_settings(jfields(js)), topt,
        convert.stage_weights(jfields(j_schedule(*sched_args)), "cpu"),
        convert.frame_data(jfields(jframes), "cpu"),
        torch.as_tensor(np.array(x0)), lambda b: b,
        torch.as_tensor(np.array(jmap), dtype=torch.int64),
        edge_idxs=torch.as_tensor(np.asarray(edges)),
        joints_model=build_joints_model(tmodel), coll_stage_mask=mask,
        collision_fn=make_collision_fn(tmodel.faces, **coll_kw), device="cpu")
    return jres, tres


@pytest.fixture(scope="module", params=["eval", "iter"])
def collision_fits(request):
    return fit_with_collision(request.param, slice_faces=False)


def test_collision_fit_matches_at_loss_level(collision_fits):
    assert_collision_fits_match(*collision_fits)


def test_slice_faces_collision_fit_matches_at_loss_level():
    """The slice's own faces and parts, as the main path fits them."""
    assert_collision_fits_match(*fit_with_collision("iter", slice_faces=True))


def assert_collision_fits_match(j, t):
    # loss level, as for the collision-off fit (5% per lane)
    np.testing.assert_allclose(t.loss.numpy(), np.asarray(j.loss), rtol=0.05)
    np.testing.assert_allclose(t.stage_losses.numpy(),
                               np.asarray(j.stage_losses), rtol=0.05)
    np.testing.assert_array_equal(t.flipped.numpy(), np.asarray(j.flipped))
    assert t.stage_evals.shape == (2, B)
    assert int(t.stage_evals[1].min()) > 0


def test_slice_model_has_local_faces_and_a_part_segmentation():
    from smplifyx_torch.models.bodymodel import smooth_synthetic_model

    model = slice_model(500, device="cpu")
    base = smooth_synthetic_model(500, seed=0, device="cpu")
    assert torch.equal(model.faces[:, 0], base.faces[:, 0])
    assert torch.equal(model.v_template, base.v_template)
    f = model.faces
    assert bool(((f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2])
                 & (f[:, 0] != f[:, 2])).all())

    def longest_edge(faces):
        tri = model.v_template[faces]
        return (tri - tri.roll(1, dims=1)).norm(dim=-1).amax(-1).median()

    # the two nearest neighbours make triangles far smaller than the
    # generator's own, which join vertices of equal height across the body
    assert longest_edge(f) < 0.25 * longest_edge(base.faces)
    segm, parents = slice_part_segm(model)
    assert segm.shape == parents.shape == (f.shape[0],)
    assert set(np.unique(segm)) <= set(range(model.lbs_weights.shape[1]))
    assert (parents >= 0).all()
