"""The port's first-order optimizers against the JAX package's (optax
0.2.6's update rules under `vmap`), on the CPU: the update rules step by
step, 20 masked steps on a quadratic and on the SMPLify energy at V=96,
the NaN and masking cases of tests/test_optimizers.py, and whole staged
fits through `fit_batch` with the collision term on."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from smplifyx_tpu.fitting import energy as jen
from smplifyx_tpu.fitting.lbfgs import LBFGSConfig as JConfig
from smplifyx_tpu.fitting.optimizers import make_optax_optimizer
from smplifyx_tpu.fitting.optimizers import minimize_first_order as j_first_order
from smplifyx_tpu.fitting.pipeline import FitOptions as JOptions
from smplifyx_tpu.fitting.pipeline import fit_batch as j_fit_batch
from smplifyx_tpu.fitting.prepare import settings_from_config as j_settings
from smplifyx_tpu.fitting.stages import build_stage_schedule as j_schedule
from smplifyx_tpu.models.sparse import build_joints_model as j_joints_model
from smplifyx_tpu.ops.collision import make_collision_fn as j_collision_fn
from smplifyx_tpu.ops.collision import synthetic_part_segm
from smplifyx_tpu.utils.config import load_config as j_load_config

from smplifyx_torch import convert
from smplifyx_torch.fitting import energy as ten
from smplifyx_torch.fitting.lbfgs import LBFGSConfig
from smplifyx_torch.fitting.optimizers import (
    create_minimizer,
    make_optimizer,
    minimize_first_order,
)
from smplifyx_torch.fitting.pipeline import FitOptions, fit_batch
from smplifyx_torch.models.sparse import build_joints_model
from smplifyx_torch.ops.collision import make_collision_fn
from smplifyx_torch.problem import SLICE_OVERRIDES, SLICE_PRESET, slice_config
from smplifyx_torch.session import build_fit_session

NAMES = ["adam", "sgd", "rmsprop"]
# Learning rates of the quadratic and of the SMPLify energy: its gradients
# reach 1e5, so plain SGD needs a tiny step.
QUAD_LR = {"adam": 0.1, "sgd": 0.02, "rmsprop": 0.02}
ENERGY_LR = {"adam": 0.01, "sgd": 1e-9, "rmsprop": 1e-3}
# x after 20 steps against optax's, per unit of x's scale: f32 rounding of
# the same operations (pow, rsqrt) and gradients summed in another order.
STEP_TOL = 1e-6


def jfields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name))
                     if hasattr(getattr(obj, f.name), "shape")
                     else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def assert_close_to_scale(got, want, tol=STEP_TOL, what=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


@pytest.mark.parametrize("name", NAMES)
def test_updates_match_optax(name):
    """Each of 20 steps of the update rule on seeded gradients, per lane."""
    rng = np.random.default_rng(3)
    B, D = 3, 7
    grads = rng.normal(0, 2.0, (20, B, D)).astype(np.float32)
    grads[:, 1] *= 1e-3                   # lanes of other scales
    jopt = make_optax_optimizer(name, 0.05)
    jstate = jax.vmap(jopt.init)(jnp.zeros((B, D)))
    jupdate = jax.jit(jax.vmap(lambda g, s: jopt.update(g, s)))
    topt = make_optimizer(name, 0.05)
    tstate = topt.init(torch.zeros(B, D))
    for k, g in enumerate(grads):
        ju, jstate = jupdate(jnp.asarray(g), jstate)
        tu, tstate = topt.update(t(g), tstate)
        assert_close_to_scale(tu.numpy(), ju, what=f"{name} step {k}")


@pytest.mark.parametrize("name", NAMES)
def test_masked_quadratic_matches_jax(name):
    """Up to 20 steps of each lane against JAX's vmapped while_loop, with
    two frozen coordinates, lanes of two scales, and lanes that stop early
    on ftol while the others go on."""
    rng = np.random.default_rng(0)
    B, D = 3, 6
    A = rng.normal(size=(D, D))
    Q = (A @ A.T + 2 * np.eye(D)).astype(np.float32)
    b = rng.normal(size=(B, D)).astype(np.float32)
    x0 = rng.normal(size=(B, D)).astype(np.float32)
    b[1] *= 30.0
    mask = np.array([1, 1, 0, 1, 1, 0], np.float32)
    lr = QUAD_LR[name]
    kw = dict(max_iters=20, ftol=1e-2, gtol=1e-4)

    def jrun(x, bb):
        return j_first_order(lambda z: 0.5 * z @ jnp.asarray(Q) @ z - z @ bb,
                             x, make_optax_optimizer(name, lr),
                             mask=jnp.asarray(mask), **kw)

    jres = jax.jit(jax.vmap(jrun))(jnp.asarray(x0), jnp.asarray(b))
    Qt, bt = t(Q), t(b)
    tres = minimize_first_order(
        lambda x: 0.5 * torch.einsum("bi,ij,bj->b", x, Qt, x) - (x * bt).sum(-1),
        t(x0), make_optimizer(name, lr), mask=t(mask), **kw)
    assert_close_to_scale(tres.x.numpy(), jres.x, what=name)
    assert_close_to_scale(tres.f.numpy(), jres.f, what=name)
    for key in ("n_iters", "n_evals", "converged"):
        np.testing.assert_array_equal(getattr(tres, key).numpy(),
                                      np.asarray(getattr(jres, key)), key)
    assert int(tres.n_iters.min()) < 20 and bool(tres.converged.any())
    np.testing.assert_array_equal(tres.x.numpy()[:, mask == 0],
                                  x0[:, mask == 0])
    assert tres.host_reads == int(tres.n_iters.max()) + 1


@pytest.fixture(scope="module")
def energy_problem():
    """The stage-2 SMPLify energy of the slice's problem at V=96, joints
    only, from x0 at a 4.5 m depth, in both packages."""
    cfg = j_load_config(SLICE_PRESET, **SLICE_OVERRIDES,
                        interpenetration=False)
    model, _, jframes, x0, jmap = bench.build_problem(3, 96)
    js = j_settings(cfg)
    x = np.array(x0)
    x[:, 2] = 4.5
    sched_args = (cfg.body_pose_prior_weights, cfg.shape_weights,
                  cfg.expr_weights, cfg.hand_pose_prior_weights,
                  cfg.jaw_pose_prior_weights, cfg.hand_joints_weights,
                  cfg.face_joints_weights, cfg.coll_loss_weights)
    jsched = j_schedule(*sched_args)
    jw = jax.tree_util.tree_map(lambda a: a[2], jsched)
    jjm = j_joints_model(model)
    tmodel = convert.smplx_model(jfields(model), "cpu")
    tsched = convert.stage_weights(jfields(jsched), "cpu")
    tframes = convert.frame_data(jfields(jframes), "cpu")
    ts = convert.fit_settings(jfields(js))
    tjm = build_joints_model(tmodel)
    tmap = torch.as_tensor(np.array(jmap), dtype=torch.int64)

    def jfun(z, frame):
        return jen.smplify_energy(z, js, model, frame, jw, jnp.asarray(2), 3,
                                  lambda b: b, jmap, joints_model=jjm)

    def tfun(z):
        return ten.smplify_energy(z, ts, tmodel, tframes, tsched.stage(2), 2,
                                  3, lambda b: b, tmap, joints_model=tjm)

    mask = np.ones(x.shape[1], np.float32)
    mask[:3] = 0.0                         # the body stages' frozen camera
    return dict(jfun=jfun, tfun=tfun, x=x, jframes=jframes, mask=mask)


@pytest.mark.parametrize("name", NAMES)
def test_smplify_energy_steps_match_jax(energy_problem, name):
    P = energy_problem
    lr = ENERGY_LR[name]
    kw = dict(max_iters=20, ftol=0.0, gtol=0.0)
    jres = jax.jit(jax.vmap(lambda x, f: j_first_order(
        lambda z: P["jfun"](z, f), x, make_optax_optimizer(name, lr),
        mask=jnp.asarray(P["mask"]), **kw)))(jnp.asarray(P["x"]), P["jframes"])
    tres = minimize_first_order(P["tfun"], t(P["x"]), make_optimizer(name, lr),
                                mask=t(P["mask"]), **kw)
    assert tres.n_iters.tolist() == np.asarray(jres.n_iters).tolist() == [20] * 3
    assert_close_to_scale(tres.x.numpy(), jres.x, what=name)
    np.testing.assert_allclose(tres.f.numpy(), np.asarray(jres.f), rtol=1e-5)
    assert bool((tres.f < P["tfun"](t(P["x"]))).all())


@pytest.mark.parametrize("name,lr", [("adam", 0.1), ("sgd", 0.05),
                                     ("rmsprop", 0.05)])
def test_first_order_converges(name, lr):
    m = create_minimizer(name, lr=lr, max_iters=2000, ftol=0.0)
    res = m(lambda x: torch.sum((x - 1.5) ** 2, dim=-1), torch.zeros(1, 3))
    np.testing.assert_allclose(res.x.numpy(), 1.5, atol=0.05)


def test_lbfgs_variants():
    for name in ("lbfgs", "lbfgsls"):
        m = create_minimizer(name, max_iters=100)
        res = m(lambda x: torch.sum((x - 2.0) ** 2, dim=-1), torch.zeros(1, 4))
        np.testing.assert_allclose(res.x.numpy(), 2.0, atol=1e-4)


def test_mask_respected():
    m = create_minimizer("adam", lr=0.1, max_iters=1000, ftol=0.0)
    res = m(lambda x: torch.sum((x - 3.0) ** 2, dim=-1), torch.zeros(1, 3),
            t([1.0, 0.0, 1.0]))
    x = res.x[0].numpy()
    assert x[1] == 0.0
    np.testing.assert_allclose(x[[0, 2]], 3.0, atol=0.05)


@pytest.mark.parametrize("name,lr", [("adam", 0.1), ("sgd", 0.05),
                                     ("rmsprop", 0.05)])
def test_nan_gradient_in_frozen_coords_cannot_leak(name, lr):
    """norm()'s gradient at a frozen zero point is 0/0 = NaN: masking must
    zero it with `where`, or it poisons the update and the loop halts at
    its first step returning x0."""
    def fun(x):
        return (x[:, 0] - 3.0) ** 2 + torch.linalg.norm(x[:, 1:], dim=-1)

    m = create_minimizer(name, lr=lr, max_iters=2000, ftol=0.0)
    res = m(fun, torch.zeros(1, 3), t([1.0, 0.0, 0.0]))
    x = res.x[0].numpy()
    assert np.isfinite(x).all(), (name, x)
    np.testing.assert_allclose(x[0], 3.0, atol=0.05, err_msg=name)
    np.testing.assert_array_equal(x[1:], 0.0, err_msg=name)


def test_lanes_run_independently():
    """Batched lanes end where per-lane runs end (JAX's vmap test), and a
    lane whose value turns NaN keeps its last finite point."""
    m = create_minimizer("adam", lr=0.2, max_iters=500, ftol=0.0)
    targets = t([[1.0, 2.0], [3.0, -1.0], [0.5, 0.5]])

    def fun(x):
        val = torch.sum((x - targets) ** 2, dim=-1)
        return torch.where(x[:, 0] > 2.5, torch.nan, val)

    res = m(fun, torch.zeros(3, 2))
    np.testing.assert_allclose(res.x[[0, 2]].numpy(), targets[[0, 2]].numpy(),
                               atol=0.05)
    assert bool(res.x[1, 0] <= 2.5) and np.isfinite(res.f.numpy()).all()
    assert not bool(res.converged[1]) and int(res.n_iters[1]) < 500
    alone = m(lambda x: torch.sum((x - targets[2:]) ** 2, dim=-1),
              torch.zeros(1, 2))
    assert torch.equal(alone.x[0], res.x[2])


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="not supported"):
        make_optimizer("adagrad_deluxe", 0.1)
    with pytest.raises(ValueError, match="not supported"):
        build_fit_session(slice_config(96, optim_type="adagrad"), device="cpu")
    session = build_fit_session(slice_config(96, interpenetration=False),
                                device="cpu")
    options = dataclasses.replace(session.options, optim_type="adagrad")
    with pytest.raises(ValueError, match="not supported"):
        fit_batch(None, session.settings, options, session.schedule, None,
                  torch.zeros(1, 3), None, None, device="cpu")


B, V, ITERS = 2, 96, 10


def first_order_fits(name, lr, collision):
    """The preset's last two stages fitted by both packages with a
    first-order optimizer, on the smooth V=96 model; with `collision`, the
    second stage carries the collision term, a broad phase per
    evaluation."""
    cfg = j_load_config(SLICE_PRESET, **SLICE_OVERRIDES,
                        synthetic_num_verts=V, interpenetration=collision)
    model, _, jframes, x0, jmap = bench.build_problem(B, V, smooth=True)
    js = j_settings(cfg)
    edges = jnp.asarray(cfg.body_tri_pairs)
    sched_args = [a[1:] for a in (
        cfg.body_pose_prior_weights, cfg.shape_weights, cfg.expr_weights,
        cfg.hand_pose_prior_weights, cfg.jaw_pose_prior_weights,
        cfg.hand_joints_weights, cfg.face_joints_weights,
        cfg.coll_loss_weights)]
    mask = (False, collision)
    coll_kw = None
    if collision:
        segm, parents = synthetic_part_segm(model.faces.shape[0], 27, seed=0)
        coll_kw = dict(segm=segm, parents=parents,
                       ign_part_pairs=cfg.ign_part_pairs,
                       max_pairs=max(cfg.max_coll_pairs, cfg.max_collisions),
                       sigma=cfg.df_cone_height,
                       penalize_outside=cfg.penalize_outside)
    lb = dict(max_iters=ITERS, lr=lr)
    jopt = JOptions(lbfgs=JConfig(**lb), camera_lbfgs=JConfig(**lb),
                    try_both_orient=True, optim_type=name)
    jfn = (j_collision_fn(model.faces, **coll_kw) if collision else None)
    jres = jax.jit(lambda m, jm, fr, x: j_fit_batch(
        m, js, jopt, j_schedule(*sched_args), fr, x, lambda b: b, jmap,
        edge_idxs=edges, collision_fn=jfn, joints_model=jm,
        coll_stage_mask=mask))(model, j_joints_model(model), jframes, x0)

    tmodel = convert.smplx_model(jfields(model), "cpu")
    topt = FitOptions(lbfgs=LBFGSConfig(**lb), camera_lbfgs=LBFGSConfig(**lb),
                      try_both_orient=True, optim_type=name)
    tfn = (make_collision_fn(tmodel.faces, **coll_kw) if collision else None)
    builds = []
    if collision:
        build = tfn.build
        tfn.build = lambda v: builds.append(1) or build(v)
    tres = fit_batch(
        tmodel, convert.fit_settings(jfields(js)), topt,
        convert.stage_weights(jfields(j_schedule(*sched_args)), "cpu"),
        convert.frame_data(jfields(jframes), "cpu"),
        torch.as_tensor(np.array(x0)), lambda b: b,
        torch.as_tensor(np.array(jmap), dtype=torch.int64),
        edge_idxs=torch.as_tensor(np.asarray(edges)),
        joints_model=build_joints_model(tmodel), coll_stage_mask=mask,
        collision_fn=tfn, device="cpu")
    return jres, tres, len(builds)


@pytest.mark.parametrize("name,lr,collision", [("adam", 0.01, True),
                                               ("rmsprop", 1e-3, False)])
def test_fit_batch_matches_jax(name, lr, collision):
    j, tr, builds = first_order_fits(name, lr, collision)
    # whole fits at loss level (ROADMAP "Tolerances"): 5% per lane
    np.testing.assert_allclose(tr.loss.numpy(), np.asarray(j.loss), rtol=0.05)
    np.testing.assert_allclose(tr.camera_loss.numpy(),
                               np.asarray(j.camera_loss), rtol=0.05)
    np.testing.assert_allclose(tr.stage_losses.numpy(),
                               np.asarray(j.stage_losses), rtol=0.05)
    np.testing.assert_array_equal(tr.flipped.numpy(), np.asarray(j.flipped))
    np.testing.assert_array_equal(tr.stage_evals.numpy(),
                                  np.asarray(j.stage_evals))
    # one broad phase per evaluation of the collision stage, over all 2B
    # lanes: the loop runs while any lane does
    assert builds == (ITERS + 1 if collision else 0)
    assert tr.host_reads == 3 * (ITERS + 1)
