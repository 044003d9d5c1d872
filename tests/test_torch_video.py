"""The batched video-sequence fit against the JAX package's
`examples/video_batch.py`, on the CPU.

The example's construction is rebuilt with the JAX package's own
functions, in its order (`tests/_torch_parity.py::example_inputs`); the
port's `problem.video_problem` must give the same inputs and the same
energy at one x.  The whole fits against JAX's are in
tests/test_torch_video_fits.py."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from smplifyx_tpu.fitting.energy import FrameData as JFrameData
from smplifyx_tpu.fitting.energy import smplify_energy as j_energy
from smplifyx_tpu.fitting.params import body_params_from_flat as j_body_params
from smplifyx_tpu.models.forward import smplx_forward as j_forward
from smplifyx_tpu.models.sparse import build_joints_model as j_joints_model
from smplifyx_tpu.ops.camera import project_points as j_project

from smplifyx_torch import convert
from smplifyx_torch.examples import video_batch
from smplifyx_torch.fitting.energy import smplify_energy
from smplifyx_torch.fitting.params import FitSettings, body_params_from_flat
from smplifyx_torch.models.forward import smplx_forward
from smplifyx_torch.problem import video_problem

from tests._torch_parity import example_inputs, torch_threads

B, V = 4, 96


@pytest.fixture(scope="module")
def inputs():
    return example_inputs(B, V), video_problem(B, V, "synthetic", "cpu")


def test_inputs_equal_the_example(inputs):
    j, p = inputs
    np.testing.assert_array_equal(p.gt.body_pose.numpy(), j["poses"])
    for name in ("rotation", "translation", "focal", "center"):
        np.testing.assert_array_equal(getattr(p.camera, name).numpy(),
                                      np.asarray(getattr(j["cam"], name)),
                                      err_msg=name)
    for f in dataclasses.fields(JFrameData):
        if f.name != "gt_joints":
            np.testing.assert_array_equal(
                getattr(p.frames, f.name).numpy(),
                np.asarray(getattr(j["frames"], f.name)), err_msg=f.name)
    np.testing.assert_array_equal(p.x0.numpy(), np.asarray(j["x0"]))
    np.testing.assert_array_equal(p.joint_map.numpy(), np.asarray(j["joint_map"]))
    assert p.settings == convert.fit_settings(
        {f.name: getattr(j["settings"], f.name)
         for f in dataclasses.fields(FitSettings)})
    for f in dataclasses.fields(p.schedule):
        np.testing.assert_array_equal(getattr(p.schedule, f.name).numpy(),
                                      np.asarray(getattr(j["schedule"], f.name)),
                                      err_msg=f.name)
    for name in ("lbfgs", "camera_lbfgs"):
        ours, theirs = getattr(p.options, name), getattr(j["options"], name)
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), (name, f.name)
    assert p.options.try_both_orient == j["options"].try_both_orient
    assert p.options.coll_broad_refresh == j["options"].coll_broad_refresh
    fn = p.collision_fn
    np.testing.assert_array_equal(fn.faces.numpy(), np.asarray(j["model"].faces))
    np.testing.assert_array_equal(fn.segm[:fn.F].numpy(), j["segm"])
    np.testing.assert_array_equal(fn.parents[:fn.F].numpy(), j["parents"])
    assert fn.ign == [(9, 16), (9, 17)] and fn.sigma == 1e-3
    tri_corners, (pa, _), _, _, _ = j["collision_fn"].build(
        j["out"].vertices[0])
    assert (fn.P, fn.T) == (pa.shape[0], tri_corners.shape[0])


def test_projected_joints_match_jax(inputs):
    j, p = inputs
    with torch.no_grad():
        joints = smplx_forward(p.model, p.gt, joint_map=p.joint_map).joints
    # JAX's projection of the port's joints: the same inputs, f32 rounding
    same = np.asarray(j_project(j["cam"], jnp.asarray(joints.numpy())))
    np.testing.assert_allclose(p.frames.gt_joints.numpy(), same, rtol=0,
                               atol=1e-4)
    # JAX's forward too: f32 forwards in another order (as
    # test_torch_pipeline.py::test_problem_matches_bench)
    np.testing.assert_allclose(p.frames.gt_joints.numpy(),
                               np.asarray(j["frames"].gt_joints), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(p.gt_vertices.numpy(),
                               np.asarray(j["out"].vertices), atol=1e-5)


def test_energy_with_the_collision_term_matches_jax(inputs):
    """Stage-2 energy and gradient (collision weight 1, sigma 1e-3) at one
    x near the sequence, both packages on the same pair list (JAX's broad
    phase, carried over by convert.collision_aux)."""
    j, p = inputs
    rng = np.random.default_rng(3)
    x = p.x_gt.numpy() + rng.normal(0, 0.1, p.x_gt.shape).astype(np.float32)
    jm = j_joints_model(j["model"])
    jfn = j["collision_fn"]
    w = jax.tree_util.tree_map(lambda a: a[2], j["schedule"])

    def verts(x1):
        params, _, _ = j_body_params(j["settings"], x1[None], lambda b: b)
        return j_forward(j["model"], params).vertices[0]

    jaux = jax.jit(jax.vmap(lambda x1: jfn.build(verts(x1))))(jnp.asarray(x))

    def one(x1, frame, aux1):
        return j_energy(x1, j["settings"], j["model"], frame, w,
                        jnp.asarray(2), 3, lambda b: b, j["joint_map"],
                        collision_fn=jfn, joints_model=jm, collision_aux=aux1)

    f_ref, g_ref = jax.jit(jax.vmap(jax.value_and_grad(one)))(
        jnp.asarray(x), j["frames"], jaux)
    xx = torch.tensor(x, requires_grad=True)
    f = smplify_energy(xx, p.settings, p.model, p.frames, p.schedule.stage(2),
                       2, 3, p.decode_body, p.joint_map,
                       joints_model=p.joints_model, collision_fn=p.collision_fn,
                       collision_aux=convert.collision_aux(jaux, "cpu"))
    (g,) = torch.autograd.grad(f.sum(), xx)
    f_ref, g_ref = np.asarray(f_ref), np.asarray(g_ref)
    np.testing.assert_allclose(f.detach().numpy(), f_ref, rtol=1e-4)
    scale = float(np.abs(g_ref).max())
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-4, atol=1e-4 * scale)
    # the check is not empty: the collision term scores in some lane
    params, _, _ = body_params_from_flat(p.settings, xx.detach(),
                                         p.decode_body)
    penalty = p.collision_fn.apply(smplx_forward(p.model, params).vertices,
                                   convert.collision_aux(jaux, "cpu"))
    assert float(penalty.max()) > 0


def test_main_prints_the_three_lines(capsys):
    with torch_threads(1):
        seq = video_batch.main(2, "cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("fitted 2-frame sequence in ")
    assert lines[1].startswith("PA-V2V vs ground truth: mean ")
    assert lines[2] == "losses finite: True"
    assert np.isfinite(seq.result.loss.numpy()).all()
    assert f"mean {1000 * float(seq.pa_v2v.mean()):.1f} mm" in lines[1]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_main_refuses_the_cpu_by_default(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        video_batch.main(2)
