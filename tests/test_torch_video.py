"""The batched video-sequence fit against the JAX package's
`examples/video_batch.py`, on the CPU.

The example's construction is rebuilt here with the JAX package's own
functions, in its order; the port's `problem.video_problem` must give the
same inputs, the same energy at one x, and a fit that ends at the same
loss level (5% per lane, as tests/test_torch_pipeline.py holds
collision-on fits) and PA-V2V (5% on the mean); on the synthetic model
over the stages that f32 rounding leaves comparable (STAGES)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from smplifyx_tpu.evaluation.metrics import procrustes_v2v as j_procrustes_v2v
from smplifyx_tpu.fitting.energy import FrameData as JFrameData
from smplifyx_tpu.fitting.energy import smplify_energy as j_energy
from smplifyx_tpu.fitting.lbfgs import LBFGSConfig as JConfig
from smplifyx_tpu.fitting.params import FitSettings as JSettings
from smplifyx_tpu.fitting.params import body_params_from_flat as j_body_params
from smplifyx_tpu.fitting.params import pack as j_pack
from smplifyx_tpu.fitting.pipeline import FitOptions as JOptions
from smplifyx_tpu.fitting.pipeline import fit_batch as j_fit_batch
from smplifyx_tpu.fitting.pipeline import recover_outputs as j_recover
from smplifyx_tpu.fitting.stages import build_stage_schedule as j_schedule
from smplifyx_tpu.models.bodymodel import build_extra_lmk_matrix
from smplifyx_tpu.models.bodymodel import smooth_synthetic_model as j_smooth_model
from smplifyx_tpu.models.bodymodel import synthetic_model as j_synthetic_model
from smplifyx_tpu.models.forward import BodyParams as JBodyParams
from smplifyx_tpu.models.forward import smplx_forward as j_forward
from smplifyx_tpu.models.joint_mapping import model_to_annotation
from smplifyx_tpu.models.sparse import build_joints_model as j_joints_model
from smplifyx_tpu.ops.camera import CameraParams as JCamera
from smplifyx_tpu.ops.camera import project_points as j_project
from smplifyx_tpu.ops.collision import make_collision_fn as j_collision_fn
from smplifyx_tpu.ops.collision import synthetic_part_segm as j_part_segm

from smplifyx_torch import convert
from smplifyx_torch.examples import video_batch
from smplifyx_torch.fitting.energy import smplify_energy
from smplifyx_torch.fitting.params import FitSettings, body_params_from_flat
from smplifyx_torch.fitting.pipeline import fit_batch
from smplifyx_torch.models.forward import smplx_forward
from smplifyx_torch.fitting.lbfgs import LBFGSConfig
from smplifyx_torch.problem import slice_model, slice_part_segm, video_problem

B, V = 4, 96


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


# Body-stage iterations of the whole fits, cut from the example's 40 to
# keep this file's time down; the camera stage keeps its 20.
FIT_ITERS = 10
# Body stages each case's parity fit runs.  The synthetic model's random
# faces all interpenetrate (V=96: 48 faces spanning the body), so its
# collision stages end at losses ~1e7 where f32 rounding alone sends
# lanes into other minima (test_synthetic_collision_stages_are_chaotic):
# its parity fit stops after body stage 0, the last stage without the
# collision term.  The slice's local faces run the whole schedule.
STAGES = {"slice": 3, "synthetic": 1}


def jax_fit(j, stages=3):
    """JAX's `fit_batch` of `example_inputs` over its first `stages` body
    stages, jitted -> fit(frames) -> FitResult."""
    schedule = jax.tree_util.tree_map(lambda a: a[:stages], j["schedule"])
    fit = jax.jit(lambda m, jm, f, x: j_fit_batch(
        m, j["settings"], j["options"], schedule, f, x, lambda b: b,
        j["joint_map"], edge_idxs=jnp.asarray([[5, 12], [2, 9]]),
        collision_fn=j["collision_fn"], joints_model=jm))
    jm = j_joints_model(j["model"])
    return lambda frames: fit(j["model"], jm, frames, j["x0"])


def port_problem(kind, stages=3):
    """`video_problem(B, V, kind)` with FIT_ITERS body iterations over its
    first `stages` body stages."""
    p = video_problem(B, V, kind, "cpu")
    lbfgs = dataclasses.replace(p.options.lbfgs, max_iters=FIT_ITERS)
    return dataclasses.replace(
        p, options=dataclasses.replace(p.options, lbfgs=lbfgs),
        schedule=p.schedule.map(lambda a: a[:stages]))


@pytest.fixture(scope="module", params=["slice", "synthetic"])
def fits(request):
    """The example's fit (schedule cut to STAGES[kind] body stages,
    collision settings, LBFGSConfigs with FIT_ITERS body iterations) by
    both packages at B=4, V=96."""
    kind = request.param
    j = example_inputs(B, V, kind, FIT_ITERS)
    jres = jax_fit(j, STAGES[kind])(j["frames"])
    jout, _, _ = j_recover(j["model"], j["settings"], jres.x, lambda b: b)
    j_v2v = np.asarray(j_procrustes_v2v(jout.vertices, j["out"].vertices))
    p = port_problem(kind, STAGES[kind])
    assert LBFGSConfig(**{f.name: getattr(j["options"].lbfgs, f.name)
                          for f in dataclasses.fields(LBFGSConfig)}) \
        == p.options.lbfgs
    return kind, jres, j_v2v.mean(-1), video_batch.fit_sequence(p)


def test_whole_fit_matches_jax_at_loss_level(fits):
    """Collision-on fits agree at loss level (ROADMAP "Tolerances"): the
    camera stage and every lane's final loss within 5%, as
    tests/test_torch_pipeline.py holds them, and the mean PA-V2V within 5%
    (the synthetic case's fit ends after body stage 0, see STAGES)."""
    kind, jres, j_v2v, seq = fits
    res = seq.result
    assert torch.equal(res.x, seq.warmup.x)
    assert torch.equal(res.loss, seq.warmup.loss)
    np.testing.assert_allclose(res.camera_loss.numpy(),
                               np.asarray(jres.camera_loss), rtol=0.05)
    np.testing.assert_allclose(res.stage_losses.numpy(),
                               np.asarray(jres.stage_losses), rtol=0.05)
    np.testing.assert_allclose(res.loss.numpy(), np.asarray(jres.loss),
                               rtol=0.05)
    np.testing.assert_allclose(float(seq.pa_v2v.mean()), float(j_v2v.mean()),
                               rtol=0.05)
    assert np.isfinite(res.stage_losses.numpy()).all()
    assert seq.pa_v2v.shape == (B,) and seq.seconds > 0
    assert res.stage_evals.shape == (STAGES[kind], B)
    assert int(res.stage_evals.min()) > 0 and res.host_reads > 0


def _spread(a, b):
    """Per-stage max over lanes of |a / b - 1|, [S] for [S, B] losses."""
    return np.abs(np.asarray(a, np.float64) / np.asarray(b, np.float64)
                  - 1).max(-1)


def test_synthetic_collision_stages_are_chaotic(capsys):
    """Why the synthetic case's parity fit stops after body stage 0: on
    its whole schedule, two witnesses that share no code with the port's
    fit move the collision stages' losses by more than the 5% bound,
    while the camera stage and body stage 0 stay within it.  JAX against
    JAX with its 2D joints moved by one ulp, and the port against itself
    on one CPU thread and on the default count.  The spreads are printed
    (per stage, max over lanes) beside the port's against JAX's."""
    j = example_inputs(B, V, "synthetic", FIT_ITERS)
    fit = jax_fit(j)
    j0 = fit(j["frames"])
    moved = np.nextafter(np.asarray(j["frames"].gt_joints), np.float32(np.inf))
    j1 = fit(j["frames"].replace(gt_joints=jnp.asarray(moved)))
    threads = torch.get_num_threads()
    p = port_problem("synthetic")

    def fit_port():
        return fit_batch(p.model, p.settings, p.options, p.schedule, p.frames,
                         p.x0, p.decode_body, p.joint_map,
                         edge_idxs=p.edge_idxs, collision_fn=p.collision_fn,
                         joints_model=p.joints_model, device="cpu")

    p0 = fit_port()
    torch.set_num_threads(1)
    try:
        p1 = fit_port()
    finally:
        torch.set_num_threads(threads)

    def stages(r):
        return np.concatenate([np.asarray(r.camera_loss)[None],
                               np.asarray(r.stage_losses)])

    spreads = {"jax_vs_jax_one_ulp": _spread(stages(j1), stages(j0)),
               f"port_1_vs_{threads}_threads": _spread(stages(p1), stages(p0)),
               "port_vs_jax": _spread(stages(p0), stages(j0))}
    with capsys.disabled():
        print("\nsynthetic B=4 V=96, FIT_ITERS=10; camera, stages 0-2:",
              {k: v.tolist() for k, v in spreads.items()})
    for name in ("jax_vs_jax_one_ulp", "port_vs_jax"):
        assert (spreads[name][:2] < 0.05).all(), (name, spreads[name])
    assert spreads["jax_vs_jax_one_ulp"][3] > 0.05, spreads
    assert np.isfinite(stages(p0)).all() and np.isfinite(stages(p1)).all()


def test_main_prints_the_three_lines(capsys):
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
