"""Port parity for the fitting energies against the JAX package, on the CPU.

In the manner of test_reference_parity.py::TestSMPLifyLossParity, each
term of the SMPLify objective is held alone, value and gradient, across
the three stages of the combined preset, through both the joints-only and
the full-mesh forward; then the camera-init energy in all three conf modes
and the depth guess."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from smplifyx_tpu.fitting import energy as jen
from smplifyx_tpu.fitting.prepare import settings_from_config as j_settings
from smplifyx_tpu.fitting.stages import build_stage_schedule as j_schedule
from smplifyx_tpu.models.bodymodel import synthetic_model
from smplifyx_tpu.models.joint_mapping import model_to_annotation
from smplifyx_tpu.models.sparse import build_joints_model
from smplifyx_tpu.priors.priors import synthetic_gmm
from smplifyx_tpu.utils.config import load_config as j_load_config

from smplifyx_torch import convert
from smplifyx_torch.fitting import energy as ten
from smplifyx_torch.fitting.prepare import settings_from_config as t_settings
from smplifyx_torch.fitting.stages import build_stage_schedule as t_schedule
from smplifyx_torch.problem import SLICE_OVERRIDES, SLICE_PRESET
from smplifyx_torch.utils.config import load_config as t_load_config

TERMS = ("data", "pose_prior", "shape", "bending", "hands", "expression",
         "jaw")
B = 3


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
def problem():
    jcfg = j_load_config(SLICE_PRESET, **SLICE_OVERRIDES)
    tcfg = t_load_config(SLICE_PRESET, **SLICE_OVERRIDES)
    js = j_settings(jcfg)
    ts = t_settings(tcfg)
    assert convert.fit_settings(jfields(js)) == ts
    model = synthetic_model(num_verts=96, seed=0)
    jmap = model_to_annotation("smplx", True, True, True, "coco25")
    K, D = len(jmap), js.dim
    rng = np.random.default_rng(11)
    x = rng.normal(0, 0.2, (B, D)).astype(np.float32)
    x[:, :3] = [0.05, -0.1, 4.0]
    frames = dict(
        gt_joints=rng.uniform(150, 650, (B, K, 2)),
        conf=rng.uniform(0.2, 1.0, (B, K)),
        joint_weights=(rng.uniform(size=(B, K)) > 0.1).astype(np.float32),
        focal=np.full((B, 2), 1498.0), center=np.tile([400.0, 300.0], (B, 1)),
        data_weight=np.full((B,), 1000.0 / 600), init_joints_mask=np.isin(
            np.arange(K), jcfg.init_joints_idxs)[None].repeat(B, 0),
        trans_estimation=rng.normal(0, 1, (B, 3)),
        depth_loss_weight=np.full((B,), 100.0),
        regression_body=rng.normal(0, 0.1, (B, 63)),
    )
    frames = {k: np.asarray(v, np.float32) for k, v in frames.items()}
    jframes = jen.FrameData(**{k: jnp.asarray(v) for k, v in frames.items()})
    return dict(
        js=js, ts=ts, jcfg=jcfg, tcfg=tcfg, x=x,
        jmodel=model, tmodel=convert.smplx_model(jfields(model), "cpu"),
        jjm=build_joints_model(model),
        tjm=convert.joints_model(jfields(build_joints_model(model)), "cpu"),
        jframes=jframes, tframes=convert.frame_data(frames, "cpu"),
        jmap=jnp.asarray(jmap), tmap=torch.as_tensor(jmap, dtype=torch.int64),
    )


def torch_value_and_grads(fn, x, keys):
    """Per-key values [B] and gradients [B, D] of a dict-valued fn."""
    out = {}
    for k in keys:
        xt = torch.tensor(x, requires_grad=True)
        v = fn(xt)[k]
        (g,) = torch.autograd.grad(v.sum(), xt)
        out[k] = (v.detach().numpy(), g.numpy())
    return out


def assert_close(got, ref, what):
    v, g = got
    v_ref, g_ref = ref
    # f32 sums over up to K*2 terms in another order.
    np.testing.assert_allclose(v, v_ref, rtol=2e-5, atol=1e-6, err_msg=what)
    scale = max(float(np.abs(g_ref).max()), 1e-6)
    np.testing.assert_allclose(g, g_ref, rtol=1e-3, atol=2e-5 * scale,
                               err_msg=what)


# The GMM priors read only params, so one forward path covers them.
@pytest.mark.parametrize("sparse,prior", [(True, "l2"), (False, "l2"),
                                          (True, "gmm")],
                         ids=["joints-l2", "mesh-l2", "joints-gmm"])
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_smplify_terms_match(problem, stage, sparse, prior):
    P = problem
    js, ts = P["js"], P["ts"]
    jgmm = lgmm = rgmm = tgmm = tl = tr = None
    if prior == "gmm":
        js = js.replace(body_prior_type="gmm", has_regression_prior=False,
                        left_hand_prior_type="gmm", right_hand_prior_type="gmm")
        ts = dataclasses.replace(ts, body_prior_type="gmm",
                                 has_regression_prior=False,
                                 left_hand_prior_type="gmm",
                                 right_hand_prior_type="gmm")
        jgmm = synthetic_gmm(dim=63, seed=1)
        lgmm = synthetic_gmm(num_components=6, dim=12, seed=2)
        rgmm = synthetic_gmm(num_components=6, dim=12, seed=3)
        tgmm, tl, tr = (convert.gmm_prior(jfields(g), "cpu")
                        for g in (jgmm, lgmm, rgmm))
    jsched = j_schedule(*schedule_args(P["jcfg"]))
    tsched = t_schedule(*schedule_args(P["tcfg"]), device="cpu")
    for f in dataclasses.fields(tsched):
        np.testing.assert_array_equal(getattr(tsched, f.name).numpy(),
                                      np.asarray(getattr(jsched, f.name)))
    jw = jax.tree_util.tree_map(lambda a: a[stage], jsched)
    tw = tsched.stage(stage)
    S = tsched.num_stages
    jjm = P["jjm"] if sparse else None
    tjm = P["tjm"] if sparse else None

    def jterms(x, frame):
        return jen.smplify_energy_terms(
            x, js, P["jmodel"], frame, jw, jnp.asarray(stage), S,
            lambda b: b, P["jmap"], gmm=jgmm, joints_model=jjm,
            lhand_gmm=lgmm, rhand_gmm=rgmm)

    def jvec(x, frame):
        terms = jterms(x, frame)
        return jnp.stack([terms[k] for k in TERMS])

    # One compiled program for all terms: values [B, T], Jacobians [B, T, D].
    v, g = jax.jit(jax.vmap(lambda x, f: (jvec(x, f), jax.jacrev(jvec)(x, f))))(
        jnp.asarray(P["x"]), P["jframes"])
    ref = {k: (np.asarray(v[:, i]), np.asarray(g[:, i]))
           for i, k in enumerate(TERMS)}

    got = torch_value_and_grads(
        lambda x: ten.smplify_energy_terms(
            x, ts, P["tmodel"], P["tframes"], tw, stage, S, lambda b: b,
            P["tmap"], gmm=tgmm, joints_model=tjm, lhand_gmm=tl,
            rhand_gmm=tr),
        P["x"], TERMS)
    for k in TERMS:
        assert_close(got[k], ref[k], f"stage {stage} term {k}")


@pytest.mark.parametrize("mode", ["global_scale", "per_joint", "none"])
def test_camera_init_energy_matches(problem, mode):
    P = problem
    js = P["js"].replace(camera_conf_mode=mode)
    ts = dataclasses.replace(P["ts"], camera_conf_mode=mode)
    vg = jax.jit(jax.vmap(jax.value_and_grad(
        lambda x, f: jen.camera_init_energy(x, js, P["jmodel"], f,
                                            lambda b: b, P["jmap"],
                                            joints_model=P["jjm"]))))
    v, g = vg(jnp.asarray(P["x"]), P["jframes"])
    got = torch_value_and_grads(
        lambda x: {"e": ten.camera_init_energy(x, ts, P["tmodel"],
                                               P["tframes"], lambda b: b,
                                               P["tmap"], joints_model=P["tjm"])},
        P["x"], ["e"])["e"]
    assert_close(got, (np.asarray(v), np.asarray(g)), mode)


def test_guess_camera_depth_matches(problem):
    P = problem
    edges = P["jcfg"].body_tri_pairs
    ref = jax.jit(jax.vmap(lambda x, f: jen.guess_camera_depth(
        P["js"], P["jmodel"], x, f.gt_joints, jnp.asarray(edges), f.focal[0],
        lambda b: b, P["jmap"], joints_model=P["jjm"])))(
            jnp.asarray(P["x"]), P["jframes"])
    out = ten.guess_camera_depth(
        P["ts"], P["tmodel"], torch.as_tensor(P["x"]),
        P["tframes"].gt_joints, torch.as_tensor(edges), P["tframes"].focal[:, 0],
        lambda b: b, P["tmap"], joints_model=P["tjm"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)
