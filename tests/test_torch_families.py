"""Port parity for the SMPL and SMPL-H families against the JAX package, on
the CPU: joint mappings, synthetic models and forwards at full width
(V=10475), the loaders on files written in the published layouts, and a
staged fit per family at loss level."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from smplifyx_tpu.models import bodymodel as jbody
from smplifyx_tpu.models.forward import BodyParams as JBodyParams
from smplifyx_tpu.models.joint_mapping import model_to_annotation as j_map

from smplifyx_torch.fitting.lbfgs import LBFGSConfig
from smplifyx_torch.fitting.params import FitSettings
from smplifyx_torch.fitting.pipeline import FitOptions, fit_batch
from smplifyx_torch.fitting.stages import build_stage_schedule
from smplifyx_torch.models import bodymodel as tbody
from smplifyx_torch.models import forward as tfwd
from smplifyx_torch.models.joint_mapping import model_to_annotation
from smplifyx_torch.models.sparse import build_joints_model, joints_forward
from smplifyx_torch.ops.lbs import lbs_plan
from smplifyx_torch.problem import family_problem

from tests._jit import jit_forward
from tests.test_model_families import (
    _fit_family,
    _write_smpl_pkl,
    _write_smplh_npz,
    _write_smplx_npz,
)

FAMILIES = ("smplh", "smpl")
V_FULL = 10475


def jfields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name))
                     if hasattr(getattr(obj, f.name), "shape")
                     else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def assert_model_equal(got, ref):
    """The port's model holds the JAX model's arrays and metadata, and the
    column plan of its own weights."""
    for f in dataclasses.fields(got):
        a = getattr(got, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), ref[f.name],
                                          err_msg=f.name)
        elif f.name == "lbs_plan":
            assert a == lbs_plan(torch.tensor(ref["lbs_weights"]))
        else:
            assert (tuple(a) == tuple(ref[f.name]) if isinstance(a, tuple)
                    else a == ref[f.name]), f.name


@pytest.mark.parametrize("fmt", ["coco25", "coco19"])
@pytest.mark.parametrize("model_type,use_hands",
                         [("smplh", True), ("smplh", False), ("smpl", False)])
def test_mapping_tables_equal_jax(model_type, use_hands, fmt):
    got = model_to_annotation(model_type, use_hands, False, False, fmt)
    np.testing.assert_array_equal(
        got, j_map(model_type, use_hands, False, False, fmt))


def family_params(model_type, B, seed=1):
    """Random parameters of the family (SMPL: 69 body dofs, no hands)."""
    rng = np.random.default_rng(seed)
    dof = 69 if model_type == "smpl" else 63
    p = {
        "global_orient": rng.normal(0, 0.3, (B, 3)),
        "body_pose": rng.normal(0, 0.2, (B, dof)),
        "betas": rng.normal(0, 1.0, (B, 10)),
        "expression": np.zeros((B, 10)),
        "jaw_pose": np.zeros((B, 3)),
        "leye_pose": np.zeros((B, 3)),
        "reye_pose": np.zeros((B, 3)),
        "left_hand_pose": rng.normal(0, 0.5, (B, 12)),
        "right_hand_pose": rng.normal(0, 0.5, (B, 12)),
    }
    return {k: v.astype(np.float32) for k, v in p.items()}


def to_jax(p):
    return JBodyParams(**{k: jnp.asarray(v) for k, v in p.items()})


def to_torch(p):
    return tfwd.BodyParams(**{k: torch.tensor(v) for k, v in p.items()})


@pytest.fixture(scope="module", params=FAMILIES)
def full_width(request):
    """(model_type, JAX model, port model) at V=10475."""
    mt = request.param
    return (mt, jbody.synthetic_model(num_verts=V_FULL, model_type=mt, seed=0),
            tbody.synthetic_model(num_verts=V_FULL, model_type=mt, seed=0,
                                  device="cpu"))


def test_synthetic_model_equal_jax(full_width):
    _, jm, tm = full_width
    ref = jfields(jm)
    ref.pop("extra_lmk_matrix")        # the port indexes instead
    assert_model_equal(tm, ref)
    assert tm.num_joints == {"smplh": 52, "smpl": 24}[full_width[0]]


@pytest.mark.parametrize("mapped", [False, True])
def test_forward_matches_jax(full_width, mapped):
    mt, jm, tm = full_width
    p = family_params(mt, 2)
    jmap = j_map(mt, mt == "smplh", False, False, "coco25") if mapped else None
    ref = jit_forward(jm, to_jax(p), use_face_contour=False,
                      joint_map=None if jmap is None else jnp.asarray(jmap))
    tmap = None if jmap is None else torch.as_tensor(jmap)
    out = tfwd.smplx_forward(tm, to_torch(p), use_face_contour=False,
                             joint_map=tmap)
    # f32 contractions in another order; vertices are O(1) metres.
    np.testing.assert_allclose(out.vertices.numpy(), np.asarray(ref.vertices),
                               atol=2e-5)
    np.testing.assert_allclose(out.joints.numpy(), np.asarray(ref.joints),
                               atol=2e-5)
    np.testing.assert_allclose(out.full_pose.numpy(),
                               np.asarray(ref.full_pose), atol=1e-6)
    # the joints-only forward gives the full forward's joints
    joints = joints_forward(build_joints_model(tm), to_torch(p),
                            use_face_contour=False, joint_map=tmap)
    np.testing.assert_allclose(joints.numpy(), out.joints.numpy(), atol=3e-5)


@pytest.mark.parametrize("name,writer,model_type", [
    ("SMPLX_NEUTRAL.npz", _write_smplx_npz, "smplx"),
    ("SMPLH_MALE.npz", _write_smplh_npz, "smplh"),
    ("SMPL_NEUTRAL.pkl", _write_smpl_pkl, "smpl"),
])
def test_loaders_match_jax_on_published_layouts(tmp_path, name, writer,
                                                model_type):
    path = str(tmp_path / name)
    writer(path)
    kw = dict(num_betas=10, num_expression_coeffs=10, num_pca_comps=12)
    ref = jfields(jbody.load_body_model(path, model_type, **kw))
    ref.pop("extra_lmk_matrix")
    got = tbody.load_body_model(path, model_type, device="cpu", **kw)
    assert_model_equal(got, ref)


def fit_family_port(model_type, use_hands):
    """The port's fit of tests/test_model_families.py::_fit_family's
    problem: the same model, settings, schedule, options and inputs."""
    dof = 69 if model_type == "smpl" else 63
    model = tbody.synthetic_model(num_verts=64, model_type=model_type, seed=3,
                                  device="cpu")
    settings = FitSettings(use_hands=use_hands, use_face=False,
                           use_face_contour=False, body_pose_dof=dof)
    jmap = torch.as_tensor(model_to_annotation(model_type, use_hands, False,
                                               False, "coco25"))
    frames, x0 = family_problem(model, settings, jmap, 2)
    schedule = build_stage_schedule(
        [4.04e2, 4.78], shape_weights=[1e2, 5.0], expr_weights=[1e2, 5.0],
        hand_pose_prior_weights=[1e2, 5.0], hand_joints_weights=[0.0, 1.0],
        face_joints_weights=[0.0, 0.0], device="cpu")
    options = FitOptions(
        lbfgs=LBFGSConfig(max_iters=25, history=8, max_ls=10),
        camera_lbfgs=LBFGSConfig(max_iters=15, history=8, max_ls=10))
    return fit_batch(model, settings, options, schedule, frames, x0,
                     lambda b: b, jmap,
                     edge_idxs=torch.as_tensor([[5, 12], [2, 9]]),
                     joints_model=build_joints_model(model), device="cpu")


@pytest.mark.parametrize("model_type,use_hands",
                         [("smplh", True), ("smpl", False)])
def test_staged_fit_matches_jax_at_loss_level(model_type, use_hands):
    ref = _fit_family(model_type, use_hands=use_hands)
    got = fit_family_port(model_type, use_hands)
    # f32 L-BFGS trajectories diverge between implementations: 5% per lane
    # (ROADMAP "Tolerances").
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(ref.loss),
                               rtol=0.05)
    np.testing.assert_allclose(got.camera_loss.numpy(),
                               np.asarray(ref.camera_loss), rtol=0.05)
    assert np.isfinite(got.stage_losses.numpy()).all()
    assert (got.stage_losses[-1] <= got.stage_losses[0]).all()
