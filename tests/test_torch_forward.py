"""Port parity: synthetic models, smplx_forward and joints_forward against
the JAX package, on the CPU (values and parameter gradients)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from smplifyx_tpu.models import bodymodel as jbody
from smplifyx_tpu.models import forward as jfwd
from smplifyx_tpu.models import sparse as jsparse
from smplifyx_tpu.models.joint_mapping import model_to_annotation
from smplifyx_tpu.ops.rotation import batch_rodrigues

from smplifyx_torch import convert
from smplifyx_torch.models import bodymodel as tbody
from smplifyx_torch.models import forward as tfwd
from smplifyx_torch.models import sparse as tsparse
from smplifyx_torch.ops.lbs import lbs_plan

from tests._jit import jit_forward

jit_joints = jax.jit(jsparse.joints_forward,
                     static_argnames=("use_pca", "flat_hand_mean",
                                      "use_face_contour"))
JOINT_MAP = model_to_annotation("smplx", True, True, True, "coco25")
FIELDS = [f.name for f in dataclasses.fields(jfwd.BodyParams)]


def jfields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name))
                     if hasattr(getattr(obj, f.name), "shape")
                     else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def make_params(B, seed=1):
    """Random params; lanes 0/1 turn the head beyond +-39 degrees of yaw."""
    rng = np.random.default_rng(seed)
    p = {
        "global_orient": rng.normal(0, 0.3, (B, 3)),
        "body_pose": rng.normal(0, 0.2, (B, 63)),
        "betas": rng.normal(0, 1.0, (B, 10)),
        "expression": rng.normal(0, 1.0, (B, 10)),
        "jaw_pose": rng.normal(0, 0.1, (B, 3)),
        "leye_pose": rng.normal(0, 0.1, (B, 3)),
        "reye_pose": rng.normal(0, 0.1, (B, 3)),
        "left_hand_pose": rng.normal(0, 0.5, (B, 12)),
        "right_hand_pose": rng.normal(0, 0.5, (B, 12)),
    }
    # neck (joint 12) and head (joint 15) yaw about y
    p["body_pose"][0, 34] = p["body_pose"][0, 43] = 0.45
    if B > 1:
        p["body_pose"][1, 34] = p["body_pose"][1, 43] = -0.5
    return {k: v.astype(np.float32) for k, v in p.items()}


def to_jax(p):
    return jfwd.BodyParams(**{k: jnp.asarray(v) for k, v in p.items()})


def to_torch(p, grad=False):
    return tfwd.BodyParams(**{k: torch.tensor(v, requires_grad=grad)
                              for k, v in p.items()})


@pytest.fixture(scope="module", params=[96, 10475], ids=["V96", "V10475"])
def models(request):
    jm = jbody.synthetic_model(num_verts=request.param, seed=0)
    tm = tbody.synthetic_model(num_verts=request.param, seed=0, device="cpu")
    return jm, tm


class TestModels:
    def test_synthetic_model_equal(self, models):
        jm, tm = models
        for name, ref in jfields(jm).items():
            if name == "extra_lmk_matrix":   # the port indexes instead
                continue
            got = getattr(tm, name)
            if isinstance(got, torch.Tensor):
                np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
            else:
                assert tuple(got) == tuple(ref) if isinstance(ref, tuple) \
                    else got == ref, name

    def test_smooth_synthetic_model_equal(self):
        jm = jbody.smooth_synthetic_model(num_verts=300, seed=3)
        tm = tbody.smooth_synthetic_model(num_verts=300, seed=3, device="cpu")
        for name, ref in jfields(jm).items():
            got = getattr(tm, name, None)
            if isinstance(got, torch.Tensor):
                np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)

    def test_convert_round_trip(self, models):
        jm, tm = models
        cm = convert.smplx_model(jfields(jm), device="cpu")
        for f in dataclasses.fields(tm):
            a, b = getattr(tm, f.name), getattr(cm, f.name)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), f.name
            else:
                assert a == b, f.name


class TestForward:
    @pytest.mark.parametrize("mapped", [False, True])
    def test_smplx_forward_matches(self, models, mapped):
        jm, tm = models
        B = 2 if tm.num_verts > 1000 else 4
        p = make_params(B)
        jmap = jnp.asarray(JOINT_MAP) if mapped else None
        tmap = torch.as_tensor(JOINT_MAP, dtype=torch.int64) if mapped else None
        ref = jit_forward(jm, to_jax(p), use_face_contour=True, joint_map=jmap)
        out = tfwd.smplx_forward(tm, to_torch(p), use_face_contour=True,
                                 joint_map=tmap)
        # f32 contractions in another order; vertices are O(1) metres.
        np.testing.assert_allclose(out.vertices.numpy(),
                                   np.asarray(ref.vertices), atol=2e-5)
        np.testing.assert_allclose(out.joints.numpy(),
                                   np.asarray(ref.joints), atol=2e-5)
        np.testing.assert_allclose(out.full_pose.numpy(),
                                   np.asarray(ref.full_pose), atol=1e-6)

    @pytest.mark.parametrize("mapped", [False, True])
    def test_joints_forward_matches(self, models, mapped):
        jm, tm = models
        B = 2 if tm.num_verts > 1000 else 4
        p = make_params(B, seed=2)
        jmap = jnp.asarray(JOINT_MAP) if mapped else None
        tmap = torch.as_tensor(JOINT_MAP, dtype=torch.int64) if mapped else None
        ref = jit_joints(jsparse.build_joints_model(jm), to_jax(p),
                         use_face_contour=True, joint_map=jmap)
        out = tsparse.joints_forward(tsparse.build_joints_model(tm), to_torch(p),
                                     use_face_contour=True, joint_map=tmap)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5)
        full = tfwd.smplx_forward(tm, to_torch(p), use_face_contour=True,
                                  joint_map=tmap).joints
        np.testing.assert_allclose(out.numpy(), full.numpy(), atol=3e-5)

    def test_head_yaw_buckets_beyond_39_degrees(self, models):
        jm, tm = models
        full_pose = jit_forward(jm, to_jax(make_params(2))).full_pose
        rot = np.array(jax.jit(batch_rodrigues)(full_pose.reshape(2, 55, 3)))
        ref = np.asarray(jfwd._head_yaw_bucket(jnp.asarray(rot),
                                               jm.neck_kin_chain, 79))
        out = tfwd._head_yaw_bucket(torch.as_tensor(rot), tm.neck_kin_chain,
                                    79).numpy()
        np.testing.assert_array_equal(out, ref)
        # one lane looks far to one side (bucket > 39), one to the other
        assert out[0] != out[1] and max(out) > 39, out

    def test_param_gradients_match(self, models):
        jm, tm = models
        B = 2
        p = make_params(B, seed=4)
        wj = np.random.default_rng(9).normal(
            size=(B, len(JOINT_MAP), 3)).astype(np.float32)

        def jloss(params):
            out = jfwd.smplx_forward(jm, params, use_face_contour=True,
                                     joint_map=jnp.asarray(JOINT_MAP))
            return jnp.sum(out.joints * wj)

        g_ref = jax.jit(jax.grad(jloss))(to_jax(p))
        tp = to_torch(p, grad=True)
        out = tfwd.smplx_forward(tm, tp, use_face_contour=True,
                                 joint_map=torch.as_tensor(JOINT_MAP))
        torch.sum(out.joints * torch.as_tensor(wj)).backward()
        for name in FIELDS:
            # gradients sum O(100) joint terms in f32
            np.testing.assert_allclose(getattr(tp, name).grad.numpy(),
                                       np.asarray(getattr(g_ref, name)),
                                       rtol=1e-4, atol=2e-4, err_msg=name)


def test_load_body_model_npz_matches(tmp_path):
    """An .npz in the published SMPL-X layout loads to the same arrays."""
    jm = jbody.synthetic_model(num_verts=120, seed=5)
    V = jm.num_verts
    posedirs = np.asarray(jm.posedirs).T.reshape(V, 3, -1)
    path = str(tmp_path / "SMPLX_NEUTRAL.npz")
    np.savez(
        path, v_template=np.asarray(jm.v_template),
        shapedirs=np.concatenate([np.asarray(jm.shapedirs),
                                  np.zeros((V, 3, 290), np.float32),
                                  np.asarray(jm.exprdirs)], axis=-1),
        posedirs=posedirs, J_regressor=np.asarray(jm.J_regressor),
        weights=np.asarray(jm.lbs_weights), f=np.asarray(jm.faces),
        kintree_table=np.stack([np.asarray(jm.parents), np.arange(55)]),
        hands_componentsl=np.asarray(jm.left_hand_components),
        hands_componentsr=np.asarray(jm.right_hand_components),
        hands_meanl=np.asarray(jm.left_hand_mean),
        hands_meanr=np.asarray(jm.right_hand_mean),
        lmk_faces_idx=np.asarray(jm.lmk_faces_idx),
        lmk_bary_coords=np.asarray(jm.lmk_bary_coords),
        dynamic_lmk_faces_idx=np.asarray(jm.dyn_lmk_faces_idx),
        dynamic_lmk_bary_coords=np.asarray(jm.dyn_lmk_bary_coords),
    )
    ref = jfields(jbody.load_body_model(path))
    got = tbody.load_body_model(path, device="cpu")
    for f in dataclasses.fields(got):
        a = getattr(got, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), ref[f.name], err_msg=f.name)
        elif f.name == "lbs_plan":     # the port's own: K1's column plan
            assert a == lbs_plan(torch.tensor(ref["lbs_weights"]))
        else:
            assert tuple(a) == tuple(ref[f.name]) if isinstance(a, tuple) \
                else a == ref[f.name], f.name
    # The same arrays as a legacy .pkl (J_regressor scipy-sparse) load alike.
    import pickle

    import scipy.sparse as sp

    raw = dict(np.load(path))
    raw["J_regressor"] = sp.csc_matrix(raw["J_regressor"])
    pkl = tmp_path / "SMPLX_NEUTRAL.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(raw, f)
    from_pkl = tbody.load_body_model(str(pkl), device="cpu")
    for f in dataclasses.fields(got):
        a = getattr(got, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(getattr(from_pkl, f.name), a), f.name
