"""Port parity for kernel K1's plain version and its autograd Function
against the JAX package's LBS (Pallas in interpret mode, and its VJP).

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py holds
it against the plain version there."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from smplifyx_tpu.models import bodymodel as jbody
from smplifyx_tpu.models.sparse import build_joints_model as j_joints_model
from smplifyx_tpu.ops.lbs_pallas import _lbs_reference, lbs_apply as jax_lbs

from smplifyx_torch import convert
from smplifyx_torch.models import forward as tfwd
from smplifyx_torch.models import sparse as tsparse
from smplifyx_torch.models.forward import BodyParams, smplx_forward
from smplifyx_torch.models.sparse import build_joints_model, joints_forward
from smplifyx_torch.ops import lbs as tlbs


def make_inputs(B=2, V=300, J=55, seed=0):
    """The inputs of tests/test_lbs_pallas.py."""
    rng = np.random.default_rng(seed)
    W = rng.dirichlet(np.ones(J) * 0.1, size=V).astype(np.float32)
    A = rng.normal(0, 0.3, (B, J, 16)).astype(np.float32)
    A[..., [0, 5, 10, 15]] += 1.0
    v = rng.normal(0, 0.5, (B, V, 3)).astype(np.float32)
    return W, A, v


def jfields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name))
                     if hasattr(getattr(obj, f.name), "shape")
                     else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


class TestPlainVersion:
    @pytest.mark.parametrize("V", [300, 500])   # 500: not a tile multiple
    def test_matches_jax_interpret(self, V):
        W, A, v = make_inputs(V=V)
        ref = np.asarray(jax_lbs(jnp.asarray(W), jnp.asarray(A),
                                 jnp.asarray(v), True, True))
        ref_xla = np.asarray(_lbs_reference(*map(jnp.asarray, (W, A, v))))
        tW, tA, tv = map(torch.as_tensor, (W, A, v))
        plain = tlbs.lbs_reference(tW, tA, tv).numpy()
        cpu_path = tlbs.lbs_apply(tW, tA, tv).numpy()
        # f32 sums over J=55 in another order.
        np.testing.assert_allclose(plain, ref, atol=1e-5)
        np.testing.assert_allclose(plain, ref_xla, atol=1e-5)
        np.testing.assert_array_equal(cpu_path, plain)

    def test_autograd_function_matches_jax_vjp(self):
        W, A, v = make_inputs(B=2, V=64)
        gout = np.random.default_rng(5).normal(size=(2, 64, 3)).astype(np.float32)

        def loss(a, vv):
            return jnp.sum(jax_lbs(jnp.asarray(W), a, vv, False, False) * gout)

        gA_j, gv_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(v))
        tA = torch.as_tensor(A).requires_grad_(True)
        tv = torch.as_tensor(v).requires_grad_(True)
        torch.sum(tlbs.lbs_apply(torch.as_tensor(W), tA, tv)
                  * torch.as_tensor(gout)).backward()
        # The bound of test_lbs_pallas.py: f32 sums in another order.
        np.testing.assert_allclose(tA.grad.numpy(), np.asarray(gA_j), atol=1e-4)
        np.testing.assert_allclose(tv.grad.numpy(), np.asarray(gv_j), atol=1e-4)

        # ... and against autograd through the plain version.
        pA = torch.as_tensor(A).requires_grad_(True)
        pv = torch.as_tensor(v).requires_grad_(True)
        torch.sum(tlbs.lbs_reference(torch.as_tensor(W), pA, pv)
                  * torch.as_tensor(gout)).backward()
        np.testing.assert_allclose(tA.grad.numpy(), pA.grad.numpy(), atol=1e-4)
        np.testing.assert_allclose(tv.grad.numpy(), pv.grad.numpy(), atol=1e-4)

    def test_cpu_tensors_never_touch_the_kernel(self, monkeypatch):
        def refuse(*a, **k):
            raise AssertionError("the kernel loader ran for CPU tensors")

        monkeypatch.setattr(tlbs, "_load", refuse)
        monkeypatch.setattr(tlbs.nvcc, "build", refuse)
        monkeypatch.setattr(tlbs.nvcc, "load", refuse)
        before = tlbs.lbs_apply.launches
        W, A, v = map(torch.as_tensor, make_inputs(V=40))
        A.requires_grad_(True)
        tlbs.lbs_apply(W, A, v).sum().backward()
        assert tlbs.lbs_apply.launches == before

    def test_rejects_bad_inputs(self):
        W, A, v = map(torch.as_tensor, make_inputs(V=40))
        with pytest.raises(TypeError):
            tlbs.lbs_apply(W.double(), A, v)
        with pytest.raises(ValueError):
            tlbs.lbs_apply(W, A[:, :10], v)
        with pytest.raises(ValueError):
            tlbs.lbs_apply(W, A, v.transpose(0, 1).contiguous().transpose(0, 1))



def plan_weights(kind):
    """Skinning weights of the JAX package's generators, and a dense W."""
    if kind == "synthetic":
        return np.asarray(jbody.synthetic_model(num_verts=96, seed=0).lbs_weights)
    if kind == "smooth":
        return np.asarray(
            jbody.smooth_synthetic_model(num_verts=512, seed=0).lbs_weights)
    return make_inputs(V=300)[0] + np.float32(1e-3)     # no zero entry


class TestColumnPlan:
    @pytest.mark.parametrize("kind,K", [("synthetic", 4), ("smooth", 4),
                                        ("dense", 55)])
    def test_plan_densifies_back_in_ascending_columns(self, kind, K):
        W = torch.tensor(plan_weights(kind))
        before = tlbs.lbs_plan.builds
        plan = tlbs.lbs_plan(W)
        assert tlbs.lbs_plan.builds == before + 1
        assert plan.cols.dtype == torch.int32 and plan.vals.dtype == torch.float32
        assert tuple(plan.cols.shape) == tuple(plan.vals.shape) == (W.shape[0], K)
        dense = torch.zeros_like(W).scatter_(1, plan.cols.long(), plan.vals)
        assert torch.equal(dense, W)
        nnz = (W != 0).sum(1)
        for v in range(W.shape[0]):
            row = plan.cols[v, :nnz[v]].long()
            assert torch.equal(row, torch.nonzero(W[v]).flatten())
            assert bool((plan.vals[v, nnz[v]:] == 0).all())
        assert int((plan.vals != 0).sum()) == int(nnz.sum())

    def test_all_zero_row_gets_a_column_and_skins_to_zero(self):
        W, A, v = map(torch.as_tensor, make_inputs(V=6))
        W[2] = 0.0
        plan = tlbs.lbs_plan(W[2:3])
        assert plan.cols.shape == (1, 1) and float(plan.vals[0, 0]) == 0.0
        out = tlbs.lbs_apply(W, A, v, tlbs.lbs_plan(W))
        assert bool((out[:, 2] == 0).all())
        assert bool((out[:, 3] != 0).all())

    def test_apply_with_and_without_plan_equal_on_cpu(self):
        W, A, v = map(torch.as_tensor, make_inputs(V=97))
        before = tlbs.lbs_plan.builds
        unplanned = tlbs.lbs_apply(W, A, v)
        assert tlbs.lbs_plan.builds == before     # unused on the CPU
        planned = tlbs.lbs_apply(W, A, v, tlbs.lbs_plan(W))
        assert torch.equal(planned, unplanned)
        assert torch.equal(planned, tlbs.lbs_reference(W, A, v))

    def test_apply_refuses_a_plan_of_other_weights(self):
        W, A, v = map(torch.as_tensor, make_inputs(V=40))
        with pytest.raises(ValueError, match="plan"):
            tlbs.lbs_apply(W, A, v, tlbs.lbs_plan(W[:39]))
        plan = tlbs.lbs_plan(W)
        with pytest.raises(ValueError, match="plan"):
            tlbs.lbs_apply(W, A, v, tlbs.LBSPlan(plan.cols.long(), plan.vals))

    @pytest.mark.parametrize("smooth", [False, True], ids=["synthetic", "smooth"])
    def test_models_carry_the_plans_of_their_weights(self, smooth):
        jm = (jbody.smooth_synthetic_model(num_verts=512, seed=1) if smooth
              else jbody.synthetic_model(num_verts=96, seed=1))
        tm = convert.smplx_model(jfields(jm), "cpu")
        assert tm.lbs_plan == tlbs.lbs_plan(tm.lbs_weights)
        assert tm.lbs_plan.cols.shape[1] == 4
        for jmodel in (build_joints_model(tm),
                       convert.joints_model(jfields(j_joints_model(jm)), "cpu")):
            assert torch.equal(jmodel.sub_lbs, build_joints_model(tm).sub_lbs)
            assert jmodel.lbs_plan == tlbs.lbs_plan(jmodel.sub_lbs)
        moved = tm.to("cpu")
        assert moved.lbs_plan == tm.lbs_plan

    @pytest.mark.parametrize("which", ["smplx", "joints"])
    def test_models_refuse_a_plan_of_other_weights(self, which):
        """The kernel reads the plan, the backward the weights: a model
        whose weights change without their plan is refused."""
        tm = convert.smplx_model(jfields(jbody.synthetic_model(num_verts=96,
                                                               seed=3)), "cpu")
        model, field = ((tm, "lbs_weights") if which == "smplx"
                        else (build_joints_model(tm), "sub_lbs"))
        other = getattr(model, field).flip(1).contiguous()  # same V and K
        with pytest.raises(ValueError, match="column plan"):
            dataclasses.replace(model, **{field: other})
        before = tlbs.lbs_plan.builds
        same = dataclasses.replace(model, **{field: other,
                                             "lbs_plan": tlbs.lbs_plan(other)})
        assert tlbs.lbs_plan.builds == before + 1   # the check builds none
        assert same.lbs_plan == tlbs.lbs_plan(other)

    def test_forwards_pass_the_models_plans_and_build_none(self, monkeypatch):
        jm = jbody.synthetic_model(num_verts=96, seed=2)
        tm = convert.smplx_model(jfields(jm), "cpu")
        tjm = build_joints_model(tm)
        seen = []

        def recording(weights, A, v_posed, plan=None):
            seen.append(plan)
            return tlbs.lbs_apply(weights, A, v_posed, plan)

        monkeypatch.setattr(tfwd, "lbs_apply", recording)
        monkeypatch.setattr(tsparse, "lbs_apply", recording)
        before = tlbs.lbs_plan.builds
        params = BodyParams.zeros(2, device="cpu")
        smplx_forward(tm, params)
        joints_forward(tjm, params)
        assert tlbs.lbs_plan.builds == before
        assert seen[0] is tm.lbs_plan and seen[1] is tjm.lbs_plan
