"""Port parity for kernel K1's plain version and its autograd Function
against the JAX package's LBS (Pallas in interpret mode, and its VJP).

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py holds
it against the plain version there."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from smplifyx_tpu.ops.lbs_pallas import _lbs_reference, lbs_apply as jax_lbs

from smplifyx_torch.ops import lbs as tlbs


def make_inputs(B=2, V=300, J=55, seed=0):
    """The inputs of tests/test_lbs_pallas.py."""
    rng = np.random.default_rng(seed)
    W = rng.dirichlet(np.ones(J) * 0.1, size=V).astype(np.float32)
    A = rng.normal(0, 0.3, (B, J, 16)).astype(np.float32)
    A[..., [0, 5, 10, 15]] += 1.0
    v = rng.normal(0, 0.5, (B, V, 3)).astype(np.float32)
    return W, A, v


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

