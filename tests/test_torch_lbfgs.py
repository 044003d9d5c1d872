"""The port's batched L-BFGS: the problems of tests/test_lbfgs.py, batched
runs against per-lane runs, and per-lane counts against JAX's
vmap(minimize)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from smplifyx_tpu.fitting.lbfgs import LBFGSConfig as JConfig
from smplifyx_tpu.fitting.lbfgs import minimize as jminimize

from smplifyx_torch.fitting.lbfgs import LBFGSConfig, minimize


def rosenbrock(x):
    """Per-lane Rosenbrock: [B, D] -> [B]."""
    return torch.sum(100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2
                     + (1.0 - x[:, :-1]) ** 2, dim=-1)


def t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("ls_mode", ["wolfe", "armijo"])
class TestProblems:
    def test_exact_on_quadratic(self, ls_mode):
        rng = np.random.default_rng(0)
        D = 8
        A = rng.normal(size=(D, D))
        Q = t(A @ A.T + np.eye(D) * 2.0)
        b = t(rng.normal(size=D))

        def fun(x):
            return 0.5 * torch.einsum("bi,ij,bj->b", x, Q, x) - x @ b

        res = minimize(fun, torch.zeros(1, D),
                       cfg=LBFGSConfig(max_iters=200, ls_mode=ls_mode))
        x_star = np.linalg.solve(Q.double().numpy(), b.double().numpy())
        np.testing.assert_allclose(res.x[0].numpy(), x_star, atol=1e-3)
        assert bool(res.converged[0])

    def test_rosenbrock_2d(self, ls_mode):
        res = minimize(rosenbrock, t([[-1.2, 1.0]]),
                       cfg=LBFGSConfig(max_iters=400, ftol=0.0, gtol=1e-6,
                                       ls_mode=ls_mode))
        np.testing.assert_allclose(res.x[0].numpy(), [1.0, 1.0], atol=1e-3)

    def test_frozen_coordinates_do_not_move(self, ls_mode):
        res = minimize(lambda x: torch.sum((x - 5.0) ** 2, dim=-1),
                       torch.zeros(2, 6), mask=t([1, 1, 0, 0, 1, 0]),
                       cfg=LBFGSConfig(ls_mode=ls_mode))
        x = res.x.numpy()
        np.testing.assert_allclose(x[:, [0, 1, 4]], 5.0, atol=1e-5)
        np.testing.assert_array_equal(x[:, [2, 3, 5]], 0.0)

    def test_nan_gradient_in_frozen_coords_cannot_leak(self, ls_mode):
        def fun(x):
            # norm's gradient at the frozen zero point is 0/0 = NaN
            return (x[:, 0] - 3.0) ** 2 + torch.linalg.norm(x[:, 1:], dim=-1)

        res = minimize(fun, torch.zeros(1, 3), mask=t([1, 0, 0]),
                       cfg=LBFGSConfig(max_iters=50, ls_mode=ls_mode))
        x = res.x[0].numpy()
        assert np.isfinite(x).all(), x
        np.testing.assert_allclose(x[0], 3.0, atol=1e-4)
        np.testing.assert_array_equal(x[1:], 0.0)

    def test_nan_objective_stops_cleanly(self, ls_mode):
        def fun(x):
            val = torch.sum(x ** 2, dim=-1) - 2 * x[:, 0]
            return torch.where(x[:, 0] > 1.0, torch.nan, val)

        res = minimize(fun, torch.zeros(1, 2),
                       cfg=LBFGSConfig(max_iters=50, ls_mode=ls_mode))
        assert np.isfinite(res.f.numpy()).all()

    def test_already_converged_start(self, ls_mode):
        res = minimize(lambda x: torch.sum(x ** 2, dim=-1), torch.zeros(2, 3),
                       cfg=LBFGSConfig(ls_mode=ls_mode))
        assert res.n_iters.tolist() == [0, 0]
        assert bool(res.converged.all())
        assert res.host_reads == 1


@pytest.mark.parametrize("ls_mode", ["wolfe", "armijo"])
def test_batched_equals_per_lane_runs(ls_mode):
    rng = np.random.default_rng(3)
    x0 = t(rng.uniform(-1.5, 1.5, size=(6, 4)))
    cfg = LBFGSConfig(max_iters=60, ls_mode=ls_mode, max_ls=6)
    batched = minimize(rosenbrock, x0, cfg=cfg)
    for b in range(x0.shape[0]):
        one = minimize(rosenbrock, x0[b:b + 1], cfg=cfg)
        # Lanes never mix, so a lane run alone takes the same path; the
        # batched reductions round alike, so the results agree bit for bit.
        assert torch.equal(batched.x[b], one.x[0]), b
        assert batched.n_evals[b] == one.n_evals[0]
        assert batched.n_iters[b] == one.n_iters[0]


@pytest.mark.parametrize("ls_mode", ["wolfe", "armijo"])
@pytest.mark.parametrize("quartic", [False, True])
def test_counts_equal_jax_vmap(ls_mode, quartic):
    """On a separable convex problem the f32 trajectories cannot diverge,
    so per-lane iteration and evaluation counts equal JAX's exactly."""
    rng = np.random.default_rng(0)
    B, D = 6, 5
    scale = rng.uniform(0.5, 3, (B, D)).astype(np.float32)
    tgt = rng.normal(size=(B, D)).astype(np.float32)
    q = 0.1 if quartic else 0.0

    def jfun(x, s, c):
        r = x - c
        return jnp.sum(s * r * r) + q * jnp.sum(r ** 4)

    ref = jax.jit(jax.vmap(lambda x, s, c: jminimize(
        lambda z: jfun(z, s, c), x,
        cfg=JConfig(max_iters=50, ls_mode=ls_mode))))(
            jnp.zeros((B, D)), jnp.asarray(scale), jnp.asarray(tgt))
    S, C = t(scale), t(tgt)

    def tfun(x):
        r = x - C
        return torch.sum(S * r * r, dim=-1) + q * torch.sum(r ** 4, dim=-1)

    res = minimize(tfun, torch.zeros(B, D),
                   cfg=LBFGSConfig(max_iters=50, ls_mode=ls_mode))
    np.testing.assert_array_equal(res.n_iters.numpy(), np.asarray(ref.n_iters))
    np.testing.assert_array_equal(res.n_evals.numpy(), np.asarray(ref.n_evals))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-6)


def test_max_evals_caps_each_lane():
    x0 = t(np.random.default_rng(4).uniform(-1.5, 1.5, size=(4, 4)))
    res = minimize(rosenbrock, x0,
                   cfg=LBFGSConfig(max_iters=500, ls_mode="armijo", max_ls=4,
                                   max_evals=20))
    # A lane stops once it has spent the budget; its last iteration may
    # overrun by at most one line search.
    assert int(res.n_evals.max()) <= 20 + 4


@pytest.mark.parametrize("ls_mode", ["wolfe", "armijo"])
@pytest.mark.parametrize("aux_every", [1, 4])
def test_aux_counts_equal_jax_vmap(ls_mode, aux_every):
    """A separable problem whose target moves with an aux rebuilt from x
    (a hundredth of floor(x), folded into the previous aux by a max): the
    aux reaches an exact fixed point, so lanes reopen after a refresh and
    then seal, and per-lane counts equal JAX's vmap(minimize)."""
    rng = np.random.default_rng(0)
    B, D = 6, 5
    scale = rng.uniform(0.5, 3, (B, D)).astype(np.float32)
    tgt = rng.normal(size=(B, D)).astype(np.float32)
    cfg = dict(max_iters=40, ls_mode=ls_mode, aux_every=aux_every)

    def jfun(x, aux, s, c):
        r = x - c - aux[0]
        return jnp.sum(s * r * r)

    ref = jax.jit(jax.vmap(lambda x, s, c: jminimize(
        lambda z, a: jfun(z, a, s, c), x, cfg=JConfig(**cfg),
        aux_fn=lambda z: (0.01 * jnp.floor(z),),
        aux_refresh_fn=lambda z, p: (jnp.maximum(p[0], 0.01 * jnp.floor(z)),),
    )))(jnp.zeros((B, D)), jnp.asarray(scale), jnp.asarray(tgt))
    S, C = t(scale), t(tgt)

    def tfun(x, aux):
        r = x - C - aux[0]
        return torch.sum(S * r * r, dim=-1)

    res = minimize(
        tfun, torch.zeros(B, D), cfg=LBFGSConfig(**cfg),
        aux_fn=lambda z: (0.01 * torch.floor(z),),
        aux_refresh_fn=lambda z, p: (torch.maximum(p[0], 0.01 * torch.floor(z)),))
    assert int(res.n_iters.max()) > aux_every   # more than one period
    np.testing.assert_array_equal(res.n_iters.numpy(), np.asarray(ref.n_iters))
    np.testing.assert_array_equal(res.n_evals.numpy(), np.asarray(ref.n_evals))
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-6)


@pytest.mark.parametrize("ls_mode", ["wolfe", "armijo"])
def test_aux_batched_equals_per_lane_runs(ls_mode):
    x0 = t(np.random.default_rng(5).uniform(-1.5, 1.5, size=(5, 4)))
    cfg = LBFGSConfig(max_iters=40, ls_mode=ls_mode, max_ls=6, aux_every=3)
    calls = []

    def fun(x, aux):
        return rosenbrock(x) + torch.sum((x - aux[0]) ** 2, dim=-1)

    def aux_fn(x):
        calls.append(x.shape[0])
        return (torch.round(x * 2.0) / 2.0,)

    batched = minimize(fun, x0, cfg=cfg, aux_fn=aux_fn)
    assert len(calls) > 2       # rebuilt at the start of every period
    for b in range(x0.shape[0]):
        one = minimize(fun, x0[b:b + 1], cfg=cfg, aux_fn=aux_fn)
        assert torch.equal(batched.x[b], one.x[0]), b
        assert batched.n_evals[b] == one.n_evals[0]
        assert batched.n_iters[b] == one.n_iters[0]
