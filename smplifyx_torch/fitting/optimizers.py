"""Optimizer factory: L-BFGS plus the first-order optimizers, on [B, D].

Counterpart of `smplifyx_tpu/fitting/optimizers.py` (reference
optim_factory, smplifyx/optimizers/optim_factory.py:27-65: adam / lbfgs /
lbfgsls / rmsprop / sgd).  'lbfgs' and 'lbfgsls' both map to the strong-Wolfe
or Armijo L-BFGS of fitting/lbfgs.py; 'adam', 'sgd' and 'rmsprop' run a
fixed-step masked loop with the same ftol/gtol/NaN termination.

The update rules are optax's (the JAX package builds them with
`optax.adam`, `optax.sgd` and `optax.rmsprop` at their defaults), not
`torch.optim`'s:

  * adam:    m <- b1 m + (1-b1) g,  v <- b2 v + (1-b2) g^2, count += 1,
             u = -lr (m / (1-b1^count)) / (sqrt(v / (1-b2^count)) + eps);
  * sgd:     t <- g + momentum t,  u = -lr (g + momentum t) with Nesterov,
             -lr t without;
  * rmsprop: nu <- alpha nu + (1-alpha) g^2,  s = -lr g rsqrt(nu + eps)
             (eps inside the root, where torch adds it outside), then the
             momentum trace t <- s + momentum t, u = t.

The batch is written out: every lane carries its own moments and count, a
lane that is done keeps its whole state, and the loop goes on while any
lane runs, reading one flag from the device per step
(`LBFGSResult.host_reads`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from smplifyx_torch.fitting.lbfgs import (
    LBFGSConfig,
    LBFGSResult,
    _pick,
    _Reads,
    _where,
    minimize,
)


class FirstOrder:
    """One of optax's first-order update rules over [B, D] lanes:
    `init(x)` gives the state, `update(g, state)` the step to add to x and
    the next state (both dicts of tensors with a leading lane axis)."""

    def __init__(self, kind: str, lr: float, momentum: float, beta1: float,
                 beta2: float, epsilon: float, rmsprop_alpha: float,
                 use_nesterov: bool):
        self.kind = kind
        self.lr = float(lr)
        self.momentum = float(momentum)
        self.b1, self.b2 = float(beta1), float(beta2)
        self.eps = float(epsilon)
        self.alpha = float(rmsprop_alpha)
        self.nesterov = bool(use_nesterov)

    def init(self, x: torch.Tensor) -> dict:
        zeros = torch.zeros_like(x)
        if self.kind == "adam":
            count = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
            return dict(mu=zeros, nu=zeros.clone(), count=count)
        if self.kind == "sgd":
            return dict(trace=zeros)
        return dict(nu=zeros, trace=zeros.clone())

    def _bias(self, decay: float, count: torch.Tensor, like: torch.Tensor):
        """1 - decay^count per lane, in the moments' dtype, as [B, 1]."""
        base = torch.tensor(decay, dtype=like.dtype, device=like.device)
        return (1 - base ** count.to(like.dtype))[:, None]

    def update(self, g: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
        if self.kind == "adam":
            mu = (1 - self.b1) * g + self.b1 * state["mu"]
            nu = (1 - self.b2) * (g * g) + self.b2 * state["nu"]
            count = state["count"] + 1
            mu_hat = mu / self._bias(self.b1, count, mu)
            nu_hat = nu / self._bias(self.b2, count, nu)
            u = (-self.lr) * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
            return u, dict(mu=mu, nu=nu, count=count)
        if self.kind == "sgd":
            trace = g + self.momentum * state["trace"]
            u = g + self.momentum * trace if self.nesterov else trace
            return (-self.lr) * u, dict(trace=trace)
        nu = (1 - self.alpha) * (g * g) + self.alpha * state["nu"]
        s = (-self.lr) * (torch.rsqrt(nu + self.eps) * g)
        trace = s + self.momentum * state["trace"]
        return trace, dict(nu=nu, trace=trace)


def make_optimizer(optim_type: str, lr: float, momentum: float = 0.9,
                   beta1: float = 0.9, beta2: float = 0.999,
                   epsilon: float = 1e-8, rmsprop_alpha: float = 0.99,
                   use_nesterov: bool = True) -> FirstOrder:
    """The port's `make_optax_optimizer`: the same names and defaults.
    rmsprop takes no Nesterov (optax.rmsprop's default)."""
    t = optim_type.lower()
    if t not in ("adam", "sgd", "rmsprop"):
        raise ValueError(f"Optimizer {optim_type} not supported")
    return FirstOrder(t, lr, momentum, beta1, beta2, epsilon, rmsprop_alpha,
                      use_nesterov and t == "sgd")


def minimize_first_order(
    fun: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    optimizer: FirstOrder,
    mask: Optional[torch.Tensor] = None,
    max_iters: int = 300,
    ftol: float = 1e-9,
    gtol: float = 1e-9,
) -> LBFGSResult:
    """Masked first-order minimization of each lane of fun ([B, D] -> [B],
    lanes independent), with L-BFGS-compatible results.

    A lane stops when its new value is not finite (keeping its previous x,
    f and g, not converged), when |f - f_new| / max(|f|, |f_new|, 1) <= ftol
    after its first step (first-order steps are not monotone, so one uphill
    step is not convergence), when its largest gradient entry is within
    gtol, or at max_iters.
    """
    B, D = x0.shape
    if mask is None:
        mask = torch.ones_like(x0)
    # where, not a product: a frozen coordinate's gradient may be NaN, and
    # NaN * 0 is NaN.
    free = (mask > 0).expand(B, D)
    reads = _Reads()

    def value_grad(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = fun(x)
            (g,) = torch.autograd.grad(f.sum(), x)
        return f.detach(), torch.where(free, g, 0.0)

    x = x0.detach()
    f, g = value_grad(x)
    st = dict(x=x, f=f, g=g, opt=optimizer.init(x),
              it=torch.zeros(B, dtype=torch.int64, device=x.device),
              done=~torch.isfinite(f),
              converged=torch.zeros(B, dtype=torch.bool, device=x.device))

    while True:
        active = ~st["done"] & (st["it"] < max_iters)
        if not reads.any(active):
            break
        u, opt = optimizer.update(st["g"], st["opt"])
        x_new = st["x"] + torch.where(free, u, 0.0)
        f_new, g_new = value_grad(x_new)
        non_finite = ~torch.isfinite(f_new)
        f = st["f"]
        rel = (f - f_new) / torch.clamp(
            torch.maximum(torch.abs(f), torch.abs(f_new)), min=1.0)
        small_f = (ftol > 0) & (torch.abs(rel) <= ftol) & (st["it"] > 0)
        conv = small_f | (torch.amax(torch.abs(g_new), dim=-1) <= gtol)
        new = dict(
            x=_where(non_finite, st["x"], x_new),
            f=torch.where(non_finite, f, f_new),
            g=_where(non_finite, st["g"], g_new),
            it=st["it"] + 1, done=non_finite | conv,
            converged=conv & ~non_finite)
        st = dict(_pick(active, new, {k: st[k] for k in new}),
                  opt=_pick(active, opt, st["opt"]))

    return LBFGSResult(x=st["x"], f=st["f"], g=st["g"], n_iters=st["it"],
                       n_evals=st["it"] + 1, converged=st["converged"],
                       host_reads=reads.n)


def create_minimizer(
    optim_type: str = "lbfgsls",
    lbfgs_cfg: Optional[LBFGSConfig] = None,
    lr: float = 1.0,
    max_iters: int = 300,
    ftol: float = 1e-9,
    gtol: float = 1e-9,
    **kwargs,
):
    """Factory -> minimize(fun, x0, mask) with uniform LBFGSResult output."""
    t = optim_type.lower()
    if t in ("lbfgs", "lbfgsls"):
        cfg = lbfgs_cfg or LBFGSConfig(max_iters=max_iters, ftol=ftol,
                                       gtol=gtol, lr=lr)
        return lambda fun, x0, mask=None: minimize(fun, x0, mask, cfg)
    opt = make_optimizer(t, lr, **kwargs)
    return lambda fun, x0, mask=None: minimize_first_order(
        fun, x0, opt, mask=mask, max_iters=max_iters, ftol=ftol, gtol=gtol)
