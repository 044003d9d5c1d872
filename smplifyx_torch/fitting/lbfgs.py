"""Batched L-BFGS with strong-Wolfe or Armijo line search, on [B, D] tensors.

Counterpart of `smplifyx_tpu/fitting/lbfgs.py::minimize`, which the JAX
package batches with `vmap` over a `while_loop`.  Here the batch dimension
is written out: every lane carries its own history, step length, line-search
state, evaluation count and done flag, all lanes are evaluated together,
and every state update is masked per lane with `torch.where`, so a lane
that has finished stops changing while the others go on.  The per-lane
results therefore equal independent single-lane runs.

The loops are Python loops.  Each decides whether to go on by reading one
boolean from the device (`any` lane still running); `LBFGSResult.host_reads`
counts those reads.  While the span recorder records (`utils/timing.py`),
every batched call of the objective is an `evaluation` span with the lanes
it evaluated.

Frozen parameters are a 0/1 mask on the gradient, applied with `where`
(not a multiply: NaN * 0 is NaN), which keeps every search direction inside
the free subspace.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from smplifyx_torch.utils import timing

_BRACKET = 0
_ZOOM = 1
_DONE = 2


@dataclass(frozen=True)
class LBFGSConfig:
    max_iters: int = 150
    history: int = 16
    max_ls: int = 25
    # After this many line-search evaluations any Armijo point is accepted
    # even without the curvature condition.  Default off.
    ls_soft_accept: int = 10_000
    # Start each line search from twice the previous accepted step.
    warm_start_step: bool = False
    # Cap on ||d||_inf (0 disables).
    max_dir_inf: float = 0.0
    # Cap on objective evaluations per lane (0 = unlimited).
    max_evals: int = 0
    # Rebuild minimize()'s aux every this many iterations (aux_fn only).
    aux_every: int = 1
    ls_mode: str = "wolfe"        # "wolfe" | "armijo"
    lr: float = 1.0
    ftol: float = 1e-9            # relative f change
    gtol: float = 1e-9            # max-abs gradient
    tol_change: float = 1e-9
    c1: float = 1e-4
    c2: float = 0.9


class LBFGSResult(NamedTuple):
    x: torch.Tensor          # [B, D] final parameters
    f: torch.Tensor          # [B] final objective
    g: torch.Tensor          # [B, D] final (masked) gradient
    n_iters: torch.Tensor    # [B] iterations taken
    n_evals: torch.Tensor    # [B] objective evaluations
    converged: torch.Tensor  # [B] bool
    host_reads: int          # device -> host reads made to steer the loops


def _lane(c: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Reshape a [B] condition to broadcast against a [B, ...] tensor."""
    return c.reshape(c.shape + (1,) * (like.dim() - c.dim()))


def _where(c, a, b):
    """Per-lane select; a and b are [B, ...] tensors or Python scalars."""
    ref = a if torch.is_tensor(a) else b
    return torch.where(_lane(c, ref), a, b)


def _pick(c, new: dict, old: dict) -> dict:
    return {k: _where(c, new[k], old[k]) for k in old}


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _clip(t, lo, hi):
    return torch.minimum(torch.maximum(t, lo), hi)


class _Reads:
    """Counts device -> host reads of the loops' continue flags."""

    def __init__(self):
        self.n = 0

    def any(self, mask: torch.Tensor) -> bool:
        self.n += 1
        return bool(mask.any())


def _cubic_minimizer(x1, f1, g1, x2, f2, g2, lo, hi):
    """Minimizer of the cubic through (x1,f1,g1), (x2,f2,g2), clipped to
    [lo, hi]; bisection where the cubic has no real minimum."""
    dx = x1 - x2
    dx = torch.where(torch.abs(dx) < 1e-20, 1e-20, dx)
    d1 = g1 + g2 - 3 * (f1 - f2) / dx
    d2_sq = d1 * d1 - g1 * g2
    safe = d2_sq >= 0
    d2 = torch.sqrt(torch.where(safe, d2_sq, 0.0)) * torch.sign(x2 - x1)
    denom = g2 - g1 + 2 * d2
    denom = torch.where(torch.abs(denom) < 1e-20, 1e-20, denom)
    t = x2 - (x2 - x1) * ((g2 + d2 - d1) / denom)
    t = torch.where(safe & torch.isfinite(t), t, 0.5 * (lo + hi))
    return _clip(t, lo, hi)


def _strong_wolfe(value_grad_fn, x, t_init, d, f0, g0, gtd0,
                  cfg: LBFGSConfig, active, reads: _Reads):
    """Per-lane strong-Wolfe search along d from x (bracket, then zoom).

    Returns (t, f_t, g_t, n_evals), each [B] or [B, D].  On budget
    exhaustion or a degenerate bracket a lane returns the best point it
    saw, which may be t = 0 (no movement).
    """
    def phi(t):
        f, g = value_grad_fn(x + t[:, None] * d)
        return f, g, _dot(g, d)

    def armijo_ref(tt):
        return f0 + cfg.c1 * tt * gtd0

    wolfe_curv = -cfg.c2 * gtd0

    def classify_bracket(s):
        cond_hi = ((s["f_t"] > armijo_ref(s["t"]))
                   | ((s["it"] > 1) & (s["f_t"] >= s["f_prev"]))
                   | ~torch.isfinite(s["f_t"]))
        soft = s["it"] >= cfg.ls_soft_accept
        cond_done = ~cond_hi & ((torch.abs(s["gtd_t"]) <= wolfe_curv) | soft)
        cond_swap = ~cond_hi & ~cond_done & (s["gtd_t"] >= 0)
        to_zoom = cond_hi | cond_swap
        stay = ~(to_zoom | cond_done)
        lo_b = s["t"] + 0.01 * (s["t"] - s["t_prev"])
        hi_b = 10.0 * s["t"]
        t_next = _cubic_minimizer(s["t_prev"], s["f_prev"], s["gtd_prev"],
                                  s["t"], s["f_t"], s["gtd_t"], lo_b, hi_b)
        n = dict(s)
        n["phase"] = torch.where(cond_done, _DONE,
                                 torch.where(to_zoom, _ZOOM, _BRACKET))
        # The pending trial lives in t_nx; s["t"] always pairs with f_t/g_t.
        n["t_prev"] = torch.where(stay, s["t"], s["t_prev"])
        n["f_prev"] = torch.where(stay, s["f_t"], s["f_prev"])
        n["g_prev"] = _where(stay, s["g_t"], s["g_prev"])
        n["gtd_prev"] = torch.where(stay, s["gtd_t"], s["gtd_prev"])
        n["t_nx"] = torch.where(stay, t_next, s["t_nx"])
        # Bracket endpoints on transition (cond_hi: [prev, t]; swap: [t, prev]).
        lo = dict(t_lo=("t_prev", "t"), f_lo=("f_prev", "f_t"),
                  g_lo=("g_prev", "g_t"), gtd_lo=("gtd_prev", "gtd_t"),
                  t_hi=("t", "t_prev"), f_hi=("f_t", "f_prev"),
                  gtd_hi=("gtd_t", "gtd_prev"))
        for key, (if_hi, if_swap) in lo.items():
            val = _where(cond_hi, s[if_hi], s[if_swap])
            n[key] = _where(to_zoom, val, s[key])
        return n

    def classify_zoom(s):
        cond_hi = ((s["f_t"] > armijo_ref(s["t"])) | (s["f_t"] >= s["f_lo"])
                   | ~torch.isfinite(s["f_t"]))
        soft = s["it"] >= cfg.ls_soft_accept
        cond_done = ~cond_hi & ((torch.abs(s["gtd_t"]) <= wolfe_curv) | soft)
        flip = (~cond_hi & ~cond_done
                & (s["gtd_t"] * (s["t_hi"] - s["t_lo"]) >= 0))
        n = dict(s)
        for hi_key, t_key, lo_key in (("t_hi", "t", "t_lo"),
                                      ("f_hi", "f_t", "f_lo"),
                                      ("gtd_hi", "gtd_t", "gtd_lo")):
            n[hi_key] = torch.where(cond_hi, s[t_key],
                                    torch.where(flip, s[lo_key], s[hi_key]))
        take_lo = ~cond_hi
        for lo_key, t_key in (("t_lo", "t"), ("f_lo", "f_t"), ("g_lo", "g_t"),
                              ("gtd_lo", "gtd_t")):
            n[lo_key] = _where(take_lo, s[t_key], s[lo_key])
        tiny = (torch.abs(n["t_hi"] - n["t_lo"])
                < 1e-9 * torch.clamp(torch.abs(n["t_hi"]), min=1.0))
        n["phase"] = torch.where(cond_done | tiny, _DONE, _ZOOM)
        return n

    def zoom_trial(s):
        """Next zoom trial and the insufficient-progress latch: a cubic step
        hugging a bracket end is allowed once, clamped inside on a repeat."""
        lo_b = torch.minimum(s["t_lo"], s["t_hi"])
        hi_b = torch.maximum(s["t_lo"], s["t_hi"])
        eps = 0.1 * (hi_b - lo_b)
        t_try = _cubic_minimizer(s["t_lo"], s["f_lo"], s["gtd_lo"],
                                 s["t_hi"], s["f_hi"], s["gtd_hi"], lo_b, hi_b)
        too_close = torch.minimum(hi_b - t_try, t_try - lo_b) < eps
        at_bound = (t_try >= hi_b) | (t_try <= lo_b)
        clamp = too_close & (s["insuf"] | at_bound)
        clamped = torch.where(torch.abs(t_try - hi_b) < torch.abs(t_try - lo_b),
                              hi_b - eps, lo_b + eps)
        return torch.where(clamp, clamped, t_try), too_close & ~clamp

    f_t, g_t, gtd_t = phi(t_init)
    zero = torch.zeros_like(t_init)
    better = f_t < f0   # NaN-safe: NaN < x is False
    s = dict(
        phase=torch.full_like(t_init, _BRACKET, dtype=torch.int64),
        it=torch.ones_like(t_init, dtype=torch.int64),
        t=t_init, f_t=f_t, g_t=g_t, gtd_t=gtd_t, t_nx=t_init,
        t_prev=zero, f_prev=f0, g_prev=g0, gtd_prev=gtd0,
        t_lo=zero, f_lo=f0, g_lo=g0, gtd_lo=gtd0,
        t_hi=t_init, f_hi=f_t, gtd_hi=gtd_t,
        best_t=torch.where(better, t_init, zero),
        best_f=torch.where(better, f_t, f0),
        best_g=_where(better, g_t, g0),
        insuf=torch.zeros_like(t_init, dtype=torch.bool),
    )
    s = classify_bracket(s)

    while True:
        running = (s["phase"] != _DONE) & (s["it"] < cfg.max_ls) & active
        if not reads.any(running):
            break
        in_zoom = s["phase"] == _ZOOM
        t_zoom, insuf_next = zoom_trial(s)
        t_try = torch.where(in_zoom, t_zoom, s["t_nx"])
        n = dict(s)
        n["insuf"] = torch.where(in_zoom, insuf_next, s["insuf"])
        f_t, g_t, gtd_t = phi(t_try)
        better = f_t < s["best_f"]
        n.update(
            t=t_try, f_t=f_t, g_t=g_t, gtd_t=gtd_t, it=s["it"] + 1,
            best_t=torch.where(better, t_try, s["best_t"]),
            best_f=torch.where(better, f_t, s["best_f"]),
            best_g=_where(better, g_t, s["best_g"]),
        )
        n = _pick(in_zoom, classify_zoom(n), classify_bracket(n))
        s = _pick(running, n, s)

    # Accept the final point if it decreases sufficiently (strict Wolfe or a
    # soft accept); otherwise fall back to the best point seen.
    accept = torch.isfinite(s["f_t"]) & (s["f_t"] <= armijo_ref(s["t"]))
    return (torch.where(accept, s["t"], s["best_t"]),
            torch.where(accept, s["f_t"], s["best_f"]),
            _where(accept, s["g_t"], s["best_g"]),
            s["it"])


def _armijo_backtrack(value_fn, value_grad_fn, x, t_init, d, f0, g0, gtd0,
                      cfg: LBFGSConfig, active, reads: _Reads):
    """Per-lane backtracking: the first trial with f(t) <= f0 + c1 t gtd0
    wins.  Trials are value-only (no autograd graph); one value and
    gradient is taken at the chosen step, which may be the best decreasing
    trial or t = 0 when nothing decreased."""
    def phi_val(t):
        return value_fn(x + t[:, None] * d)

    def armijo_ok(t, f):
        return torch.isfinite(f) & (f <= f0 + cfg.c1 * t * gtd0)

    f_t = phi_val(t_init)
    t = t_init
    it = torch.ones_like(t_init, dtype=torch.int64)
    ok = armijo_ok(t_init, f_t)
    bt = torch.zeros_like(t_init)
    bf = f0
    while True:
        running = ~ok & (it < cfg.max_ls) & active
        if not reads.any(running):
            break
        better = torch.isfinite(f_t) & (f_t < bf)
        bt_n = torch.where(better, t, bt)
        bf_n = torch.where(better, f_t, bf)
        # Quadratic-interpolated backtrack; a non-finite trial pulls in hard.
        denom = 2.0 * (f_t - f0 - gtd0 * t)
        t_q = torch.where(torch.abs(denom) > 1e-20, -gtd0 * t * t / denom,
                          0.5 * t)
        t_new = _clip(t_q, 0.1 * t, 0.5 * t)
        t_new = torch.where(torch.isfinite(f_t) & torch.isfinite(t_new)
                            & (t_new > 0), t_new, 0.1 * t)
        f_n = phi_val(t_new)
        t = torch.where(running, t_new, t)
        f_t = torch.where(running, f_n, f_t)
        ok = torch.where(running, armijo_ok(t_new, f_n), ok)
        bt = torch.where(running, bt_n, bt)
        bf = torch.where(running, bf_n, bf)
        it = torch.where(running, it + 1, it)
    # Fold the last trial into the best-seen fallback.
    better = torch.isfinite(f_t) & (f_t < bf)
    bt = torch.where(better, t, bt)
    t_out = torch.where(ok, t, bt)
    # t == 0 evaluates exactly at x (x + 0 * d is NaN if d is not finite).
    f_out, g_out = value_grad_fn(
        x + _where(t_out != 0.0, t_out[:, None] * d, 0.0))
    return t_out, f_out, g_out, it + 1


def _two_loop(g, S_hist, Y_hist, rho, n_hist, m):
    """Two-loop recursion -H^{-1} g per lane from the last n_hist pairs
    (newest at index m-1; entries below m - n_hist are invalid)."""
    valid = (torch.arange(m, device=g.device)[None, :]
             >= (m - n_hist)[:, None])
    q = g
    alphas = [None] * m
    for i in range(m - 1, -1, -1):
        alpha = torch.where(valid[:, i], rho[:, i] * _dot(S_hist[:, i], q), 0.0)
        q = q - alpha[:, None] * Y_hist[:, i]
        alphas[i] = alpha
    y_new, s_new = Y_hist[:, m - 1], S_hist[:, m - 1]
    yy = _dot(y_new, y_new)
    sy = _dot(s_new, y_new)
    gamma = torch.where((n_hist > 0) & (yy > 0),
                        sy / torch.clamp(yy, min=1e-20), 1.0)
    r = gamma[:, None] * q
    for i in range(m):
        beta = torch.where(valid[:, i], rho[:, i] * _dot(Y_hist[:, i], r), 0.0)
        r = r + S_hist[:, i] * (alphas[i] - beta)[:, None]
    return -r


def _pick_aux(c, new, old):
    """Per-lane select over an aux tuple of [B, ...] tensors."""
    items = [_where(c, n, o) for n, o in zip(new, old)]
    return old._make(items) if hasattr(old, "_make") else tuple(items)


def minimize(
    fun: Callable[..., torch.Tensor],
    x0: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    cfg: LBFGSConfig = LBFGSConfig(),
    aux_fn: Optional[Callable[[torch.Tensor], tuple]] = None,
    aux_refresh_fn: Optional[Callable[[torch.Tensor, tuple], tuple]] = None,
) -> LBFGSResult:
    """Minimize each lane of fun over the masked subspace of x0.

    fun: [B, D] -> [B], lanes independent (lane b's value depends on x[b]
    only), differentiable by autograd.  mask: [D] or [B, D] 0/1 floats;
    zero entries are frozen.

    aux_fn: optional `x -> aux`, a tuple of [B, ...] tensors that is not
    differentiated (the collision broad phase, ops/collision.py `build`).
    With it, fun takes `(x, aux)`; the aux is rebuilt every
    `cfg.aux_every` iterations at the then-current iterate and every
    evaluation in between reuses it.  aux_refresh_fn: optional
    `(x, aux_prev) -> aux` used for every rebuild after the first
    (`build_refresh`, which keeps the previous Morton order).

    As in the JAX package, an outer loop rebuilds the aux and re-evaluates
    f and g under it (one evaluation per period); an inner loop runs up to
    `aux_every` iterations per lane.  Convergence inside a period is
    provisional: the next rebuild seals a lane only if its fresh gradient
    is within gtol or its fresh value within ftol of the converged one,
    and otherwise reopens it.  Lanes that have left the outer loop keep
    their state and their aux.
    """
    B, D = x0.shape
    m = cfg.history
    if mask is None:
        mask = torch.ones_like(x0)
    free = (mask > 0).expand(B, D)
    reads = _Reads()

    def call(x, aux):
        return fun(x) if aux_fn is None else fun(x, aux)

    def value_grad(x, aux):
        with timing.span("evaluation", lanes=B, grad=True):
            x = x.detach().requires_grad_(True)
            with torch.enable_grad():
                f = call(x, aux)
                (g,) = torch.autograd.grad(f.sum(), x)
            return f.detach(), torch.where(free, g, 0.0)

    def value(x, aux):
        with timing.span("evaluation", lanes=B, grad=False), torch.no_grad():
            return call(x, aux)

    x = x0.detach()
    aux = aux_fn(x) if aux_fn is not None else None
    f, g = value_grad(x, aux)
    g_max = torch.amax(torch.abs(g), dim=-1)
    st = dict(
        x=x, f=f, g=g,
        S_hist=x.new_zeros((B, m, D)), Y_hist=x.new_zeros((B, m, D)),
        rho=x.new_zeros((B, m)),
        n_hist=torch.zeros(B, dtype=torch.int64, device=x.device),
        it=torch.zeros(B, dtype=torch.int64, device=x.device),
        n_evals=torch.ones(B, dtype=torch.int64, device=x.device),
        done=(g_max <= cfg.gtol) | ~torch.isfinite(f),
        converged=(g_max <= cfg.gtol) & torch.isfinite(f),
        t_prev=torch.full((B,), cfg.lr, dtype=x.dtype, device=x.device),
        sealed=torch.zeros(B, dtype=torch.bool, device=x.device),
    )

    def running(st):
        active = ~st["done"] & (st["it"] < cfg.max_iters)
        if cfg.max_evals > 0:
            active = active & (st["n_evals"] < cfg.max_evals)
        return active

    def iterate(st, aux, gate):
        """L-BFGS iterations under a fixed aux while any lane runs and
        passes gate(st)."""
        while True:
            active = gate(st) & running(st)
            if not reads.any(active):
                return st
            st = _pick(active, _iteration(st, active, aux), st)

    def _iteration(st, active, aux):
        x, f, g, n_hist = st["x"], st["f"], st["g"], st["n_hist"]
        first = n_hist == 0
        d = _two_loop(g, st["S_hist"], st["Y_hist"], st["rho"], n_hist, m)
        d = _where(first, -g, d)
        if cfg.max_dir_inf > 0:
            d_inf = torch.amax(torch.abs(d), dim=-1)
            d = d * torch.clamp(
                cfg.max_dir_inf / torch.clamp(d_inf, min=1e-20), max=1.0
            )[:, None]
        gtd = _dot(g, d)
        # Reset to steepest descent where d is not a descent direction.
        bad_dir = gtd > -cfg.tol_change
        d = _where(bad_dir, -g, d)
        gtd = torch.where(bad_dir, -_dot(g, g), gtd)

        g_abs_sum = torch.sum(torch.abs(g), dim=-1)
        if cfg.warm_start_step:
            later_t = torch.clamp(2.0 * st["t_prev"], 1e-5, cfg.lr)
        else:
            later_t = torch.full_like(f, cfg.lr)
        t0 = torch.where(
            first,
            torch.clamp(1.0 / torch.clamp(g_abs_sum, min=1e-20), max=1.0) * cfg.lr,
            later_t,
        )

        def vg(z):
            return value_grad(z, aux)

        if cfg.ls_mode == "armijo":
            t, f_new, g_new, ls_evals = _armijo_backtrack(
                lambda z: value(z, aux), vg, x, t0, d, f, g, gtd, cfg, active,
                reads)
        else:
            t, f_new, g_new, ls_evals = _strong_wolfe(
                vg, x, t0, d, f, g, gtd, cfg, active, reads)

        # t == 0 (failed search) must reproduce x exactly, even when d holds
        # non-finite entries.
        step = _where(t != 0.0, t[:, None] * d, 0.0)
        y_vec = g_new - g
        ys = _dot(y_vec, step)
        ls_failed = t == 0.0
        # A failed search with a stale history is not convergence: wipe the
        # history and retry from steepest descent.
        retry = ls_failed & (n_hist > 0)
        push = (ys > 1e-10) & ~ls_failed
        S_hist = _where(push, torch.cat([st["S_hist"][:, 1:], step[:, None]], 1),
                        st["S_hist"])
        Y_hist = _where(push, torch.cat([st["Y_hist"][:, 1:], y_vec[:, None]], 1),
                        st["Y_hist"])
        rho = _where(push, torch.cat(
            [st["rho"][:, 1:], (1.0 / torch.clamp(ys, min=1e-20))[:, None]], 1),
            st["rho"])
        n_hist = torch.where(retry, 0, torch.where(
            push, torch.clamp(n_hist + 1, max=m), n_hist))

        # Termination (reference FittingMonitor semantics).
        non_finite = ~torch.isfinite(f_new)
        rel = (f - f_new) / torch.clamp(
            torch.maximum(torch.abs(f), torch.abs(f_new)), min=1.0)
        small_f = rel <= cfg.ftol
        small_g = torch.amax(torch.abs(g_new), dim=-1) <= cfg.gtol
        small_step = torch.amax(torch.abs(step), dim=-1) <= cfg.tol_change
        conv = (small_f | small_g | small_step) & ~retry

        return dict(
            x=_where(non_finite, x, x + step),
            f=torch.where(non_finite, f, f_new),
            g=_where(non_finite, g, g_new),
            S_hist=S_hist, Y_hist=Y_hist, rho=rho, n_hist=n_hist,
            it=st["it"] + 1, n_evals=st["n_evals"] + ls_evals,
            done=non_finite | conv, converged=conv & ~non_finite,
            t_prev=torch.where(t > 0, t, st["t_prev"]),
            sealed=st["sealed"],
        )

    if aux_fn is None:
        st = iterate(st, None, lambda s: torch.ones_like(s["done"]))
    else:
        K = max(1, cfg.aux_every)
        while True:
            outer = ~st["sealed"] & (st["it"] < cfg.max_iters)
            if cfg.max_evals > 0:
                outer = outer & (st["n_evals"] < cfg.max_evals)
            if not reads.any(outer):
                break
            # f and g are re-evaluated under the fresh aux: a stale Armijo
            # reference makes every trial look like an ascent.
            fresh = (aux_refresh_fn(st["x"], aux) if aux_refresh_fn is not None
                     else aux_fn(st["x"]))
            aux = _pick_aux(outer, fresh, aux)
            f_cur, g_cur = value_grad(st["x"], aux)
            g_small = torch.amax(torch.abs(g_cur), dim=-1) <= cfg.gtol
            # Seal on f-stationarity too: a lane that converged by ftol or
            # tol_change inside the period rarely reaches gtol in f32.
            f_rel = torch.abs(f_cur - st["f"]) / torch.clamp(
                torch.maximum(torch.abs(f_cur), torch.abs(st["f"])), min=1.0)
            confirm = st["done"] & (g_small | (f_rel <= cfg.ftol)
                                    | ~torch.isfinite(f_cur))
            st = _pick(outer, dict(
                st, f=f_cur, g=g_cur, n_evals=st["n_evals"] + 1,
                sealed=confirm, done=confirm,
                converged=st["converged"] & confirm), st)
            period_end = st["it"] + K
            st = iterate(st, aux,
                         lambda s: outer & (s["it"] < period_end))

    return LBFGSResult(x=st["x"], f=st["f"], g=st["g"], n_iters=st["it"],
                       n_evals=st["n_evals"], converged=st["converged"],
                       host_reads=reads.n)
