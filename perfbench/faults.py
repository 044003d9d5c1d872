"""Faults planted under the timed path, to show that the comparison of
check.py catches them: each is a context manager that patches the program
while the window runs and while its energy is asked for after
(cell.run_cell's `fault`).

  unchanged     every optimizer step returns its state unchanged: the fit
                answers with its starting parameters;
  half_batch    half of each batch is left out: those frames answer with
                their starting parameters;
  mesh          an answer altered where it is produced: the recovered mesh
                of every frame with one vertex moved by 1 mm;
  no_collision  the self-collision term's weight 0 in every stage;
  k3_zero       kernel K3 (the collision term's gradient scattered back to
                the vertices) returns zeros;
  half_iters    half the iterations and evaluations per stage;
  vposer_weight one entry of the VPoser decoder's output layer (joint 0's
                third 6D entry, through its bias) moved by 0.01;
  vposer_detached
                the decoded pose detached from the latent, so that z takes
                no gradient through the forward.

The two VPoser faults act only where the preset uses VPoser
(`VPOSER_ONLY`); elsewhere they leave the program as it is.

A cell on one card exchanges nothing between cards, so the fault of a
left-out exchange does not apply.
"""

from __future__ import annotations

import contextlib
import dataclasses


@contextlib.contextmanager
def _patched(module, name, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def unchanged():
    import smplifyx_torch.fitting.pipeline as pipeline

    def make(minimize):
        def stuck(fun, x, mask, cfg, aux_fn=None, aux_refresh_fn=None):
            return minimize(fun, x, mask, dataclasses.replace(cfg, max_iters=0),
                            aux_fn=aux_fn, aux_refresh_fn=aux_refresh_fn)
        return stuck

    return _patched(pipeline, "minimize", make)


def half_batch():
    import smplifyx_torch.session as session

    def make(fit_batch):
        def half(model, settings, options, schedule, frames, x0, *a, **kw):
            res = fit_batch(model, settings, options, schedule, frames, x0,
                            *a, **kw)
            n = (x0.shape[0] + 1) // 2
            x = res.x.clone()
            x[:n] = x0[:n]
            return dataclasses.replace(res, x=x)
        return half

    return _patched(session, "fit_batch", make)


def mesh():
    import smplifyx_torch.fitting.pipeline as pipeline

    def make(recover):
        def moved(*a, **kw):
            out, params, cam_t = recover(*a, **kw)
            vertices = out.vertices.clone()
            vertices[:, 0, 0] += 1e-3
            return dataclasses.replace(out, vertices=vertices), params, cam_t
        return moved

    return _patched(pipeline, "recover_outputs", make)


def no_collision():
    import smplifyx_torch.fitting.pipeline as pipeline

    def make(energy):
        def weightless(x, settings, model, frames, w, *a, **kw):
            w = dataclasses.replace(w, coll_loss_weight=0 * w.coll_loss_weight)
            return energy(x, settings, model, frames, w, *a, **kw)
        return weightless

    return _patched(pipeline, "smplify_energy", make)


def k3_zero():
    import smplifyx_torch.ops.collision as collision

    def make(scatter):
        def zeros(ids, values, num_rows):
            return scatter(ids, values, num_rows).zero_()
        return zeros

    return _patched(collision, "scatter_add_rows", make)


def half_iters():
    import smplifyx_torch.session as session

    def make(fit_batch):
        def hurried(model, settings, options, *a, **kw):
            lb = options.lbfgs
            lb = dataclasses.replace(lb, max_iters=lb.max_iters // 2,
                                     max_evals=lb.max_evals // 2)
            return fit_batch(model, settings,
                             dataclasses.replace(options, lbfgs=lb), *a, **kw)
        return hurried

    return _patched(session, "fit_batch", make)


def vposer_weight():
    import smplifyx_torch.models.vposer as vposer

    def make(rot6d):
        def moved(x):
            x = x.clone()
            x[..., 0, 2] += 0.01
            return rot6d(x)
        return moved

    return _patched(vposer, "rot6d_to_rotmat", make)


def vposer_detached():
    import smplifyx_torch.models.vposer as vposer

    def make(log_map):
        def detached(R):
            return log_map(R).detach()
        return detached

    return _patched(vposer, "rotmat_to_aa", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "mesh": mesh,
          "no_collision": no_collision, "k3_zero": k3_zero,
          "half_iters": half_iters, "vposer_weight": vposer_weight,
          "vposer_detached": vposer_detached}
VPOSER_ONLY = ("vposer_weight", "vposer_detached")
