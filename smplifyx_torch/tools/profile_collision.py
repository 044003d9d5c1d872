"""Where a collision-stage evaluation's time goes, component by component.

    python -m smplifyx_torch.tools.profile_collision [B] [--stages] [--apply]
        [--trace] [--platform cpu]

Counterpart of the JAX package's `tools/profile_collision.py` (the
components), `tools/profile_build.py` (the broad phase step by step),
`tools/profile_apply.py` (the narrow phase's parts) and the
`trace_build.py`, `trace_egrad.py` and `trace_collstage.py` tools (device
time per op name).  It runs on the video sequence's full-width case
(`problem.video_problem(B, SLICE_VERTS, "slice")`: the slice's model at
V=10475, whose local faces keep every budget below saturation, and the
collision term at sigma 1e-3) at its ground-truth poses, with the video schedule's stage-2
weights.  Components, one call each at batch B:

  lbs_fwd  the full-mesh forward x -> vertices (K1 at V)
  build    the broad phase -> CollisionAux (row plans included)
  apply    the penalty on that aux (K2 twice)
  energy   the stage-2 energy on that aux (one line-search evaluation)
  egrad    its value and gradient (the per-evaluation cost; K3 twice)

`--stages` adds each step of the broad phase (`CollisionFn.BUILD_STEPS`:
triangle AABBs, Morton sort, sorted tables, levels 0-2, the final
compactions, the unique triangles, the row plans), each run alone on the
previous steps' outputs, as `build` runs them.  `--apply` adds the narrow
phase's parts: the two-level corner gather and its VJP, the penalty on
the gathered corners (AABB recheck and cone field) and its VJP, and the
whole apply with its VJP.  Beside the times it prints
`CollisionFn.saturation` for each level.  `--trace` wraps build, egrad
and one collision stage (stage 2 as a one-stage fit from the ground
truth) in torch.profiler and sums device time per kernel name (its
parameter list cut, its template arguments kept: `utils/timing.py`'s
`profile_summary`).

On the card every time is device time, under `device_ms`: the CUDA
kernels' own times from torch.profiler, summed over DEVICE_REPS calls and
divided by them, the gaps between kernels left out.  (chip_smoke.py's
`time_ms`, calls queued behind a spin kernel, cannot time these: one
call launches hundreds of kernels, and the launch queue fills before the
spin ends.)  Beside the components, `call_ms` is CUDA events around one
call, host path inside: 1 - device_ms / call_ms is the share the card
waits on the host.  `--platform cpu` times on the host clock, under
`host_ms`.  Prints one JSON line; `main` returns it as a dict.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import torch

from smplifyx_torch.fitting.energy import smplify_energy
from smplifyx_torch.fitting.params import body_params_from_flat
from smplifyx_torch.fitting.pipeline import fit_batch
from smplifyx_torch.models.forward import smplx_forward
from smplifyx_torch.ops.collision import _PairGather
from smplifyx_torch.problem import SLICE_VERTS, video_problem
from smplifyx_torch.utils.device import device_for_platform, resolve_device
from smplifyx_torch.utils.timing import card_name, kernel_events, profile_summary

COMPONENTS = ("lbs_fwd", "build", "apply", "energy", "egrad")
APPLY_PARTS = ("gather_f", "gather_vjp", "cone_f", "cone_vjp", "apply_f",
               "apply_vjp")
STAGE = 2           # the video schedule's last stage: collision weight 1
DEVICE_REPS = 5     # calls per device timing
HOST_REPS = 2
PROFILE_TRIES = 3   # profiles of one function before a lost trace fails
TRACE_TOP = 15      # op names kept per traced region


def device_ms(fn) -> float:
    """Device ms of one call of fn: its CUDA kernels' times under
    torch.profiler over DEVICE_REPS calls (after one warm call), / reps.
    Every function timed here launches kernels, so a profile whose kernels
    sum to no time lost its trace (on an H100, one step in two whole runs
    of chip_smoke.py): it is taken again, at most PROFILE_TRIES times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(DEVICE_REPS):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in kernel_events(prof))
        if us > 0:
            return us / 1e3 / DEVICE_REPS
    raise RuntimeError(f"torch.profiler recorded no kernel time in "
                       f"{PROFILE_TRIES} profiles of a function that "
                       "launches kernels")


def call_ms(fn) -> float:
    """Median ms of CUDA events around one call of fn, host path inside."""
    fn()
    times = []
    for _ in range(DEVICE_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_timer(dev: torch.device):
    """-> (clock name, fn -> ms per call): device time on the card, the
    host clock on the CPU."""
    if dev.type == "cuda":
        return "device", device_ms

    def host_ms(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(HOST_REPS):
            fn()
        return 1e3 * (time.perf_counter() - t0) / HOST_REPS

    return "host", host_ms


def _vertices(p, x):
    s = p.settings
    params, _, _ = body_params_from_flat(s, x, p.decode_body)
    return smplx_forward(p.model, params, use_pca=s.use_pca,
                         flat_hand_mean=s.flat_hand_mean,
                         use_face_contour=s.use_face_contour,
                         return_verts=True).vertices


def _energy(p, x, aux):
    return smplify_energy(
        x, p.settings, p.model, p.frames, p.schedule.stage(STAGE), STAGE,
        p.schedule.num_stages, p.decode_body, p.joint_map,
        joints_model=p.joints_model, collision_fn=p.collision_fn,
        collision_aux=aux)


def _egrad(p, x, aux):
    xx = x.detach().requires_grad_(True)
    f = _energy(p, xx, aux)
    (g,) = torch.autograd.grad(f.sum(), xx)
    return f.detach(), g


def components(p, x, timer) -> tuple[dict, dict, torch.Tensor, object]:
    """{component: ms}, {component: call ms} (on the card; else empty), the
    vertices at x and their aux."""
    with torch.no_grad():
        verts = _vertices(p, x)
        aux = p.collision_fn.build(verts)
    fn = p.collision_fn

    def lbs_fwd():
        with torch.no_grad():
            return _vertices(p, x)

    def energy():
        with torch.no_grad():
            return _energy(p, x, aux)

    fns = dict(zip(COMPONENTS, (
        lbs_fwd, lambda: fn.build(verts), lambda: fn.apply(verts, aux),
        energy, lambda: _egrad(p, x, aux))))
    ms = {name: timer(f) for name, f in fns.items()}
    calls = ({name: call_ms(f) for name, f in fns.items()}
             if x.device.type == "cuda" else {})
    return ms, calls, verts, aux


@torch.no_grad()
def stage_outputs(fn, verts, timer=None) -> tuple[dict, dict]:
    """Each broad-phase step of `fn` on the outputs of the steps before it,
    in `build`'s order -> ({step: ms}, {step: the entries it added});
    without a timer the first dict is empty."""
    st, ms, outs = {"vertices": verts}, {}, {}
    for name in fn.BUILD_STEPS:
        step = getattr(fn, "_step_" + name)
        if timer is not None:
            ms[name] = timer(lambda: step(st))
        outs[name] = step(st)
        st = {**st, **outs[name]}
    return ms, outs


def apply_parts(fn, verts, aux, timer) -> dict:
    """{part: ms} of the narrow phase on a fixed aux."""
    planes = (aux.corner_plan, aux.pair_plan)

    def gather_f():
        with torch.no_grad():
            return _PairGather.apply(verts, *planes)

    def gather_vjp():
        v = verts.detach().requires_grad_(True)
        ta, tb = _PairGather.apply(v, *planes)
        return torch.autograd.grad(ta.sum() + tb.sum(), v)

    ta, tb = gather_f()

    def cone_f():
        with torch.no_grad():
            return fn.penalty(ta, tb, aux.valid)

    def cone_vjp():
        a, b = ta.requires_grad_(True), tb.requires_grad_(True)
        return torch.autograd.grad(fn.penalty(a, b, aux.valid).sum(), (a, b))

    def apply_f():
        with torch.no_grad():
            return fn.apply(verts, aux)

    def apply_vjp():
        v = verts.detach().requires_grad_(True)
        return torch.autograd.grad(fn.apply(v, aux).sum(), v)

    return {name: timer(f) for name, f in zip(
        APPLY_PARTS, (gather_f, gather_vjp, cone_f, cone_vjp, apply_f,
                      apply_vjp))}


def saturation(fn, verts) -> dict:
    return {k: {"max": int(c.max()), "median": float(c.float().median()),
                "budget": b, "lanes_at_budget": int((c >= b).sum())}
            for k, (c, b) in fn.saturation(verts).items()}


def _profiled(dev, region) -> dict:
    """torch.profiler over region(): wall ms, busy ms and the op names
    with the most time (device kernels on the card, host ops on the CPU)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        region()
        if cuda:
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    return {"wall_ms": 1e3 * wall, **profile_summary(prof, TRACE_TOP, cuda)}


def trace(p, x, verts, aux) -> dict:
    """Device time per op name over build, egrad and one collision stage."""
    dev = x.device
    one = dataclasses.replace(p.options, camera_stage=False)
    sched = p.schedule.map(lambda a: a[STAGE:STAGE + 1])

    def stage():
        res = fit_batch(p.model, p.settings, one, sched, p.frames, x,
                        p.decode_body, p.joint_map, edge_idxs=p.edge_idxs,
                        collision_fn=p.collision_fn,
                        joints_model=p.joints_model, coll_stage_mask=(True,),
                        device=dev)
        evals.update(max=int(res.stage_evals.max()),
                     median=float(res.stage_evals.float().median()),
                     host_reads=res.host_reads)

    evals = {}
    stage()                                                 # warm
    out = {"build": _profiled(dev, lambda: p.collision_fn.build(verts)),
           "egrad": _profiled(dev, lambda: _egrad(p, x, aux)),
           "stage": _profiled(dev, stage)}
    out["stage"]["evals"] = evals
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=32)
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--apply", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--platform", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(device_for_platform(args.platform))
    p = video_problem(args.batch, SLICE_VERTS, "slice", dev)
    x = p.x_gt
    clock, timer = make_timer(dev)
    fn = p.collision_fn
    ms, calls, verts, aux = components(p, x, timer)
    row = {"tool": "profile_collision",
           "card": card_name() if dev.type == "cuda" else "cpu",
           "B": args.batch, "V": int(p.model.num_verts), "F": fn.F,
           "clock": clock, f"{clock}_ms": ms}
    if calls:
        row["call_ms"] = calls
    if args.stages:
        steps, _ = stage_outputs(fn, verts, timer)
        row[f"stages_{clock}_ms"] = steps
        row[f"stages_sum_{clock}_ms"] = sum(steps.values())
    if args.apply:
        row[f"apply_{clock}_ms"] = apply_parts(fn, verts, aux, timer)
    row["saturation"] = saturation(fn, verts)
    if args.trace:
        row["trace"] = trace(p, x, verts, aux)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
