#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (smplifyx_torch) on one CUDA card.

    python3 chip_smoke.py

Builds every hand-written kernel from the sources in the checkout (one
nvcc per source, all started together), holds each against its plain
PyTorch version at the shapes the main path gives it (K1 skinning, K2
gather, K3 scatter-add) and times it, its plain version and one library
call on the device only (`time_ms`), holds the card's collision broad
phase equal to the CPU's, and drives two paths through the entry points a
user calls
(build_fit_session -> FitSession.fit -> recover_outputs, B=128 frames of a
full-width synthetic SMPL-X, V=10475; `smplifyx_torch.problem.build_slice`):

  * the collision-on path: the combined preset with the collision term in
    body stages 1-2, on the slice's model (`problem.slice_model`) and its
    part segmentation;
  * the collision-off path of the first slice (`interpenetration=False`);

and the app path through the command line a user runs
(`python -m smplifyx_torch.cli`, `smplifyx_torch.cli.main`): the VPoser
combined preset (`cfg/fit_smplx_combined_vposer_coco25.yaml`, collision on
in body stages 1-2) from the files `problem.write_app_inputs` writes into
a temporary directory (the slice's model as an SMPL-X .npz, its part
segmentation, a VPoser checkpoint, 128 PNGs with OpenPose JSONs, ExPose
and PIXIE results), run twice (the second timed, with its `Timer` spans),
its loaded model and prepared keypoints held equal to the in-memory ones,
and 4 of its frames refitted on the CPU through `app.run`.

The `serve` phase runs `serve.FitService` over the collision-on session
(`serve_http` on 127.0.0.1, `tools/load_serve.py` at 8 clients x 4
requests and 32 x 2), checks /healthz against the requests completed, and
refits the first batch served under load directly: the served losses and
parameters must be its bits.  The `first_order` phase fits the
collision-on preset with adam at B=32 (a broad phase in every
collision-stage evaluation, two row plans each) and short collision-off
fits with sgd and rmsprop, each twice (bit-equal), below the energy at its
start, with 2 lanes refitted on the CPU.  The `app` phase also reads its
JSONs through the native keypoint parser (`data/native.py`, built with the
host compiler beside the kernels) and the Python reader: the same
keypoints.

The `parallel` phases drive `smplifyx_torch/parallel/mesh.py` on the one
card, repeated in each mesh's device list: the vertex-sharded forward
(1x2 mesh, B=256: two K1 launches, each block's K1 against its plain
version, vertices and joints within 2e-5 m of the unsharded forward);
two spawned processes building the stale kernel libraries at once; the
data-parallel fit of 64 frames through `fit_batch_sharded`, collision_on's
preset in one worker (1x1) and in two (2x1) and collision_off's in two,
each run bit-equal per lane to `session.fit` in this process on its
workers' blocks of frames, with each run's start-up and fit seconds and
frames/s, beside session.fit on all 64 frames (a lane's result depends
on its batch's size; collision off, the median within 1%); and the
vertex-sharded collision-off fit (1x2, 8 frames, no joints model, within
5% per lane).  The `multihost` phases drive
`smplifyx_torch/parallel/multihost.py` on the one card: the dry run's
command (`python -m smplifyx_torch.parallel.multihost 2 1`, two ranks
over gloo on 127.0.0.1, their GLOBAL_LOSS lines the same bits), then
collision_on's preset on the same 64 frames in two ranks, fresh
interpreters that each build the problem from the seed, hold its digest
to this process's, fit their 32 rows through `fit_batch_multihost` and
gather: the gathered loss and x the same bits in both ranks and, per
lane, the bits of session.fit on the same two 32-frame blocks, K1, K2 and
K3 launched in each rank, no skinning plan built; per rank the start-up,
problem build, fit and gather times, the fit window and frames/s.  The
`oracle` phase holds the broad
phase on the card at `make_collision_fn`'s defaults against the exact
pair set of the ~21k-face posed-human proxy (`utils/proxy_mesh.py`), with
2x headroom at every budget.  The `families` phase checks K1 at J=52 and
J=24 and fits SMPL-H and SMPL at V=10475 through `build_fit_session`
(collision off).  The `video` phase fits the JAX package's batched
video-sequence example at full width (`problem.video_problem(128, 10475,
"slice")` through `examples/video_batch.py::fit_sequence`: a broad phase
every L-BFGS iteration, strong Wolfe) twice, bit-equal, with two row
plans per broad phase; it prints frames/s, host reads, broad phases and
PA-V2V against the sequence's ground truth, holds the stage-2 energy and
gradient of 16 lanes to the CPU's at x0 and at the fitted x
(`video_energy`) and the quality to the CPU's, and runs the example's
command line at 32 frames in a subprocess (`video_cli`).  The
`collision_profile` phase runs `tools/profile_collision.py` at B=256 with
`--stages --apply`: every component, broad-phase step and narrow-phase
part on the device, with each level's saturation.

The `classic` phase runs the command line with the classic SMPLify-X
preset (`cfg/fit_smplx_smplifyx.yaml`: five body stages, VPoser from the
zero latent, no regression or camera prior, the collision term in stages
3-4) on the app path's files: one frame (the reference fits one image per
process) and 128 frames, each twice, bit-equal, the second timed with its
evaluations per stage, host reads, `Timer` spans and launches.  The
`halpe` phase runs the Halpe preset (`cfg/fit_smplx_combined_halpe.yaml`)
the same way on 128 frames of Halpe-26 keypoint JSONs
(`write_app_inputs(..., keypoint_format="halpe")`).

Every CPU refit (the lane references of collision_on and collision_off,
the first-order lanes, the app's, classic's and halpe's first frames)
runs in one spawned child process (`cpu_refits`), started right after the
build, before the card's first fit, in the order the phases read the
results, with the card process's thread count at a lower priority: it
fits the card's own lanes (each path's problem built on the card first,
`refit_inputs`; the phase's own build must give the same bits) or writes
the same files (the same digest) and runs `app.run` on them.  Each phase
waits for its result (at most REFIT_WAIT_S) where it reads it.  The
classic preset's final losses move past 5% at the median of its 4 frames
under f32 rounding alone (the child refits them with the keypoints one
ulp up, `classic_one_ulp`); where that witness passes the bound, its
camera and body stages before the collision term are held at the median
instead, and the last stage's energy and gradient at the card's x are
held to the CPU's (both presets).  The `cpu_refits` line gives when each
refit started and ended beside the card's collision_on seconds per fit;
every phase line carries `t_s`, its seconds since the start.

After the collision-on, collision-off, first-order, app, classic and
halpe paths the `quality` phase holds the fit's meshes
against the problem's ground truth through `evaluation/metrics.py` on the
card (PA-V2V in mm over all vertices and per part of
`synthetic_part_vertex_ids`, PA-MPJPE over the skeleton joints) and
requires the same numbers from the CPU on the same arrays.  Last, the
`viz` phase runs the command line with `--visualize true` on 8 frames
(overlays per stage, the VPoser pose grid, the pickles' "stages"), fits
the same batch stage by stage through `viz/live.py::stream_fit`, and asks
the live viewer (`viz/viewer.py::serve_live_viewer`, on a thread on
127.0.0.1) for its page and its /version.  The `classic` and `halpe`
phases come after it.

Each path's kernel launch counts are set to 0 just before its timed fit
and read just after (K1's split into full-mesh and landmark-subset
launches); the two fits of each path must end bit-equal, neither may
build a skinning plan (the models carry them: `lbs_plan`), and the
collision-on fit must build two row plans per broad phase and none per
gradient; a sample of each path's lanes is fitted again through the
plain versions on the CPU by the refit process.  K1 is also held bit-equal to itself with a
plan of every column (the dense loop), and its rows carry the bound of
this W's nonzeros beside the dense one and the time of the torch-op VJP.  Each phase prints one JSON line; the
card's name and power limit are printed as nvidia-smi gives them; the
`kernels` line comes just before the last line, which is
{"ok": true, "device": {...}}.  Any failed check raises and the script
exits non-zero without that line, the refit process stopped.  Without a
CUDA card, or outside the repository, it fails.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

FWD_TOL = 1e-5      # f32 sums over J=55 in another order
GRAD_TOL = 1e-4     # the bound of tests/test_lbs_pallas.py, per unit of scale
SCATTER_TOL = 1e-5  # per unit of scale: the plain version adds with atomics
ENERGY_VALUE_RTOL = 1e-5
BROAD_LANES = 4     # lanes of the card-vs-CPU broad-phase check
# The first lanes of each path fitted again on the CPU; their final losses
# against the card's.  Collision off: every lane within 5%.  Collision on,
# the penalty's 1/sigma = 1e4 (df_cone_height) turns the f32 rounding
# differences between the devices into other trajectories, as a change of
# summation order on one card does (PERF.md §6, tools/rerun_spread.py), and
# single lanes end far apart: the median over 16 lanes within 5%.
LANE_SAMPLE = {"collision_on": 16, "collision_off": 4}
LANE_LOSS_RTOL = 0.05
# Stage-2 energy of the card and of the CPU at the same x.  The collision
# term's 1/sigma = 1e4 (df_cone_height) scales the f32 rounding of vertex
# coordinates (~1.2e-7 of a metre-sized body) into the penalty: ~1e-3
# relative for the value, more for the gradient.  A wrong pair, sign or
# index moves either by O(1).
SAME_X_VALUE_RTOL = 1e-3
SAME_X_GRAD_TOL = 1e-2

APP_FRAMES = 128    # frames of the app path (one gender group, B=128)
APP_CPU_FRAMES = 4  # of them refitted on the CPU; median loss within 5%
# PA-V2V and PA-MPJPE in mm of the same arrays through evaluation/metrics.py
# on the card and on the CPU: f32 sums over V=10475 in another order move
# them by ~1e-5 mm.
QUALITY_TOL_MM = 1e-3
VIZ_FRAMES = 8      # frames of the viz path: the host rasteriser draws
                    # (S + 2) images per frame
# A pickle's last "stages" entry against its final parameters: the same x,
# with VPoser decoding another batch.
STAGE_PARAM_TOL = 1e-6

# The serve phase: FitService over the collision-on session, and the load
# points (clients, requests per client) that tools/load_serve.py drives.
SERVE_OPTIONS = dict(max_batch=32, max_wait_s=0.25, max_queue=256)
SERVE_LOADS = ((8, 4), (32, 2))
# The first-order phase: 32 frames (64 lanes with try_both_orient), cut
# from 128 because every collision-stage evaluation runs a broad phase.
# The learning rates were chosen on CPU fits at V=96 (optax's rules): the
# preset's lr 1.0 is L-BFGS's first step.  adam runs the collision-on
# preset; sgd and rmsprop a short collision-off fit (maxiters 10: 20
# iterations per stage), where Nesterov SGD takes a tiny step because the
# data term's gradients reach 1e5.
FIRST_ORDER_BATCH = 32
FIRST_ORDER = {
    "adam": dict(optim_type="adam", lr=0.01),
    "sgd": dict(optim_type="sgd", lr=1e-9, maxiters=10,
                interpenetration=False),
    "rmsprop": dict(optim_type="rmsprop", lr=1e-3, maxiters=10,
                    interpenetration=False),
}
# Lanes of each first-order fit refitted on the CPU: 2, cut from 4 to
# make room for the parallel, oracle and families phases (adam's CPU
# refit took ~128 s per lane).
FIRST_ORDER_CPU_LANES = 2
# CPU refit of the collision-off first-order lanes: the median final loss
# within 1% of the card's, every lane within 5%.
FIRST_ORDER_MEDIAN_RTOL = 0.01

# The parallel phases (parallel/mesh.py) on one card, repeated in the
# device lists of their meshes: (a) the vertex-sharded forward at 256
# lanes (the collision stages' batch), within the bound of JAX's
# test_vertex_sharded_forward_matches; (b) the data-parallel fit of 64
# frames (collision_on's preset in 1 and 2 workers, collision_off's in
# 2), each run bit-equal to session.fit on its workers' blocks, and
# collision off within 1% at the median of session.fit on all 64; (c)
# the vertex-sharded collision-off fit of 8 frames, within 5% per lane.
CARD = "cuda:0"
SHARDED_FWD_BATCH = 256
SHARD_TOL = 2e-5
PARALLEL_FRAMES = 64
SHARDED_FIT_BATCH = 8
PARALLEL_LANE_RTOL = 0.05
PARALLEL_MEDIAN_RTOL = 0.01
# The multihost phase (parallel/multihost.py): (a) the dry run's command
# at 2 ranks x 1 device on the card; (b) collision_on's preset on the
# PARALLEL_FRAMES frames of phase_data_parallel, MULTIHOST_RANKS ranks on
# one card, each rank's lanes the bits of session.fit on its block.
MULTIHOST_RANKS = 2
MULTIHOST_TIMEOUT_S = 600
# The families phase: SMPL-H with hands and SMPL without, at V=10475.
FAMILIES = (("smplh", True), ("smpl", False))
FAMILY_BATCH = 32
# The video phase: the JAX package's examples/video_batch.py at full
# width, 128 frames (about 4 s of 30 fps video) on the slice's model
# (V=10475: the example's random faces saturate every budget at that
# width); the stage-2 energy of its first VIDEO_CPU_LANES lanes on the card
# against the CPU; then the example's command line at its own size (32
# frames, V=1024) in a subprocess.
VIDEO_FRAMES = 128
VIDEO_CPU_LANES = 16
VIDEO_CLI_FRAMES = 32
VIDEO_CLI_TIMEOUT_S = 300
# The collision_profile phase: tools/profile_collision.py at the doubled
# batch of the main path's collision stages.
PROFILE_BATCH = 256
# The classic and halpe phases: the command line on APP_FRAMES frames of
# `write_app_inputs` (Halpe-26 JSONs for halpe), collision on, with
# APP_CPU_FRAMES of them refitted on the CPU (median within 5%); classic
# also on one frame, the reference's unit of work.
PRESET_PATHS = {"app": ("fit_smplx_combined_vposer_coco25.yaml", "coco25"),
                "classic": ("fit_smplx_smplifyx.yaml", "coco25"),
                "halpe": ("fit_smplx_combined_halpe.yaml", "halpe")}
# The CPU refits of every path, in the order the card's phases read them:
# one spawned child process runs them all, started before the card's first
# fit, so they overlap the card's phases.  It fits the card's own lanes
# (built on the card first, `refit_inputs`) or writes the same files, and
# "classic_one_ulp" refits classic's frames with their 2D keypoints one
# ulp up: the witness of how far f32 rounding alone moves that fit.
REFIT_JOBS = ("collision_on", "collision_off", "first_order_adam",
              "first_order_sgd", "first_order_rmsprop", "app", "classic",
              "classic_one_ulp", "halpe")
REFIT_WAIT_S = 900      # the longest a phase waits for its refit
# The child keeps the card process's intra-op thread count, so its fits are
# the bits an in-process refit gives: the CPU's f32 sums depend on the
# count, and the collision-on and VPoser fits turn a last-bit difference
# into another minimum (classic_one_ulp shows how far).  It runs at a lower
# priority instead.
REFIT_NICE = 10
T0 = time.time()        # the run's start; every phase line carries t_s

# Data-sheet peaks (dense, no sparsity): FP32 on the CUDA cores, memory rate.
PEAKS = {  # name fragment -> (FP32 FLOP/s, bytes/s)
    "H100 PCIe": (51.2e12, 2.0e12),
    "H100 NVL": (60.0e12, 3.9e12),
    "H200": (67.0e12, 4.8e12),
    "H100": (67.0e12, 3.35e12),   # SXM
}


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": time.time() - T0}
    print(json.dumps(obj), flush=True)


def peaks_for(name: str):
    for frag, peak in PEAKS.items():
        if frag in name:
            return peak
    raise RuntimeError(f"no data-sheet peaks for card {name!r}")


def timings(**fns):
    """{name}_ms (device) and {name}_call_ms (host path inside) per fn."""
    out = {}
    for name, fn in fns.items():
        out[f"{name}_ms"], out[f"{name}_call_ms"] = time_ms(fn)
    return out


def _bound_ms(ops, nbytes, peak):
    flop, bw = peak
    t_ops, t_bytes = ops / flop, nbytes / bw
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def lbs_bound_ms(B, V, J, nnz, peak):
    """Least time for the skinning function with this W: the larger of its
    operations (12 FMAs per lane and nonzero weight, the 3x4 epilogue)
    over the FP32 peak and its bytes (v_posed read and the output written
    once, A, and a 4-byte column and value per nonzero) over the memory
    rate."""
    ops = 2.0 * B * nnz * 12 + 18.0 * B * V
    nbytes = 4.0 * (B * J * 16 + 2 * B * V * 3) + 8.0 * nnz
    return _bound_ms(ops, nbytes, peak)


def dense_bound_ms(B, V, J, peak):
    """The same bound for a dense W (every one of the V x J weights read
    and multiplied), as the K1 rows were held to before the column plan."""
    ops = 2.0 * B * V * J * 12 + 18.0 * B * V
    nbytes = 4.0 * (V * J + B * J * 16 + 2 * B * V * 3)
    return _bound_ms(ops, nbytes, peak)


def _event():
    import torch

    return torch.cuda.Event(enable_timing=True)


def _spin_cycles_per_ms():
    """Clock cycles of `torch.cuda._sleep` per millisecond on this card."""
    import torch

    if not hasattr(_spin_cycles_per_ms, "value"):
        cycles = 20_000_000
        torch.cuda._sleep(cycles)           # warm
        start, end = _event(), _event()
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _spin_cycles_per_ms.value = cycles / start.elapsed_time(end)
    return _spin_cycles_per_ms.value


def time_ms(fn, reps=25, warmup=3):
    """-> (device ms, call ms) of one call of fn (warm L2, as on the main
    path).

    Device: `reps` calls queued behind a spin kernel (`torch.cuda._sleep`)
    that outlasts their enqueue, between two CUDA events, divided by
    `reps`.  The card runs the calls back to back, so no host path (the
    wrapper's checks, the ctypes call) sits in the window.  The start event
    must still be pending when the last call is queued; if not, the spin
    doubles and the run repeats.
    Call: the median over `reps` of events around one call, host path
    inside (the per-call time this script reported before it timed the
    device alone)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    calls = []
    for _ in range(reps):
        start, end = _event(), _event()
        start.record()
        fn()
        end.record()
        end.synchronize()
        calls.append(start.elapsed_time(end))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    spin_ms = 2e3 * (time.perf_counter() - t0) + 1.0
    torch.cuda.synchronize()
    for _ in range(6):
        start, end = _event(), _event()
        torch.cuda._sleep(int(spin_ms * _spin_cycles_per_ms()))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        covered = not start.query()
        end.synchronize()
        if covered:
            return start.elapsed_time(end) / reps, statistics.median(calls)
        spin_ms *= 2
    raise RuntimeError("the spin kernel never outlasted the enqueue")


def nvidia_smi():
    """The first card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this script "
                           "runs the port on a CUDA card")
    smi = nvidia_smi()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return name


KERNEL_SOURCES = ("lbs", "gather")
HOST_LIBRARIES = ("keypoints_torch",)   # the native keypoint parser


def phase_build():
    """nvcc for every kernel source and the host compiler for the keypoint
    parser, all started together."""
    from smplifyx_torch.ops import nvcc

    t0 = time.perf_counter()
    report = nvcc.build(*KERNEL_SOURCES, *HOST_LIBRARIES, force=True)
    wall = time.perf_counter() - t0
    for name, (seconds, ptxas) in report.items():
        emit({"phase": "build", "source": name, "seconds": seconds,
              "ptxas": ptxas, "command": " ".join(nvcc.build_command(name))})
    emit({"phase": "build", "wall_s": wall})


def launch_counters():
    from smplifyx_torch.ops.gather import gather_rows, scatter_add_rows
    from smplifyx_torch.ops.lbs import lbs_apply

    return {"lbs": lbs_apply, "gather": gather_rows,
            "scatter": scatter_add_rows}


def reset_counts():
    for fn in launch_counters().values():
        fn.launches = 0
    launch_counters()["scatter"].join_launches = 0
    launch_counters()["lbs"].launches_by_rows = {}


def read_counts():
    """Launches per wrapper; `scatter_join` counts K3's second kernel,
    `lbs_by_rows` K1's launches per vertex count V."""
    counts = {name: fn.launches for name, fn in launch_counters().items()}
    counts["scatter_join"] = launch_counters()["scatter"].join_launches
    counts["lbs_by_rows"] = dict(launch_counters()["lbs"].launches_by_rows)
    return counts


def check_lbs(name, W, plan, B, peak, seed):
    """K1 against its plain version on the card: forward, VJP, times; the
    kernel with the plan bit-equal to the kernel with every column (the
    dense loop)."""
    import torch

    from smplifyx_torch.ops import lbs

    lbs_apply, lbs_reference = lbs.lbs_apply, lbs.lbs_reference
    V, J = W.shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(B, J, 16, device="cuda", generator=gen) * 0.3
    A[..., [0, 5, 10, 15]] += 1.0
    v = torch.randn(B, V, 3, device="cuda", generator=gen) * 0.5
    gout = torch.randn(B, V, 3, device="cuda", generator=gen)

    with torch.no_grad():
        out = lbs_apply(W, A, v, plan)
        ref = lbs_reference(W, A, v)
        cols = torch.arange(J, dtype=torch.int32, device="cuda").expand(V, J)
        full = lbs.LBSPlan(cols.contiguous(), W)
        full_plan_equal = torch.equal(out, lbs._kernel_forward(full, A, v))
    torch.cuda.synchronize()
    fwd_err = (out - ref).abs().max().item()

    Ak, vk = A.clone().requires_grad_(True), v.clone().requires_grad_(True)
    (lbs_apply(W, Ak, vk, plan) * gout).sum().backward()
    Ap, vp = A.clone().requires_grad_(True), v.clone().requires_grad_(True)
    (lbs_reference(W, Ap, vp) * gout).sum().backward()
    torch.cuda.synchronize()
    grad_err = {}
    for key, got, want in (("dA", Ak.grad, Ap.grad), ("dv", vk.grad, vp.grad)):
        scale = max(1.0, want.abs().max().item())
        grad_err[key] = (got - want).abs().max().item() / scale

    with torch.no_grad():
        times = timings(
            kernel=lambda: lbs_apply(W, A, v, plan),
            plain=lambda: lbs_reference(W, A, v),
            library=lambda: torch.matmul(W, A),
            backward=lambda: lbs.lbs_vjp(W, A, v, gout))
    nnz = int((W != 0).sum())
    bound_ms, bound_by = lbs_bound_ms(B, V, J, nnz, peak)
    dense_ms, _ = dense_bound_ms(B, V, J, peak)
    row = {"phase": "lbs_check", "shape": name, "B": B, "V": V, "J": J,
           "K": int(plan.cols.shape[1]), "nnz": nnz,
           "fwd_max_abs_err": fwd_err, "dA_err_per_scale": grad_err["dA"],
           "dv_err_per_scale": grad_err["dv"],
           "full_plan_bit_equal": full_plan_equal,
           **times, "bound_ms": bound_ms, "bound_by": bound_by,
           "dense_bound_ms": dense_ms,
           "share_of_bound": bound_ms / times["kernel_ms"]}
    emit(row)
    if not full_plan_equal:
        raise AssertionError(f"lbs kernel with its plan and with every column "
                             f"differ in bits at {name}")
    if not fwd_err <= FWD_TOL:
        raise AssertionError(f"lbs forward error {fwd_err} > {FWD_TOL} at {name}")
    for key, err in grad_err.items():
        if not err <= GRAD_TOL:
            raise AssertionError(f"lbs {key} error {err} > {GRAD_TOL} at {name}")
    return row


def phase_lbs(model, jm, batch, peak):
    """K1 at the main path's shapes (the full mesh over the doubled batch
    of the collision stages, the full mesh of `recover_outputs`, the
    landmark subset over the doubled batch) and at a ragged one."""
    import torch

    from smplifyx_torch.ops.lbs import lbs_plan

    gen = torch.Generator(device="cuda").manual_seed(7)
    W_ragged = torch.rand(500, 55, device="cuda", generator=gen)
    W_ragged = W_ragged / W_ragged.sum(-1, keepdim=True)
    full = (model.lbs_weights, model.lbs_plan)
    return [
        check_lbs("full_mesh_stages", *full, 2 * batch, peak, 4),
        check_lbs("full_mesh", *full, batch, peak, 1),
        check_lbs("ragged", W_ragged, lbs_plan(W_ragged), 3, peak, 2),
        check_lbs("subset", jm.sub_lbs, jm.lbs_plan, 2 * batch, peak, 3),
    ]


def rows_bound_ms(B, R, C, touched_rows, out_rows, rate, id_bytes):
    """Least time for a row gather or scatter: bytes over the memory rate.
    Inputs read once (one id of id_bytes per entry, the rows the ids
    touch), the output written once; the arithmetic (K3's adds) is
    negligible beside them.  What an implementation reads beyond that (K3's
    sorted order) is its own cost, not the function's."""
    nbytes = id_bytes * B * R + 4.0 * C * (touched_rows + out_rows)
    return 1e3 * nbytes / rate, "bytes"


def check_gather(name, table, ids, rate):
    """K2 against its plain version: bit-exact with the int64 ids and with
    the int32 ids of their row plan; its times with the plan's ids, as the
    main path calls it, and the plan's build."""
    import torch

    from smplifyx_torch.ops.gather import gather_reference, gather_rows, row_plan

    B, N, C = table.shape
    R = ids.shape[1]
    plan = row_plan(ids)
    ref = gather_reference(table, ids)
    exact = {"int64": torch.equal(gather_rows(table, ids), ref),
             "int32": torch.equal(gather_rows(table, plan[:, 0]), ref)}
    err = max((gather_rows(table, i) - ref).abs().max().item()
              for i in (ids, plan[:, 0]))
    idx = ids[..., None].expand(B, R, C)
    times = timings(kernel=lambda: gather_rows(table, plan[:, 0]),
                    plan=lambda: row_plan(ids),
                    plain=lambda: gather_reference(table, ids),
                    library=lambda: torch.gather(table, 1, idx))
    lanes = torch.arange(B, device=ids.device)[:, None] * N
    touched = int(torch.unique(ids + lanes).numel())
    bound_ms, bound_by = rows_bound_ms(B, R, C, touched, B * R, rate, 4)
    row = {"phase": "gather_check", "shape": name, "B": B, "N": N, "R": R,
           "C": C, "max_abs_err": err, "bit_exact": exact, **times,
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit(row)
    if not all(exact.values()):
        raise AssertionError(f"gather kernel is not bit-exact at {name}: {exact}")
    return row


def check_scatter(name, ids, values, num_rows, rate):
    """K3 against its plain version (within 1e-5 per unit of scale), a
    second launch on the same inputs and a launch that builds its own plan
    (both bit-equal: no atomics, one order per id set), and its times with
    the plan given, as the main path calls it, and the plan's build."""
    import torch

    from smplifyx_torch.ops.gather import (row_plan, scatter_add_reference,
                                           scatter_add_rows)

    B, R, C = values.shape
    plan = row_plan(ids)
    out = scatter_add_rows(plan, values, num_rows)
    ref = scatter_add_reference(ids, values, num_rows)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    rerun = torch.equal(out, scatter_add_rows(plan, values, num_rows))
    unplanned = torch.equal(out, scatter_add_rows(ids, values, num_rows))
    lanes = torch.arange(B, device=ids.device)[:, None] * num_rows
    per_row = torch.bincount((ids + lanes).reshape(-1), minlength=B * num_rows)
    idx = ids[..., None].expand(B, R, C)
    zeros = torch.zeros(B, num_rows, C, device=values.device)
    times = timings(
        kernel=lambda: scatter_add_rows(plan, values, num_rows),
        plan=lambda: row_plan(ids),
        plain=lambda: scatter_add_reference(ids, values, num_rows),
        library=lambda: zeros.clone().scatter_add_(1, idx, values))
    distinct = int((per_row > 0).sum())
    bound_ms, bound_by = rows_bound_ms(B, R, C, B * R, B * num_rows, rate, 4)
    row = {"phase": "scatter_check", "shape": name, "B": B, "R": R, "C": C,
           "num_rows": num_rows, "distinct_rows": distinct,
           "largest_row_share": int(per_row.max()) / R,
           "max_abs_err": err, "err_per_scale": err / scale,
           "rerun_bit_equal": rerun, "unplanned_bit_equal": unplanned,
           **times, "bound_ms": bound_ms, "bound_by": bound_by}
    emit(row)
    if not err <= SCATTER_TOL * scale:
        raise AssertionError(f"scatter error {err} > {SCATTER_TOL} x {scale} "
                             f"at {name}")
    if not (rerun and unplanned):
        raise AssertionError(f"scatter launches on the same inputs differ at "
                             f"{name}: rerun {rerun}, unplanned {unplanned}")
    return row


def gt_vertices(model, lanes):
    """Vertices of the first `lanes` ground-truth poses of the problem."""
    import torch

    from smplifyx_torch.models.forward import smplx_forward
    from smplifyx_torch.problem import ground_truth

    with torch.no_grad():
        return smplx_forward(model, ground_truth(lanes, "cuda")).vertices


def phase_gather(session, model, peak):
    """K2 and K3 at the main path's four shapes (256 lanes: the doubled
    batch of the collision stages; the ids of a broad phase at the
    problem's ground-truth poses), at a padding-heavy level 2 (95% of each
    lane's ids on row 0), at ragged shapes (R not a multiple of K3's tile),
    at widths that take the generic paths (C = 5, 16) and at a
    duplicate-heavy scatter."""
    import torch

    fn = session.collision_fn
    verts = gt_vertices(model, 128)
    aux = fn.build(verts)
    verts = torch.cat([verts, verts])                   # [256, V, 3]
    B, T, P = 256, fn.T, fn.P
    cids = torch.cat([aux.tri_corners, aux.tri_corners]).reshape(B, 3 * T).long()
    pids = torch.cat([torch.cat([aux.pa, aux.pb], 1)] * 2).long()
    c9 = verts[torch.arange(B, device="cuda")[:, None], cids].reshape(B, T, 9)
    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    def randint(n, *shape):
        return torch.randint(0, n, shape, device="cuda", generator=gen)

    rate = peak[1]
    padded = torch.where(
        torch.rand(B, 2 * P, device="cuda", generator=gen) < 0.95, 0,
        randint(T, B, 2 * P))
    gathers = [
        check_gather("level1_corners", verts, cids, rate),
        check_gather("level2_pairs", c9, pids, rate),
        check_gather("padding_heavy_c9", c9, padded, rate),
        check_gather("ragged_c3", randn(3, 777, 3), randint(777, 3, 1001), rate),
        check_gather("ragged_c9", randn(3, 129, 9), randint(129, 3, 333), rate),
        check_gather("generic_c5", randn(3, 300, 5), randint(300, 3, 1001), rate),
    ]
    scatters = [
        check_scatter("level2_pairs", pids, randn(B, 2 * P, 9), T, rate),
        check_scatter("level1_corners", cids, randn(B, 3 * T, 3),
                      verts.shape[1], rate),
        check_scatter("padding_heavy_c9", padded, randn(B, 2 * P, 9), T, rate),
        check_scatter("ragged_c3", randint(777, 3, 1001), randn(3, 1001, 3),
                      777, rate),
        check_scatter("ragged_c9", randint(129, 3, 333), randn(3, 333, 9),
                      129, rate),
        check_scatter("generic_c5", randint(300, 3, 1001), randn(3, 1001, 5),
                      300, rate),
        check_scatter("generic_c16", randint(64, 2, 2500), randn(2, 2500, 16),
                      64, rate),
        check_scatter("duplicate_heavy", randint(5, 4, 3000), randn(4, 3000, 3),
                      100, rate),
    ]
    return gathers, scatters


def phase_broad(session, model, cpu_fn):
    """The broad phase on the card and on the CPU, on the same vertices
    (the problem's first ground-truth poses, skinned on the card): the
    pair lists must be identical.  Prints the survivors at every level."""
    import torch

    fn = session.collision_fn
    verts = gt_vertices(model, BROAD_LANES)
    t0 = time.perf_counter()
    card = fn.build(verts)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = cpu_fn.build(verts.cpu())
    same = {name: bool(torch.equal(getattr(card, name).cpu(), want))
            for name, want in cpu._asdict().items()}
    sat = fn.saturation(verts)
    emit({"phase": "broad_phase", "lanes": BROAD_LANES, "identical": same,
          "valid_pairs": card.valid.sum(1).tolist(), "card_build_s": card_s,
          "saturation": {k: [c.tolist(), b] for k, (c, b) in sat.items()}})
    if not all(same[k] for k in ("corner_plan", "pair_plan", "valid")):
        raise AssertionError(f"card and CPU broad phases differ: {same}")


class PlainNarrow:
    """A collision term whose narrow phase is the plain version of the
    pair gather (for holding K2/K3 against it inside the energy)."""

    def __init__(self, fn):
        self.fn = fn

    def apply(self, vertices, aux):
        from smplifyx_torch.ops.collision import pair_gather_reference

        ta, tb = pair_gather_reference(vertices, aux.tri_corners, aux.pa,
                                       aux.pb)
        return self.fn.penalty(ta, tb, aux.valid)


def phase_energy_collision(session, model, frames, x0):
    """One value-and-gradient of the stage-2 energy, collision term on,
    with K2/K3 and with the plain narrow phase under the same aux."""
    import torch

    from smplifyx_torch.fitting.energy import smplify_energy_terms
    from smplifyx_torch.fitting.params import body_params_from_flat
    from smplifyx_torch.models.forward import smplx_forward

    fn = session.collision_fn
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = x0 + 0.1 * torch.randn(x0.shape, device="cuda", generator=gen)
    x[:, 2] = 4.5
    settings = session.settings
    with torch.no_grad():
        params, _, _ = body_params_from_flat(settings, x, session.decode_body)
        aux = fn.build(smplx_forward(model, params).vertices)
    w = session.schedule.stage(2)
    res = []
    for cf in (fn, PlainNarrow(fn)):
        xx = x.clone().requires_grad_(True)
        terms = smplify_energy_terms(
            xx, settings, model, frames, w, 2, 3, session.decode_body,
            session.joint_map, collision_fn=cf, collision_aux=aux)
        f = sum(terms.values())
        (g,) = torch.autograd.grad(f.sum(), xx)
        res.append((f.detach(), g, terms["collision"].detach()))
    torch.cuda.synchronize()
    (fk, gk, ck), (fp, gp, cp) = res
    f_rel = ((fk - fp).abs() / fp.abs()).max().item()
    g_err = ((gk - gp).abs().max() / max(1.0, gp.abs().max().item())).item()
    emit({"phase": "energy_collision", "B": x.shape[0],
          "value_max_rel_err": f_rel, "grad_max_err_per_scale": g_err,
          "collision_term_median": float(ck.median()),
          "collision_term_max": float(ck.max()),
          "lanes_with_collision": int((ck > 0).sum()),
          "valid_pairs_median": float(aux.valid.sum(1).float().median()),
          "finite": bool(torch.isfinite(fk).all() and torch.isfinite(gk).all())})
    if not (f_rel <= ENERGY_VALUE_RTOL and g_err <= GRAD_TOL
            and torch.isfinite(fk).all() and torch.isfinite(gk).all()):
        raise AssertionError("the energy through K2/K3 and through the plain "
                             "narrow phase disagree")
    if not bool((ck > 0).any()):
        raise AssertionError("no lane has a collision term: the check is empty")


def phase_energy(session, model, jm, frames, x0):
    """One value-and-gradient of the stage-2 energy through the full-mesh
    forward (K1 at V=10475 and its backward) against the joints-only one."""
    import torch

    from smplifyx_torch.fitting.energy import smplify_energy

    gen = torch.Generator(device="cuda").manual_seed(11)
    x = x0 + 0.1 * torch.randn(x0.shape, device="cuda", generator=gen)
    x[:, 2] = 4.5
    w = session.schedule.stage(2)
    res = []
    for joints_model in (None, jm):
        xx = x.clone().requires_grad_(True)
        f = smplify_energy(xx, session.settings, model, frames, w, 2, 3,
                           session.decode_body, session.joint_map,
                           joints_model=joints_model)
        (g,) = torch.autograd.grad(f.sum(), xx)
        res.append((f.detach(), g))
    torch.cuda.synchronize()
    (fd, gd), (fs, gs) = res
    f_rel = ((fd - fs).abs() / fd.abs()).max().item()
    g_rel = ((gd - gs).abs().max() / gd.abs().max()).item()
    emit({"phase": "energy_dense_vs_sparse", "B": x.shape[0],
          "V": model.lbs_weights.shape[0],
          "value_max_rel_err": f_rel, "grad_max_err_per_scale": g_rel,
          "finite": bool(torch.isfinite(fd).all() and torch.isfinite(gd).all())})
    if not (f_rel <= 1e-4 and g_rel <= 1e-4
            and torch.isfinite(fd).all() and torch.isfinite(gd).all()):
        raise AssertionError("dense and sparse energies disagree")


def reprojection_px(session, model, frames, x):
    """Per-lane mean 2D distance (pixels) between projected and observed
    keypoints, over keypoints with positive weight."""
    import torch

    from smplifyx_torch.fitting.energy import make_camera
    from smplifyx_torch.fitting.pipeline import recover_outputs
    from smplifyx_torch.ops.camera import project_points

    out, _, cam_t = recover_outputs(model, session.settings, x,
                                    session.decode_body, session.joint_map)
    proj = project_points(make_camera(frames, cam_t), out.joints)
    dist = torch.linalg.norm(proj - frames.gt_joints, dim=-1)
    return dist.mean(-1), out


def setup(label, **overrides):
    """The user's entry points: session, model, joints model, frames."""
    import torch

    from smplifyx_torch.problem import build_slice

    t0 = time.perf_counter()
    session, model, jm, frames, x0 = build_slice(**overrides)
    torch.cuda.synchronize()
    emit({"phase": "setup", "path": label, "seconds": time.perf_counter() - t0,
          "B": int(x0.shape[0]), "V": int(model.lbs_weights.shape[0]),
          "interpenetration": bool(session.cfg.interpenetration),
          "coll_stage_mask": session.coll_stage_mask,
          "aux_every": session.options.lbfgs.aux_every,
          "optim_type": session.options.optim_type,
          "subset_vertices": int(jm.sub_lbs.shape[0]), "dim": int(x0.shape[1])})
    return session, model, jm, frames, x0


def count_broad_phases(fn):
    """Count calls of the collision term's broad phase (`build`,
    `build_refresh`) on this instance until the returned dict is read;
    an empty dict when the path has no collision term."""
    counts = {}
    if fn is None:
        return counts
    for name in ("build", "build_refresh"):
        counts[name] = 0
        method = getattr(fn, name)

        def counted(*args, _method=method, _name=name):
            counts[_name] += 1
            return _method(*args)

        setattr(fn, name, counted)
    return counts


def phase_main_path(label, session, model, jm, frames, x0, needs):
    """Fit twice (the first run warms up), time the second, recover the
    mesh.  Launch counts are set to 0 just before the second fit and read
    after the fit and after recover_outputs; every kernel in `needs` must
    have launched in the fit."""
    import torch

    t0 = time.perf_counter()
    first = session.fit(model, jm, frames, x0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    from smplifyx_torch.ops.gather import row_plan
    from smplifyx_torch.ops.lbs import lbs_plan

    broad = count_broad_phases(session.collision_fn)
    reset_counts()
    row_plan.builds = 0
    lbs_plan.builds = 0
    t0 = time.perf_counter()
    res = session.fit(model, jm, frames, x0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = read_counts()
    plan_builds = row_plan.builds
    lbs_plan_builds = lbs_plan.builds
    broad = dict(broad)
    for name in broad:                  # back to the class's methods
        delattr(session.collision_fn, name)
    reproj, out = reprojection_px(session, model, frames, res.x)
    torch.cuda.synchronize()
    main_launches = read_counts()

    reproj0, _ = reprojection_px(session, model, frames, x0)
    rerun = (first.loss - res.loss).abs() / res.loss.abs()
    rerun_equal = bool(torch.equal(first.x, res.x)
                       and torch.equal(first.loss, res.loss))
    B, V = x0.shape[0], model.lbs_weights.shape[0]
    S = jm.sub_lbs.shape[0]
    by_rows = fit_launches["lbs_by_rows"]
    lbs_split = {"full_mesh": by_rows.get(V, 0), "subset": by_rows.get(S, 0)}
    losses = torch.cat([res.loss[None], res.camera_loss[None],
                        res.stage_losses])
    row = {
        "phase": "main_path", "path": label,
        "card": torch.cuda.get_device_name(0),
        "B": B, "V": V, "first_fit_s": first_s,
        "fit_s": fit_s, "frames_per_s": B / fit_s,
        "host_reads_per_fit": res.host_reads,
        "launches_fit": fit_launches, "launches_main": main_launches,
        "lbs_launches_fit": lbs_split,
        "lbs_launches_main": {
            "full_mesh": main_launches["lbs_by_rows"].get(V, 0),
            "subset": main_launches["lbs_by_rows"].get(S, 0)},
        "broad_phases_fit": broad, "plan_builds_fit": plan_builds,
        "lbs_plan_builds_fit": lbs_plan_builds,
        "camera_evals_max": int(res.camera_evals.max()),
        "camera_evals_median": float(res.camera_evals.float().median()),
        "stage_evals_max": res.stage_evals.amax(1).tolist(),
        "stage_evals_median": res.stage_evals.float().median(1).values.tolist(),
        "loss_median": float(res.loss.median()),
        # the two card fits of the same inputs
        "rerun_bit_equal": rerun_equal,
        "rerun_rel_diff_max": float(rerun.max()),
        "stage_loss_median": res.stage_losses.median(1).values.tolist(),
        "flipped": int(res.flipped.sum()),
        "reproj_px_median": float(reproj.median()),
        "reproj_px_max": float(reproj.max()),
        "reproj_px_x0_median": float(reproj0.median()),
    }
    fn = session.collision_fn
    if fn is not None:
        sat = fn.saturation(out.vertices)
        row["final_saturation"] = {
            k: {"max": int(c.max()), "median": float(c.float().median()),
                "budget": b, "lanes_at_budget": int((c >= b).sum())}
            for k, (c, b) in sat.items()}
    emit(row)
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("a loss is not finite")
    if not bool((reproj < reproj0).all()):
        raise AssertionError("some lane's reprojection did not improve on x0")
    if tuple(out.vertices.shape) != (B, V, 3) or not bool(
            torch.isfinite(out.vertices).all()):
        raise AssertionError("recovered mesh has the wrong shape or non-finite values")
    for name in needs:
        if fit_launches[name] <= 0:
            raise AssertionError(f"the {label} fit never launched the {name} kernel")
    # K1 on the landmark subset in every path's fit, on the full mesh in the
    # collision stages; nothing else; the models' plans, none built.
    if not (lbs_split["subset"] > 0 and sum(lbs_split.values())
            == fit_launches["lbs"]
            and (lbs_split["full_mesh"] > 0) == (session.collision_fn
                                                 is not None)):
        raise AssertionError(f"the {label} fit launched K1 {lbs_split} "
                             f"({fit_launches['lbs']} in all)")
    if lbs_plan_builds != 0:
        raise AssertionError(f"the {label} fit built {lbs_plan_builds} "
                             "skinning plans; the models carry them")
    if not rerun_equal:
        raise AssertionError(f"two {label} fits of the same inputs differ "
                             f"(worst lane {float(rerun.max()):.3g})")
    # One sort per id set: two row plans per broad phase, none per gradient.
    if plan_builds != 2 * sum(broad.values()):
        raise AssertionError(f"the {label} fit built {plan_builds} row plans "
                             f"for {broad} broad phases")
    return res, main_launches, plan_builds, fit_s


def stage2_energy(session, model, frames, x):
    """Stage-2 energy per lane and its gradient at x, on x's device (the
    collision term, when on, on a broad phase of these vertices)."""
    import torch

    from smplifyx_torch.fitting.energy import smplify_energy

    xx = x.clone().requires_grad_(True)
    f = smplify_energy(xx, session.settings, model, frames,
                       session.schedule.stage(2), 2, 3, session.decode_body,
                       session.joint_map,
                       collision_fn=session.collision_fn)
    (g,) = torch.autograd.grad(f.sum(), xx)
    return f.detach(), g


# ------------------------------------------------------------ CPU refits


def preset_path(label):
    from smplifyx_torch.problem import APP_PRESET

    return os.path.join(os.path.dirname(APP_PRESET), PRESET_PATHS[label][0])


def app_argv(preset, overrides):
    return ["--config", preset, *[f"--{k}={v}" for k, v in overrides.items()]]


def inputs_digest(root):
    """sha256 over the files `write_app_inputs` wrote under root: the arrays
    of .npz files and the tensors of .pt files (their archives carry
    write times), the bytes of every other file."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            path = os.path.join(d, f)
            h.update(os.path.relpath(path, root).encode())
            if f.endswith(".npz"):
                with np.load(path) as z:
                    for k in sorted(z.files):
                        h.update(k.encode() + np.ascontiguousarray(z[k]).tobytes())
            elif f.endswith(".pt"):
                for k, v in sorted(torch.load(path).items()):
                    h.update(k.encode() + v.numpy().tobytes())
            else:
                with open(path, "rb") as fh:
                    h.update(fh.read())
    return h.hexdigest()


LANE_JOBS = {  # lane refit -> (batch, lanes, overrides of build_slice)
    "collision_on": (None, LANE_SAMPLE["collision_on"], {}),
    "collision_off": (None, LANE_SAMPLE["collision_off"],
                      {"interpenetration": False}),
    **{f"first_order_{k}": (FIRST_ORDER_BATCH, FIRST_ORDER_CPU_LANES, v)
       for k, v in FIRST_ORDER.items()}}


def refit_inputs():
    """The lanes each lane refit fits: the first lanes of the card's own
    problem (`build_slice` on the card, as `setup` builds it), on the CPU.
    The card builds the same bits again when its phase sets up."""
    import torch

    from smplifyx_torch.problem import SLICE_BATCH, build_slice

    out = {}
    for job, (batch, lanes, overrides) in LANE_JOBS.items():
        _, _, _, frames, x0 = build_slice(batch or SLICE_BATCH, **overrides)
        out[job] = (frames.map(lambda a: a[:lanes].cpu()), x0[:lanes].cpu())
    torch.cuda.empty_cache()
    return out


def _refit_lanes(job, frames, x0):
    """The card's lanes of a path, fitted on the CPU (the plain versions)
    by the path's session built there."""
    from smplifyx_torch.models.sparse import build_joints_model
    from smplifyx_torch.problem import slice_session

    session, model = slice_session(device="cpu", **LANE_JOBS[job][2])
    t0 = time.perf_counter()
    res = session.fit(model, build_joints_model(model), frames, x0)
    return {"fit_s": time.perf_counter() - t0, "loss": res.loss.numpy(),
            "x": res.x.numpy(), "flipped": res.flipped.numpy()}


def _refit_app(label, one_ulp=False):
    """APP_CPU_FRAMES frames of the `label` path's files on the CPU,
    through `app.run` with the path's preset: the final losses, and the
    camera and body stages' losses.  `one_ulp` moves the prepared 2D
    keypoints one ulp up (the witness of how far f32 rounding alone
    moves the fit)."""
    import tempfile

    import torch

    from smplifyx_torch.app import run
    from smplifyx_torch.problem import write_app_inputs
    from smplifyx_torch.session import FitSession
    from smplifyx_torch.utils.config import parse_cli

    fit = FitSession.fit

    def moved(session, model, jm, frames, x0):
        g = frames.gt_joints
        return fit(session, model, jm, dataclasses.replace(
            frames, gt_joints=torch.nextafter(g, torch.full_like(g, np.inf))),
            x0)

    with tempfile.TemporaryDirectory() as tmp:
        inputs = write_app_inputs(tmp, APP_FRAMES,
                                  keypoint_format=PRESET_PATHS[label][1])
        digest = inputs_digest(tmp)
        argv = app_argv(preset_path(label), inputs.overrides) + [
            "--output_folder", os.path.join(tmp, "out")]
        if one_ulp:
            FitSession.fit = moved
        counter = FitCounter()
        try:
            with counter:
                t0 = time.perf_counter()
                res = run(parse_cli(argv), max_frames=APP_CPU_FRAMES,
                          device="cpu")
                fit_s = time.perf_counter() - t0
        finally:
            FitSession.fit = fit
        r = counter.results[0]
        return {"fit_s": fit_s, "losses": np.asarray(res.losses),
                "names": res.names, "inputs_digest": digest,
                "stage_losses": torch.cat(
                    [r.camera_loss[None], r.stage_losses]).numpy()}


def refit(job, inputs):
    if job in LANE_JOBS:
        return _refit_lanes(job, *inputs[job])
    if job.endswith("_one_ulp"):
        return _refit_app(job[:-len("_one_ulp")], one_ulp=True)
    return _refit_app(job)


def cpu_refits(queue, epoch, threads, inputs):
    """The child process: every job of REFIT_JOBS in order on the CPU with
    `threads` intra-op threads at REFIT_NICE; puts (job, result) on the
    queue, or (job, {"error": traceback}) and stops."""
    import traceback

    import torch

    sys.stdout = sys.stderr     # the parent's standard output is its JSON
    os.nice(REFIT_NICE)
    torch.set_num_threads(threads)
    for job in REFIT_JOBS:
        start = time.time() - epoch
        try:
            out = refit(job, inputs)
        except Exception:
            queue.put((job, {"error": traceback.format_exc()}))
            return
        out.update(start_s=start, end_s=time.time() - epoch)
        queue.put((job, out))


class CpuRefits:
    """The parent's side of `cpu_refits`: start the child with the lane
    refits' inputs, wait (bounded) for a job's result, stop the child."""

    def __init__(self, inputs):
        import multiprocessing

        import torch

        ctx = multiprocessing.get_context("spawn")
        self.queue = ctx.Queue()
        self.inputs = inputs
        self.threads = torch.get_num_threads()
        self.proc = ctx.Process(target=cpu_refits, daemon=True,
                                args=(self.queue, T0, self.threads, inputs))
        self.proc.start()
        self.started_s = time.time() - T0
        self.results, self.waits = {}, {}

    def get(self, job):
        import queue

        t0 = time.perf_counter()
        while job not in self.results:
            try:
                name, out = self.queue.get(timeout=5)
            except queue.Empty:
                if not self.proc.is_alive():
                    raise RuntimeError(
                        f"the CPU refit process exited {self.proc.exitcode} "
                        f"before giving {job}") from None
                if time.perf_counter() - t0 > REFIT_WAIT_S:
                    raise TimeoutError(f"no CPU refit of {job} after "
                                       f"{REFIT_WAIT_S} s") from None
                continue
            if "error" in out:
                raise RuntimeError(f"the CPU refit of {name} failed:\n"
                                   f"{out['error']}")
            self.results[name] = out
        self.waits[job] = time.perf_counter() - t0
        return self.results[job]

    def check_inputs(self, job, frames, x0):
        """The lanes the child fitted are the card phase's, to the bit."""
        want_frames, want_x0 = self.inputs[job]
        n = want_x0.shape[0]
        same = all(np.array_equal(getattr(frames, f.name)[:n].cpu().numpy(),
                                  getattr(want_frames, f.name).numpy())
                   for f in dataclasses.fields(frames)) and np.array_equal(
                       x0[:n].cpu().numpy(), want_x0.numpy())
        if not same:
            raise AssertionError(f"the {job} CPU refit fitted other lanes "
                                 "than the card's")
        return same

    def stop(self):
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join(timeout=60)

    def summary(self, collision_on_fit_s):
        """When the child started and finished each refit beside the card's
        collision_on seconds per fit, and how long each phase waited."""
        emit({"phase": "cpu_refits", "threads": self.threads,
              "nice": REFIT_NICE, "host_cores": os.cpu_count(),
              "started_s": self.started_s,
              "jobs": {k: {"start_s": v["start_s"], "end_s": v["end_s"],
                           "fit_s": v["fit_s"], "wait_s": self.waits.get(k)}
                       for k, v in self.results.items()},
              "collision_on_card_fit_s": collision_on_fit_s})


def phase_lane_reference(label, card_session, card_model, res, frames, x0,
                         refits, **overrides):
    """The first lanes of a path's problem (`LANE_SAMPLE`), fitted again
    through the plain versions on the CPU by the refit process; their final
    losses against the card's, with the bounds set out at `LANE_SAMPLE`.
    The stage-2 energy and gradient of both devices at the card's final x
    of those lanes must agree to rounding.  Returns the CPU fit, its
    session and model."""
    import types

    import torch

    from smplifyx_torch.problem import slice_session

    lanes = LANE_SAMPLE[label]
    collision = card_session.collision_fn is not None
    out = refits.get(label)
    refits.check_inputs(label, frames, x0)
    cpu = types.SimpleNamespace(**{k: torch.as_tensor(out[k])
                                   for k in ("loss", "x", "flipped")})
    session, model = slice_session(device="cpu", **overrides)
    cpu_frames = frames.map(lambda a: a[:lanes].cpu())
    card = res.loss[:lanes].cpu()
    rel = (card - cpu.loss).abs() / cpu.loss.abs()
    held = rel.median().item() if collision else rel.max().item()
    fk, gk = stage2_energy(card_session, card_model,
                           frames.map(lambda a: a[:lanes]), res.x[:lanes])
    fc, gc = stage2_energy(session, model, cpu_frames, res.x[:lanes].cpu())
    f_rel = ((fk.cpu() - fc).abs() / fc.abs()).max().item()
    g_err = ((gk.cpu() - gc).abs().max() / max(1.0, gc.abs().max().item())).item()
    emit({"phase": "lane_reference", "path": label, "lanes": lanes,
          "V": int(model.lbs_weights.shape[0]), "cpu_fit_s": out["fit_s"],
          "cpu_refit_start_s": out["start_s"], "cpu_refit_end_s": out["end_s"],
          "cpu_wait_s": refits.waits[label], "cpu_threads": refits.threads,
          "loss_card": card.tolist(), "loss_cpu": cpu.loss.tolist(),
          "rel_diff": rel.tolist(), "max_rel_diff": rel.max().item(),
          "median_rel_diff": rel.median().item(),
          "lanes_within_5pct": int((rel <= LANE_LOSS_RTOL).sum()),
          "held": "median" if collision else "every lane",
          "bound": LANE_LOSS_RTOL,
          "flipped_card": res.flipped[:lanes].tolist(),
          "flipped_cpu": cpu.flipped.tolist(),
          "energy_at_card_x_rel_diff": f_rel,
          "grad_at_card_x_err_per_scale": g_err})
    if not held <= LANE_LOSS_RTOL:
        raise AssertionError(
            f"card and CPU fits differ by {held:.3g} "
            f"({'median' if collision else 'worst'} lane) > {LANE_LOSS_RTOL}")
    if not (f_rel <= SAME_X_VALUE_RTOL and g_err <= SAME_X_GRAD_TOL):
        raise AssertionError(f"card and CPU energies at the same x differ: "
                             f"value {f_rel:.3g}, gradient {g_err:.3g}")
    return cpu, session, model


class FitCounter:
    """Counts, over every `FitSession.fit` inside the block, the skinning
    plans (`lbs_plan.builds`) and row plans built while the fit ran, and
    keeps the camera stage's largest evaluation count and (in `results`)
    every FitResult."""

    def __enter__(self):
        from smplifyx_torch.ops.gather import row_plan
        from smplifyx_torch.ops.lbs import lbs_plan
        from smplifyx_torch.session import FitSession

        self.counts = {"fits": 0, "lbs_plan": 0, "row_plan": 0,
                       "camera_evals_max": 0}
        self.results = []
        self._fit = fit = FitSession.fit

        def counted(session, *args):
            before = lbs_plan.builds, row_plan.builds
            res = fit(session, *args)
            self.results.append(res)
            self.counts["fits"] += 1
            self.counts["lbs_plan"] += lbs_plan.builds - before[0]
            self.counts["row_plan"] += row_plan.builds - before[1]
            self.counts["camera_evals_max"] = max(
                self.counts["camera_evals_max"], int(res.camera_evals.max()))
            return res

        FitSession.fit = counted
        return self.counts

    def __exit__(self, *exc):
        from smplifyx_torch.session import FitSession

        FitSession.fit = self._fit


def app_losses(out_dir, names):
    from smplifyx_torch.utils.io import load_result_pickle

    return [load_result_pickle(os.path.join(out_dir, "results", n, "000.pkl"))
            ["loss"] for n in names]


def phase_app(refits):
    """The command line on the card: the VPoser combined preset, collision
    on, B=128, V=10475, from files.  Run twice (the first warms up); the
    launch counts are set to 0 just before the second run and read just
    after.  APP_CPU_FRAMES frames of the same files (the refit process
    writes them again) fitted on the CPU through `app.run`: the median
    final loss within LANE_LOSS_RTOL.  Returns the second run's launches
    and (model, settings, x, losses) of its written results."""
    import tempfile
    import types

    import torch

    from smplifyx_torch import cli
    from smplifyx_torch.app import regression_priors, run
    from smplifyx_torch.data.keypoints import create_dataset
    from smplifyx_torch.fitting.checkpoint import warm_start_from_results
    from smplifyx_torch.fitting.prepare import prepare_batch
    from smplifyx_torch.models.bodymodel import SMPLX_EXTRA_JOINT_VIDS
    from smplifyx_torch.models.sparse import build_joints_model
    from smplifyx_torch.problem import (APP_PRESET, SLICE_VERTS, slice_model,
                                        write_app_inputs)
    from smplifyx_torch.session import build_fit_session
    from smplifyx_torch.utils.config import parse_cli

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        inputs = write_app_inputs(tmp, APP_FRAMES)
        inputs_s = time.perf_counter() - t0
        digest = inputs_digest(tmp)
        ref = slice_model(SLICE_VERTS, "cpu")
        model_equal = {
            name: bool(torch.equal(getattr(ref, name), getattr(inputs.model, name)))
            for name, v in vars(ref).items()
            if isinstance(v, torch.Tensor) and name != "extra_joint_vids"}
        # Not in the .npz layout: the loader takes the family's published
        # ids (below V).
        model_equal["extra_joint_vids_published"] = bool(torch.equal(
            inputs.model.extra_joint_vids, torch.as_tensor(np.minimum(
                SMPLX_EXTRA_JOINT_VIDS, ref.num_verts - 1), dtype=torch.int64)))

        flags = [f"--{k}={v}" for k, v in inputs.overrides.items()]
        argv = ["--config", APP_PRESET, *flags]
        outs = [os.path.join(tmp, f"out{i}") for i in range(2)]

        t0 = time.perf_counter()
        cli.main(argv + ["--output_folder", outs[0]])
        first_s = time.perf_counter() - t0

        cfg = parse_cli(argv + ["--output_folder", outs[1]])
        reset_counts()
        with FitCounter() as plans:
            t0 = time.perf_counter()
            result = run(cfg)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        launches = read_counts()

        names = result.names
        first = app_losses(outs[0], names)
        second = app_losses(outs[1], names)
        files = {
            "pkl": len(result.result_files),
            "obj": len(result.mesh_files),
            "ply": sum(os.path.exists(os.path.join(outs[1], "results", n,
                                                   "vertices.ply"))
                       for n in names)}

        # The files read again through the native parser and through the
        # Python reader: the same keypoints.  Then the batch the app
        # prepared, rebuilt from them: its keypoints and confidences
        # against the in-memory problem's.
        session = build_fit_session(cfg)
        reads, read_s = {}, {}
        for reader, choice in (("native", True), ("python", False)):
            t0 = time.perf_counter()
            reads[reader] = list(create_dataset(
                format=cfg.format, data_folder=cfg.data_folder,
                use_hands=cfg.use_hands, use_face=cfg.use_face,
                use_face_contour=cfg.use_face_contour,
                joints_to_ign=cfg.joints_to_ign, use_native_parser=choice))
            read_s[reader] = time.perf_counter() - t0
        records = reads["native"]
        native_equal = len(records) == len(reads["python"]) == APP_FRAMES \
            and all(np.array_equal(a.keypoints, b.keypoints)
                    and a.keypoints.dtype == b.keypoints.dtype
                    for a, b in zip(records, reads["python"]))
        batch = prepare_batch(cfg, records, session.joint_weights(),
                              regression=regression_priors(cfg, records),
                              vposer=session.vposer, device="cuda")
        read_equal = {
            "gt_joints": bool(torch.equal(batch.frames.gt_joints.cpu(),
                                          inputs.frames.gt_joints)),
            "conf": bool(torch.equal(batch.frames.conf.cpu(),
                                     inputs.frames.conf))}

        # Reprojection of the written results: the pickles' parameters
        # (decoded body pose) packed without VPoser.
        plain = dataclasses.replace(session.settings, use_vposer=False)
        x, found = warm_start_from_results(os.path.join(outs[1], "results"),
                                           names, plain)
        model = session.get_model("neutral")
        view = types.SimpleNamespace(settings=plain, decode_body=lambda b: b,
                                     joint_map=session.joint_map)
        fitted = torch.as_tensor(x, device="cuda")
        reproj, _ = reprojection_px(view, model, batch.frames, fitted)
        del session, batch

    # A few frames again on the CPU, through the same entry point.
    cpu = refits.get("app")
    card = np.asarray(second[:APP_CPU_FRAMES])
    cpu_rel = np.abs(cpu["losses"] - card) / np.abs(cpu["losses"])
    median_rel = abs(float(np.median(cpu["losses"])) - float(np.median(card))) \
        / abs(float(np.median(card)))
    jm_rows = build_joints_model(inputs.model).sub_lbs.shape[0]
    by_rows = launches["lbs_by_rows"]
    lbs_split = {"full_mesh": by_rows.get(SLICE_VERTS, 0),
                 "subset": by_rows.get(jm_rows, 0)}
    fit_s = result.spans["fit"]
    row = {
        "phase": "app", "preset": os.path.basename(APP_PRESET),
        "card": torch.cuda.get_device_name(0),
        "B": len(names), "V": SLICE_VERTS, "inputs_s": inputs_s,
        "first_run_s": first_s, "run_s": run_s,
        "frames_per_s": len(names) / run_s,
        "fit_frames_per_s": len(names) / fit_s,
        "spans": result.spans, "host_reads": result.host_reads,
        "launches": launches, "lbs_launches": lbs_split,
        "fit_counts": plans, "files": files,
        "model_equal": model_equal, "read_equal": read_equal,
        "read_s": read_s, "native_read_equal": native_equal,
        "rerun_bit_equal": first == second,
        "loss_median": float(np.median(second)),
        "reproj_px_median": float(reproj.median()),
        "reproj_px_max": float(reproj.max()),
        "stats": result.stats,
        "cpu_frames": APP_CPU_FRAMES, "cpu_run_s": cpu["fit_s"],
        "cpu_refit_start_s": cpu["start_s"], "cpu_refit_end_s": cpu["end_s"],
        "cpu_wait_s": refits.waits["app"],
        "cpu_inputs_equal": cpu["inputs_digest"] == digest,
        "loss_card": card.tolist(), "loss_cpu": cpu["losses"].tolist(),
        "cpu_rel_diff": cpu_rel.tolist(), "cpu_median_rel_diff": median_rel,
    }
    emit(row)
    if not (row["cpu_inputs_equal"] and cpu["names"] == names[:APP_CPU_FRAMES]):
        raise AssertionError("the app's CPU refit read other files")
    if not all(model_equal.values()):
        raise AssertionError(f"the loaded model differs: {model_equal}")
    if not all(read_equal.values()):
        raise AssertionError(f"keypoints read from the JSONs differ: {read_equal}")
    if not native_equal:
        raise AssertionError("the native parser and the Python reader read "
                             "other keypoints from the same JSONs")
    if files != {"pkl": APP_FRAMES, "obj": APP_FRAMES, "ply": APP_FRAMES}:
        raise AssertionError(f"the app wrote {files} for {APP_FRAMES} frames")
    if first != second:
        raise AssertionError("two app runs of the same files differ")
    if not (np.isfinite(second).all() and found.all()):
        raise AssertionError("a loss is not finite or a result is missing")
    for name in ("lbs", "gather", "scatter", "scatter_join"):
        if launches[name] <= 0:
            raise AssertionError(f"the app run never launched the {name} kernel")
    if not (lbs_split["full_mesh"] > 0 and lbs_split["subset"] > 0):
        raise AssertionError(f"the app run launched K1 {lbs_split}")
    if plans["lbs_plan"] != 0 or plans["fits"] != 1:
        raise AssertionError(f"the app's fits built skinning plans: {plans}")
    if not median_rel <= LANE_LOSS_RTOL:
        raise AssertionError(f"the CPU's median final loss differs from the "
                             f"card's by {median_rel:.3g} > {LANE_LOSS_RTOL}")
    return launches, (model, plain, fitted, result.losses)


def _quantiles(t):
    t = t.detach().float().cpu()
    return {"median": float(t.median()), "mean": float(t.mean()),
            "worst": float(t.max()), "worst_lane": int(t.argmax())}


def _spearman(a, b):
    """Rank correlation of two per-lane vectors (no ties expected)."""
    ra = a.argsort().argsort().double()
    rb = b.argsort().argsort().double()
    ra, rb = ra - ra.mean(), rb - rb.mean()
    return float((ra * rb).sum() / (ra.norm() * rb.norm()))


def phase_quality(label, model, settings, decode_body, x, losses,
                  lane_ref=None, gt=None):
    """The fit's recovered meshes against the problem's ground truth, in
    mm, through evaluation/metrics.py on the card: PA-V2V over all
    vertices (median, mean, worst lane), per part of
    `synthetic_part_vertex_ids`, and PA-MPJPE over the skeleton joints.
    The same function on the CPU, on the same arrays, must agree within
    QUALITY_TOL_MM.  With `lane_ref` (the CPU refit of the first lanes,
    its session and model), the PA-V2V of those lanes on both devices
    beside their final losses.  The ground truth is `build_problem`'s
    unless `gt` (vertices, skeleton joints) gives another."""
    import torch

    from smplifyx_torch.evaluation.ehf import synthetic_part_vertex_ids
    from smplifyx_torch.problem import (fit_meshes, ground_truth_meshes,
                                        lane_errors_mm)

    B, V = x.shape[0], model.num_verts
    parts = synthetic_part_vertex_ids(V)
    fit_v, fit_j = fit_meshes(model, settings, decode_body, x)
    gt_v, gt_j = gt if gt is not None else ground_truth_meshes(model, B)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = lane_errors_mm(fit_v, gt_v, fit_j, gt_j, parts)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    arrays = [a.cpu() for a in (fit_v, gt_v, fit_j, gt_j)]
    cpu = lane_errors_mm(*arrays, parts)
    diff = {k: float((card[k].cpu() - cpu[k]).abs().max()) for k in card}
    losses = torch.as_tensor(losses).float().cpu()
    row = {"phase": "quality", "path": label,
           "card": torch.cuda.get_device_name(0), "B": B, "V": V,
           "pa_v2v_mm": _quantiles(card["pa_v2v"]),
           "pa_v2v_parts_mm": {k[len("pa_v2v_"):]: _quantiles(v)
                               for k, v in card.items()
                               if k.startswith("pa_v2v_")},
           "pa_mpjpe_mm": _quantiles(card["pa_mpjpe"]),
           "loss_pa_v2v_spearman": (_spearman(losses, card["pa_v2v"].cpu())
                                    if B > 1 else None),
           "card_cpu_max_abs_diff_mm": diff, "bound_mm": QUALITY_TOL_MM,
           "card_metric_s": card_s}
    if lane_ref is not None:
        cpu_res, cpu_session, cpu_model = lane_ref
        n = cpu_res.x.shape[0]
        ref_v, ref_j = fit_meshes(cpu_model, cpu_session.settings,
                                  cpu_session.decode_body, cpu_res.x)
        ref = lane_errors_mm(ref_v, arrays[1][:n], ref_j, arrays[3][:n],
                             parts)["pa_v2v"]
        rel = (losses[:n] - cpu_res.loss).abs() / cpu_res.loss.abs()
        row["lanes_refitted_on_cpu"] = {
            "loss_rel_diff": rel.tolist(),
            "pa_v2v_card_mm": card["pa_v2v"][:n].cpu().tolist(),
            "pa_v2v_cpu_mm": ref.tolist()}
    emit(row)
    if not all(bool(torch.isfinite(v).all()) for v in card.values()):
        raise AssertionError(f"the {label} errors are not finite")
    if not max(diff.values()) <= QUALITY_TOL_MM:
        raise AssertionError(f"the {label} errors on the card and the CPU "
                             f"differ by {diff} mm > {QUALITY_TOL_MM}")
    return row


def _http_get(port, path):
    """GET from the local viewer server (no proxy: a direct connection)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode()
        if resp.status != 200:
            raise AssertionError(f"GET {path} answered {resp.status}")
        return body
    finally:
        conn.close()


def phase_viz():
    """The command line with `--visualize true` on the card: the VPoser
    combined preset, collision on, V=10475, on VIZ_FRAMES frames of
    `write_app_inputs`.  Launch counts are set to 0 just before that run
    and read just after.  Every frame must get output.png, one
    stage_XX.png per body stage and pose_grid.png, each with mesh pixels;
    the fit's last snapshot must be its result to the bit; every pickle's
    "stages" has one entry per body stage, the last within
    STAGE_PARAM_TOL of its final parameters; the final losses must equal a
    run with visualize off to the bit.  Then `stream_fit` over the same
    batch (one fit per stage) and the live viewer on a thread: GET / with
    (S + 1) meshes per frame built on the card, and /version changing
    after a pickle is rewritten.  Returns the visualize run's launches."""
    import json as _json
    import pickle
    import re
    import tempfile
    import threading

    import torch
    from PIL import Image

    from smplifyx_torch import cli
    from smplifyx_torch.app import regression_priors
    from smplifyx_torch.data.keypoints import create_dataset
    from smplifyx_torch.fitting.prepare import prepare_batch
    from smplifyx_torch.models.sparse import build_joints_model
    from smplifyx_torch.problem import APP_PRESET, SLICE_VERTS, write_app_inputs
    from smplifyx_torch.session import build_fit_session
    from smplifyx_torch.utils.config import parse_cli
    from smplifyx_torch.utils.io import PARAM_KEYS, load_result_pickle
    from smplifyx_torch.viz.live import stream_fit
    from smplifyx_torch.viz.viewer import serve_live_viewer

    with tempfile.TemporaryDirectory() as tmp:
        inputs = write_app_inputs(tmp, VIZ_FRAMES)
        argv = ["--config", APP_PRESET,
                *[f"--{k}={v}" for k, v in inputs.overrides.items()]]
        vis_out = os.path.join(tmp, "vis")
        counter = FitCounter()
        reset_counts()
        with counter:
            t0 = time.perf_counter()
            result = cli.main(argv + ["--output_folder", vis_out,
                                      "--visualize", "true"])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        launches = read_counts()
        fit = counter.results[0]
        plain = cli.main(argv + ["--output_folder", os.path.join(tmp, "plain")])
        cfg = parse_cli(argv + ["--output_folder", os.path.join(tmp, "x")])
        S = len(cfg.body_pose_prior_weights)
        names = result.names

        images, stage_err = {}, 0.0
        for name in names:
            img_dir = os.path.join(vis_out, "images", name)
            files = ["output.png", "pose_grid.png",
                     *[f"stage_{s:02d}.png" for s in range(S)]]
            for f in files:
                path = os.path.join(img_dir, f)
                pixels = (np.asarray(Image.open(path))
                          if os.path.exists(path) else None)
                # the inputs' images are black; the pose grid is on white
                background = 255 if f == "pose_grid.png" else 0
                images[f"{name}/{f}"] = (
                    0 if pixels is None else int((pixels != background)
                                                 .any(-1).sum()))
            d = load_result_pickle(os.path.join(vis_out, "results", name,
                                                "000.pkl"))
            if len(d.get("stages", ())) != S:
                raise AssertionError(f"{name}'s pickle holds "
                                     f"{len(d.get('stages', ()))} stages")
            last = d["stages"][-1]
            want = {"camera_translation": d["camera_translation"],
                    **{k: d[k] for k in ("body_pose", *PARAM_KEYS)}}
            for k, v in want.items():
                stage_err = max(stage_err, float(np.abs(
                    np.reshape(last[k], -1) - np.reshape(v, -1)).max()))
        losses_equal = bool(np.array_equal(result.losses, plain.losses))
        last_is_x = bool(torch.equal(fit.stage_x[-1], fit.x))

        # stream_fit: one fit call per stage, pickles rewritten after each
        session = build_fit_session(cfg)
        model = session.get_model(cfg.gender)
        records = list(create_dataset(
            format=cfg.format, data_folder=cfg.data_folder,
            use_hands=cfg.use_hands, use_face=cfg.use_face,
            use_face_contour=cfg.use_face_contour,
            joints_to_ign=cfg.joints_to_ign))
        batch = prepare_batch(cfg, records, session.joint_weights(),
                              regression=regression_priors(cfg, records),
                              vposer=session.vposer, device="cuda")
        live_dir = os.path.join(tmp, "live")
        t0 = time.perf_counter()
        dispatches = [stage for stage, _ in stream_fit(
            session, model, build_joints_model(model), batch, live_dir)]
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0

        server = serve_live_viewer(live_dir, model)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            port = server.server_address[1]
            reset_counts()
            t0 = time.perf_counter()
            page = _http_get(port, "/")
            page_s = time.perf_counter() - t0
            page_launches = read_counts()["lbs"]
            meshes = _json.loads(re.search(r"const MESHES = (\[.*?\]);\n",
                                           page).group(1))
            ver = _json.loads(_http_get(port, "/version"))["ver"]
            pkl = os.path.join(live_dir, names[0], "000.pkl")
            d = load_result_pickle(pkl)
            d["loss"] = 0.0
            with open(pkl, "wb") as f:
                pickle.dump(d, f)
            ver_after = _json.loads(_http_get(port, "/version"))["ver"]
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        if thread.is_alive():
            raise AssertionError("the live viewer's thread did not stop")

    by_rows = launches["lbs_by_rows"]
    row = {"phase": "viz", "preset": os.path.basename(APP_PRESET),
           "card": torch.cuda.get_device_name(0), "B": len(names),
           "V": SLICE_VERTS, "run_s": run_s, "spans": result.spans,
           "render_s": result.spans.get("render"),
           "card_forward_s": result.spans.get("viz_forward"),
           "launches": launches,
           "lbs_launches": {"full_mesh": by_rows.get(SLICE_VERTS, 0),
                            "other": launches["lbs"] - by_rows.get(SLICE_VERTS, 0)},
           "images_with_mesh_pixels": sum(v > 0 for v in images.values()),
           "images_expected": len(names) * (S + 2),
           "mesh_pixels_min": min(images.values()),
           "stage_x_last_is_x": last_is_x,
           "stage_param_max_abs_diff": stage_err,
           "losses_equal_visualize_off": losses_equal,
           "loss_median": float(np.median(result.losses)),
           "stream_dispatches": dispatches, "stream_s": stream_s,
           "live_meshes": len(meshes), "live_page_s": page_s,
           "live_page_k1_launches": page_launches,
           "live_version_changed": ver != ver_after}
    emit(row)
    if len(images) != len(names) * (S + 2) or min(images.values()) <= 0:
        raise AssertionError("an image is missing or has no mesh pixels: "
                             f"{ {k: v for k, v in images.items() if v <= 0} }")
    if not last_is_x:
        raise AssertionError("the fit's last stage snapshot is not its result")
    if not stage_err <= STAGE_PARAM_TOL:
        raise AssertionError(f"a pickle's last stage differs from its final "
                             f"parameters by {stage_err}")
    if not losses_equal:
        raise AssertionError("visualize changed the final losses")
    if dispatches != list(range(S)):
        raise AssertionError(f"stream_fit yielded stages {dispatches}")
    if len(meshes) != (S + 1) * len(names) or page_launches <= 0:
        raise AssertionError(f"the live viewer built {len(meshes)} meshes "
                             f"with {page_launches} K1 launches")
    if ver == ver_after:
        raise AssertionError("/version did not change after a rewrite")
    for name in ("lbs", "gather", "scatter", "scatter_join"):
        if launches[name] <= 0:
            raise AssertionError(f"the viz run never launched the {name} kernel")
    return launches


# ---------------------------------------------------------------- presets


def run_cli(argv):
    """`cli.main(argv)` on the card, the launch counts set to 0 just before
    and read just after: (AppResult, seconds, launches, FitCounter)."""
    import torch

    from smplifyx_torch import cli

    counter = FitCounter()
    reset_counts()
    with counter:
        t0 = time.perf_counter()
        result = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    return result, run_s, read_counts(), counter


def written_fit(argv, out_dir, names):
    """(model, settings without VPoser, x on the card) of the results the
    command line `argv` wrote under out_dir: the pickles' parameters
    (decoded body pose) packed without VPoser."""
    import torch

    from smplifyx_torch.fitting.checkpoint import warm_start_from_results
    from smplifyx_torch.session import build_fit_session
    from smplifyx_torch.utils.config import parse_cli

    cfg = parse_cli(argv)
    session = build_fit_session(cfg)
    plain = dataclasses.replace(session.settings, use_vposer=False)
    x, found = warm_start_from_results(os.path.join(out_dir, "results"),
                                       names, plain)
    if not found.all():
        raise AssertionError(f"results missing under {out_dir}")
    return (session.get_model(cfg.gender), plain,
            torch.as_tensor(x, device="cuda"))


def preset_run(label, argv, outs, frames):
    """The command line twice on the same files (the first warms up), the
    second timed with its launches: the two runs' losses the same bits,
    a result pickle, mesh and vertices file per frame, finite losses, one
    fit and no skinning plan built.  Returns the row's numbers, the second
    run's AppResult and its launches."""
    first = run_cli(argv + ["--output_folder", outs[0]])
    result, run_s, launches, counter = run_cli(argv + ["--output_folder",
                                                       outs[1]])
    names = result.names
    losses = [app_losses(out, names) for out in outs]
    files = {
        "pkl": len(result.result_files), "obj": len(result.mesh_files),
        "ply": sum(os.path.exists(os.path.join(outs[1], "results", n,
                                               "vertices.ply"))
                   for n in names)}
    fit = counter.results[0]
    row = {
        "B": len(names), "first_run_s": first[1], "run_s": run_s,
        "s_per_image": run_s / len(names),
        "frames_per_s": len(names) / run_s,
        "fit_frames_per_s": len(names) / result.spans["fit"],
        "spans": result.spans, "host_reads": result.host_reads,
        "launches": launches, "fit_counts": counter.counts, "files": files,
        "camera_evals_max": int(fit.camera_evals.max()),
        "stage_evals_max": fit.stage_evals.amax(1).tolist(),
        "stage_evals_median": fit.stage_evals.float().median(1).values.tolist(),
        "rerun_bit_equal": losses[0] == losses[1],
        "loss_median": float(np.median(losses[1])), "stats": result.stats}
    if files != {"pkl": frames, "obj": frames, "ply": frames}:
        raise AssertionError(f"the {label} run wrote {files} for {frames} "
                             "frames")
    if not row["rerun_bit_equal"]:
        raise AssertionError(f"two {label} runs of the same files differ")
    if not np.isfinite(losses[1]).all():
        raise AssertionError(f"a {label} loss is not finite")
    if counter.counts["lbs_plan"] != 0 or counter.counts["fits"] != 1:
        raise AssertionError(f"the {label} run's fits: {counter.counts}")
    return row, result, launches, fit


def _median_rel(a, b):
    """|median(a) - median(b)| / |median(b)| over the last axis."""
    ma, mb = np.median(a, -1), np.median(b, -1)
    return np.abs(ma - mb) / np.abs(mb)


def last_stage_energy_card_cpu(argv, x, n):
    """The last body stage's energy per lane (the collision term on a broad
    phase of these vertices) and its gradient at the card's fitted x of
    the command line's first n frames, on the card and on the CPU, each
    from its own session and prepared batch: the largest relative value
    difference and gradient difference per unit of scale."""
    import torch

    from smplifyx_torch.app import regression_priors
    from smplifyx_torch.data.keypoints import create_dataset
    from smplifyx_torch.fitting.energy import smplify_energy
    from smplifyx_torch.fitting.prepare import prepare_batch
    from smplifyx_torch.session import build_fit_session
    from smplifyx_torch.utils.config import parse_cli

    cfg = parse_cli(argv)
    records = list(create_dataset(
        format=cfg.format, data_folder=cfg.data_folder,
        use_hands=cfg.use_hands, use_face=cfg.use_face,
        use_face_contour=cfg.use_face_contour,
        joints_to_ign=cfg.joints_to_ign))[:n]
    out = {}
    for dev in ("cuda", "cpu"):
        session = build_fit_session(cfg, device=dev)
        model = session.get_model(cfg.gender)
        batch = prepare_batch(cfg, records, session.joint_weights(),
                              regression=regression_priors(cfg, records),
                              vposer=session.vposer, gmm=session.gmm,
                              device=dev)
        S = session.schedule.num_stages
        xx = x[:n].to(dev).clone().requires_grad_(True)
        f = smplify_energy(
            xx, session.settings, model, batch.frames,
            session.schedule.stage(S - 1), S - 1, S, session.decode_body,
            session.joint_map, gmm=session.gmm, lhand_gmm=session.lhand_gmm,
            rhand_gmm=session.rhand_gmm,
            collision_fn=session.collision_for(model))
        (g,) = torch.autograd.grad(f.sum(), xx)
        out[dev] = (f.detach().cpu(), g.cpu())
    (fk, gk), (fc, gc) = out["cuda"], out["cpu"]
    return {"lanes": n,
            "value_rel_diff": float(((fk - fc).abs() / fc.abs()).max()),
            "grad_err_per_scale": float((gk - gc).abs().max()
                                        / max(1.0, float(gc.abs().max()))),
            "finite": bool(torch.isfinite(fk).all() and torch.isfinite(gk).all())}


def phase_preset(label, refits):
    """The command line on the card with PRESET_PATHS[label]'s preset,
    collision on, V=10475, from the files of `write_app_inputs` (Halpe-26
    keypoint JSONs for halpe): APP_FRAMES frames run twice (`preset_run`),
    K1 (full mesh and subset), K2 and K3 launched; APP_CPU_FRAMES of the
    same files fitted on the CPU by the refit process, the median final
    loss within LANE_LOSS_RTOL (or, where the CPU's own one-ulp witness
    moves it past that, the median of every stage before the collision
    term), the last stage's energy and gradient at the card's x of those
    frames within the same-x bounds on both devices; `quality` on the
    written results.  The classic preset also runs one frame (the
    reference fits one image per process) twice, with its own `quality`.
    Launch counts are set to 0 just before each timed run and read just
    after.  Returns the APP_FRAMES run's launches."""
    import shutil
    import tempfile

    import torch

    from smplifyx_torch.models.sparse import build_joints_model
    from smplifyx_torch.problem import (SLICE_VERTS, ground_truth_meshes,
                                        write_app_inputs)
    from smplifyx_torch.utils.config import parse_cli

    keypoint_format = PRESET_PATHS[label][1]
    preset = preset_path(label)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        inputs = write_app_inputs(tmp, APP_FRAMES,
                                  keypoint_format=keypoint_format)
        inputs_s = time.perf_counter() - t0
        digest = inputs_digest(tmp)
        S = build_joints_model(inputs.model).sub_lbs.shape[0]
        needs = ("lbs", "gather", "scatter", "scatter_join")

        if label == "classic":
            # one frame: frame 0's image and keypoints alone in a folder
            one = os.path.join(tmp, "one")
            for sub, ext in (("images", ".png"), ("keypoints", "_keypoints.json")):
                os.makedirs(os.path.join(one, sub))
                name = inputs.names[0] + ext
                shutil.copy(os.path.join(inputs.overrides["data_folder"], sub,
                                         name), os.path.join(one, sub, name))
            argv = app_argv(preset, {**inputs.overrides, "data_folder": one})
            outs = [os.path.join(tmp, f"one{i}") for i in range(2)]
            row, result, launches, _ = preset_run(f"{label} one-frame",
                                                  argv, outs, 1)
            emit({"phase": label, "preset": os.path.basename(preset),
                  "card": torch.cuda.get_device_name(0), "V": SLICE_VERTS,
                  **row, "lbs_launches": _lbs_split(launches, SLICE_VERTS, S)})
            _check_path_launches(f"{label} one-frame", launches, needs,
                                 SLICE_VERTS, S)
            model, settings, x = written_fit(argv, outs[1], result.names)
            gt = tuple(a[:1] for a in ground_truth_meshes(model, APP_FRAMES))
            phase_quality(f"{label}_one_frame", model, settings, lambda b: b,
                          x, result.losses, gt=gt)

        argv = app_argv(preset, inputs.overrides)
        outs = [os.path.join(tmp, f"out{i}") for i in range(2)]
        row, result, launches, fit = preset_run(label, argv, outs,
                                                APP_FRAMES)
        fitted = written_fit(argv, outs[1], result.names)
        same_x = last_stage_energy_card_cpu(argv, fit.x, APP_CPU_FRAMES)

    n = APP_CPU_FRAMES
    cpu = refits.get(label)
    card = np.asarray(result.losses[:n])
    card_stages = torch.cat([fit.camera_loss[None],
                             fit.stage_losses])[:, :n].cpu().numpy()
    stage_rel = _median_rel(cpu["stage_losses"], card_stages)
    median_rel = float(_median_rel(cpu["losses"], card))
    # Where f32 rounding alone moves the CPU's own median past the bound
    # (its keypoints one ulp up), the final losses cannot be compared: the
    # stages before the collision term are held instead.
    witness = (refits.get(f"{label}_one_ulp") if f"{label}_one_ulp"
               in REFIT_JOBS else None)
    witness_rel = (None if witness is None else
                   _median_rel(witness["stage_losses"], cpu["stage_losses"]))
    cfg_weights = parse_cli(argv).coll_loss_weights
    plain_rows = 1 + next(i for i, w in enumerate(cfg_weights) if w > 0)
    if witness_rel is not None and witness_rel[-1] > LANE_LOSS_RTOL:
        held = {"stages": "camera and body stages before the collision term",
                "rel": stage_rel[:plain_rows].tolist()}
    else:
        held = {"stages": "final", "rel": [median_rel]}
    emit({"phase": label, "preset": os.path.basename(preset),
          "card": torch.cuda.get_device_name(0), "V": SLICE_VERTS,
          "keypoint_format": keypoint_format, "inputs_s": inputs_s, **row,
          "lbs_launches": _lbs_split(launches, SLICE_VERTS, S),
          "cpu_frames": n, "cpu_run_s": cpu["fit_s"],
          "cpu_refit_start_s": cpu["start_s"], "cpu_refit_end_s": cpu["end_s"],
          "cpu_wait_s": refits.waits[label],
          "cpu_inputs_equal": cpu["inputs_digest"] == digest,
          "loss_card": card.tolist(), "loss_cpu": cpu["losses"].tolist(),
          "cpu_rel_diff": (np.abs(cpu["losses"] - card)
                           / np.abs(cpu["losses"])).tolist(),
          "cpu_median_rel_diff": median_rel,
          "stage_median_card": np.median(card_stages, 1).tolist(),
          "stage_median_cpu": np.median(cpu["stage_losses"], 1).tolist(),
          "stage_median_rel_diff": stage_rel.tolist(),
          "one_ulp_cpu_stage_median_rel_diff": (
              None if witness_rel is None else witness_rel.tolist()),
          "held": held, "bound": LANE_LOSS_RTOL,
          "energy_at_card_x": same_x})
    if not (cpu["inputs_digest"] == digest
            and cpu["names"] == result.names[:n]):
        raise AssertionError(f"the {label} CPU refit read other files")
    if not max(held["rel"]) <= LANE_LOSS_RTOL:
        raise AssertionError(f"the {label} CPU median losses ({held['stages']})"
                             f" differ from the card's by {held['rel']} > "
                             f"{LANE_LOSS_RTOL}")
    if not (same_x["finite"]
            and same_x["value_rel_diff"] <= SAME_X_VALUE_RTOL
            and same_x["grad_err_per_scale"] <= SAME_X_GRAD_TOL):
        raise AssertionError(f"the {label} energies at the card's x differ "
                             f"on the card and the CPU: {same_x}")
    _check_path_launches(label, launches, needs, SLICE_VERTS, S)
    model, settings, x = fitted
    phase_quality(label, model, settings, lambda b: b, x, result.losses)
    return launches


def _lbs_split(launches, V, S):
    by_rows = launches["lbs_by_rows"]
    return {"full_mesh": by_rows.get(V, 0), "subset": by_rows.get(S, 0)}


def _check_path_launches(label, launches, needs, V, S):
    """Every kernel in `needs` launched; K1 on the landmark subset always,
    on the full mesh when the path has a collision stage."""
    for name in needs:
        if launches[name] <= 0:
            raise AssertionError(f"the {label} run never launched the "
                                 f"{name} kernel")
    split = _lbs_split(launches, V, S)
    if split["subset"] <= 0 or (split["full_mesh"] > 0) != ("gather" in needs):
        raise AssertionError(f"the {label} run launched K1 {split}")


def phase_serve(session, model, jm, frames):
    """The fit service over the collision-on session (the slice's model,
    V=10475): `serve_http` on 127.0.0.1, one warm-up request, then the
    port's load tool at SERVE_LOADS with the problem's keypoints (600x800
    images).  Launch counts are set to 0 just before each load point and
    read just after.  /healthz must count every completed request, and the
    first batch served under load, fitted again directly (prepare_batch,
    pad_prepared to its bucket, session.fit), must give its served losses
    and parameters to the bit.  Returns the launches summed over the load
    points."""
    import urllib.request

    import torch

    from smplifyx_torch.fitting.params import unpack
    from smplifyx_torch.fitting.prepare import pad_prepared, prepare_batch
    from smplifyx_torch.problem import IMG_H, IMG_W
    from smplifyx_torch.serve import FitService, serve_http
    from smplifyx_torch.tools import load_serve

    keypoints = torch.cat([frames.gt_joints, frames.conf[..., None]],
                          -1).cpu().numpy()
    size = (int(IMG_H), int(IMG_W))
    V, S = model.num_verts, jm.sub_lbs.shape[0]
    svc = FitService(session, **SERVE_OPTIONS)
    server = serve_http(svc, port=0)
    rows, total = [], {}
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        t0 = time.perf_counter()
        load_serve.post(base, keypoints[0], size, "warm")
        warm_s = time.perf_counter() - t0

        recorded = []
        serve_group = svc._fit_group

        def recording(gender, reqs):
            recorded.append((gender, [r.record for r in reqs],
                             [r.future for r in reqs]))
            return serve_group(gender, reqs)

        svc._fit_group = recording
        for clients, per_client in SERVE_LOADS:
            reset_counts()
            counter = FitCounter()
            with counter as fits:
                row = load_serve.drive(base, svc, keypoints, size, clients,
                                       per_client)
                torch.cuda.synchronize()
            launches = read_counts()
            for k, v in launches.items():
                if isinstance(v, int):
                    total[k] = total.get(k, 0) + v
            row.update(
                phase="serve", card=torch.cuda.get_device_name(0),
                B_max=SERVE_OPTIONS["max_batch"], V=V, warm_s=warm_s,
                launches=launches, lbs_launches=_lbs_split(launches, V, S),
                fits=fits["fits"],
                host_reads=sum(r.host_reads for r in counter.results),
                buckets=[int(r.x.shape[0]) for r in counter.results])
            rows.append(row)
            emit(row)
            if row["errors"] or row["completed"] != clients * per_client:
                raise AssertionError(f"serving {clients} x {per_client}: "
                                     f"{row['errors']} errors, first "
                                     f"{row['first_errors']}")
            _check_path_launches("serve", launches,
                                 ("lbs", "gather", "scatter", "scatter_join"),
                                 V, S)
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        svc._fit_group = serve_group
    finally:
        server.shutdown()
        server.server_close()
        svc.stop(timeout=600)

    # the first batch served under load, fitted again directly
    gender, records, futures = recorded[0]
    served = [f.result() for f in futures]
    n = len(records)
    prepared = prepare_batch(session.cfg, records, session.joint_weights(),
                             vposer=session.vposer, gmm=session.gmm,
                             device=session.device)
    bucket = max(svc.min_bucket, 1 << (n - 1).bit_length())
    prepared = pad_prepared(prepared, bucket)
    res = session.fit(*svc._get_models(gender), prepared.frames, prepared.x0)
    seg = {k: v.cpu().numpy() for k, v in unpack(session.settings,
                                                  res.x[:n]).items()}
    refit_equal = ([r["loss"] for r in served] == res.loss[:n].tolist()
                   and all(np.array_equal(
                       np.asarray([r["params"][k] for r in served], np.float32),
                       v) for k, v in seg.items()))
    completed = 1 + sum(r["completed"] for r in rows)
    emit({"phase": "serve_check", "healthz": health,
          "completed_with_warmup": completed,
          "worker_stopped": not svc._worker.is_alive(),
          "refit_batch": n, "refit_bucket": bucket,
          "refit_bit_equal": refit_equal,
          "loss_median_served": float(np.median([r["loss"] for r in served]))})
    if health["fits_completed"] != completed or \
            health["batches_dispatched"] != svc.batches_dispatched:
        raise AssertionError(f"/healthz counts {health}, {completed} completed")
    if svc._worker.is_alive():
        raise AssertionError("the service's worker did not stop")
    if not refit_equal:
        raise AssertionError("the served batch and its direct refit differ")
    return total


class EvalCounter:
    """Counts, inside the block, the energy evaluations of `fit_batch`
    that carry the collision term (pipeline.smplify_energy called with a
    collision_fn)."""

    def __enter__(self):
        from smplifyx_torch.fitting import pipeline

        self.counts = {"collision": 0, "other": 0}
        self._energy = energy = pipeline.smplify_energy

        def counted(*args, **kwargs):
            key = ("collision" if kwargs.get("collision_fn") is not None
                   else "other")
            self.counts[key] += 1
            return energy(*args, **kwargs)

        pipeline.smplify_energy = counted
        return self.counts

    def __exit__(self, *exc):
        from smplifyx_torch.fitting import pipeline

        pipeline.smplify_energy = self._energy


def start_loss(session, model, jm, frames, x0):
    """The last body stage's energy at the point a fit starts from: x0
    with the guess-init camera depth."""
    import torch

    from smplifyx_torch.fitting.energy import guess_camera_depth, smplify_energy
    from smplifyx_torch.fitting.params import pack, unpack

    with torch.no_grad():
        seg = unpack(session.settings, x0)
        seg["cam_t"] = guess_camera_depth(
            session.settings, model, x0, frames.gt_joints, session.edge_idxs,
            frames.focal[:, 0], session.decode_body, session.joint_map,
            joints_model=jm)
        S = session.schedule.num_stages
        return smplify_energy(
            pack(session.settings, **seg), session.settings, model, frames,
            session.schedule.stage(S - 1), S - 1, S, session.decode_body,
            session.joint_map, joints_model=jm,
            collision_fn=session.collision_fn)


def phase_first_order(name, refits):
    """One first-order optimizer (FIRST_ORDER[name]) through the entry
    points: fit twice (bit-equal), the second timed with the launch counts
    set to 0 just before it and read just after; with the collision term,
    one broad phase per collision-stage evaluation and two row plans per
    broad phase.  The final losses must be finite and below the energy at
    the fit's start; FIRST_ORDER_CPU_LANES lanes fitted again on the CPU
    by the refit process:
    collision on, the median within LANE_LOSS_RTOL; off, the median within
    FIRST_ORDER_MEDIAN_RTOL and every lane within LANE_LOSS_RTOL.  Returns
    (launches, (session, model, result, lane_ref)) for `quality`."""
    import types

    import torch

    from smplifyx_torch.ops.gather import row_plan
    from smplifyx_torch.problem import slice_session

    overrides = FIRST_ORDER[name]
    label = f"first_order_{name}"
    session, model, jm, frames, x0 = setup(label, batch=FIRST_ORDER_BATCH,
                                           **overrides)

    t0 = time.perf_counter()
    first = session.fit(model, jm, frames, x0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    fn = session.collision_fn
    broad = count_broad_phases(fn)
    reset_counts()
    row_plan.builds = 0
    with EvalCounter() as evals:
        t0 = time.perf_counter()
        res = session.fit(model, jm, frames, x0)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    launches = read_counts()
    plan_builds = row_plan.builds
    broad = dict(broad)
    for key in broad:
        delattr(fn, key)
    start = start_loss(session, model, jm, frames, x0)
    rerun_equal = bool(torch.equal(first.x, res.x)
                       and torch.equal(first.loss, res.loss))

    out = refits.get(label)
    refits.check_inputs(label, frames, x0)
    cpu = types.SimpleNamespace(**{k: torch.as_tensor(out[k])
                                   for k in ("loss", "x", "flipped")})
    cpu_session, cpu_model = slice_session(device="cpu", **overrides)
    n = FIRST_ORDER_CPU_LANES
    card = res.loss[:n].cpu()
    rel = (card - cpu.loss).abs() / cpu.loss.abs()
    median_rel = abs(float(card.median()) - float(cpu.loss.median())) \
        / abs(float(card.median()))
    V, S = model.num_verts, jm.sub_lbs.shape[0]
    collision = fn is not None
    row = {
        "phase": "first_order", "optimizer": name, "path": label,
        "card": torch.cuda.get_device_name(0),
        "B": int(x0.shape[0]), "lanes": 2 * int(x0.shape[0]), "V": V,
        **{k: v for k, v in overrides.items() if k != "optim_type"},
        "first_fit_s": first_s, "fit_s": fit_s,
        "frames_per_s": x0.shape[0] / fit_s, "host_reads": res.host_reads,
        "launches": launches, "lbs_launches": _lbs_split(launches, V, S),
        "collision_evals": evals["collision"], "other_evals": evals["other"],
        "broad_phases": broad, "plan_builds": plan_builds,
        "camera_evals_max": int(res.camera_evals.max()),
        "stage_evals_max": res.stage_evals.amax(1).tolist(),
        "rerun_bit_equal": rerun_equal,
        "loss_median": float(res.loss.median()),
        "start_loss_median": float(start.median()),
        "lanes_below_start": int((res.loss < start).sum()),
        "stage_loss_median": res.stage_losses.median(1).values.tolist(),
        "cpu_lanes": n, "cpu_fit_s": out["fit_s"],
        "cpu_refit_start_s": out["start_s"], "cpu_refit_end_s": out["end_s"],
        "cpu_wait_s": refits.waits[label], "loss_card": card.tolist(),
        "loss_cpu": cpu.loss.tolist(), "cpu_rel_diff": rel.tolist(),
        "cpu_median_rel_diff": median_rel,
    }
    emit(row)
    if not (bool(torch.isfinite(res.loss).all())
            and bool((res.loss < start).all())):
        raise AssertionError(f"the {label} fit is not finite or not below "
                             "its start")
    if not rerun_equal:
        raise AssertionError(f"two {label} fits of the same inputs differ")
    if collision:
        if not (sum(broad.values()) == evals["collision"] > 0
                and plan_builds == 2 * evals["collision"]):
            raise AssertionError(
                f"the {label} fit ran {broad} broad phases and built "
                f"{plan_builds} row plans in {evals['collision']} "
                "collision-stage evaluations")
        if not median_rel <= LANE_LOSS_RTOL:
            raise AssertionError(f"{label}: CPU median loss {median_rel:.3g} "
                                 f"apart > {LANE_LOSS_RTOL}")
    elif not (median_rel <= FIRST_ORDER_MEDIAN_RTOL
              and float(rel.max()) <= LANE_LOSS_RTOL):
        raise AssertionError(f"{label}: CPU lanes {rel.tolist()} apart "
                             f"(median {median_rel:.3g})")
    _check_path_launches(label, launches,
                         ("lbs", "gather", "scatter", "scatter_join")
                         if collision else ("lbs",), V, S)
    return launches, (session, model, res, (cpu, cpu_session, cpu_model))


# ---------------------------------------------------------------- parallel


def phase_sharded_forward(model, peak):
    """(a) The vertex-sharded forward on a 1x2 mesh of one card repeated:
    vertices and joints against the unsharded forward within SHARD_TOL, one
    K1 launch per block, each block's K1 against its plain version."""
    import torch

    from smplifyx_torch.models.forward import smplx_forward
    from smplifyx_torch.parallel import make_mesh, shard_model
    from smplifyx_torch.problem import ground_truth

    B = SHARDED_FWD_BATCH
    mesh = make_mesh(1, 2, devices=[CARD, CARD])
    t0 = time.perf_counter()
    sharded = shard_model(model, mesh)[0]
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    params = ground_truth(B, CARD)
    with torch.no_grad():
        plain = smplx_forward(model, params)
        reset_counts()
        out = smplx_forward(sharded, params)
        torch.cuda.synchronize()
        launches = read_counts()
    errs = {name: (getattr(out, name) - getattr(plain, name)).abs().max().item()
            for name in ("vertices", "joints")}
    sizes = [int(blk.v_template.shape[0]) for blk in sharded.blocks]
    emit({"phase": "parallel_forward", "mesh": mesh.shape, "B": B,
          "V": model.num_verts, "block_vertices": sizes, "shard_s": shard_s,
          "max_abs_err_m": errs, "bound_m": SHARD_TOL, "launches": launches})
    rows = [check_lbs(f"block{i}", blk.lbs_weights, blk.lbs_plan, B, peak,
                      10 + i) for i, blk in enumerate(sharded.blocks)]
    if not max(errs.values()) <= SHARD_TOL:
        raise AssertionError(f"the vertex-sharded forward is {errs} m from "
                             f"the unsharded one > {SHARD_TOL}")
    if launches["lbs"] != 2 or launches["lbs_by_rows"] != {
            s: sizes.count(s) for s in sizes}:
        raise AssertionError(f"the sharded forward launched K1 {launches}")
    return launches, rows


def _spawned_build(queue):
    """A spawned process at a worker's start: build the kernel libraries
    if stale, load them, report {source: compile seconds}."""
    from smplifyx_torch.ops import gather, lbs, nvcc

    report = nvcc.build(*KERNEL_SOURCES)
    lbs._load()
    gather._load()
    queue.put((os.getpid(), {k: s for k, (s, _) in report.items()}))


def phase_cold_build():
    """Two spawned processes find the kernel libraries stale (as on a cold
    build/) and build and load them at once, as two workers of
    fit_batch_sharded would: both must load, the libraries end fresh,
    and no temporary file is left."""
    import multiprocessing

    from smplifyx_torch.ops import nvcc

    for name in KERNEL_SOURCES:
        os.utime(nvcc.library(name), (0, 0))
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_spawned_build, args=(queue,))
             for _ in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        out = [queue.get(timeout=600) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    wall = time.perf_counter() - t0
    fresh = {name: not nvcc._stale(name) for name in KERNEL_SOURCES}
    leftovers = [p.name for p in nvcc.BUILD_DIR.glob("*.tmp.so")]
    emit({"phase": "parallel_cold_build", "wall_s": wall,
          "compile_s": {str(pid): s for pid, s in out},
          "compiled_in_both": all(all(s > 0 for s in r.values())
                                  for _, r in out),
          "fresh": fresh, "tmp_left": leftovers,
          "exit_codes": [p.exitcode for p in procs]})
    if not (all(fresh.values()) and not leftovers
            and [p.exitcode for p in procs] == [0, 0]):
        raise AssertionError("two processes building the kernels at once "
                             "left them stale or broken")


def _lane_diffs(res, ref):
    """Per lane relative loss differences, the relative difference of the
    median losses, and the lanes equal to the bit (x and loss)."""
    import torch

    rel = (res.loss - ref.loss).abs() / ref.loss.abs()
    med = abs(float(res.loss.median()) - float(ref.loss.median())) \
        / abs(float(ref.loss.median()))
    bits = [bool(torch.equal(res.x[i], ref.x[i])
                 and torch.equal(res.loss[i], ref.loss[i]))
            for i in range(ref.loss.shape[0])]
    return rel, med, sum(bits)


def _diff_row(res, ref):
    rel, med, bits = _lane_diffs(res, ref)
    return {"bit_equal_lanes": bits, "max_rel_diff": float(rel.max()),
            "lane_median_rel_diff": float(rel.median()),
            "median_loss_rel_diff": med,
            "lanes_within_5pct": int((rel <= PARALLEL_LANE_RTOL).sum())}


def _run_row(label, run, B):
    launches = {k: sum(r["launches"][k] for r in run["rows"])
                for k in run["rows"][0]["launches"]}
    return {"mesh": label, "B": B, "workers": len(run["rows"]),
            "startup_s": run["startup_s"], "fit_window_s": run["fit_window_s"],
            "wall_s": run["wall_s"], "frames_per_s": B / run["fit_window_s"],
            "rows": run["rows"], "launches": launches}


def phase_data_parallel(label, session, model, jm, frames, x0, meshes):
    """(b) The path's preset on PARALLEL_FRAMES frames through
    fit_batch_sharded on each of `meshes` (1x1: one worker; 2x1: two
    workers on one card repeated), held per lane against fits in this
    process: each run bit-equal to session.fit on its workers' blocks of
    frames (one block of 64 for 1x1, two of 32 for 2x1).  Beside that,
    each run against session.fit on all 64 frames: a lane's result
    depends on the size of the batch it is fitted in (the matrix products'
    kernels, and so their rounding, change with the number of lanes), and
    L-BFGS carries that rounding to other iterates; with the collision
    term its 1/sigma = 1e4 takes lanes to other minima.  So a lane's
    difference is reported, not held; collision off, the median loss must
    stay within PARALLEL_MEDIAN_RTOL.  Returns the launches and the
    in-process fits by block count ({n: loss and x of session.fit on n
    blocks, joined})."""
    import types

    import torch

    from smplifyx_torch.parallel import fit_batch_sharded, make_mesh

    B = PARALLEL_FRAMES
    frames = frames.map(lambda a: a[:B].contiguous())
    x0 = x0[:B].contiguous()
    kwargs = dict(gmm=session.gmm, edge_idxs=session.edge_idxs,
                  joints_model=jm, coll_stage_mask=session.coll_stage_mask,
                  lhand_gmm=session.lhand_gmm, rhand_gmm=session.rhand_gmm,
                  collision_fn=session.collision_for(model))
    t0 = time.perf_counter()
    ref = session.fit(model, jm, frames, x0)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    by_blocks = {1: ref}
    runs, launches = [], {}
    for mesh_label, devices in meshes:
        n = len(devices)
        if n not in by_blocks:
            b = B // n
            parts = [session.fit(model, jm,
                                 frames.map(lambda a, r=r: a[r * b:(r + 1) * b]),
                                 x0[r * b:(r + 1) * b]) for r in range(n)]
            by_blocks[n] = types.SimpleNamespace(
                loss=torch.cat([p.loss for p in parts]),
                x=torch.cat([p.x for p in parts]))
        res = fit_batch_sharded(
            make_mesh(n, 1, devices=devices), model, session.settings,
            session.options, session.schedule, frames, x0,
            session.decode_body, session.joint_map, **kwargs)
        runs.append({**_run_row(mesh_label, fit_batch_sharded.last_run, B),
                     "loss_median": float(res.loss.median()),
                     "vs_blocks_in_process": _diff_row(res, by_blocks[n]),
                     "vs_batch_in_process": _diff_row(res, ref)})
        for k, v in runs[-1]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    blocks_vs_batch = {n: _diff_row(r, ref) for n, r in by_blocks.items()
                       if n > 1}
    emit({"phase": "parallel_fit", "path": label, "B": B,
          "V": model.num_verts, "card": torch.cuda.get_device_name(0),
          "in_process_fit_s": ref_s, "in_process_frames_per_s": B / ref_s,
          "in_process_loss_median": float(ref.loss.median()),
          "in_process_blocks_vs_batch": blocks_vs_batch, "runs": runs})
    for run in runs:
        if run["vs_blocks_in_process"]["bit_equal_lanes"] != B:
            raise AssertionError(
                f"the {label} {run['mesh']} workers' fit is bit-equal to "
                f"session.fit on the same blocks in "
                f"{run['vs_blocks_in_process']['bit_equal_lanes']} of {B} lanes")
        needs = (("lbs", "gather", "scatter", "scatter_join")
                 if kwargs["collision_fn"] is not None else ("lbs",))
        for name in needs:
            if any(r["launches"][name] <= 0 for r in run["rows"]):
                raise AssertionError(f"a {run['mesh']} worker never launched "
                                     f"the {name} kernel")
        if any(r["launches"]["lbs_plan_builds"] for r in run["rows"]):
            raise AssertionError("a worker's fit built skinning plans")
        batch = run["vs_batch_in_process"]
        if kwargs["collision_fn"] is None and not (
                batch["median_loss_rel_diff"] <= PARALLEL_MEDIAN_RTOL):
            raise AssertionError(
                f"the {label} {run['mesh']} fit's median loss is "
                f"{batch['median_loss_rel_diff']:.3g} from session.fit's on "
                "the whole batch")
    return launches, by_blocks


def phase_sharded_fit(session, model, frames, x0):
    """(c) shard_model_axis=True on a 1x2 mesh of one card repeated, the
    collision-off preset on SHARDED_FIT_BATCH frames with no joints model,
    so every evaluation runs the vertex-sharded forward: each lane's final
    loss within PARALLEL_LANE_RTOL of fit_batch on the unsharded model."""
    import torch

    from smplifyx_torch.fitting.pipeline import fit_batch
    from smplifyx_torch.parallel import fit_batch_sharded, make_mesh

    B = SHARDED_FIT_BATCH
    args = (session.settings, session.options, session.schedule,
            frames.map(lambda a: a[:B].contiguous()), x0[:B].contiguous(),
            session.decode_body, session.joint_map)
    kwargs = dict(gmm=session.gmm, edge_idxs=session.edge_idxs,
                  lhand_gmm=session.lhand_gmm, rhand_gmm=session.rhand_gmm)
    t0 = time.perf_counter()
    ref = fit_batch(model, *args, device=CARD, **kwargs)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    res = fit_batch_sharded(make_mesh(1, 2, devices=[CARD, CARD]), model,
                            *args, shard_model_axis=True, **kwargs)
    row = {**_run_row("1x2", fit_batch_sharded.last_run, B),
           **_diff_row(res, ref)}
    emit({"phase": "parallel_sharded_fit", "path": "collision_off",
          "joints_model": None, "V": model.num_verts,
          "in_process_fit_s": ref_s, **row})
    if not row["max_rel_diff"] <= PARALLEL_LANE_RTOL:
        raise AssertionError(f"the vertex-sharded fit is {row['max_rel_diff']:.3g}"
                             " from the unsharded one (worst lane)")
    lbs = row["launches"]["lbs"]
    if not (lbs > 0 and lbs % 2 == 0):
        raise AssertionError(f"the vertex-sharded fit launched K1 {lbs} times")
    return row["launches"]


# ---------------------------------------------------------------- multihost


def multihost_rank(argv) -> int:
    """One rank of the multihost phase (b), a fresh interpreter started by
    `launch_ranks`: rendezvous, build collision_on's problem from the seed
    (`build_slice`, as `setup` does), keep this rank's rows of the first
    PARALLEL_FRAMES frames, hold the model's and the rows' digests to the
    caller's, fit through `fit_batch_multihost` on the card, save the
    gathered loss and x under --out and print one MULTIHOST_RANK line."""
    import argparse

    import torch

    from smplifyx_torch.parallel import multihost as mh
    from smplifyx_torch.problem import build_slice

    p = argparse.ArgumentParser(parents=[mh.rank_parser()])
    p.add_argument("--model-digest", required=True)
    p.add_argument("--rows-digests", required=True,
                   help="each rank's rows' digest, comma-separated")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    torch.cuda.set_device(CARD)
    mh.initialize(args.coordinator, args.num_processes, args.process_id,
                  args.initialization_timeout)
    try:
        init_done = time.time()
        t0 = time.perf_counter()
        session, model, jm, frames, x0 = build_slice(device=CARD)
        torch.cuda.synchronize()
        problem_s = time.perf_counter() - t0
        lo, hi = mh.process_rows(PARALLEL_FRAMES)
        rows, rows_x0 = frames.map(lambda a: a[lo:hi]), x0[lo:hi]
        digests = {"model_digest": mh.digest(model, jm),
                   "rows_digest": mh.digest(rows, rows_x0)}
        want = {"model_digest": args.model_digest,
                "rows_digest": args.rows_digests.split(",")[
                    mh.process_index()]}
        if digests != want:
            raise AssertionError(f"rank {mh.process_index()}'s inputs differ "
                                 f"from the caller's: {digests} against {want}")
        res = mh.fit_batch_multihost(
            model, session.settings, session.options, session.schedule, rows,
            rows_x0, session.decode_body, session.joint_map, devices=[CARD],
            gmm=session.gmm, edge_idxs=session.edge_idxs, joints_model=jm,
            coll_stage_mask=session.coll_stage_mask,
            lhand_gmm=session.lhand_gmm, rhand_gmm=session.rhand_gmm,
            collision_fn=session.collision_for(model))
        run = mh.fit_batch_multihost.last_run
        torch.save({"loss": res.loss.cpu(), "x": res.x.cpu()},
                   os.path.join(args.out, f"rank{mh.process_index()}.pt"))
        print("MULTIHOST_RANK " + json.dumps({
            "process": mh.process_index(), "rows": [lo, hi],
            "init_done": init_done, "problem_s": problem_s,
            "fit_start": run["fit_start"], "fit_end": run["fit_end"],
            "fit_s": run["fit_s"], "wait_ms": 1e3 * run["wait_s"],
            "gather_ms": 1e3 * run["gather_s"],
            "launches": run["launches"], "host_reads": res.host_reads,
            **digests}), flush=True)
    finally:
        mh.shutdown()
    return 0


def phase_multihost(model, jm, frames, x0, by_blocks):
    """(a) `python -m smplifyx_torch.parallel.multihost 2 1` on the card:
    the dry run's ranks must agree to the bit.  (b) MULTIHOST_RANKS ranks,
    fresh interpreters on cuda:0, fit collision_on's preset on the
    PARALLEL_FRAMES frames of phase_data_parallel (`multihost_rank`); their
    gathered loss and x must be the same bits in every rank, and every lane
    the bits of session.fit on the same block in this process
    (`by_blocks`); each rank must launch K1, K2 and K3 (both kernels) in
    its fit and build no skinning plan.  Returns the ranks' launches."""
    import tempfile
    import types

    import torch

    from smplifyx_torch.parallel import multihost as mh

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    dry = subprocess.run(
        [sys.executable, "-m", "smplifyx_torch.parallel.multihost", "2", "1",
         "--timeout", str(MULTIHOST_TIMEOUT_S)], cwd=here, capture_output=True,
        text=True, timeout=MULTIHOST_TIMEOUT_S + 60)
    dry_s = time.perf_counter() - t0
    lines = [ln for ln in dry.stdout.splitlines()
             if ln.startswith(("SHARD ", "GLOBAL_LOSS ", "dryrun_multihost"))]
    emit({"phase": "multihost_dryrun", "command": dry.args[1:],
          "returncode": dry.returncode, "wall_s": dry_s, "lines": lines})
    if dry.returncode != 0 or not lines[-1].startswith("dryrun_multihost OK"):
        raise AssertionError("the multihost dry run failed:\n"
                             + dry.stdout[-4000:] + dry.stderr[-4000:])

    B, n = PARALLEL_FRAMES, MULTIHOST_RANKS
    b = B // n
    rows = [mh.digest(frames.map(lambda a, r=r: a[r * b:(r + 1) * b]),
                      x0[r * b:(r + 1) * b]) for r in range(n)]
    with tempfile.TemporaryDirectory() as out:
        argv = ["-c", "import sys, chip_smoke; "
                "sys.exit(chip_smoke.multihost_rank(sys.argv[1:]))",
                "--model-digest", mh.digest(model, jm),
                "--rows-digests", ",".join(rows), "--out", out]
        outs = mh.launch_ranks([argv] * n, MULTIHOST_TIMEOUT_S, cwd=here)
        started = mh.launch_ranks.last_run["started_at"]
        results = [torch.load(os.path.join(out, f"rank{r}.pt"))
                   for r in range(n)]
    ranks = [json.loads(ln.split(" ", 1)[1]) for text in outs
             for ln in text.splitlines() if ln.startswith("MULTIHOST_RANK ")]
    window = (max(r["fit_end"] for r in ranks)
              - min(r["fit_start"] for r in ranks))
    same = all(torch.equal(r["loss"], results[0]["loss"])
               and torch.equal(r["x"], results[0]["x"]) for r in results)
    vs_blocks = _diff_row(types.SimpleNamespace(
        **{k: v.to(CARD) for k, v in results[0].items()}), by_blocks[n])
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    emit({"phase": "multihost", "path": "collision_on", "ranks": n, "B": B,
          "V": model.num_verts, "card": torch.cuda.get_device_name(0),
          "nvidia_smi": nvidia_smi(),
          "per_rank": [{"process": r["process"], "rows": r["rows"],
                        "startup_s": r["init_done"] - started,
                        "problem_s": r["problem_s"], "fit_s": r["fit_s"],
                        "wait_ms": r["wait_ms"], "gather_ms": r["gather_ms"],
                        "host_reads": r["host_reads"],
                        "launches": r["launches"]} for r in ranks],
          "fit_window_s": window, "frames_per_s": B / window,
          "loss_median": float(results[0]["loss"].median()),
          "bit_identical_across_ranks": same,
          "vs_blocks_in_process": vs_blocks, "launches": launches})
    if len(ranks) != n or not same:
        raise AssertionError("the ranks' gathered results differ")
    if vs_blocks["bit_equal_lanes"] != B:
        raise AssertionError(
            f"the ranks' fit is bit-equal to session.fit on the same blocks "
            f"in {vs_blocks['bit_equal_lanes']} of {B} lanes")
    for r in ranks:
        for name in ("lbs", "gather", "scatter", "scatter_join"):
            if r["launches"][name] <= 0:
                raise AssertionError(f"rank {r['process']} never launched "
                                     f"the {name} kernel")
        if r["launches"]["lbs_plan_builds"]:
            raise AssertionError(f"rank {r['process']}'s fit built skinning "
                                 "plans")
    return launches


# ---------------------------------------------------------------- oracle


def phase_oracle():
    """The port's broad phase on the card at make_collision_fn's defaults
    against the exact all-pairs oracle on the ~21k-face posed-human proxy
    (utils/proxy_mesh.py): the same pair set, more than 1,000 pairs, fewer
    than 0.75 of max_pairs, >= 2x headroom at every level."""
    import torch

    from smplifyx_torch.ops.collision import make_collision_fn
    from smplifyx_torch.utils.proxy_mesh import (
        build_posed_human,
        oracle_overlap_pairs,
    )

    verts, faces, segm, parents = build_posed_human(scale_faces=1.25)
    t0 = time.perf_counter()
    oi, oj = oracle_overlap_pairs(verts, faces, segm, parents)
    oracle_s = time.perf_counter() - t0
    oracle = set(zip(oi.tolist(), oj.tolist()))
    fn = make_collision_fn(torch.as_tensor(faces, device=CARD), segm=segm,
                           parents=parents)
    v = torch.as_tensor(verts, device=CARD)[None]
    fn.candidate_pairs(v)                               # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ia, ib, valid = fn.candidate_pairs(v)
    torch.cuda.synchronize()
    broad_s = time.perf_counter() - t0
    keep = valid[0].cpu().numpy()
    a, b = ia[0].cpu().numpy()[keep], ib[0].cpu().numpy()[keep]
    found = set(zip(np.minimum(a, b).tolist(), np.maximum(a, b).tolist()))
    sat = {k: (int(c[0]), budget) for k, (c, budget) in fn.saturation(v).items()}
    emit({"phase": "oracle", "faces": len(faces), "oracle_pairs": len(oracle),
          "found_pairs": len(found), "missing": len(oracle - found),
          "spurious": len(found - oracle), "max_pairs": fn.P,
          "saturation": {k: {"count": c, "budget": b} for k, (c, b) in sat.items()},
          "oracle_s_host": oracle_s, "broad_phase_s": broad_s})
    if not (19000 < len(faces) < 23000 and len(oracle) > 1000):
        raise AssertionError(f"the proxy has {len(faces)} faces and "
                             f"{len(oracle)} contacts")
    if found != oracle:
        raise AssertionError(f"the broad phase lost {len(oracle - found)} and "
                             f"invented {len(found - oracle)} pairs")
    if not len(oracle) < 0.75 * 4096:
        raise AssertionError(f"{len(oracle)} pairs: budget margin too thin")
    for level, (count, budget) in sat.items():
        if not 2 * count <= budget:
            raise AssertionError(f"level {level}: {count} of {budget}, less "
                                 "than 2x headroom")


# ---------------------------------------------------------------- families


def phase_families(peak):
    """SMPL-H and SMPL at V=10475: K1 on each family's skinning weights
    (J=52, J=24) against its plain version, then a collision-off staged
    fit of FAMILY_BATCH frames through build_fit_session (the combined
    preset with model_type smplh or smpl, use_face and interpenetration
    off, SMPL without hands) and recover_outputs: finite losses, the
    median below the last stage's energy at the fit's start, every lane's
    reprojection below x0's, finite meshes."""
    import torch

    from smplifyx_torch.fitting.pipeline import recover_outputs
    from smplifyx_torch.models.sparse import build_joints_model
    from smplifyx_torch.problem import (
        SLICE_OVERRIDES,
        SLICE_PRESET,
        SLICE_VERTS,
        family_problem,
    )
    from smplifyx_torch.session import build_fit_session
    from smplifyx_torch.utils.config import load_config

    lbs_rows, total = [], {}
    for model_type, use_hands in FAMILIES:
        cfg = load_config(SLICE_PRESET, **SLICE_OVERRIDES,
                          model_type=model_type, use_hands=use_hands,
                          use_face=False, interpenetration=False,
                          synthetic_num_verts=SLICE_VERTS)
        session = build_fit_session(cfg, device=CARD)
        model = session.get_model("neutral")
        jm = build_joints_model(model)
        frames, x0 = family_problem(model, session.settings, session.joint_map,
                                    FAMILY_BATCH)
        lbs_rows.append(check_lbs(f"{model_type}_full_mesh", model.lbs_weights,
                                  model.lbs_plan, 2 * FAMILY_BATCH, peak, 20))
        start = start_loss(session, model, jm, frames, x0)
        reproj0, _ = reprojection_px(session, model, frames, x0)
        reset_counts()
        t0 = time.perf_counter()
        res = session.fit(model, jm, frames, x0)
        out, _, _ = recover_outputs(model, session.settings, res.x,
                                    session.decode_body, session.joint_map,
                                    device=CARD)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = read_counts()
        reproj, _ = reprojection_px(session, model, frames, res.x)
        for k in ("lbs", "gather", "scatter"):
            total[k] = total.get(k, 0) + launches[k]
        emit({"phase": "family_fit", "model_type": model_type,
              "J": model.num_joints, "V": model.num_verts, "B": FAMILY_BATCH,
              "use_hands": use_hands, "fit_s": fit_s,
              "frames_per_s": FAMILY_BATCH / fit_s, "launches": launches,
              "start_loss_median": float(start.median()),
              "loss_median": float(res.loss.median()),
              "lanes_below_start": int((res.loss < start).sum()),
              "stage_loss_median": res.stage_losses.median(1).values.tolist(),
              "reproj_px_median": float(reproj.median()),
              "reproj_px_max": float(reproj.max()),
              "reproj_px_x0_median": float(reproj0.median()),
              "host_reads": res.host_reads})
        losses = torch.cat([res.loss[None], res.camera_loss[None],
                            res.stage_losses])
        if not (bool(torch.isfinite(losses).all())
                and float(res.loss.median()) < float(start.median())
                and bool((reproj < reproj0).all())):
            raise AssertionError(f"the {model_type} fit is not finite, its "
                                 "median not below its start or a lane's "
                                 "reprojection not below x0's")
        if tuple(out.vertices.shape) != (FAMILY_BATCH, model.num_verts, 3) \
                or not bool(torch.isfinite(out.vertices).all()):
            raise AssertionError(f"the {model_type} mesh is wrong")
        if launches["lbs_by_rows"].get(model.num_verts, 0) <= 0:
            raise AssertionError(f"the {model_type} run never skinned the "
                                 "full mesh with K1")
    return total, lbs_rows


# ---------------------------------------------------------------- video


def video_terms(problem, frames, x):
    """Stage-2 energy per lane (collision weight 1, on a broad phase of
    these vertices), its gradient and the collision term, at x on x's
    device."""
    import torch

    from smplifyx_torch.fitting.energy import smplify_energy_terms

    p = problem
    xx = x.clone().requires_grad_(True)
    terms = smplify_energy_terms(
        xx, p.settings, p.model, frames, p.schedule.stage(2), 2, 3,
        p.decode_body, p.joint_map, joints_model=p.joints_model,
        collision_fn=p.collision_fn)
    f = sum(terms.values())
    (g,) = torch.autograd.grad(f.sum(), xx)
    return f.detach(), g, terms["collision"].detach()


def phase_video():
    """The JAX package's batched video-sequence example at full width:
    `problem.video_problem(VIDEO_FRAMES, 10475, "slice")` fitted twice
    through `examples/video_batch.py::fit_sequence` (a broad phase every
    L-BFGS iteration, strong-Wolfe line search).  Launch counts are set to
    0 just before fit_sequence and read just after (its two fits and the
    recovery).  The two fits must end bit-equal, launch K1 on the full
    mesh and the subset, K2 and K3, build two row plans per broad phase and
    no skinning plan; the losses must be finite.  Returns the launches,
    the problem and the SequenceFit."""
    import torch

    from smplifyx_torch.examples.video_batch import fit_sequence
    from smplifyx_torch.ops.gather import row_plan
    from smplifyx_torch.ops.lbs import lbs_plan
    from smplifyx_torch.problem import SLICE_VERTS, fit_meshes, video_problem

    t0 = time.perf_counter()
    p = video_problem(VIDEO_FRAMES, SLICE_VERTS, "slice", CARD)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    fn = p.collision_fn
    broad = count_broad_phases(fn)
    reset_counts()
    row_plan.builds = 0
    lbs_plan.builds = 0
    t0 = time.perf_counter()
    seq = fit_sequence(p)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    plans, lbs_plans = row_plan.builds, lbs_plan.builds
    broad = dict(broad)
    for name in broad:                  # back to the class's methods
        delattr(fn, name)
    res, first = seq.result, seq.warmup
    bit_equal = all(torch.equal(getattr(res, k), getattr(first, k))
                    for k in ("x", "loss", "stage_losses", "stage_evals"))
    B, V = VIDEO_FRAMES, p.model.num_verts
    split = _lbs_split(launches, V, p.joints_model.sub_lbs.shape[0])
    v2v = 1000.0 * seq.pa_v2v.cpu()
    broad_total = sum(broad.values())
    fit_v, _ = fit_meshes(p.model, p.settings, p.decode_body, res.x)
    sat = fn.saturation(fit_v)
    row = {
        "phase": "video", "card": torch.cuda.get_device_name(0),
        "B": B, "V": V, "F": fn.F, "sigma": fn.sigma, "setup_s": setup_s,
        "wall_s": wall, "fit_s": seq.seconds,
        "frames_per_s": B / seq.seconds,
        "host_reads_per_fit": res.host_reads,
        "broad_phases": broad, "broad_phases_per_fit": broad_total / 2,
        "row_plans": plans, "row_plans_per_fit": plans / 2,
        "lbs_plan_builds": lbs_plans,
        "launches": launches, "lbs_launches": split,
        "camera_evals_max": int(res.camera_evals.max()),
        "stage_evals_max": res.stage_evals.amax(1).tolist(),
        "stage_evals_median": res.stage_evals.float().median(1).values.tolist(),
        "loss_median": float(res.loss.median()),
        "stage_loss_median": res.stage_losses.median(1).values.tolist(),
        "rerun_bit_equal": bit_equal,
        "pa_v2v_mm": {"mean": float(v2v.mean()), "median": float(v2v.median()),
                      "worst_frame": float(v2v.max()),
                      "worst_frame_index": int(v2v.argmax())},
        "final_saturation": {
            k: {"max": int(c.max()), "median": float(c.float().median()),
                "budget": b, "lanes_at_budget": int((c >= b).sum())}
            for k, (c, b) in sat.items()},
    }
    emit(row)
    losses = torch.cat([res.loss[None], res.camera_loss[None],
                        res.stage_losses])
    if not bool(torch.isfinite(losses).all()) or not bool(
            torch.isfinite(seq.pa_v2v).all()):
        raise AssertionError("a video loss or PA-V2V is not finite")
    if not bit_equal:
        raise AssertionError("two video fits of the same inputs differ")
    for name in ("gather", "scatter", "scatter_join"):
        if launches[name] <= 0:
            raise AssertionError(f"the video fit never launched the {name} kernel")
    if not (split["full_mesh"] > 0 and split["subset"] > 0
            and sum(split.values()) == launches["lbs"]):
        raise AssertionError(f"the video fit launched K1 {split} "
                             f"({launches['lbs']} in all)")
    if lbs_plans != 0:
        raise AssertionError(f"the video fit built {lbs_plans} skinning plans")
    if broad_total <= 0 or plans != 2 * broad_total:
        raise AssertionError(f"the video fit built {plans} row plans for "
                             f"{broad} broad phases")
    return launches, p, seq


def phase_video_energy(problem, seq):
    """The stage-2 energy, gradient and collision term of the video
    problem's first VIDEO_CPU_LANES lanes on the card and on the CPU (the
    problem built again there from the seed), each broad phase on its own
    device: at x0 (the rest pose, collision term on) within
    ENERGY_VALUE_RTOL and GRAD_TOL, at the card's fitted x within the
    same-x bounds of the lane references (SAME_X_VALUE_RTOL,
    SAME_X_GRAD_TOL).  There the fitted poses press the penetrating
    vertices against the cone field, whose 1/sigma = 1e3 scales the
    devices' f32 rounding of the vertices into the penalty (on an H100:
    5.1e-5 of the value, 2.0e-4 of the gradient's scale); a wrong pair,
    sign or index moves either by O(1)."""
    import torch

    from smplifyx_torch.problem import SLICE_VERTS, video_problem

    n = VIDEO_CPU_LANES
    t0 = time.perf_counter()
    cpu = video_problem(VIDEO_FRAMES, SLICE_VERTS, "slice", "cpu")
    rows, ok = {}, True
    bounds = {"x0": (ENERGY_VALUE_RTOL, GRAD_TOL),
              "fitted": (SAME_X_VALUE_RTOL, SAME_X_GRAD_TOL)}
    for name, x in (("x0", problem.x0), ("fitted", seq.result.x)):
        fk, gk, ck = video_terms(problem, problem.frames.map(lambda a: a[:n]),
                                 x[:n])
        fc, gc, cc = video_terms(cpu, cpu.frames.map(lambda a: a[:n]),
                                 x[:n].cpu())
        f_rel = ((fk.cpu() - fc).abs() / fc.abs()).max().item()
        g_err = ((gk.cpu() - gc).abs().max()
                 / max(1.0, gc.abs().max().item())).item()
        finite = bool(torch.isfinite(fk).all() and torch.isfinite(gk).all())
        rows[name] = {"value_max_rel_err": f_rel,
                      "grad_max_err_per_scale": g_err,
                      "collision_term_median": float(ck.median()),
                      "collision_term_max": float(ck.max()),
                      "collision_rel_err_max": float(
                          ((ck.cpu() - cc).abs() / cc.abs().clamp(min=1e-30))
                          .max()),
                      "lanes_with_collision": int((ck > 0).sum()),
                      "finite": finite, "bounds": bounds[name]}
        f_tol, g_tol = bounds[name]
        ok = ok and finite and f_rel <= f_tol and g_err <= g_tol
    emit({"phase": "video_energy", "lanes": n, "V": SLICE_VERTS,
          "cpu_s": time.perf_counter() - t0, **rows})
    if not ok:
        raise AssertionError(f"the video energy on the card and the CPU "
                             f"differ: {rows}")
    if not any(r["lanes_with_collision"] for r in rows.values()):
        raise AssertionError("no lane has a collision term: the check is empty")


def phase_video_cli():
    """The example's command line at its own size in a subprocess: `python
    -m smplifyx_torch.examples.video_batch 32` must exit 0 and print its
    three lines, the losses finite.  (Its random faces saturate the
    budgets at this width, as in JAX: no PA-V2V bound.)"""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "smplifyx_torch.examples.video_batch",
         str(VIDEO_CLI_FRAMES)],
        cwd=here, capture_output=True, text=True, timeout=VIDEO_CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    emit({"phase": "video_cli", "frames": VIDEO_CLI_FRAMES,
          "returncode": proc.returncode, "wall_s": wall, "lines": lines[-3:]})
    if proc.returncode != 0:
        raise AssertionError(f"the video example exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    want = (f"fitted {VIDEO_CLI_FRAMES}-frame sequence in ",
            "PA-V2V vs ground truth: mean ", "losses finite: True")
    if len(lines) < 3 or not all(
            line.startswith(w) for line, w in zip(lines[-3:], want)):
        raise AssertionError(f"the video example printed {lines[-3:]}")


def phase_collision_profile():
    """tools/profile_collision.py at PROFILE_BATCH lanes with --stages and
    --apply (its JSON line comes before this phase's): every component,
    broad-phase step and narrow-phase part timed on the device, finite and
    positive, the saturation of each level, and K1, K2 and K3 launched.
    Launch counts are set to 0 just before the tool runs and read just
    after.  Returns them."""
    from smplifyx_torch.ops.collision import CollisionFn
    from smplifyx_torch.tools import profile_collision as tool

    reset_counts()
    t0 = time.perf_counter()
    row = tool.main([str(PROFILE_BATCH), "--stages", "--apply"])
    wall = time.perf_counter() - t0
    launches = read_counts()
    emit({"phase": "collision_profile", "B": PROFILE_BATCH, "wall_s": wall,
          "launches": launches})
    want = {"device_ms": tool.COMPONENTS,
            "stages_device_ms": CollisionFn.BUILD_STEPS,
            "apply_device_ms": tool.APPLY_PARTS}
    for key, names in want.items():
        got = row.get(key, {})
        if set(got) != set(names) or not all(
                np.isfinite(v) and v > 0 for v in got.values()):
            raise AssertionError(f"the profile's {key} is {got}")
    if set(row["saturation"]) != {"superblock", "hit_superblock", "hit",
                                  "final", "narrow_tris"}:
        raise AssertionError(f"the profile's saturation is {row['saturation']}")
    for name in ("lbs", "gather", "scatter", "scatter_join"):
        if launches[name] <= 0:
            raise AssertionError(f"the profile never launched the {name} kernel")
    return launches


def kernel_entry(name, source, replaces, launches, rows, shape_keys, **extra):
    main = rows[0]
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"], "call_ms": main["kernel_call_ms"],
        "shape": ",".join(f"{k}={main[k]}" for k in shape_keys),
    }
    if "plan_ms" in main:
        entry["plan_ms"] = main["plan_ms"]
    entry.update(extra)
    return entry


def phase_k3_amortised(scatters, launches, plan_builds):
    """K3 with its plan's build shared by the launches that read the plan,
    against `scatter_add_` in the same call, at the two main-path shapes.
    Each broad phase builds one plan per level and both levels launch K3
    equally often, so a launch carries plan_ms x plan_builds / launches."""
    share = plan_builds / launches
    rows = {}
    for r in scatters[:2]:
        amortised = r["kernel_ms"] + r["plan_ms"] * share
        rows[r["shape"]] = {"kernel_ms": r["kernel_ms"], "plan_ms": r["plan_ms"],
                            "amortised_ms": amortised,
                            "library_ms": r["library_ms"],
                            "beats_library": amortised <= r["library_ms"]}
    emit({"phase": "k3_amortised", "plan_builds_fit": plan_builds,
          "scatter_launches_fit": launches, "plans_per_launch": share,
          "shapes": rows})


def main() -> int:
    name = phase_device()
    here = os.path.dirname(os.path.abspath(__file__))
    os.chdir(here)
    sys.path.insert(0, here)
    peak = peaks_for(name)
    phase_build()
    t0 = time.perf_counter()
    refits = CpuRefits(refit_inputs())
    emit({"phase": "cpu_refits_start", "inputs_s": time.perf_counter() - t0,
          "jobs": REFIT_JOBS, "threads": refits.threads, "nice": REFIT_NICE})
    try:
        return run_phases(peak, refits)
    finally:
        refits.stop()


def run_phases(peak, refits) -> int:
    import torch

    from smplifyx_torch.problem import slice_session

    # ---- the main path: collision on
    session, model, jm, frames, x0 = setup("collision_on")
    lbs_rows = phase_lbs(model, jm, x0.shape[0], peak)
    gathers, scatters = phase_gather(session, model, peak)
    cpu_session, cpu_model = slice_session(device="cpu")
    phase_broad(session, model, cpu_session.collision_fn)
    phase_energy_collision(session, model, frames, x0)
    res, launches, plan_builds, collision_on_fit_s = phase_main_path(
        "collision_on", session, model, jm, frames, x0,
        needs=("lbs", "gather", "scatter", "scatter_join"))
    phase_k3_amortised(scatters, launches["scatter"], plan_builds)

    # ---- the serve path: FitService over the collision-on session
    serve = phase_serve(session, model, jm, frames)
    collision_on = (session, model, jm, frames, x0)
    on_res = res

    # ---- the collision-off path of the first slice
    off = dict(interpenetration=False)
    session, model, jm, frames, x0 = setup("collision_off", **off)
    phase_energy(session, model, jm, frames, x0)
    res, _, _, _ = phase_main_path("collision_off", session, model, jm,
                                   frames, x0, needs=("lbs",))

    # ---- both paths' lanes refitted on the CPU (the refit process fitted
    # collision_on's while the card served and fitted collision_off)
    on_session, on_model, _, on_frames, on_x0 = collision_on
    lane_ref = phase_lane_reference("collision_on", on_session, on_model,
                                    on_res, on_frames, on_x0, refits)
    phase_quality("collision_on", on_model, on_session.settings,
                  on_session.decode_body, on_res.x, on_res.loss, lane_ref)
    del on_res, on_session, on_model, on_frames, on_x0
    lane_ref = phase_lane_reference("collision_off", session, model, res,
                                    frames, x0, refits, **off)
    phase_quality("collision_off", model, session.settings,
                  session.decode_body, res.x, res.loss, lane_ref)

    # ---- the parallel path (parallel/mesh.py) on one card: the
    # vertex-sharded forward, kernel builds racing in two processes, the
    # data-parallel collision-on fit in 1 and 2 workers, the vertex-sharded
    # collision-off fit
    par_forward, block_rows = phase_sharded_forward(collision_on[1], peak)
    phase_cold_build()
    par_on, on_blocks = phase_data_parallel(
        "collision_on", *collision_on,
        meshes=(("1x1", [CARD]), ("2x1", [CARD, CARD])))
    par_off, _ = phase_data_parallel("collision_off", session, model, jm,
                                     frames, x0,
                                     meshes=(("2x1", [CARD, CARD]),))
    par_sharded = phase_sharded_fit(session, model, frames, x0)
    parallel = {k: par_forward[k] + par_on[k] + par_off[k] + par_sharded[k]
                for k in ("lbs", "gather", "scatter")}

    # ---- the multihost path (parallel/multihost.py): the dry run, then
    # collision_on's 64 frames in two ranks over gloo on the one card
    multihost = phase_multihost(*collision_on[1:], on_blocks)
    del collision_on, on_blocks

    # ---- the full-scale oracle audit of the broad phase; SMPL-H and SMPL
    phase_oracle()
    families, family_rows = phase_families(peak)

    # ---- the video path: the batched sequence example at full width (a
    # broad phase per L-BFGS iteration, strong Wolfe), its energy on the
    # card against the CPU, its quality, its command line; then the
    # collision-stage profiler
    video, problem, seq = phase_video()
    phase_video_energy(problem, seq)
    phase_quality("video", problem.model, problem.settings,
                  problem.decode_body, seq.result.x, seq.result.loss,
                  gt=(problem.gt_vertices, problem.gt_joints))
    del problem, seq
    phase_video_cli()
    collision_profile = phase_collision_profile()

    # ---- the first-order path: adam with the collision term (a broad
    # phase per evaluation), then short collision-off sgd and rmsprop fits
    first_order, (session, model, res, lane_ref) = phase_first_order(
        "adam", refits)
    phase_quality("first_order", model, session.settings,
                  session.decode_body, res.x, res.loss, lane_ref)
    del session, model, res, lane_ref
    for name in ("sgd", "rmsprop"):
        phase_first_order(name, refits)

    # ---- the app path: the command line, from files
    app, (model, settings, x, losses) = phase_app(refits)
    phase_quality("app", model, settings, lambda b: b, x, losses)

    # ---- the viz path: --visualize true, overlays, live viewer
    viz = phase_viz()

    # ---- the classic SMPLify-X preset (five body stages, VPoser from the
    # zero latent, collision term in stages 3-4) on one frame and on
    # APP_FRAMES; the Halpe preset on Halpe-26 keypoint files
    classic = phase_preset("classic", refits)
    halpe = phase_preset("halpe", refits)
    refits.summary(collision_on_fit_s)

    lbs_rows += block_rows + family_rows
    for r in lbs_rows:
        r["max_abs_err"] = r["fwd_max_abs_err"]

    def by_path(name):
        return {"app": app[name], "collision_on": launches[name],
                "viz": viz[name], "serve": serve[name],
                "first_order": first_order[name],
                "parallel": parallel[name], "multihost": multihost[name],
                "families": families[name], "video": video[name],
                "collision_profile": collision_profile[name],
                "classic": classic[name], "halpe": halpe[name]}

    emit({"kernels": [
        kernel_entry("lbs", "smplifyx_torch/csrc/lbs.cu",
                     "smplifyx_tpu/ops/lbs_pallas.py:65", app["lbs"],
                     lbs_rows, ("B", "V", "J", "K"),
                     launches_by_path=by_path("lbs")),
        kernel_entry("gather", "smplifyx_torch/csrc/gather.cu",
                     "smplifyx_tpu/ops/gather_pallas.py:76", app["gather"],
                     gathers, ("B", "N", "R", "C"),
                     launches_by_path=by_path("gather")),
        kernel_entry("scatter", "smplifyx_torch/csrc/gather.cu",
                     "smplifyx_tpu/ops/gather_pallas.py:111",
                     app["scatter"], scatters, ("B", "R", "C", "num_rows"),
                     join_launches=app["scatter_join"],
                     launches_by_path=by_path("scatter")),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
