#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (smplifyx_torch) on one CUDA card.

    python3 chip_smoke.py

Builds every hand-written kernel from the sources in the checkout, holds
each against its plain PyTorch version at the shapes the main path gives
it, drives the main path (build_fit_session -> FitSession.fit ->
recover_outputs on the collision-off combined preset, B=128 frames of a
full-width synthetic SMPL-X, V=10475; `smplifyx_torch.problem.build_slice`),
and checks the result, a sample of its lanes against the same fit through
the plain versions on the CPU.  Each phase
prints one JSON line; the card's name and power limit are printed as
nvidia-smi gives them; the `kernels` line comes just before the last line,
which is {"ok": true, "device": {...}}.  Any failed check raises and the
script exits non-zero without that line.  Without a CUDA card, or outside
the repository, it fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

FWD_TOL = 1e-5      # f32 sums over J=55 in another order
GRAD_TOL = 1e-4     # the bound of tests/test_lbs_pallas.py, per unit of scale
LANE_SAMPLE = 4     # main-path lanes fitted again on the CPU
LANE_LOSS_RTOL = 0.05

# Data-sheet peaks (dense, no sparsity): FP32 on the CUDA cores, memory rate.
PEAKS = {  # name fragment -> (FP32 FLOP/s, bytes/s)
    "H100 PCIe": (51.2e12, 2.0e12),
    "H100 NVL": (60.0e12, 3.9e12),
    "H200": (67.0e12, 4.8e12),
    "H100": (67.0e12, 3.35e12),   # SXM
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peaks_for(name: str):
    for frag, peak in PEAKS.items():
        if frag in name:
            return peak
    raise RuntimeError(f"no data-sheet peaks for card {name!r}")


def lbs_bound_ms(B, V, J, peak):
    """Least time for the skinning function: the larger of its operations
    over the FP32 peak and its bytes (each input read once, the output
    written once) over the memory rate."""
    flop, bw = peak
    ops = 2.0 * B * V * J * 12 + 18.0 * B * V
    nbytes = 4.0 * (V * J + B * J * 16 + 2 * B * V * 3)
    t_ops, t_bytes = ops / flop, nbytes / bw
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def time_ms(fn, reps=25, warmup=3):
    """Median of per-call CUDA-event times (warm L2, as on the main path)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this script "
                           "runs the port on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return name


def phase_build():
    from smplifyx_torch.ops import lbs

    seconds, ptxas = lbs.build(force=True)
    emit({"phase": "build", "kernel": "lbs", "seconds": seconds,
          "ptxas": ptxas, "command": " ".join(lbs.build_command())})


def check_lbs(name, W, B, peak, seed):
    """K1 against its plain version on the card: forward, VJP, times."""
    import torch

    from smplifyx_torch.ops.lbs import lbs_apply, lbs_reference

    V, J = W.shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(B, J, 16, device="cuda", generator=gen) * 0.3
    A[..., [0, 5, 10, 15]] += 1.0
    v = torch.randn(B, V, 3, device="cuda", generator=gen) * 0.5
    gout = torch.randn(B, V, 3, device="cuda", generator=gen)

    with torch.no_grad():
        out = lbs_apply(W, A, v)
        ref = lbs_reference(W, A, v)
    torch.cuda.synchronize()
    fwd_err = (out - ref).abs().max().item()

    Ak, vk = A.clone().requires_grad_(True), v.clone().requires_grad_(True)
    (lbs_apply(W, Ak, vk) * gout).sum().backward()
    Ap, vp = A.clone().requires_grad_(True), v.clone().requires_grad_(True)
    (lbs_reference(W, Ap, vp) * gout).sum().backward()
    torch.cuda.synchronize()
    grad_err = {}
    for key, got, want in (("dA", Ak.grad, Ap.grad), ("dv", vk.grad, vp.grad)):
        scale = max(1.0, want.abs().max().item())
        grad_err[key] = (got - want).abs().max().item() / scale

    with torch.no_grad():
        kernel_ms = time_ms(lambda: lbs_apply(W, A, v))
        plain_ms = time_ms(lambda: lbs_reference(W, A, v))
        library_ms = time_ms(lambda: torch.matmul(W, A))
    bound_ms, bound_by = lbs_bound_ms(B, V, J, peak)
    row = {"phase": "lbs_check", "shape": name, "B": B, "V": V, "J": J,
           "fwd_max_abs_err": fwd_err, "dA_err_per_scale": grad_err["dA"],
           "dv_err_per_scale": grad_err["dv"], "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit(row)
    if not fwd_err <= FWD_TOL:
        raise AssertionError(f"lbs forward error {fwd_err} > {FWD_TOL} at {name}")
    for key, err in grad_err.items():
        if not err <= GRAD_TOL:
            raise AssertionError(f"lbs {key} error {err} > {GRAD_TOL} at {name}")
    return row


def phase_lbs(model, jm, batch, peak):
    """K1 at the main path's two shapes (the mesh of `recover_outputs`, the
    landmark subset over the doubled batch) and at a ragged one."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(7)
    W_ragged = torch.rand(500, 55, device="cuda", generator=gen)
    W_ragged = W_ragged / W_ragged.sum(-1, keepdim=True)
    rows = [
        check_lbs("full_mesh", model.lbs_weights, batch, peak, 1),
        check_lbs("ragged", W_ragged, 3, peak, 2),
        check_lbs("subset", jm.sub_lbs, 2 * batch, peak, 3),
    ]
    return rows


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


def setup():
    """The user's entry points: session, model, joints model, frames."""
    import torch

    from smplifyx_torch.problem import build_slice

    t0 = time.perf_counter()
    session, model, jm, frames, x0 = build_slice()
    torch.cuda.synchronize()
    emit({"phase": "setup", "seconds": time.perf_counter() - t0,
          "B": int(x0.shape[0]), "V": int(model.lbs_weights.shape[0]),
          "subset_vertices": int(jm.sub_lbs.shape[0]), "dim": int(x0.shape[1])})
    return session, model, jm, frames, x0


def phase_main_path(session, model, jm, frames, x0):
    """Fit twice (the first run warms up), time the second, recover the
    mesh; lbs launches are counted from just before the second fit."""
    import torch

    from smplifyx_torch.ops.lbs import lbs_apply

    t0 = time.perf_counter()
    session.fit(model, jm, frames, x0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    lbs_apply.launches = 0
    t0 = time.perf_counter()
    res = session.fit(model, jm, frames, x0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = lbs_apply.launches
    reproj, out = reprojection_px(session, model, frames, res.x)
    torch.cuda.synchronize()
    main_launches = lbs_apply.launches

    reproj0, _ = reprojection_px(session, model, frames, x0)
    B, V = x0.shape[0], model.lbs_weights.shape[0]
    losses = torch.cat([res.loss[None], res.camera_loss[None],
                        res.stage_losses])
    emit({
        "phase": "main_path", "card": torch.cuda.get_device_name(0),
        "B": B, "V": V, "first_fit_s": first_s,
        "fit_s": fit_s, "frames_per_s": B / fit_s,
        "host_reads_per_fit": res.host_reads,
        "lbs_launches_fit": fit_launches, "lbs_launches_main": main_launches,
        "camera_evals_max": int(res.camera_evals.max()),
        "camera_evals_median": float(res.camera_evals.float().median()),
        "stage_evals_max": res.stage_evals.amax(1).tolist(),
        "stage_evals_median": res.stage_evals.float().median(1).values.tolist(),
        "loss_median": float(res.loss.median()),
        "flipped": int(res.flipped.sum()),
        "reproj_px_median": float(reproj.median()),
        "reproj_px_max": float(reproj.max()),
        "reproj_px_x0_median": float(reproj0.median()),
    })
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("a loss is not finite")
    if not bool((reproj < reproj0).all()):
        raise AssertionError("some lane's reprojection did not improve on x0")
    if tuple(out.vertices.shape) != (B, V, 3) or not bool(
            torch.isfinite(out.vertices).all()):
        raise AssertionError("recovered mesh has the wrong shape or non-finite values")
    if fit_launches <= 0:
        raise AssertionError("the fit never launched the lbs kernel")
    return res, main_launches


def phase_lane_reference(res, frames, x0, lanes=LANE_SAMPLE):
    """The first lanes of the main-path problem, fitted again through the
    plain versions on the CPU, end at the card's final loss per lane
    (within 5%: f32 L-BFGS paths diverge between devices)."""
    import torch

    from smplifyx_torch.models.sparse import build_joints_model
    from smplifyx_torch.problem import slice_config
    from smplifyx_torch.session import build_fit_session

    t0 = time.perf_counter()
    session = build_fit_session(slice_config(), device="cpu")
    model = session.get_model("neutral")
    cpu = session.fit(model, build_joints_model(model),
                      frames.map(lambda a: a[:lanes].cpu()), x0[:lanes].cpu())
    card = res.loss[:lanes].cpu()
    rel = ((card - cpu.loss).abs() / cpu.loss.abs()).max().item()
    emit({"phase": "lane_reference", "lanes": lanes,
          "V": int(model.lbs_weights.shape[0]),
          "cpu_fit_s": time.perf_counter() - t0,
          "loss_card": card.tolist(), "loss_cpu": cpu.loss.tolist(),
          "flipped_card": res.flipped[:lanes].tolist(),
          "flipped_cpu": cpu.flipped.tolist(), "max_rel_diff": rel})
    if not rel <= LANE_LOSS_RTOL:
        raise AssertionError(
            f"card and CPU fits differ by {rel:.3g} > {LANE_LOSS_RTOL}")


def main() -> int:
    import torch

    name = phase_device()
    here = os.path.dirname(os.path.abspath(__file__))
    os.chdir(here)
    sys.path.insert(0, here)
    peak = peaks_for(name)
    phase_build()
    session, model, jm, frames, x0 = setup()
    rows = phase_lbs(model, jm, x0.shape[0], peak)
    phase_energy(session, model, jm, frames, x0)
    res, main_launches = phase_main_path(session, model, jm, frames, x0)
    phase_lane_reference(res, frames, x0)

    full = rows[0]
    emit({"kernels": [{
        "name": "lbs", "route": "cuda",
        "source": "smplifyx_torch/csrc/lbs.cu",
        "replaces": "smplifyx_tpu/ops/lbs_pallas.py:65",
        "launches": main_launches,
        "max_abs_err": max(r["fwd_max_abs_err"] for r in rows),
        "ms": full["kernel_ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
        "library_ms": full["library_ms"],
        "shape": f"B={full['B']},V={full['V']},J={full['J']}",
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
