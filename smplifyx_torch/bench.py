"""Throughput of the collision-off staged fit on one CUDA card: the port's
counterpart of the JAX package's `bench.py`.

    python -m smplifyx_torch.bench [--rounds 3] [--device cuda|cpu]
        [--batch 128] [--num-verts 10475] [--max-iters N]

Prints one JSON line with the JAX program's keys

  {"metric": "frames_per_sec_per_chip", "value": N, "unit": "frames/s",
   "vs_baseline": N}

and three more: `device` (the card's name and power limit as nvidia-smi
gives them, or "cpu"), `git` (the checkout's short SHA) and `options` (the
resolved FitOptions).

Protocol (bench.py:116-214): B=128 frames of `problem.build_problem(B)`
(`synthetic_model`, V=10475), the three body stages of `schedule()`, the
fast options of `options()` (body stages: Armijo trials, at most 90
evaluations and 4 trials per line search, 60 iterations, history 16;
camera stage: strong Wolfe, 30 iterations, history 8), the guess-init
torso edges [[5, 12], [2, 9]] and the joints-only model in every stage.
One warm fit, then `--rounds` timed fits, each on the host clock up to
`torch.cuda.synchronize()`; frames/s is B over their mean.  vs_baseline is
frames/s over 0.05, the reference's ~20 s per frame (BASELINE.md).

The fit runs on the card unless `--device cpu` is given; with no card it
raises.  `--batch`, `--num-verts` and `--max-iters` (every stage's
L-BFGS iterations, the camera's included) shrink the run for the CPU.

`bench_collision.py`, `bench_quality.py` and `tools/ab_flagship.py` build
on this module, as their JAX counterparts build on `bench.py`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os.path as osp
import subprocess
import time
from dataclasses import dataclass
from typing import Optional

import torch

from smplifyx_torch.fitting.energy import FrameData, StageWeights
from smplifyx_torch.fitting.lbfgs import LBFGSConfig
from smplifyx_torch.fitting.params import FitSettings
from smplifyx_torch.fitting.pipeline import FitOptions, FitResult, fit_batch
from smplifyx_torch.fitting.stages import build_stage_schedule
from smplifyx_torch.models.bodymodel import SMPLXModel
from smplifyx_torch.models.sparse import build_joints_model
from smplifyx_torch.problem import build_problem
from smplifyx_torch.utils.device import resolve_device
from smplifyx_torch.utils.timing import card_name

BASELINE_FPS = 0.05     # the reference: ~20 s per frame (BASELINE.md)
BATCH = 128
NUM_VERTS = 10475
ROUNDS = 3
EDGE_IDXS = ((5, 12), (2, 9))   # the guess-init torso edges


def schedule(coll_loss_weights=None, device="cuda") -> StageWeights:
    """The three body stages of bench.py:144-151 (with
    `coll_loss_weights`, bench_collision.py's)."""
    return build_stage_schedule(
        body_pose_prior_weights=[4.04e2, 57.4, 4.78],
        shape_weights=[1e2, 1e1, 0.5e1], expr_weights=[1e2, 1e1, 0.5e1],
        hand_pose_prior_weights=[1e2, 1e1, 0.5e1],
        hand_joints_weights=[0.0, 0.0, 1.0],
        face_joints_weights=[0.0, 0.0, 1.0],
        coll_loss_weights=coll_loss_weights, device=device)


def options() -> FitOptions:
    """The fast options of bench.py:168-176."""
    return FitOptions(
        lbfgs=LBFGSConfig(max_iters=60, history=16, ftol=1e-9, gtol=1e-9,
                          ls_soft_accept=6, ls_mode="armijo", max_evals=90,
                          max_ls=4),
        camera_lbfgs=LBFGSConfig(max_iters=30, history=8, ls_soft_accept=6))


def with_iters(opts: FitOptions, max_iters: Optional[int]) -> FitOptions:
    """`opts` with every stage's L-BFGS iterations set to max_iters (the
    camera stage's included); unchanged for None."""
    if max_iters is None:
        return opts
    return dataclasses.replace(
        opts, lbfgs=dataclasses.replace(opts.lbfgs, max_iters=max_iters),
        camera_lbfgs=dataclasses.replace(opts.camera_lbfgs,
                                         max_iters=max_iters))


@dataclass
class Problem:
    """bench.py's problem: `build_problem`'s outputs, the joints-only
    model and the torso edges, on one device."""

    model: SMPLXModel
    settings: FitSettings
    frames: FrameData
    x0: torch.Tensor            # [B, D] zeros
    joint_map: torch.Tensor     # [K] coco25 with hands, face and contour
    joints_model: object
    edge_idxs: torch.Tensor     # [2, 2]

    @property
    def device(self) -> torch.device:
        return self.x0.device


def build(B: int = BATCH, V: int = NUM_VERTS, smooth: bool = False,
          device="cuda") -> Problem:
    """B frames of `build_problem(B, V, smooth)` on `device`."""
    dev = resolve_device(device)
    model, settings, frames, x0, joint_map = build_problem(
        B, V, smooth=smooth, device=dev)
    return Problem(model, settings, frames, x0, joint_map,
                   build_joints_model(model),
                   torch.as_tensor(EDGE_IDXS, device=dev))


def fit(p: Problem, opts: FitOptions, stage_weights: StageWeights,
        **kwargs) -> FitResult:
    """`fit_batch` on the problem (identity body decoder)."""
    return fit_batch(p.model, p.settings, opts, stage_weights, p.frames,
                     p.x0, lambda b: b, p.joint_map, edge_idxs=p.edge_idxs,
                     joints_model=p.joints_model, device=p.device, **kwargs)


def timed_fit(p: Problem, opts: FitOptions, stage_weights: StageWeights,
              **kwargs) -> tuple[FitResult, float]:
    """(result, seconds) of one fit on the host clock, up to the card's
    last kernel."""
    t0 = time.perf_counter()
    res = fit(p, opts, stage_weights, **kwargs)
    if p.device.type == "cuda":
        torch.cuda.synchronize(p.device)
    return res, time.perf_counter() - t0


def git_sha() -> str:
    """The checkout's short SHA, "unknown" outside a git checkout."""
    try:
        return subprocess.run(
            ["git", "-C", osp.dirname(osp.abspath(__file__)), "rev-parse",
             "--short", "HEAD"],
            capture_output=True, text=True, timeout=10).stdout.strip() \
            or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def provenance(dev: torch.device, opts: Optional[FitOptions] = None) -> dict:
    """The keys every program adds to the JAX program's line: `device`
    (the card's name and power limit, or "cpu"), `git` and, where given,
    `options` (the resolved FitOptions)."""
    out = {"device": card_name() if dev.type == "cuda" else dev.type,
           "git": git_sha()}
    if opts is not None:
        out["options"] = dataclasses.asdict(opts)
    return out


def device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) "
                             "or cpu")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--num-verts", type=int, default=NUM_VERTS)
    ap.add_argument("--max-iters", type=int, default=None)
    device_argument(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    B = args.batch
    p = build(B, args.num_verts, device=dev)
    opts = with_iters(options(), args.max_iters)
    stages = schedule(device=dev)
    timed_fit(p, opts, stages)          # warm-up
    dt = sum(timed_fit(p, opts, stages)[1]
             for _ in range(args.rounds)) / args.rounds
    fps = B / dt
    record = {"metric": "frames_per_sec_per_chip", "value": round(fps, 3),
              "unit": "frames/s", "vs_baseline": round(fps / BASELINE_FPS, 2),
              **provenance(dev, opts)}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
