"""Batched video-sequence fit (the EgoBody-style scenario).

Counterpart of the JAX package's `examples/video_batch.py`: an animated
pose sequence, its 2D keypoint tracks, and every frame fitted at once as
one batch with the interpenetration term on (a broad phase in every
L-BFGS iteration, strong-Wolfe line search), then the recovered meshes
against the sequence's ground truth (PA-V2V).

    python -m smplifyx_torch.examples.video_batch [num_frames] [cpu|gpu]

The fit runs on the CUDA card unless the second argument is `cpu`; with
no card it raises.
"""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import torch

from smplifyx_torch.evaluation.metrics import procrustes_v2v
from smplifyx_torch.fitting.pipeline import FitResult, fit_batch, recover_outputs
from smplifyx_torch.problem import VideoProblem, video_problem
from smplifyx_torch.utils.device import device_for_platform


class SequenceFit(NamedTuple):
    result: FitResult       # the timed (second) fit
    warmup: FitResult       # the first fit of the same inputs
    pa_v2v: torch.Tensor    # [B] per-frame PA-V2V of the timed fit, metres
    seconds: float          # the timed fit, up to its last kernel


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fit_sequence(problem: VideoProblem) -> SequenceFit:
    """Fit every frame of `problem` as one batch twice (the first run
    warms up, as the JAX example's first call compiles), time the second
    up to its last kernel, and recover its meshes against the ground
    truth."""
    p = problem
    dev = p.device

    def fit():
        return fit_batch(
            p.model, p.settings, p.options, p.schedule, p.frames, p.x0,
            p.decode_body, p.joint_map, edge_idxs=p.edge_idxs,
            collision_fn=p.collision_fn, joints_model=p.joints_model,
            device=dev)

    warmup = fit()
    _sync(dev)
    t0 = time.perf_counter()
    res = fit()
    _sync(dev)
    seconds = time.perf_counter() - t0
    out, _, _ = recover_outputs(p.model, p.settings, res.x, p.decode_body,
                                device=dev)
    pa_v2v = procrustes_v2v(out.vertices, p.gt_vertices).mean(-1)
    return SequenceFit(res, warmup, pa_v2v, seconds)


def main(num_frames: int = 32, platform: str | None = None) -> SequenceFit:
    problem = video_problem(num_frames, 1024, "synthetic",
                            device_for_platform(platform))
    seq = fit_sequence(problem)
    B, dt = num_frames, seq.seconds
    v2v = seq.pa_v2v.cpu()
    print(f"fitted {B}-frame sequence in {dt:.2f}s ({B / dt:.1f} frames/s)")
    print(f"PA-V2V vs ground truth: mean {1000 * float(v2v.mean()):.1f} mm, "
          f"per-frame max {1000 * float(v2v.max()):.1f} mm")
    print(f"losses finite: {bool(torch.isfinite(seq.result.loss).all())}")
    return seq


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 32,
         sys.argv[2] if len(sys.argv) > 2 else None)
