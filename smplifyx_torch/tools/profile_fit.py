"""Where the main path's time goes on the card.

    python -m smplifyx_torch.tools.profile_fit [--out build/profile]

Runs the slice's fit (`problem.build_slice`, the fit chip_smoke.py drives:
B=128 frames, V=10475) once to warm up, once timed without the profiler,
and once under torch.profiler.  Prints one JSON line: the unprofiled and
profiled wall seconds, device-busy seconds (the sum of CUDA kernel times
in the profiled fit), the device's idle share over each of the two walls,
kernel launches per fit, host reads per fit, and the kernels that take the
most device time; writes the profiler's table to <out>/profile_fit.txt.

The profiler's host overhead stretches the profiled wall while the kernels
themselves keep their times, so the idle share of the fit as users run it
is the one over the unprofiled wall (`idle_share`); the one over the
profiled wall is printed beside it, labelled.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from smplifyx_torch.problem import build_slice


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args(argv)

    session, model, jm, frames, x0 = build_slice()
    B, V = x0.shape[0], model.lbs_weights.shape[0]
    session.fit(model, jm, frames, x0)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    res = session.fit(model, jm, frames, x0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.fit(model, jm, frames, x0)
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    launches = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_fit.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    evals = int(res.camera_evals.max() + res.stage_evals.amax(1).sum())
    print(json.dumps({
        "card": smi, "B": B, "V": V,
        "wall_s": wall, "frames_per_s": B / wall,
        "wall_profiled_s": wall_profiled, "device_busy_s": busy,
        "idle_share": 1.0 - busy / wall,
        "idle_share_profiled_wall": 1.0 - busy / wall_profiled,
        "kernel_launches": launches, "host_reads": res.host_reads,
        "max_lane_evals": evals,
        "launches_per_eval": launches / evals,
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "device_ms": e.self_device_time_total / 1e3}
                        for e in top],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
