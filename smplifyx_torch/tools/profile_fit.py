"""Where the main path's time goes on the card.

    python -m smplifyx_torch.tools.profile_fit [--out build/profile]

Runs the slice's fit (`problem.build_slice`, the fit chip_smoke.py drives:
B=128 frames, V=10475) once to warm up, once timed without the profiler,
and once under torch.profiler.  Prints one JSON line: the unprofiled and
profiled wall seconds, device-busy seconds (the sum of CUDA kernel times
in the profiled fit), the device's idle share over each of the two walls,
kernel launches per fit, host reads per fit, the device time and share of
each hand-written kernel (K1 `lbs_kernel`, K2 `k2_gather_rows`, K3's two
kernels `k3_scatter_tiles` and `k3_join`, each on its own), the
`aten::sort` calls with the device time of their kernels and the row
plans built (two per broad phase, ops/gather.py `row_plan`), and the
kernels that take the most device time; writes the profiler's table to
<out>/profile_fit.txt.

The profiler's host overhead stretches the profiled wall while the kernels
themselves keep their times, so the idle share of the fit as users run it
is the one over the unprofiled wall (`idle_share`); the one over the
profiled wall is printed beside it, labelled.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from smplifyx_torch.ops.gather import row_plan
from smplifyx_torch.problem import build_slice
from smplifyx_torch.utils.timing import card_name, kernel_events, profile_summary

TOP = 12            # kernels kept in top_kernels


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

    row_plan.builds = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.fit(model, jm, frames, x0)
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t0
    averages = prof.key_averages()
    events = kernel_events(prof)
    summary = profile_summary(prof, TOP)
    busy = summary["busy_device_ms"] / 1e3
    ours = {}
    for label, symbol in (("lbs", "lbs_kernel"), ("gather", "k2_gather_rows"),
                          ("scatter", "k3_scatter_tiles"), ("scatter_join", "k3_join")):
        hits = [e for e in events if symbol in e.key]
        ms = sum(e.self_device_time_total for e in hits) / 1e3
        ours[label] = {"count": sum(e.count for e in hits), "device_ms": ms,
                       "share": ms / 1e3 / busy if busy else None}
    sorts = [e for e in averages if e.key == "aten::sort"]
    ours["aten_sort"] = {"count": sum(e.count for e in sorts),
                         "device_ms": sum(e.device_time_total for e in sorts) / 1e3}
    ours["plan_builds"] = row_plan.builds
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_fit.txt"), "w") as f:
        f.write(averages.table(sort_by="self_device_time_total", row_limit=60))
    evals = int(res.camera_evals.max() + res.stage_evals.amax(1).sum())
    print(json.dumps({
        "card": card_name(), "B": B, "V": V,
        "wall_s": wall, "frames_per_s": B / wall,
        "wall_profiled_s": wall_profiled, "device_busy_s": busy,
        "idle_share": 1.0 - busy / wall,
        "idle_share_profiled_wall": 1.0 - busy / wall_profiled,
        "kernel_launches": summary["launches"], "host_reads": res.host_reads,
        "max_lane_evals": evals,
        "launches_per_eval": summary["launches"] / evals,
        "hand_written_kernels": ours,
        "top_kernels": summary["top"],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
