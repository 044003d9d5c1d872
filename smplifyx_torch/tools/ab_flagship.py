"""Interleaved A/B runs of collision-off fit configurations on one CUDA
card: the port's counterpart of the JAX package's `tools/ab_flagship.py`.

    python -m smplifyx_torch.tools.ab_flagship [B] [rounds] [config ...]
        [--device cuda|cpu] [--num-verts 10475]

  config grammar: name=ls_mode:max_evals[:max_iters[:warm]]   e.g.
    wolfe=wolfe:0  armijo=armijo:0  wolfe_me90=wolfe:90  warm=wolfe:0:60:warm
  Defaults: B=128, rounds=5, configs wolfe=wolfe:0, armijo=armijo:0,
  wolfe_me90=wolfe:90 (the JAX program's).

Host speed moves between processes, so every config runs in this one
process on bench.py's problem and schedule (`bench.build`,
`bench.schedule`): one warm fit per config (its `first_run_s` line: the
warm-up compiles nothing here), then `rounds` rounds that interleave the
configs (A, B, C, A, B, C, ...; a line per round), each fit on the host
clock up to `torch.cuda.synchronize()`.  Last, a line per config: the
median round seconds, frames/s, the mean final loss of its warm fit and
its relative difference from the first config's (the quality check:
configs must agree with the baseline loss or they are not viable bench
configs), and the mean evaluations per body stage.  Body stages: the
config's line search, max_evals, max_iters (60 by default) and warm start,
history 16; the camera stage strong Wolfe, 30 iterations, history 8, the
same warm start.  Every line carries `device` and `git`, a config's line
also its resolved `options` (`bench.provenance`).
"""

from __future__ import annotations

import argparse
import json
import statistics
from typing import Iterator

from smplifyx_torch import bench
from smplifyx_torch.fitting.lbfgs import LBFGSConfig
from smplifyx_torch.fitting.pipeline import FitOptions
from smplifyx_torch.utils.device import resolve_device

DEFAULT_SPECS = ("wolfe=wolfe:0", "armijo=armijo:0", "wolfe_me90=wolfe:90")
# Keys of the round lines besides the configs' names.
RESERVED = ("round", "device", "git")


def parse_spec(spec: str) -> tuple[str, FitOptions]:
    """(name, options) of `name=ls_mode:max_evals[:max_iters[:warm]]`
    (ab_flagship.py:55-70)."""
    name, rest = spec.split("=")
    if name in RESERVED:
        raise ValueError(f"config name {name!r} is a key of the round lines")
    parts = rest.split(":")
    ls_mode = parts[0]
    max_evals = int(parts[1]) if len(parts) > 1 else 0
    max_iters = int(parts[2]) if len(parts) > 2 else 60
    warm = len(parts) > 3 and parts[3] == "warm"
    return name, FitOptions(
        lbfgs=LBFGSConfig(max_iters=max_iters, history=16, ftol=1e-9,
                          gtol=1e-9, ls_soft_accept=6, ls_mode=ls_mode,
                          max_evals=max_evals, warm_start_step=warm),
        camera_lbfgs=LBFGSConfig(max_iters=30, history=8, ls_soft_accept=6,
                                 warm_start_step=warm))


def interleave(names, rounds: int) -> Iterator[tuple[int, str]]:
    """(round, config) of the timed fits in their order: A, B, C, A, ..."""
    for r in range(rounds):
        for name in names:
            yield r, name


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", type=int, nargs="?", default=bench.BATCH)
    ap.add_argument("rounds", type=int, nargs="?", default=5)
    ap.add_argument("configs", nargs="*")
    ap.add_argument("--num-verts", type=int, default=bench.NUM_VERTS)
    bench.device_argument(ap)
    args = ap.parse_args(argv)
    specs = args.configs or list(DEFAULT_SPECS)
    configs = dict(parse_spec(s) for s in specs)
    dev = resolve_device(args.device)
    B = args.B
    p = bench.build(B, args.num_verts, device=dev)
    stages = bench.schedule(device=dev)
    base = bench.provenance(dev)
    lines = []

    def emit(line):
        print(json.dumps(line), flush=True)
        lines.append(line)

    loss, evals = {}, {}
    for name, opts in configs.items():      # warm-up
        res, dt = bench.timed_fit(p, opts, stages)
        loss[name] = float(res.loss.mean())
        evals[name] = [round(float(m), 1)
                       for m in res.stage_evals.double().mean(dim=1)]
        emit({"config": name, "first_run_s": round(dt, 1),
              **bench.provenance(dev, opts)})

    names = list(configs)
    times = {name: [] for name in names}
    for r, name in interleave(names, args.rounds):
        times[name].append(bench.timed_fit(p, configs[name], stages)[1])
        if name == names[-1]:
            emit({"round": r, **{n: round(t[-1], 3)
                                 for n, t in times.items()}, **base})

    first = names[0]
    for name, opts in configs.items():
        med = statistics.median(times[name])
        emit({"config": name, "B": B, "median_s": round(med, 3),
              "fps": round(B / med, 2), "loss_mean": loss[name],
              "loss_rel_vs_first": round(abs(loss[name] - loss[first])
                                         / abs(loss[first]), 6),
              "stage_evals_mean": evals[name],
              **bench.provenance(dev, opts)})
    return lines


if __name__ == "__main__":
    main()
