"""The readings that the limits of `correct` are set from: the program's
sound runs, the control, and the planted faults, each on the cell's own
size, one fit per seed, in one process.

    python3 perfbench/control.py --workload <cell> --seeds 12 --first <seed> \
        [--seconds 0] [--fault-seeds 3] [--out control_<cell>.jsonl]

For every seed: one run of the cell with a window of `--seconds` (0: one
fit; give a cell whose fit holds fewer frames than a run compares its
run length, so that a run's sample is compared); its numbers
(check.py) are the program's readings, and the reference computed in
float32 with TF32 products and put in the program's place gives the
control's readings on the same sample.  For the first `--fault-seeds`
seeds, every fault of faults.py that applies to the configuration once.
Prints one JSON line per run, then a summary: per number (and
`over_budget` and `run_off`, read beside them) the largest sound reading,
the smallest control reading and the smallest reading of each fault.
Needs a CUDA card: TF32 exists only there.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(workload: str, seeds: list, fault_seeds: int, seconds=0.0,
             device="cuda", overrides: dict | None = None,
             emit=print) -> dict:
    """Run the program, the control and the faults on `seeds`; returns the
    summary {number: {sound, control, <fault>: reading}}."""
    from perfbench import check
    from perfbench.cell import _merge, run_cell
    from perfbench.faults import FAULTS, VPOSER_ONLY
    from perfbench.manifest import Manifest

    manifest = Manifest()
    cell = manifest.workload(workload)
    preset = _merge(manifest.config(cell["config"]),
                    (overrides or {}).get("config"))["preset"]
    faults = {k: f for k, f in FAULTS.items()
              if preset["use_vposer"] or k not in VPOSER_ONLY}
    runs = []
    for k, seed in enumerate(seeds):
        # Only the first run warms up: the readings need no steady timing.
        ov = {**(overrides or {})}
        if k > 0:
            ov["traffic"] = {**ov.get("traffic", {}), "warmup_iters": 0}
        out = run_cell(manifest, cell, seed, seconds, False, device=device,
                       overrides=ov, control=True)
        sound = out["values"]
        runs.append(("sound", seed, sound))
        runs.append(("control", seed, out["control"]))
        emit(json.dumps({"seed": seed, "sound": sound,
                         "control": out["control"], "info": out["info"]}))
        if k < fault_seeds:
            for name, fault in faults.items():
                out = run_cell(manifest, cell, seed, seconds, False,
                               device=device, overrides=ov, fault=fault())
                got = out["values"]
                runs.append((name, seed, got))
                emit(json.dumps({"seed": seed, "fault": name,
                                 "readings": got}))
    summary = {}
    for n in (*check.NAMES, "over_budget", "run_off"):
        row = {"sound": max(r[n] for kind, _, r in runs if kind == "sound"),
               "control": min(r[n] for kind, _, r in runs if kind == "control")}
        for name in faults:
            vals = [r[n] for kind, _, r in runs if kind == name]
            if vals:
                row[name] = min(vals)
        summary[n] = row
    emit(json.dumps({"workload": workload, "summary": summary}))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=4_000_000_001)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("perfbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    sink = open(args.out, "a") if args.out else None

    def emit(line):
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    try:
        readings(args.workload, [args.first + k for k in range(args.seeds)],
                 args.fault_seeds, args.seconds, emit=emit)
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
