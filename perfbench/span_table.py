#!/usr/bin/env python3
"""One traced run of a cell, and where its idle time went by the
program's spans: the traced call's idle gaps by the stage that was open
(camera, body 0..S-1, or none) and by the innermost span inside it
(evaluation, the stage's own L-BFGS work, broad phase, the fit outside
its stages, or no span), with each stage's wall time, evaluations and
lanes.

    python3 perfbench/span_table.py --workload <cell> --seed <n> \
        --seconds <s> [--out <file.json>]

Prints one JSON line: the run's result line and the table (`idle_s`
and `idle_pts`, the latter as points of `idle_share`, which they add up
to).  Run on a machine with the cell's cards; the program must record
spans (`smplifyx_torch/utils/timing.py`).
"""

import argparse
import json
import os.path as osp
import sys
from types import SimpleNamespace

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _stage_of(spans, i):
    """The label of the stage span enclosing span i (itself included)."""
    while i is not None:
        s = spans[i]
        if s.name == "stage":
            k = s.attrs["stage"]
            return k if k == "camera" else f"body {k}"
        i = s.parent
    return "no stage"


def table(run, spans) -> dict:
    from perfbench import spans as sp

    parts = sp.idle_parts(run, spans)
    share = sp.idle_share(run)
    if parts is None or share is None:
        return {}
    kinds = {"evaluation": "evaluation", "stage": "lbfgs_self",
             "broad_phase": "broad_phase", "fit": "fit_self"}
    idle_ns = sum(parts.values())
    idle = {}
    for i, ns in parts.items():
        stage = "no stage" if i is None else _stage_of(spans, i)
        kind = "outside" if i is None else kinds.get(spans[i].name,
                                                     spans[i].name)
        row = idle.setdefault(stage, {})
        row[kind] = row.get(kind, 0) + ns
    stages = {}
    fits = {s.fit for s in sp.traced_fits(run, spans) or []}
    for i, s in enumerate(spans):
        if s.fit not in fits:
            continue
        if s.name == "stage":
            row = stages.setdefault(_stage_of(spans, i), {"evaluations": 0})
            row.update(wall_s=(s.end_ns - s.start_ns) / 1e9,
                       lanes=s.attrs["lanes"],
                       lane_evals=int(s.attrs["lane_evals"]))
        elif s.name == "evaluation":
            row = stages.setdefault(_stage_of(spans, i), {"evaluations": 0})
            row["evaluations"] += 1
    return {"idle_share": share, "idle_s_total": idle_ns / 1e9,
            "idle_s": {st: {k: v / 1e9 for k, v in row.items()}
                       for st, row in idle.items()},
            "idle_pts": {st: {k: share * v / idle_ns for k, v in row.items()}
                         for st, row in idle.items()},
            "stages": stages}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from perfbench import trace as tr
    from perfbench.cell import run_cell
    from perfbench.manifest import Manifest
    from smplifyx_torch.utils import timing

    # The traced run's reading of the profiler, kept for the table.
    read, summaries = tr.read, []

    def keep(*a, **kw):
        summaries.append(read(*a, **kw))
        return summaries[-1]

    tr.read = keep
    m = Manifest()
    cell = m.workload(args.workload)
    out = run_cell(m, cell, args.seed, args.seconds, True)
    tr.read = read
    result = {"line": out["line"], "info": out["info"]}
    if summaries:
        # info["fit_s"]: the traced fit's seconds, then the untraced ones
        run = SimpleNamespace(trace=summaries[-1], untraced=[
            {"seconds": s} for s in out["info"]["fit_s"][1:]])
        result["table"] = table(run, list(timing.RECORDER.spans))
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
