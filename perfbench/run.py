#!/usr/bin/env python3
"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the repository root on a machine with as many CUDA cards as the
cell asks for.  The last line of standard output is one JSON object
(correct, attempted, failed, metrics, device, [breakdown], checks); the
numbers compared for `correct` end standard error too.  Without the cards
it prints no result and exits 2; if the process has loaded JAX or the JAX
package once the window has closed it prints no result and exits 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os.path as osp  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "smplifyx_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card() -> dict:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"unread: {e}"
    return {"nvidia_smi": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench.cell import run_cell
    from perfbench.manifest import Manifest

    manifest = Manifest()
    cell = manifest.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(manifest, cell, args.seed, args.seconds, bool(args.trace),
                   t0=T0)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps({**out["info"], **card()}))
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
