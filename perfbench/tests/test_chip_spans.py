"""On the card: the program's spans share a clock with the device trace,
the recorder records under the harness's CUDA-only profiler, and a traced
run reads the metrics of the program's spans.  Run on the chip with
`python -m pytest -p no:cacheprovider -s perfbench/tests/test_chip_spans.py`,
which prints the clock's offsets and the traced run's metrics."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench.manifest import ROOT
from perfbench.tests._tiny import CELL
from perfbench.tests.test_chip import SMALL
from smplifyx_torch.utils import timing

NEW = ("lane_evals_per_frame.frames", "active_lane_share.frames",
       "idle_in_eval.frames", "idle_in_lbfgs.frames",
       "live_pair_share.frames")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _kernels(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return sorted((e.start_ns(), e.end_ns()) for e in
                  prof.profiler.kineto_results.events()
                  if e.device_type() == cuda and not e.is_user_annotation())


@pytest.mark.cuda
def test_spans_hold_their_kernels_on_the_profilers_clock():
    """Every kernel launched inside a span closed after
    torch.cuda.synchronize() lies within that span's start..end; a kernel
    queued behind a spin starts after the span that launched it closed,
    so the containment is not a loose clock."""
    _card()
    dev = torch.device("cuda")
    a = torch.randn(2048, 2048, device=dev)
    (a @ a).div_(2048.0)                # cuBLAS's set-up outside the trace
    torch.cuda.synchronize()
    timing.RECORDER.clear()
    held, early = [], []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        a.add_(0)                       # CUPTI settles on a throwaway
        torch.cuda.synchronize()
        on = timing.recording()
        for _ in range(20):
            with timing.span("held") as sp:
                for _ in range(4):
                    a = (a @ a).div_(2048.0)
                torch.cuda.synchronize()
            held.append(sp)
        for _ in range(5):
            with timing.span("early") as sp:
                torch.cuda._sleep(20_000_000)
                a.add_(1)
            torch.cuda.synchronize()
            early.append(sp)
    timing.RECORDER.clear()
    assert on, "the recorder does not see the CUDA-only profiler"
    kernels = _kernels(prof)[1:]        # after the throwaway
    n_held = sum(k[0] < early[0].start_ns for k in kernels)
    # Outside: how far a kernel of the held phase lies from every span
    # (0 inside one); margins: first start - open and close - last end.
    outside, margins = [], []
    for k0, k1 in kernels[:n_held]:
        outside.append(min(max(sp.start_ns - k0, k1 - sp.end_ns, 0)
                           for sp in held))
    for sp in held:
        mine = [k for k in kernels[:n_held]
                if sp.start_ns <= k[0] and k[1] <= sp.end_ns]
        if mine:
            margins.append((mine[0][0] - sp.start_ns,
                            sp.end_ns - mine[-1][1]))
    pairs = kernels[n_held:]
    after_close = [pairs[2 * i + 1][0] - sp.end_ns
                   for i, sp in enumerate(early) if 2 * i + 1 < len(pairs)]
    out = {"card": torch.cuda.get_device_name(dev),
           "held_kernels": n_held, "largest_offset_ns": max(outside),
           "open_margin_ns": [m[0] for m in margins],
           "close_margin_ns": [m[1] for m in margins],
           "early_start_after_close_ns": after_close}
    print("clock", json.dumps(out))
    assert n_held >= 20 * 8 and len(margins) == 20
    assert max(outside) == 0
    assert len(after_close) == 5 and min(after_close) > 0


@pytest.mark.cuda
def test_a_traced_run_reads_the_programs_spans():
    """In a fresh process, as a run has one profiler session."""
    _card()
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from perfbench.cell import run_cell\n"
        "from perfbench.manifest import Manifest\n"
        "m = Manifest()\n"
        f"out = run_cell(m, m.workload({CELL!r}), 2_900_000_007, 5.0, True, "
        f"overrides={SMALL!r})\n"
        "print(json.dumps(out['line']))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    got = line["metrics"]
    print("metrics", json.dumps({k: v["value"] for k, v in got.items()}))
    assert set(NEW) <= set(got)
    for name in ("active_lane_share.frames", "live_pair_share.frames"):
        assert 0 < got[name]["value"] <= 100
    idle = got["idle_share.frames"]["value"]
    parts = got["idle_in_eval.frames"]["value"] + \
        got["idle_in_lbfgs.frames"]["value"]
    assert 0 < parts <= idle
    assert got["lane_evals_per_frame.frames"]["value"] > 0
