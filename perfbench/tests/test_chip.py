"""On the card: the control fails the comparison, and a traced run reads
the trace.  Run on the chip with
`python -m pytest -p no:cacheprovider perfbench/tests/test_chip.py`."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench.cell import run_cell
from perfbench.manifest import ROOT, Manifest
from perfbench.tests._tiny import CELL

SMALL = {"config": {"preset": {"lbfgs_iters_per_stage": 4, "max_evals": 6}},
         "traffic": {"frames_per_fit": 4, "fit_pool": 2, "check_frames": 4,
                     "warmup_iters": 1}}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_the_control_fails_where_the_program_passes():
    """At full width and four frames: the program's mesh, keypoints,
    energy and gradient within their limits, the TF32 control's beyond
    one of them."""
    _card()
    m = Manifest()
    cell = m.workload(CELL)
    limits = m.config(cell["config"])["correct_limits"]
    exact = ("mesh_gap_mm", "joints_gap_mm", "energy_gap", "grad_gap")
    out = run_cell(m, cell, 5, 0.0, False, overrides=SMALL, control=True)
    for n in exact:
        assert out["checks"][n]["value"] <= limits[n], n
    assert any(out["control"][n] > limits[n] for n in exact)


@pytest.mark.cuda
def test_a_traced_run_reads_every_per_layer_metric():
    """In a fresh process, as a run has one profiler session: a second
    session in one process need not hold its own span marks whole."""
    _card()
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from perfbench.cell import run_cell\n"
        "from perfbench.manifest import Manifest\n"
        "m = Manifest()\n"
        f"out = run_cell(m, m.workload({CELL!r}), 6, 5.0, True, "
        f"overrides={SMALL!r})\n"
        "print(json.dumps(out['line']))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    m = Manifest()
    names = {x["name"] for x in m.metrics("per_layer", CELL)}
    assert set(line["metrics"]) == names
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    for name, v in line["metrics"].items():
        if name.split(".")[0].endswith(("roofline", "mfu", "share")):
            assert 0 < v["value"] <= 100
