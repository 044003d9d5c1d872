"""The runner: without a card it prints no result and fails; the rest of a
run, on the CPU at a small size, prints the contract's keys; with each
fault planted under the timed path `correct` comes out false."""

import json
import os.path as osp
import subprocess
import sys

import pytest
import torch

from perfbench import run
from perfbench.cell import run_cell
from perfbench.faults import FAULTS, VPOSER_ONLY
from perfbench.manifest import ROOT, Manifest
from perfbench.tests._tiny import CELL, TINY
from perfbench.tests._vposer import TINY_VPOSER

SEED = 2_200_000_003
FAULT_SEED = 1
# At this size a fit converges within half its iterations, so `half_iters`
# changes nothing to see; at the cell's own size the card reads it
# (perfbench/control.py, PERF.md).  The VPoser faults act only under a
# VPoser preset.
CAUGHT_SMALL = sorted(set(FAULTS) - {"half_iters", *VPOSER_ONLY})
CAUGHT_VPOSER = ["unchanged", "mesh", *VPOSER_ONLY]


def test_without_a_card_the_run_fails_and_prints_nothing(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc = run.main(["--workload", "combined-b128", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "needs 1 CUDA card" in out.err


def test_without_the_program_the_run_fails(tmp_path):
    """A directory holding only BENCHMARK.json and perfbench/ runs nothing."""
    import shutil

    shutil.copy(osp.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(osp.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "combined-b128", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_prints_the_contracts_keys(trace):
    m = Manifest()
    cell = CELL
    out = run_cell(m, m.workload(cell), SEED, 0.0, trace, device="cpu",
                   overrides=TINY)
    line = json.loads(json.dumps(out["line"]))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["attempted"] == 2 and line["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    names = {x["name"] for x in m.metrics(kind, cell)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for c in line["checks"].values():
        assert c["value"] >= 0 and c["limit"] is not None
    # mesh and keypoints agree with the reference at any size
    assert line["checks"]["mesh_gap_mm"]["value"] <= \
        line["checks"]["mesh_gap_mm"]["limit"]


@pytest.mark.parametrize("fault", [None, *CAUGHT_SMALL])
def test_a_broken_timed_path_is_not_correct(fault):
    """The sound run is correct; each fault fails one of the numbers."""
    m = Manifest()
    out = run_cell(m, m.workload(CELL), FAULT_SEED, 0.0, False,
                   device="cpu", overrides=TINY,
                   fault=FAULTS[fault]() if fault else None)
    failed = [n for n, c in out["checks"].items() if c["value"] > c["limit"]]
    assert out["line"]["correct"] is (fault is None), out["checks"]
    assert bool(failed) is (fault is not None)


@pytest.mark.parametrize("seed", [SEED, 3_500_000_007])
def test_a_vposer_run_is_correct(seed):
    """The combined cell under the VPoser preset, at the tests' size: the
    latent fitted, decoded by the reference's own VPoser."""
    m = Manifest()
    out = run_cell(m, m.workload(CELL), seed, 0.0, False, device="cpu",
                   overrides=TINY_VPOSER)
    assert out["line"]["correct"] is True, out["checks"]
    assert out["line"]["failed"] == 0


@pytest.mark.parametrize("fault", CAUGHT_VPOSER)
def test_a_broken_vposer_path_is_not_correct(fault):
    m = Manifest()
    out = run_cell(m, m.workload(CELL), FAULT_SEED, 0.0, False,
                   device="cpu", overrides=TINY_VPOSER, fault=FAULTS[fault]())
    assert out["line"]["correct"] is False, out["checks"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def _forbidden_after_a_run(overrides: str) -> list:
    code = (
        "import sys, json\n"
        "sys.path.insert(0, {root!r})\n"
        "import perfbench.run, perfbench.reference, perfbench.check\n"
        "from perfbench.cell import run_cell\n"
        "from perfbench.manifest import Manifest\n"
        "from perfbench.tests._tiny import TINY, CELL\n"
        "from perfbench.tests._vposer import TINY_VPOSER\n"
        "m = Manifest()\n"
        "run_cell(m, m.workload(CELL), 1, 0.0, False, "
        "device='cpu', overrides={overrides})\n"
        "print(json.dumps(perfbench.run.forbidden_modules()))\n"
    ).format(root=ROOT, overrides=overrides)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_no_jax_in_the_runner_and_reference():
    """Nothing that perfbench runs loads JAX or the JAX package, compared by
    the whole top-level name: a run of a tiny cell in a fresh process."""
    assert _forbidden_after_a_run("TINY") == []


def test_no_jax_in_a_vposer_run():
    assert _forbidden_after_a_run("TINY_VPOSER") == []


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlike_pkg", sys)
    monkeypatch.setitem(sys.modules, "smplifyx_tpu_extra.sub", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]
