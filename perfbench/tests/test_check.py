"""The numbers of `check.readings` on a reference's fixed outputs: which
frames each number judges."""

from types import SimpleNamespace

import pytest
import torch

from perfbench import check

N, K = 8, 3     # sampled frames; the first K are made to differ
OFF_PX = 50.0 * 2 ** 0.5


def _reading(fit_energy: float, total: float, pairs: int = 0) -> dict:
    """The readings of a sample whose first K frames have the given exact
    energies (without and with the collision term) and pairs, and whose
    answers there are off by half the gradient's length, 1 um in the
    vertices and OFF_PX in the projection; the other frames sit at the
    median energy and are answered exactly."""
    dt = torch.float64
    fit = torch.full((N,), 7e3, dtype=dt)
    fit[:K] = fit_energy
    whole = fit.clone()
    whole[:K] = total
    grad = torch.ones(N, 5, dtype=dt)
    proj = torch.zeros(N, 4, 2, dtype=dt)
    proj[:K] += 50.0
    e = {"total": whole, "fit_energy": fit, "grad": grad,
         "vertices": torch.zeros(N, 3, 3, dtype=dt),
         "joints": torch.zeros(N, 4, 3, dtype=dt), "proj": proj,
         "weights": torch.ones(N, 4, dtype=dt),
         "pairs": torch.tensor([pairs] * K + [0] * (N - K))}
    reference = SimpleNamespace(evaluate=lambda *a, **kw: e,
                                preset={"max_coll_pairs": 4096})
    answers = {"grad": grad.clone(), "vertices": e["vertices"].clone(),
               "joints": e["joints"].clone()}
    answers["grad"][:K] *= 1.5
    answers["vertices"][:K] += 1e-6
    sample = {"x": None, "keypoints": torch.zeros(N, 4, 3), "reg": None}
    return check.readings(reference, sample, answers)


def test_frames_that_ran_off_leave_the_gradient_and_reprojection():
    r = _reading(fit_energy=7e3 * check.RUN_OFF * 2, total=1e9)
    assert r["run_off"] == K
    assert r["grad_gap"] == 0.0 and r["reproj_px"] == 0.0
    assert r["mesh_gap_mm"] == pytest.approx(1e-3)


@pytest.mark.parametrize("total", [7e3, 1e9])
def test_frames_that_fit_are_judged_whatever_their_collision_energy(total):
    """Frames deep in self-contact (the whole energy far above the median,
    the energy without collisions not) stay in: a broken collision term
    must not take its own frames out."""
    r = _reading(fit_energy=7e3, total=total)
    assert r["run_off"] == 0
    assert r["grad_gap"] == pytest.approx(0.5)
    assert r["reproj_px"] == pytest.approx(OFF_PX)


def test_frames_past_the_pair_budget_leave_the_gradient_only():
    r = _reading(fit_energy=7e3, total=7e3, pairs=5000)
    assert r["over_budget"] == K and r["run_off"] == 0
    assert r["grad_gap"] == 0.0
    assert r["reproj_px"] == pytest.approx(OFF_PX)
    assert r["mesh_gap_mm"] == pytest.approx(1e-3)
