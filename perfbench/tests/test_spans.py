"""The readers of the program's spans (perfbench/spans.py and the metrics
that use it) on hand-made spans and kernels, and the program's broad
phase spans against the harness's marks on a tiny CPU fit."""

from types import SimpleNamespace

import pytest
import torch

from perfbench import spans
from perfbench import trace as tr
from perfbench.manifest import Manifest
from perfbench.span_table import table
from smplifyx_torch.problem import build_slice
from smplifyx_torch.utils import timing
from smplifyx_torch.utils.timing import Span

NEW = ("lane_evals_per_frame", "active_lane_share", "idle_in_eval",
       "idle_in_lbfgs", "live_pair_share")


def _span(name, start, end, parent, fit, **attrs):
    s = Span(name, start, parent, fit, attrs)
    s.end_ns = end
    return s


def _recorded():
    """An earlier fit outside the trace, then the traced fit: a stage with
    two evaluations and a broad phase."""
    return [
        _span("fit", -5000, -4000, None, 1, frames=2),
        _span("fit", 0, 1000, None, 2, frames=2),
        _span("stage", 10, 900, 1, 2, stage=0, collision=True, lanes=4,
              lane_evals=torch.tensor(6)),
        _span("evaluation", 100, 300, 2, 2, lanes=4, grad=True),
        _span("evaluation", 400, 600, 2, 2, lanes=4, grad=False),
        _span("broad_phase", 700, 800, 2, 2, refresh=False, slots=100,
              live=torch.tensor(5)),
    ]


def _run(busy_s=0.25, fit_s=1.0):
    kernels = [(f"k{i}", s, d, "fit") for i, (s, d) in enumerate(
        [(0, 10), (150, 50), (250, 200), (650, 70), (950, 50), (1100, 10)])]
    return SimpleNamespace(trace={"kernels": kernels, "busy_s": busy_s},
                           untraced=[{"seconds": fit_s}] * 3)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(timing.RECORDER, "spans", _recorded())


def test_idle_gaps_go_to_the_innermost_span(recorded):
    # gaps 10-150, 200-250, 450-650, 720-950, 1000-1100
    by = spans.idle_by_span(_run())
    assert by == {"stage": 90 + 50 + 100, "evaluation": 50 + 50 + 150,
                  "broad_phase": 80, "fit": 50, "outside": 100}


def test_the_idle_parts_add_up_to_idle_share(recorded):
    run = _run()
    share = spans.idle_share(run)
    assert share == pytest.approx(75.0)
    names = ("evaluation", "stage", "broad_phase", "fit", "outside")
    parts = [spans.idle_in(run, n) for n in names]
    assert sum(parts) == pytest.approx(share)
    assert parts[0] == pytest.approx(75.0 * 250 / 720)
    m = Manifest()
    assert m.reader("idle_in_eval.frames")(run) == parts[0]
    assert m.reader("idle_in_lbfgs.frames")(run) == parts[1]


def test_the_counters_readers(recorded):
    m = Manifest()
    run = _run()
    fits = spans.traced_fits(run)
    assert [s.fit for s in fits] == [2] * 5       # the earlier fit left out
    assert m.reader("lane_evals_per_frame.frames")(run) == 8 / 2
    assert m.reader("active_lane_share.frames")(run) == 100.0 * 6 / 8
    assert m.reader("live_pair_share.frames")(run) == 100.0 * 5 / 100


def test_the_table_splits_idle_by_stage_and_span():
    got = table(_run(), _recorded())
    assert got["idle_s"] == {
        "body 0": {"lbfgs_self": 240e-9, "evaluation": 250e-9,
                   "broad_phase": 80e-9},
        "no stage": {"fit_self": 50e-9, "outside": 100e-9}}
    pts = [v for row in got["idle_pts"].values() for v in row.values()]
    assert sum(pts) == pytest.approx(got["idle_share"])
    assert got["stages"] == {"body 0": {"evaluations": 2, "wall_s": 890e-9,
                                        "lanes": 4, "lane_evals": 6}}


@pytest.mark.parametrize("case", ["no_trace", "no_spans", "no_recorder"])
def test_the_readers_return_none_without_spans(monkeypatch, case):
    m = Manifest()
    run = _run()
    if case == "no_trace":
        monkeypatch.setattr(timing.RECORDER, "spans", _recorded())
        run.trace = None
    elif case == "no_spans":
        monkeypatch.setattr(timing.RECORDER, "spans", [])
    else:   # a program without the recorder
        monkeypatch.delattr(timing, "RECORDER")
    for name in NEW:
        assert m.reader(name)(run) is None, name


def test_the_programs_broad_phases_equal_the_harness_marks():
    """A tiny collision-on fit on the CPU under a CPU-only profiler: the
    program's broad phase spans against the harness's Recorder (its marks
    kept as a list: the card's spin kernel does not run here)."""
    from torch.profiler import ProfilerActivity, profile

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        session, model, jm, frames, x0 = build_slice(2, 96, device="cpu",
                                                     maxiters=3)
        harness = tr.Recorder()
        harness._mark = lambda name, edge: harness.marks.append((name, edge))
        harness.prime(model.lbs_weights, jm.sub_lbs)
        timing.RECORDER.clear()
        with harness.installed(session), \
                profile(activities=[ProfilerActivity.CPU]):
            session.fit(model, jm, frames, x0)
    finally:
        torch.set_num_threads(old)
    phases = sum(s.name == "broad_phase" for s in timing.RECORDER.spans)
    timing.RECORDER.clear()
    assert phases == harness.marks.count(("broad_phase", "start")) > 0
