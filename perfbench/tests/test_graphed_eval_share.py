"""The reader of `graphed_eval_share` on hand-made spans: the evaluation
spans' `graphed_lanes` over their `lanes` in the traced fit, and None where
no evaluation span carries the attribute (a program without graphed
evaluations) or the traced fit has no evaluation span."""

import pytest

from perfbench.manifest import Manifest
from perfbench.tests.test_spans import _recorded, _run, _span
from smplifyx_torch.utils import timing

NAME = "graphed_eval_share.frames"


def _with_graphs(*graphed):
    """The traced fit of `test_spans`, its evaluations carrying
    `graphed_lanes` (None: an evaluation span without it)."""
    spans = [s for s in _recorded() if s.name != "evaluation"]
    for i, g in enumerate(graphed):
        attrs = {"lanes": 4, "grad": True}
        if g is not None:
            attrs["graphed_lanes"] = g
        spans.append(_span("evaluation", 100 + 100 * i, 150 + 100 * i, 2, 2,
                           **attrs))
    return spans


@pytest.mark.parametrize("graphed,share", [
    ((0, 4, 4, 4), 75.0),
    ((4, 4), 100.0),
    ((0, 0), 0.0),
    ((0, 4, None), 100.0 * 4 / 12),
])
def test_the_reader_sums_the_evaluations(monkeypatch, graphed, share):
    monkeypatch.setattr(timing.RECORDER, "spans", _with_graphs(*graphed))
    assert Manifest().reader(NAME)(_run()) == share


def test_spans_without_the_attribute_read_none(monkeypatch):
    """The parent's spans: `lane_evals_per_frame` still reads them."""
    monkeypatch.setattr(timing.RECORDER, "spans", _recorded())
    m = Manifest()
    assert m.reader(NAME)(_run()) is None
    assert m.reader("lane_evals_per_frame.frames")(_run()) == 8 / 2


@pytest.mark.parametrize("case", ["no_evaluations", "no_trace", "no_spans",
                                  "no_recorder"])
def test_the_reader_returns_none_without_evaluations(monkeypatch, case):
    run = _run()
    if case == "no_evaluations":
        monkeypatch.setattr(timing.RECORDER, "spans", _with_graphs())
    elif case == "no_trace":
        monkeypatch.setattr(timing.RECORDER, "spans", _with_graphs(4))
        run.trace = None
    elif case == "no_spans":
        monkeypatch.setattr(timing.RECORDER, "spans", [])
    else:   # a program without the recorder
        monkeypatch.delattr(timing, "RECORDER")
    assert Manifest().reader(NAME)(run) is None
