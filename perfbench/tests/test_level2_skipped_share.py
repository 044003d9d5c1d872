"""The reader of `level2_skipped_share` on hand-made spans: the broad
phase spans' `l2_skipped` over `l2_slots` in the traced fit, and None
where the spans carry neither (a program without kernel K4)."""

import pytest
import torch

from perfbench.manifest import Manifest
from perfbench.tests.test_spans import _recorded, _run, _span
from smplifyx_torch.utils import timing

NAME = "level2_skipped_share.frames"


def _with_level2(*phases):
    """The traced fit of `test_spans`, its broad phases carrying the two
    attributes: one (l2_slots, l2_skipped) pair per broad phase."""
    spans = [s for s in _recorded() if s.name != "broad_phase"]
    for i, (slots, skipped) in enumerate(phases):
        spans.append(_span("broad_phase", 700 + 100 * i, 750 + 100 * i, 2,
                           2, refresh=i > 0, slots=100,
                           live=torch.tensor(5 - i), l2_slots=slots,
                           l2_skipped=torch.tensor(skipped)))
    return spans


@pytest.mark.parametrize("phases,share", [
    ([(40, 12)], 100.0 * 12 / 40),
    ([(40, 12), (40, 30)], 100.0 * 42 / 80),
    ([(40, 0)], 0.0),
    ([(40, 40)], 100.0),
])
def test_the_reader_sums_the_broad_phases(monkeypatch, phases, share):
    monkeypatch.setattr(timing.RECORDER, "spans", _with_level2(*phases))
    assert Manifest().reader(NAME)(_run()) == share


def test_spans_without_the_attributes_read_none(monkeypatch):
    """The parent's spans: `live_pair_share` still reads them."""
    monkeypatch.setattr(timing.RECORDER, "spans", _recorded())
    m = Manifest()
    run = _run()
    assert m.reader(NAME)(run) is None
    assert m.reader("live_pair_share.frames")(run) == 100.0 * 5 / 100


@pytest.mark.parametrize("case", ["no_trace", "no_spans", "no_recorder"])
def test_the_reader_returns_none_without_spans(monkeypatch, case):
    run = _run()
    if case == "no_trace":
        monkeypatch.setattr(timing.RECORDER, "spans", _with_level2((40, 12)))
        run.trace = None
    elif case == "no_spans":
        monkeypatch.setattr(timing.RECORDER, "spans", [])
    else:   # a program without the recorder
        monkeypatch.delattr(timing, "RECORDER")
    assert Manifest().reader(NAME)(run) is None
