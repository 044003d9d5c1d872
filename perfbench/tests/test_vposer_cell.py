"""The combined VPoser cell by files: its configuration is the combined
one with the VPoser keys of `_vposer.py::VPOSER` written in, its traffic
the combined traffic with the latents' spread, every metric that lists it
has a reader, and `idle_in_vposer` reads the idle time under the
program's `vposer` spans (hand-made spans and kernels).  A tiny run of the
configuration is `test_run.py::test_a_vposer_run_is_correct` (the combined
cell under `VPOSER`, which the configuration equals), and its spans are
held in tests/test_torch_tracing.py."""

from types import SimpleNamespace

import pytest
import torch

from perfbench.cell import _merge
from perfbench.manifest import Manifest
from perfbench.tests._vposer import VPOSER
from smplifyx_torch.utils import timing
from smplifyx_torch.utils.timing import Span

CELL = "combined-vposer-b128"
# Keys of the configuration file that say where it comes from and how it
# is judged, not what runs.
ABOUT = {"name", "source", "assumed", "correct_limits", "correct_limits_why"}


@pytest.fixture(scope="module")
def manifest():
    return Manifest()


def test_the_cell_resolves_its_configuration_and_traffic(manifest):
    cell = manifest.workload(CELL)
    assert cell["chips"] == 1
    conf = manifest.config(cell["config"])
    assert conf["name"] == cell["config"] == "smplx-combined-vposer-coco25"
    entry, = [c for c in manifest.data["configs"] if c["name"] == conf["name"]]
    assert entry["source"] == conf["source"]
    assert entry["reduced"] == conf["reduced"] == ["use_gender_classifier"]
    traffic = manifest.traffic(cell["traffic"])
    assert traffic == {**manifest.traffic("offline-b128"),
                       "vposer_latent_std": 1.45}


def test_the_configuration_is_the_combined_one_with_vposer(manifest):
    mine = manifest.config("smplx-combined-vposer-coco25")
    combined = manifest.config("smplx-combined-coco25")
    want = _merge(combined, VPOSER["config"])
    assert {k: v for k, v in mine.items() if k not in ABOUT} == \
        {k: v for k, v in want.items() if k not in ABOUT}
    assert mine["assumed"][:len(combined["assumed"])] == combined["assumed"]
    assert len(mine["assumed"]) == len(combined["assumed"]) + 2
    assert set(mine["correct_limits"]) == set(combined["correct_limits"])
    assert set(mine["correct_limits_why"]) == set(mine["correct_limits"])


def test_every_metric_that_lists_the_cell_has_a_reader(manifest):
    listed = [m for kind in ("end_to_end", "per_layer")
              for m in manifest.metrics(kind, CELL)]
    names = {m["name"] for m in listed}
    assert {"frames_per_s", "setup_s", "idle_in_vposer.frames"} <= names
    # the cell reports every per-layer metric combined-b128 reports
    assert {m["name"] for m in manifest.metrics("per_layer", "combined-b128")} \
        < names
    for m in listed:
        assert callable(manifest.reader(m["name"])), m["name"]


def _span(name, start, end, parent, fit, **attrs):
    s = Span(name, start, parent, fit, attrs)
    s.end_ns = end
    return s


def _recorded():
    """An encode before the traced fit; in the fit one evaluation with a
    decode and the decode's backward, and one value-only evaluation with
    a decode."""
    return [
        _span("vposer", -200, -100, None, None, lanes=2, encode=True),
        _span("fit", 0, 1000, None, 1, frames=2),
        _span("stage", 10, 900, 1, 1, stage=0, collision=False, lanes=4,
              lane_evals=torch.tensor(6)),
        _span("evaluation", 100, 500, 2, 1, lanes=4, grad=True),
        _span("vposer", 120, 200, 3, 1, lanes=4, grad=True),
        _span("vposer", 380, 480, 3, 1, lanes=4, backward=True),
        _span("evaluation", 600, 800, 2, 1, lanes=4, grad=False),
        _span("vposer", 610, 650, 6, 1, lanes=4, grad=False),
    ]


def _run(kernels):
    return SimpleNamespace(
        trace={"kernels": [(f"k{i}", s, d, "fit")
                           for i, (s, d) in enumerate(kernels)],
               "busy_s": 0.25},
        untraced=[{"seconds": 1.0}] * 3)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(timing.RECORDER, "spans", _recorded())


def test_idle_in_vposer_counts_the_gaps_under_the_vposer_spans(recorded,
                                                                manifest):
    # gaps 140-160 (forward decode), 250-300 (evaluation), 400-450
    # (the decode's backward), 700-750 (evaluation)
    run = _run([(0, 140), (160, 90), (300, 100), (450, 250), (750, 250)])
    read = manifest.reader("idle_in_vposer.frames")
    share = manifest.reader("idle_share.frames")(run)
    assert read(run) == pytest.approx(share * (20 + 50) / 170)
    assert manifest.reader("idle_in_eval.frames")(run) == \
        pytest.approx(share * 100 / 170)


def test_idle_in_vposer_leaves_out_a_gap_under_an_evaluation(recorded,
                                                             manifest):
    run = _run([(0, 250), (300, 700)])       # one gap, 250-300
    assert manifest.reader("idle_in_vposer.frames")(run) == 0.0
    assert manifest.reader("idle_in_eval.frames")(run) > 0


@pytest.mark.parametrize("case", ["no_trace", "no_spans", "no_vposer_span",
                                  "no_recorder"])
def test_idle_in_vposer_is_none_without_vposer_spans(monkeypatch, manifest,
                                                     case):
    run = _run([(0, 140), (160, 90), (300, 100), (450, 250), (750, 250)])
    spans = _recorded()
    if case == "no_trace":
        run.trace = None
    elif case == "no_spans":
        spans = []
    elif case == "no_vposer_span":       # a program before the span
        spans = [s for s in spans if s.name != "vposer"]
        for s, parent in zip(spans[2:], (1, 2, 2)):
            s.parent = parent
    monkeypatch.setattr(timing.RECORDER, "spans", spans)
    if case == "no_recorder":
        monkeypatch.delattr(timing, "RECORDER")
    assert manifest.reader("idle_in_vposer.frames")(run) is None
