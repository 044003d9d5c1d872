"""The span recorder (`smplifyx_torch/utils/timing.py`): its clock is the
profiler's, it records nothing outside a profiler, recording changes no
result, and the fit's spans match the work that ran (a tiny collision-on
fit on the CPU, both orientations, under a CPU-only profiler)."""

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import smplifyx_torch.fitting.pipeline as pipeline
from smplifyx_torch.fitting.lbfgs import LBFGSConfig, minimize
from smplifyx_torch.fitting.optimizers import make_optimizer, minimize_first_order
from smplifyx_torch.ops.gather import row_plan
from smplifyx_torch.problem import build_slice
from smplifyx_torch.utils import timing

B, V = 2, 96


def profiled():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture
def rec():
    timing.RECORDER.clear()
    yield timing.RECORDER
    timing.RECORDER.clear()


@pytest.fixture(scope="module")
def fits():
    """The slice fitted unprofiled, then profiled with the work it did
    counted beside the recorder: energy calls, broad phases with their
    live pairs, row plans built."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    try:
        session, model, jm, frames, x0 = build_slice(B, V, device="cpu",
                                                     maxiters=3)
        timing.RECORDER.clear()
        plain = session.fit(model, jm, frames, x0)
        untraced = list(timing.RECORDER.spans)

        seen = Counter()

        def counted(name, fn):
            def wrapper(*a, **kw):
                seen[name] += 1
                return fn(*a, **kw)
            return wrapper

        for name in ("smplify_energy", "camera_init_energy"):
            mp.setattr(pipeline, name, counted("energy",
                                               getattr(pipeline, name)))
        cf = session.collision_fn
        live = []
        for name in ("build", "build_refresh"):
            def phase(*a, _f=getattr(cf, name), **kw):
                aux = _f(*a, **kw)
                live.append(int(aux.valid.sum()))
                return aux
            mp.setattr(cf, name, phase, raising=False)
        plans = row_plan.builds
        with profiled():
            traced = session.fit(model, jm, frames, x0)
        plans = row_plan.builds - plans
        spans = list(timing.RECORDER.spans)
        timing.RECORDER.clear()
        return dict(plain=plain, traced=traced, untraced=untraced,
                    spans=spans, seen=seen, live=live,
                    plans=plans, stages=session.schedule.num_stages)
    finally:
        mp.undo()
        torch.set_num_threads(old)


def test_a_span_holds_a_cpu_ops_profiler_stamps(rec):
    """time.time_ns() and the profiler's event times share one clock."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert timing.recording()
        with timing.span("op") as sp:
            x * x
    assert not timing.recording()
    mul = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mul"]
    assert len(mul) == 1
    assert sp.start_ns <= mul[0].start_ns() <= mul[0].end_ns() <= sp.end_ns
    assert rec.spans == [sp]


def test_an_untraced_fit_records_nothing(fits):
    assert fits["untraced"] == []


def test_off_a_span_is_the_shared_null_context(rec):
    assert not timing.recording()
    assert timing.span("x") is timing.span("y", fit=True, lanes=3)
    with timing.span("x") as sp:
        assert sp is None
    assert rec.spans == []


def test_recording_changes_no_result(fits):
    plain, traced = fits["plain"], fits["traced"]
    assert torch.equal(plain.x, traced.x)
    assert torch.equal(plain.loss, traced.loss)
    assert torch.equal(plain.stage_evals, traced.stage_evals)
    assert plain.host_reads == traced.host_reads


def test_the_span_tree_follows_the_fit(fits):
    spans, S = fits["spans"], fits["stages"]
    names = Counter(s.name for s in spans)
    fit, = [s for s in spans if s.name == "fit"]
    assert fit.parent is None and fit.attrs["frames"] == B
    assert all(s.fit == fit.fit for s in spans)
    assert all(s.end_ns is not None and s.start_ns <= s.end_ns for s in spans)
    stages = [s for s in spans if s.name == "stage"]
    assert len(stages) == 1 + S
    assert [s.attrs["stage"] for s in stages] == ["camera", *range(S)]
    assert [s.attrs["lanes"] for s in stages] == [B] + [2 * B] * S
    assert all(spans[s.parent] is fit for s in stages)
    # one evaluation span per batched call of the energy, inside a stage
    assert names["evaluation"] == fits["seen"]["energy"] > 0
    for s in spans:
        if s.name == "evaluation":
            assert spans[s.parent].name == "stage"
            assert s.attrs["lanes"] == spans[s.parent].attrs["lanes"]
    # a broad phase builds two row plans
    assert names["broad_phase"] * 2 == fits["plans"] > 0


def test_stage_evaluations_are_the_lanes_counts_before_the_choice(fits):
    stages = [s for s in fits["spans"] if s.name == "stage"]
    traced = fits["traced"]
    assert int(stages[0].attrs["lane_evals"]) == int(traced.camera_evals.sum())
    # the body stages count both orientations: at least the winner's
    for s, winner in zip(stages[1:], traced.stage_evals):
        assert int(s.attrs["lane_evals"]) >= int(winner.sum())
    lanes = sum(s.attrs["lanes"] for s in fits["spans"]
                if s.name == "evaluation")
    assert 0 < sum(int(s.attrs["lane_evals"]) for s in stages) <= lanes


def test_broad_phase_spans_hold_their_live_pairs(fits):
    phases = [s for s in fits["spans"] if s.name == "broad_phase"]
    assert [int(s.attrs["live"]) for s in phases] == fits["live"]
    assert sum(fits["live"]) > 0
    assert all(s.attrs["slots"] > 0 for s in phases)
    assert [s.attrs["refresh"] for s in phases].count(False) == 2


def test_broad_phase_spans_count_level2_slots_and_skipped_ones(rec):
    """`l2_slots` is B x Phs and `l2_skipped` the slots whose block-pair
    mask level 1 left empty, in build and in build_refresh."""
    from smplifyx_torch.ops import collision as tc

    gen = torch.Generator().manual_seed(0)
    nv, nf = 400, 600
    verts = torch.rand(2, nv, 3, generator=gen)
    base = torch.randint(0, nv - 3, (nf, 1), generator=gen)
    fn = tc.make_collision_fn(torch.cat([base, base + 1, base + 2], dim=1),
                              max_pairs=512, max_tris=256)
    mb_h = fn.run_steps({"vertices": verts},
                        fn.BUILD_STEPS[:fn.BUILD_STEPS.index("level2")])["mb_h"]
    empty = int((~mb_h.any(-1)).sum())
    with profiled():
        fn.build_refresh(verts, fn.build(verts))
    phases = [s for s in rec.spans if s.name == "broad_phase"]
    assert [s.attrs["refresh"] for s in phases] == [False, True]
    for s in phases:
        assert s.attrs["l2_slots"] == 2 * fn.Phs == 200
        assert int(s.attrs["l2_skipped"]) == empty
    assert 0 < empty < 200


def test_first_order_and_lbfgs_evaluations_are_spans(rec):
    """Outside a fit: every batched call of the objective is a span."""
    target = torch.tensor([[1.0, -2.0], [0.5, 3.0], [2.0, 2.0]])
    calls = []

    def fun(x):
        calls.append(x.shape[0])
        return ((x - target) ** 2).sum(-1)

    x0 = torch.zeros(3, 2)
    with profiled():
        minimize(fun, x0, cfg=LBFGSConfig(max_iters=5, ls_mode="armijo"))
        minimize(fun, x0, cfg=LBFGSConfig(max_iters=5))
        minimize_first_order(fun, x0, make_optimizer("adam", 0.1),
                             max_iters=4)
    evals = [s for s in rec.spans if s.name == "evaluation"]
    assert [s.attrs["lanes"] for s in evals] == calls
    assert all(s.parent is None and s.fit is None for s in evals)
    # Armijo's trials are values only; every other call takes the gradient
    assert {s.attrs["grad"] for s in evals} == {True, False}


def test_timer_spans_stay_out_of_the_record(rec):
    timer = timing.Timer()
    with profiled():
        with timer.span("fit"):
            with timing.span("fit", fit=True, frames=1):
                pass
    inner, = rec.spans
    assert (inner.name, inner.parent) == ("fit", None)
    assert inner.fit is not None and set(timer.spans) == {"fit"}


def test_a_span_opened_in_a_span_records_after_the_profiler_stops(rec):
    """The tree stays whole: the open span's children record."""
    prof = profiled()
    prof.__enter__()
    try:
        outer = timing.span("fit", fit=True, frames=1)
        sp = outer.__enter__()
    finally:
        prof.__exit__(None, None, None)
    assert timing.recording()
    with timing.span("stage", stage="camera") as child:
        pass
    outer.__exit__(None, None, None)
    assert not timing.recording()
    assert rec.spans == [sp, child] and child.parent == 0
    assert child.fit == sp.fit is not None


def test_the_record_is_bounded(rec, monkeypatch):
    """Past its limit, a span opened while none is open starts the record
    afresh; one opened inside a span does not."""
    monkeypatch.setattr(rec, "limit", 3)
    with profiled():
        for _ in range(2):
            with timing.span("a"):
                pass
        with timing.span("fit", fit=True) as fit:
            for _ in range(3):
                with timing.span("evaluation"):
                    pass
        assert len(rec.spans) == 6
        with pytest.raises(RuntimeError):
            with timing.span("b"):
                rec.clear()
        assert [s.name for s in rec.spans] == ["b"]
    assert fit.end_ns is not None
