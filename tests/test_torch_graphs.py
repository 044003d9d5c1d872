"""CUDA graphs over the plain-PyTorch stretches of every evaluation
(`smplifyx_torch/utils/graphs.py`), on the CPU.

A fit on the CPU makes no graph: every evaluation runs eagerly.  The
stage's machinery (record at the first evaluation, capture at the second,
replay through `_Replay`, static inputs and outputs) is driven here by a
stand-in for a CUDA graph that reruns the function captured at the second
evaluation on the segment's static tensors: its fits must equal the eager
ones bit for bit, which holds only where every segment is a function of
its arguments alone and its gradient adds up in the eager order.  The
card's own graphs are tested in `tests/test_torch_cuda.py`."""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import smplifyx_torch.fitting.pipeline as pipeline
from smplifyx_torch.utils import graphs, timing

from _fit_slices import KINDS, same_fit, slice_fit


class Rerun(graphs._Segment):
    """A segment whose graph is its captured function rerun on the static
    tensors: the forward writes the static outputs, the backward the static
    gradients of the inputs, as a replay does."""

    @staticmethod
    def capture_all(segs):
        for s in segs:
            s.capture_forward(None, None)
        for s in reversed(segs):
            s.capture_backward(None, None)

    def _run(self):
        run, graphs._local.run = getattr(graphs._local, "run", None), None
        try:
            with torch.enable_grad():
                out = self.fn(*self.inputs)
        finally:
            graphs._local.run = run
        self.tuple_out = isinstance(out, tuple)
        return graphs._flat(out)

    def capture_forward(self, pool, stream):
        self.outputs = tuple(o.detach().clone().requires_grad_(o.requires_grad)
                             for o in self._run())
        self.diff = tuple(o.requires_grad for o in self.outputs)

    def _grads(self, outs):
        wrt = [i for i in self.inputs if i.requires_grad]
        pairs = [(o, g) for o, g in zip(outs, self.grad_outputs)
                 if g is not None]
        if not (pairs and wrt):
            return [None] * len(wrt)
        return torch.autograd.grad([o for o, _ in pairs], wrt,
                                   [g for _, g in pairs], allow_unused=True)

    def capture_backward(self, pool, stream):
        self.grad_outputs = tuple(torch.zeros_like(o) if o.requires_grad
                                  else None for o in self.outputs)
        it = iter(self._grads(self._run()))
        self.grad_inputs = tuple(
            (lambda g: None if g is None else torch.zeros_like(g))(next(it))
            if i.requires_grad else None for i in self.inputs)

    def replay_forward(self):
        outs = self._run()
        with torch.no_grad():
            for s, o in zip(self.outputs, outs):
                s.copy_(o)
        self.live = outs

    def replay_backward(self):
        it = iter(self._grads(self.live))
        for s, i in zip(self.grad_inputs, self.inputs):
            g = next(it) if i.requires_grad else None
            if s is not None:
                s.copy_(g)


@pytest.fixture
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    timing.RECORDER.clear()
    yield
    timing.RECORDER.clear()
    torch.set_num_threads(old)


def test_capturable_reads_the_stage_inputs():
    card = SimpleNamespace(device=torch.device("cuda"))
    one, two = SimpleNamespace(blocks=(1,)), SimpleNamespace(blocks=(1, 2))
    assert pipeline._graphed(card, one, True, False)
    assert not pipeline._graphed(torch.zeros(1), one, True, False)
    assert not pipeline._graphed(card, one, False, False)   # first-order
    assert not pipeline._graphed(card, two, True, False)    # sharded model
    assert not pipeline._graphed(card, one, True, True)     # per-eval broad phase


def test_a_fit_on_the_cpu_makes_no_graph(monkeypatch, one_thread):
    decisions = []
    graphed = pipeline._graphed

    def spy(*a):
        decisions.append(graphed(*a))
        return decisions[-1]

    def refuse(*a, **kw):
        raise AssertionError("a graph was made on the CPU")

    monkeypatch.setattr(pipeline, "_graphed", spy)
    monkeypatch.setattr(graphs, "_Stage", refuse)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    fit, _ = slice_fit("combined", 2, 96, "cpu", maxiters=2)
    with profile(activities=[ProfilerActivity.CPU]):
        res = fit()
    evals = [s for s in timing.RECORDER.spans if s.name == "evaluation"]
    assert decisions == [False] * 3
    assert torch.isfinite(res.loss).all()
    assert evals and all(s.attrs["graphed_lanes"] == 0 for s in evals)


@pytest.mark.parametrize("kind", KINDS)
def test_replayed_segments_give_the_eager_fit(monkeypatch, one_thread, kind):
    """Bit-equal fits, every stage replaying from its second evaluation;
    each `evaluation` span's `graphed_lanes` says which did."""
    fit, _ = slice_fit(kind, 4, 600, "cpu", maxiters=5)
    eager = fit()
    captures = []
    capture_all = Rerun.capture_all

    def counted(segs):
        captures.append([s.name for s in segs])
        capture_all(segs)

    monkeypatch.setattr(Rerun, "capture_all", staticmethod(counted))
    monkeypatch.setattr(graphs._Stage, "segment_type", Rerun)
    monkeypatch.setattr(pipeline, "_graphed",
                        lambda x, model, lbfgs, bp: lbfgs and not bp)
    with profile(activities=[ProfilerActivity.CPU]):
        graphed = fit()
    assert same_fit(eager, graphed) == {}
    head = ["vposer"] if kind == "vposer" else []
    body = head + ["skin_inputs", "energy"]
    assert captures == [body, body, body + ["penalty"] * (kind != "nocoll")]
    spans = timing.RECORDER.spans
    for i, st in enumerate(s for s in spans if s.name == "stage"):
        evals = [s for s in spans if s.name == "evaluation"
                 and s.parent == spans.index(st)]
        assert [s.attrs["graphed_lanes"] for s in evals] == \
            [0] + [s.attrs["lanes"] for s in evals[1:]], i


def test_replayed_segments_take_a_refreshed_pair_list(monkeypatch, one_thread):
    """With a broad phase every 3 iterations the collision stage refreshes
    its pair list after its capture: the replays take the new pairs and
    mask, and the fit stays bit-equal to the eager one."""
    from smplifyx_torch.ops.collision import CollisionFn

    fit, _ = slice_fit("combined", 4, 600, "cpu", maxiters=7,
                       coll_broad_every=3)
    eager = fit()
    captures, refreshes = [], []
    capture_all, build_refresh = Rerun.capture_all, CollisionFn.build_refresh

    def counted(segs):
        captures.append(1)
        capture_all(segs)

    def refresh(fn, *a):
        refreshes.append(len(captures))
        return build_refresh(fn, *a)

    monkeypatch.setattr(Rerun, "capture_all", staticmethod(counted))
    monkeypatch.setattr(CollisionFn, "build_refresh", refresh)
    monkeypatch.setattr(graphs._Stage, "segment_type", Rerun)
    monkeypatch.setattr(pipeline, "_graphed",
                        lambda x, model, lbfgs, bp: lbfgs and not bp)
    graphed = fit()
    assert len(captures) == 3 and refreshes.count(3) >= 1
    assert same_fit(eager, graphed) == {}


def _stage(segment_type=Rerun):
    st = graphs._Stage()
    st.segment_type = segment_type
    return st


def test_a_replay_refuses_another_segment_than_captured():
    st = _stage()
    x = torch.ones(3, requires_grad=True)
    with st.evaluation(True) as graphed:
        assert not graphed
        graphs.segment("a", torch.sin, x)
    with pytest.raises(RuntimeError, match="does not match"):
        with st.evaluation(True):
            graphs.segment("b", torch.sin, x)
    with pytest.raises(RuntimeError, match="ran 0 segments"):
        with st.evaluation(True):
            pass


def test_outside_a_stage_a_segment_is_its_function():
    calls = []
    assert graphs.segment("a", lambda t: calls.append(t) or t + 1,
                          torch.ones(1)).item() == 2.0
    assert len(calls) == 1
    with graphs.stage(False), graphs.evaluation(True) as graphed:
        assert not graphed
        assert graphs.segment("a", torch.neg, torch.ones(1)).item() == -1.0


def test_an_unchanged_input_is_copied_in_once():
    """The collision aux's pair mask between two broad phases: the same
    tensor, unchanged, is not copied again; changed in place, it is."""
    static = torch.zeros(3)
    seg = graphs._Segment("penalty", None, (static,))
    mask = torch.ones(3)
    seg.load((mask,))
    assert torch.equal(static, mask)
    static.zero_()
    seg.load((mask,))
    assert not static.any()
    mask.mul_(2.0)
    seg.load((mask,))
    assert torch.equal(static, mask)
    seg.load((torch.full((3,), 5.0),))
    assert static.tolist() == [5.0] * 3


def test_a_stage_ending_before_its_second_evaluation_captures_nothing(
        monkeypatch):
    monkeypatch.setattr(Rerun, "capture_all", staticmethod(
        lambda segs: pytest.fail("captured")))
    st = _stage()
    x = torch.ones(2, requires_grad=True)
    with st.evaluation(True):
        graphs.segment("a", torch.cos, x)
    st.close()
    assert st.segs is None and st.calls is None
