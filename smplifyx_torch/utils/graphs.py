"""CUDA graphs over the plain-PyTorch stretches of every evaluation.

An evaluation of a stage's objective (fitting/lbfgs.py `minimize`) is a
few stretches of plain PyTorch with a hand-written kernel between two of
them: the VPoser decode; flat parameters to skinning's inputs (blends,
Rodrigues, the kinematic chain); skinning (K1); skinning's consumers to
the energy without the collision term (landmarks, projection, robustifier,
priors); the pair gather (K2); the cone penalty.  Backward, autograd runs
the same stretches back, with K1's VJP and K3 between them.  On the card
each stretch is hundreds of small launches, and the host's time to issue
them is most of a fit.

The energy writes each stretch as `segment(name, fn, *tensors)`: fn is a
function of its tensor arguments alone, and what it closes over (the
model's tables, the stage's frames and weights) stays fixed for a stage.
Outside a graphed stage `segment` is `fn(*tensors)`: the eager path, the
only one on the CPU.

Inside one (`stage`, which fitting/pipeline.py enables for a stage on the
card), the stage's first evaluation runs eagerly and keeps each segment's
function and a copy of its arguments.  At the second, every segment is captured as a CUDA graph,
forward and backward, in one memory pool of the stage, and that evaluation
and every later one replays them (`_Replay`, an autograd function, so
autograd stitches the graphs to the eager kernels between them).  The
hand-written kernels are never captured: each launch is still an eager
call through its Python wrapper.  A stage that ends before its second
evaluation captures nothing; the graphs are dropped when the stage ends.

A replay copies an argument into its graph's static input unless it is
that input already, or the same tensor as at the last replay, unchanged
(the collision aux's pair mask between two broad phases).  Its outputs
are the graph's static outputs, which the next replay overwrites: a
caller keeps a value across evaluations by cloning it.
"""

from __future__ import annotations

import contextlib
import threading
import weakref

import torch

# .stage: the graphed stage on this thread; .run: how a segment runs in its
# evaluation; .streams: device index -> the thread's warm-up and capture
# stream (two threads never capture on one stream).
_local = threading.local()


@contextlib.contextmanager
def stage(enabled: bool):
    """The evaluations of the `minimize` call inside run from graphs when
    `enabled`; the graphs and their pool go when the block ends."""
    prev = getattr(_local, "stage", None)
    st = _local.stage = _Stage() if enabled else None
    try:
        yield
    finally:
        _local.stage = prev
        if st is not None:
            st.close()


@contextlib.contextmanager
def evaluation(grad: bool):
    """One evaluation of the stage's objective; yields True when its
    segments replay from graphs, False when they run eagerly."""
    st = getattr(_local, "stage", None)
    if st is None:
        yield False
        return
    with st.evaluation(grad) as graphed:
        yield graphed


def segment(name: str, fn, *args: torch.Tensor):
    """fn(*args), a stretch of plain PyTorch in an evaluation (a tensor or
    a tuple of tensors), from a graph where the evaluation replays them."""
    run = getattr(_local, "run", None)
    return fn(*args) if run is None else run(name, fn, args)


def _flat(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


class _Segment:
    """One captured stretch: its graphs and their static tensors."""

    def __init__(self, name, fn, args):
        self.name, self.fn = name, fn
        self.inputs = args              # static inputs: copies of the first
        self.last = [None] * len(args)  # (weakref, version) last copied in
        self.tuple_out = False
        self.outputs = self.diff = None
        self.grad_outputs = self.grad_inputs = None
        self.fwd = self.bwd = None

    def warm_up(self):
        """One eager pass forward and back, on the capture stream, so that
        nothing is initialised lazily inside a capture."""
        outs = _flat(self.fn(*self.inputs))
        diff = [o for o in outs if o.requires_grad]
        wrt = [i for i in self.inputs if i.requires_grad]
        if diff and wrt:
            _vjp(diff, wrt, [torch.zeros_like(o) for o in diff])

    def capture_forward(self, pool, stream):
        self.fwd = torch.cuda.CUDAGraph()
        with _capturing(self.fwd, pool, stream):
            out = self.fn(*self.inputs)
        self.tuple_out = isinstance(out, tuple)
        self.outputs = _flat(out)
        self.diff = tuple(o.requires_grad for o in self.outputs)

    def capture_backward(self, pool, stream):
        diff = [o for o in self.outputs if o.requires_grad]
        wrt = [i for i in self.inputs if i.requires_grad]
        self.grad_outputs = tuple(torch.empty_like(o) if o.requires_grad
                                  else None for o in self.outputs)
        grads = [None] * len(wrt)
        if diff and wrt:
            self.bwd = torch.cuda.CUDAGraph()
            with _capturing(self.bwd, pool, stream):
                grads = _vjp(diff, wrt,
                             [g for g in self.grad_outputs if g is not None])
        it = iter(grads)
        self.grad_inputs = tuple(next(it) if i.requires_grad else None
                                 for i in self.inputs)

    @staticmethod
    def capture_all(segs):
        """Warm every segment up, then capture the forwards in order and
        the backwards in reverse, the order they replay in, into one
        pool."""
        dev = segs[0].inputs[0].device
        stream = _capture_stream(dev)
        pool = torch.cuda.graph_pool_handle()
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.enable_grad():
            with torch.cuda.stream(stream):
                for s in segs:
                    s.warm_up()
            for s in segs:
                s.capture_forward(pool, stream)
            for s in reversed(segs):
                s.capture_backward(pool, stream)
        torch.cuda.current_stream(dev).wait_stream(stream)

    def replay_forward(self):
        self.fwd.replay()

    def replay_backward(self):
        if self.bwd is not None:
            self.bwd.replay()

    def load(self, args):
        """Bring the arguments into the static inputs."""
        for k, (s, a) in enumerate(zip(self.inputs, args)):
            if a is s or s.data_ptr() == a.data_ptr():
                continue
            last = self.last[k]
            if last is not None and last[0]() is a and last[1] == a._version:
                continue
            s.copy_(a)
            self.last[k] = (weakref.ref(a), a._version)

    def close(self):
        for g in (self.fwd, self.bwd):
            if g is not None:
                g.reset()
        self.fn = self.inputs = self.last = self.outputs = None
        self.grad_outputs = self.grad_inputs = None


class _Replay(torch.autograd.Function):
    """A segment's forward graph, with its backward graph as the VJP."""

    @staticmethod
    def forward(ctx, seg: _Segment, *args):
        seg.load(args)
        seg.replay_forward()
        ctx.seg = seg
        outs = tuple(o.detach() for o in seg.outputs)
        ctx.mark_non_differentiable(
            *(o for o, d in zip(outs, seg.diff) if not d))
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        seg = ctx.seg
        for s, g in zip(seg.grad_outputs, grads):
            if s is None:
                continue
            if g is None:
                s.zero_()
            elif s.data_ptr() != g.data_ptr():
                s.copy_(g)
        seg.replay_backward()
        return (None, *(g.detach() if g is not None else None
                        for g in seg.grad_inputs))


class _Stage:
    """The graphs of one stage: recorded at its first evaluation, captured
    at its second, replayed from then on."""

    segment_type = _Segment

    def __init__(self):
        self.calls = None       # [(name, fn, argument copies)], first evaluation
        self.segs = None        # [_Segment] once captured
        self.pos = 0

    @contextlib.contextmanager
    def evaluation(self, grad: bool):
        if self.segs is None and self.calls is not None:
            self._capture()
        if self.segs is None:
            run = self._record if grad and self.calls is None else None
            graphed = False
        else:
            run, graphed, self.pos = self._replay, True, 0
        _local.run = run
        try:
            yield graphed
        finally:
            _local.run = None
        if graphed and self.pos != len(self.segs):
            raise RuntimeError(
                f"an evaluation ran {self.pos} segments; the stage captured "
                f"{len(self.segs)}")

    def _record(self, name, fn, args):
        if self.calls is None:
            self.calls = []
        self.calls.append((name, fn, tuple(
            a.detach().clone().requires_grad_(a.requires_grad) for a in args)))
        _local.run = None       # nothing inside fn is a segment of its own
        try:
            return fn(*args)
        finally:
            _local.run = self._record

    def _replay(self, name, fn, args):
        if self.pos >= len(self.segs):
            raise RuntimeError(f"segment {name!r} past the {len(self.segs)} "
                               "the stage captured")
        seg = self.segs[self.pos]
        self.pos += 1
        if seg.name != name or len(args) != len(seg.inputs) or any(
                a.shape != s.shape or a.dtype != s.dtype or a.device != s.device
                or (a.requires_grad and not s.requires_grad)
                for a, s in zip(args, seg.inputs)):
            raise RuntimeError(f"segment {name!r} does not match the stage's "
                               f"capture of {seg.name!r}")
        out = _Replay.apply(seg, *args)
        return out if seg.tuple_out else out[0]

    def _capture(self):
        segs = [self.segment_type(*c) for c in self.calls]
        self.calls = None
        self.segment_type.capture_all(segs)
        self.segs = segs

    def close(self):
        for s in self.segs or ():
            s.close()
        self.segs = self.calls = None


def _vjp(outputs, inputs, grad_outputs) -> tuple:
    """The gradients of `outputs` with respect to `inputs` (None where
    unused) given the outputs' own: autograd's engine, called as
    `torch.autograd.grad` calls it.  `torch.autograd.grad` itself, handed
    output gradients, first imports torch.fx's symbolic shapes and sympy:
    seconds in a fresh process, which every process's first capture
    would pay."""
    return torch.autograd.Variable._execution_engine.run_backward(
        tuple(outputs), tuple(grad_outputs), False, False, tuple(inputs),
        True, False)


@contextlib.contextmanager
def _capturing(graph, pool, stream):
    """Capture the block's work into `graph`, on `stream`, its memory from
    `pool`.  Unlike `torch.cuda.graph` it leaves the allocator's cache as
    it is, and only the capturing thread is held to capture's rules (a
    server's other threads go on using the card)."""
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            yield
        finally:
            graph.capture_end()


def _capture_stream(dev: torch.device):
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    s = streams.get(dev.index)
    if s is None:
        s = streams[dev.index] = torch.cuda.Stream(dev)
    return s
