"""The traced window: spans the benchmark marks around its calls into the
program, the wrappers that record the shapes of the hand-written kernels'
launches, and the reading of a torch.profiler run (CUDA activity only:
recording the CPU ops would stretch the host's time several-fold) into
device-busy time, idle gaps and kernel sums.

A span is marked on the device: a one-cycle `torch.cuda._sleep` kernel
(`spin_kernel`) at its start and at its end.  The program runs on one
stream, so the kernels between two marks in the trace are the span's.
The spans are `prepare`, `fit` and `recover` around the window's three
calls, and `broad_phase` around every `CollisionFn.build` and
`build_refresh` of the session's collision term.  The marks are launched
only in a traced run.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

MARK = "spin_kernel"
# Host calls that wait for the device: a read of a device value.
HOST_READS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
              "cudaEventSynchronize")


def kernel_name(key: str) -> str:
    """A kernel's profiler name without a leading `void` and its parameter
    list (the last parenthesised group; names hold `(anonymous
    namespace)`)."""
    name, depth = key[5:] if key.startswith("void ") else key, 0
    if name.endswith(")"):
        for i in range(len(name) - 1, 0, -1):
            if name[i] == ")":
                depth += 1
            elif name[i] == "(":
                depth -= 1
                if depth == 0:
                    return name[:i].rstrip()
    return name


def kernel_base(name: str) -> str:
    """A kernel's own name: `kernel_name` without namespaces and template
    arguments (`(anonymous namespace)::lbs_kernel<4>` -> `lbs_kernel`)."""
    return name.split("<")[0].split("::")[-1]


class Recorder:
    """Spans, and the shapes of K1's and K3's launches, recorded around the
    program's own calls while the traced window runs."""

    def __init__(self):
        self.marks = []     # (span, "start" | "end") in launch order
        self.k1 = []        # (B, V, J, nnz) per launch
        self.k3 = []        # (B, R, C, num_rows) per launch
        self._nnz = {}

    @contextlib.contextmanager
    def span(self, name: str):
        self._mark(name, "start")
        try:
            yield
        finally:
            self._mark(name, "end")

    def _mark(self, name, edge):
        torch.cuda._sleep(1)
        self.marks.append((name, edge))

    def prime(self, *weights):
        """Count the nonzeros of the skinning weights the window will pass
        to K1, before the window: counting reads the device."""
        for w in weights:
            self._nnz[(w.data_ptr(), tuple(w.shape))] = int((w != 0).sum())

    @contextlib.contextmanager
    def installed(self, session):
        import smplifyx_torch.models.forward as fwd
        import smplifyx_torch.models.sparse as sparse
        import smplifyx_torch.ops.collision as coll

        saved = [(fwd, "lbs_apply", fwd.lbs_apply),
                 (sparse, "lbs_apply", sparse.lbs_apply),
                 (coll, "scatter_add_rows", coll.scatter_add_rows)]
        k1, k3 = saved[0][2], saved[2][2]

        def lbs_apply(weights, A, v_posed, plan=None):
            key = (weights.data_ptr(), tuple(weights.shape))
            self.k1.append((v_posed.shape[0], weights.shape[0],
                            weights.shape[1], self._nnz.get(key)))
            return k1(weights, A, v_posed, plan)

        def scatter_add_rows(ids, values, num_rows):
            B, R, C = values.shape
            self.k3.append((B, R, C, num_rows))
            return k3(ids, values, num_rows)

        cf = session.collision_fn
        methods = {}
        if cf is not None:
            for name in ("build", "build_refresh"):
                methods[name] = getattr(cf, name)

                def marked(*a, _f=methods[name], **kw):
                    with self.span("broad_phase"):
                        return _f(*a, **kw)
                setattr(cf, name, marked)
        fwd.lbs_apply = sparse.lbs_apply = lbs_apply
        coll.scatter_add_rows = scatter_add_rows
        try:
            yield self
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
            for name in methods:
                delattr(cf, name)


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def read(prof, marks: list) -> dict:
    """A finished torch.profiler run and the recorder's marks -> {busy_s,
    kernels: [(name, start_ns, dur_ns, span)], launches, device_ops:
    [[name, s]], idle_gaps: [[name, s]]}.  The marks' own kernels and
    time, and what ran before the first mark, are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    device, reads = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append((e.start_ns(), e.duration_ns(), e.name()))
        elif e.name().startswith(HOST_READS):
            reads.append((e.start_ns(), e.end_ns()))
    device.sort()
    # What ran before the first mark (the profiler's settling) is not the
    # window's.
    first = next((i for i, (_, _, n) in enumerate(device) if MARK in n), 0)
    device = device[first:]
    found = sum(MARK in n for _, _, n in device)
    if found != len(marks):
        raise RuntimeError(f"the trace holds {found} span marks; the window "
                           f"launched {len(marks)}")

    stack, kernels, intervals, edges = [], [], [], []
    m = 0
    for s, d, name in device:
        if MARK in name:
            span, edge = marks[m]
            m += 1
            if edge == "start":
                stack.append(span)
            else:
                stack.pop()
            edges.append((s, stack[-1] if stack else "outside"))
            continue
        intervals.append((s, s + d))
        if not name.startswith(("Memcpy", "Memset")):
            kernels.append((kernel_name(name), s, d,
                            stack[-1] if stack else "outside"))
    busy = _union(intervals)
    busy_ns = sum(e - s for s, e in busy)

    by_name = defaultdict(int)
    for name, _, d, _ in kernels:
        by_name[name] += d
    device_ops = sorted(([n, d / 1e9] for n, d in by_name.items()),
                        key=lambda r: -r[1])[:10]

    edge_t = [t for t, _ in edges]
    reads.sort()
    read_starts = [s for s, _ in reads]
    gaps = defaultdict(int)
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        i = bisect.bisect_right(edge_t, end) - 1
        span = edges[i][1] if i >= 0 else "outside"
        # Reads run one after another on the host: only the last to start
        # before the gap's end can reach into it.
        j = bisect.bisect_left(read_starts, nxt) - 1
        kind = "host_read" if j >= 0 and reads[j][1] > end else "launch"
        gaps[f"{span}.{kind}"] += nxt - end
    idle_gaps = sorted(([n, d / 1e9] for n, d in gaps.items()),
                       key=lambda r: -r[1])[:10]
    return {"busy_s": busy_ns / 1e9, "kernels": kernels,
            "launches": len(kernels), "device_ops": device_ops,
            "idle_gaps": idle_gaps}
