"""The program's own spans in a traced run, joined to the device trace.

The program records spans at its layer boundaries while torch.profiler
runs (`smplifyx_torch/utils/timing.py::RECORDER`): `fit` (one per
`fit_batch` call, with its frames), `stage` (one per minimization, with
its lanes and the per-lane evaluations it needed), `evaluation` (one per
batched call of the objective, with the lanes it evaluated) and
`broad_phase` (with the slots the narrow phase scores and the live pairs
among them).  Each is stamped with `time.time_ns()`, the clock of the
profiler's events, so an idle gap of the card is put down to the span
that was innermost on the host while the card waited.

Every function returns None, and never raises, where the run has no trace
or the program recorded no span in it (a program without the recorder).
"""

from __future__ import annotations

from perfbench.manifest import Manifest


def _recorded() -> list:
    try:
        from smplifyx_torch.utils import timing
        return list(timing.RECORDER.spans)
    except (ImportError, AttributeError):
        return []


def _window(run):
    """[first kernel start, last kernel end] of the traced call, in ns."""
    if run.trace is None or not run.trace["kernels"]:
        return None
    kernels = run.trace["kernels"]
    return kernels[0][1], max(s + d for _, s, d, _ in kernels)


def traced_fits(run, spans: list | None = None) -> list | None:
    """The spans of the `fit_batch` calls that ran in the traced call,
    each fit's own span first, or None."""
    window = _window(run)
    spans = _recorded() if spans is None else spans
    if window is None or not spans:
        return None
    lo, hi = window
    fits = set()
    for s in spans:
        if s.fit is not None and s.name == "fit" and s.end_ns is not None \
                and s.start_ns <= hi and s.end_ns >= lo:
            fits.add(s.fit)
    picked = [s for s in spans if s.fit in fits and s.end_ns is not None]
    return picked or None


def _innermost(spans: list) -> list:
    """(start, end, index) segments of time by the innermost open span;
    the spans nest (they are opened and closed on one thread)."""
    events = []
    for i, s in enumerate(spans):
        if s.end_ns is not None:
            events.append((s.start_ns, 1, i))
            events.append((s.end_ns, 0, i))
    # At one instant: ends before starts; a child ends before its parent
    # and starts after it (it was opened later: a larger index).
    events.sort(key=lambda e: (e[0], e[1], e[2] if e[1] else -e[2]))
    out, stack, t_prev = [], [], None
    for t, is_start, i in events:
        if stack and t > t_prev:
            out.append((t_prev, t, stack[-1]))
        if is_start:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        t_prev = t
    return out


def _gaps(kernels: list) -> list:
    """[start, end) intervals between the traced call's kernels in which
    none ran."""
    busy = []
    for _, s, d, _ in sorted(kernels, key=lambda k: k[1]):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], s + d)
        else:
            busy.append([s, s + d])
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:])]


def idle_parts(run, spans: list | None = None) -> dict | None:
    """{index of the innermost open span, None where none was open: ns of
    the traced call's idle gaps under it}; or None."""
    spans = _recorded() if spans is None else spans
    if _window(run) is None or traced_fits(run, spans) is None:
        return None
    segments = _innermost(spans)
    out, j = {}, 0
    for a, b in _gaps(run.trace["kernels"]):
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        covered, k = 0, j
        while k < len(segments) and segments[k][0] < b:
            s, e, i = segments[k]
            d = min(e, b) - max(s, a)
            out[i] = out.get(i, 0) + d
            covered += d
            k += 1
        out[None] = out.get(None, 0) + b - a - covered
    return out


def idle_by_span(run, spans: list | None = None) -> dict | None:
    """{innermost span name: ns of the traced call's idle gaps under it},
    `outside` where no program span was open; or None."""
    spans = _recorded() if spans is None else spans
    parts = idle_parts(run, spans)
    if parts is None:
        return None
    out = {}
    for i, ns in parts.items():
        name = "outside" if i is None else spans[i].name
        out[name] = out.get(name, 0) + ns
    return out


def idle_share(run) -> float | None:
    """The accepted `idle_share` reader's value, in %."""
    return Manifest().reader("idle_share")(run)


def idle_in(run, name: str, spans: list | None = None) -> float | None:
    """The part of `idle_share` during which `name` was the innermost
    program span: idle_share times that span's share of the traced call's
    idle time, so the parts over every name add up to idle_share."""
    share, by = idle_share(run), idle_by_span(run, spans)
    if share is None or by is None or sum(by.values()) <= 0:
        return None
    return share * by.get(name, 0) / sum(by.values())


def total(spans: list, name: str, attr: str) -> int:
    """The sum of one attribute over the spans of one name that hold it (a
    device scalar is read here, after the fit)."""
    return sum(int(s.attrs[attr]) for s in spans
               if s.name == name and s.attrs.get(attr) is not None)
