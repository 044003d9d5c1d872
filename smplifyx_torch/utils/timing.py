"""Timing and profiling helpers.

Counterpart of `smplifyx_tpu/utils/timing.py`:

  * `Timer`: named wall-clock spans; `block_on` synchronises the device of
    the given tensor before a span closes (torch.cuda.synchronize +
    time.time, as the reference times its stages);
  * `RECORDER`, `span`, `recording`: the program's own spans at its layer
    boundaries, recorded only while a torch.profiler run is active, on the
    clock the profiler stamps its events with (see `Recorder`);
  * `trace`: `torch.profiler` around a block, written as a Chrome trace
    (`trace.json` under the given folder);
  * `profile_summary`: a finished torch.profiler run summed (busy ms,
    launches and the names with the most time), `kernel_events` its CUDA
    kernels, `kernel_name` a kernel's name without its parameter list;
  * `card_name`: the card's name and power limit from nvidia-smi;
  * `FitStats`: per-batch loss and evaluation summaries from `FitResult`.
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp
import subprocess
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


_profiler_enabled = torch._C._autograd._profiler_enabled


@dataclass
class Span:
    """One recorded span.  `start_ns`/`end_ns` are `time.time_ns()`, the
    clock torch.profiler stamps its events with (`end_ns` is None while it
    is open); `parent` is the index of the span it opened in; `fit` the id
    shared by every span of one `fit_batch` call (None outside one).
    `attrs` are small attributes: a device value stays a tensor, read only
    when a reader asks after the fit."""

    name: str
    start_ns: int
    parent: Optional[int]
    fit: Optional[int]
    attrs: dict
    end_ns: Optional[int] = None


class _Opened:
    """The context of one recorded span: appended at entry, closed at exit."""

    __slots__ = ("rec", "name", "new_fit", "attrs", "span")

    def __init__(self, rec, name, new_fit, attrs):
        self.rec, self.name = rec, name
        self.new_fit, self.attrs = new_fit, attrs

    def __enter__(self) -> Span:
        rec = self.rec
        if not rec.open and len(rec.spans) >= rec.limit:
            rec.spans = []
        parent = rec.open[-1] if rec.open else None
        if self.new_fit:
            fit = rec.fits = rec.fits + 1
        else:
            fit = rec.spans[parent].fit if parent is not None else None
        self.span = Span(self.name, 0, parent, fit, self.attrs)
        rec.spans.append(self.span)
        rec.open.append(len(rec.spans) - 1)
        self.span.start_ns = time.time_ns()
        return self.span

    def __exit__(self, *exc):
        self.span.end_ns = time.time_ns()
        self.rec.open.pop()
        return False


_OFF = contextlib.nullcontext()     # entered as None


class Recorder:
    """Spans at the program's layer boundaries, kept in memory.  It
    records only while a torch.profiler run is active (one
    `_profiler_enabled` check, ~70 ns); otherwise a span is a shared null
    context, so recording off allocates nothing on the device and reads
    nothing from it.

    One per process (`RECORDER`), as the profiler is: code anywhere in the
    fit records without an argument passed down to it.  Spans are opened
    on the thread that runs the fit, one fit at a time.

    The program never clears the record, and readers do not either.  A
    caller that profiles a block and wants only its spans calls `clear()`
    first, or picks them by time as `perfbench/spans.py` does.  The record
    holds at most `limit` spans (a few dozen fits): a span opened while
    none is open, once it holds that many, starts it afresh, so a long
    profiled run keeps a bounded record."""

    limit = 1 << 16

    def __init__(self):
        self.spans: list[Span] = []
        self.open: list[int] = []   # the open spans' indices, innermost last
        self.fits = 0

    def recording(self) -> bool:
        return bool(self.open) or _profiler_enabled()

    def span(self, name: str, fit: bool = False, **attrs):
        """A context that records the span `name` with `attrs` and yields
        its `Span`, or yields None when not recording.  `fit=True` starts
        a new fit id (`fit_batch`)."""
        if not self.recording():
            return _OFF
        return _Opened(self, name, fit, attrs)

    def clear(self) -> None:
        """Drop every span (for a caller that starts afresh)."""
        if self.open:
            raise RuntimeError("the recorder has open spans")
        self.spans = []


RECORDER = Recorder()
recording = RECORDER.recording
span = RECORDER.span


@dataclass
class Timer:
    """Named wall-clock spans; `block_on` forces device completion first."""

    spans: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str, block_on: Optional[torch.Tensor] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None and block_on.device.type == "cuda":
                torch.cuda.synchronize(block_on.device)
            self.spans[name] = self.spans.get(name, 0.0) + (
                time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.spans.values())
        return "\n".join(f"{k}: {v:.3f}s ({100 * v / max(total, 1e-9):.1f}%)"
                         for k, v in self.spans.items())


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over a block (CPU, and CUDA where a card is present);
    the trace goes to `log_dir/trace.json` (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(osp.join(log_dir, "trace.json"))


def kernel_events(prof) -> list:
    """The CUDA kernels of a finished torch.profiler run, one averaged
    event per kernel name."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def kernel_name(key: str) -> str:
    """A kernel's profiler name without a leading `void` and its parameter
    list: the last parenthesised group, where it follows the name directly
    (names hold `(anonymous namespace)`; the profiler's `Memcpy DtoH
    (Device -> Pageable)` keeps its words).  The template arguments, which
    tell one elementwise kernel from another (the functor), stay."""
    name, depth = key[5:] if key.startswith("void ") else key, 0
    if name.endswith(")"):
        for i in range(len(name) - 1, 0, -1):
            if name[i] == ")":
                depth += 1
            elif name[i] == "(":
                depth -= 1
                if depth == 0:
                    return name if name[i - 1] == " " else name[:i]
    return name


def profile_summary(prof, top: int, device: bool = True) -> dict:
    """A finished torch.profiler run summed: the CUDA kernels' self times
    (device=True) or the host ops' (device=False) -> {busy_<clock>_ms,
    launches (kernels) or ops (host ops), top: the `top` names with the
    most time, each with its count and ms}."""
    if device:
        clock, events = "device", kernel_events(prof)

        def us(e):
            return e.self_device_time_total
    else:
        clock, events = "host", list(prof.key_averages())

        def us(e):
            return e.self_cpu_time_total
    ranked = sorted(events, key=lambda e: -us(e))[:top]
    return {f"busy_{clock}_ms": sum(us(e) for e in events) / 1e3,
            "launches" if device else "ops": sum(e.count for e in events),
            "top": [{"name": kernel_name(e.key), "count": e.count,
                     f"{clock}_ms": us(e) / 1e3} for e in ranked]}


def card_name() -> str:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


@dataclass
class FitStats:
    """Summary statistics of a batched fit (from FitResult)."""

    losses: np.ndarray
    camera_losses: Optional[np.ndarray] = None
    flipped: Optional[np.ndarray] = None
    # [S, B] objective evaluations per body stage (FitResult.stage_evals)
    stage_evals: Optional[np.ndarray] = None

    def summary(self) -> dict:
        out = {
            "loss_mean": float(np.mean(self.losses)),
            "loss_median": float(np.median(self.losses)),
            "loss_max": float(np.max(self.losses)),
            "num_frames": int(len(self.losses)),
            "num_nonfinite": int((~np.isfinite(self.losses)).sum()),
        }
        if self.camera_losses is not None:
            out["camera_loss_mean"] = float(np.mean(self.camera_losses))
        if self.flipped is not None:
            out["num_flipped_orientation"] = int(np.sum(self.flipped))
        if self.stage_evals is not None:
            ev = np.asarray(self.stage_evals)
            out["stage_evals_mean"] = [float(m) for m in ev.mean(axis=1)]
            out["stage_evals_max"] = [int(m) for m in ev.max(axis=1)]
        return out
