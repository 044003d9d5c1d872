"""Timing and profiling helpers.

Counterpart of `smplifyx_tpu/utils/timing.py`:

  * `Timer`: named wall-clock spans; `block_on` synchronises the device of
    the given tensor before a span closes (torch.cuda.synchronize +
    time.time, as the reference times its stages);
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
    """A kernel's profiler name without the leading `void` and the
    parameter list; the template arguments, which tell one elementwise
    kernel from another (the functor), stay."""
    if not key.startswith("void "):
        return key
    name, depth = key[5:], 0
    for i, c in enumerate(name):
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif c == "(" and depth == 0:
            return name[:i]
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
