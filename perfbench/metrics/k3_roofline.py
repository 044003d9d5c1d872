"""Kernel K3's (row scatter-add, `k3_scatter_tiles` and `k3_join`) share of
its roofline, in %: the least time of every launch in the traced window at
its own shape (`counts.scatter_counts`) over both kernels' device time."""

from perfbench import counts
from perfbench.trace import kernel_base

KERNELS = ("k3_scatter_tiles", "k3_join")


def read(run):
    if run.trace is None or run.peak is None or not run.recorder.k3:
        return None
    mine = [(kernel_base(name), d) for name, _, d, _ in run.trace["kernels"]
            if kernel_base(name) in KERNELS]
    if sum(name == KERNELS[0] for name, _ in mine) != len(run.recorder.k3):
        return None
    time_ns = sum(d for _, d in mine)
    least = sum(counts.least_s(*counts.scatter_counts(*shape), run.peak)
                for shape in run.recorder.k3)
    return 100.0 * least / (time_ns / 1e9)
