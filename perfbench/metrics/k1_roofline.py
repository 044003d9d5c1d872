"""Kernel K1's (skinning, `lbs_kernel`) share of its roofline, in %: the
least time of every launch in the traced window at its own shape
(`counts.lbs_counts`, this model's nonzero weights) over the kernel's
device time."""

from perfbench import counts
from perfbench.trace import kernel_base

KERNELS = ("lbs_kernel",)


def read(run):
    if run.trace is None or run.peak is None or not run.recorder.k1:
        return None
    times = [d for name, _, d, _ in run.trace["kernels"]
             if kernel_base(name) in KERNELS]
    if len(times) != len(run.recorder.k1) or None in (
            nnz for *_, nnz in run.recorder.k1):
        return None
    least = sum(counts.least_s(*counts.lbs_counts(*shape), run.peak)
                for shape in run.recorder.k1)
    return 100.0 * least / (sum(times) / 1e9)
