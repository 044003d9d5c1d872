"""Reads of a device value that steer the optimizer's loops, per fit: the
program's own counter `FitResult.host_reads`."""


def read(run):
    if not run.counters:
        return None
    return sum(c["host_reads"] for c in run.counters) / len(run.counters)
