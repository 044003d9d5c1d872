"""Share of a fit's time in which no operation ran on the card, in %: one
minus the device's busy time in the traced fit (the union of its activity)
over the median time of the window's untraced fits, since the profiler
stretches the traced fit's own time with every launch."""

import statistics


def read(run):
    if run.trace is None or not run.untraced:
        return None
    fit_s = statistics.median(c["seconds"] for c in run.untraced)
    return 100.0 * (1.0 - run.trace["busy_s"] / fit_s)
