"""The part of `idle_share`, in points of %, during which the host's
innermost program span was a `stage`: L-BFGS's own work and its reads of
the device, outside the evaluations and broad phases it calls (and the
forward whose vertices a broad phase takes)."""

from perfbench import spans


def read(run):
    return spans.idle_in(run, "stage")
