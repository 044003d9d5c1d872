"""The part of `idle_share`, in points of %, during which the host's
innermost program span was an `evaluation` (the energy's forward and
autograd's backward): idle_share times the traced call's idle time under
that span over all of its idle time."""

from perfbench import spans


def read(run):
    return spans.idle_in(run, "evaluation")
