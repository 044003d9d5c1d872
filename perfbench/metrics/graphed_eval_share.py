"""Share of the lane-evaluations computed in the traced fit whose stretches
of plain PyTorch replayed from CUDA graphs, in %: the `graphed_lanes` of
the program's `evaluation` spans over their `lanes` (a stage's first
evaluation runs eagerly, and its second captures the graphs).  None where
no evaluation span carries `graphed_lanes` (a program that graphs none)."""

from perfbench import spans


def read(run):
    fits = spans.traced_fits(run)
    if fits is None or not any(s.name == "evaluation"
                               and "graphed_lanes" in s.attrs for s in fits):
        return None
    lanes = spans.total(fits, "evaluation", "lanes")
    graphed = spans.total(fits, "evaluation", "graphed_lanes")
    return 100.0 * graphed / lanes if lanes else None
