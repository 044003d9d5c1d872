"""Share of the lane-evaluations computed in the traced fit that a lane
still running needed, in %: the per-lane evaluation counts of every stage
(the program's `stage` spans, both orientations, before the choice) over
the lanes of every batched evaluation (its `evaluation` spans).  The
batched loops evaluate finished lanes until the last lane stops."""

from perfbench import spans


def read(run):
    fits = spans.traced_fits(run)
    if fits is None:
        return None
    lanes = spans.total(fits, "evaluation", "lanes")
    needed = spans.total(fits, "stage", "lane_evals")
    return 100.0 * needed / lanes if lanes else None
