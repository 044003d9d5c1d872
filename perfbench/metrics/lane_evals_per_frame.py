"""Lane-evaluations the card computed per frame in the traced fit: the
lanes of every batched call of the objective (the program's `evaluation`
spans; B lanes in the camera stage, both orientations' 2B in the body
stages where the preset tries both), over the fit's frames (its `fit`
span)."""

from perfbench import spans


def read(run):
    fits = spans.traced_fits(run)
    if fits is None:
        return None
    frames = spans.total(fits, "fit", "frames")
    lanes = spans.total(fits, "evaluation", "lanes")
    return lanes / frames if frames and lanes else None
