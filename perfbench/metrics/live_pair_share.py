"""Share of the pair slots the narrow phase scores that hold a live pair,
in %: the live pairs over the slots of every broad phase in the traced
fit (the program's `broad_phase` spans, `CollisionFn.build` and
`build_refresh`)."""

from perfbench import spans


def read(run):
    fits = spans.traced_fits(run)
    if fits is None:
        return None
    slots = spans.total(fits, "broad_phase", "slots")
    live = spans.total(fits, "broad_phase", "live")
    return 100.0 * live / slots if slots else None
