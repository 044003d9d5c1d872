"""Share of the broad phase's level-2 slots that kernel K4 skips, in %:
the slots whose block-pair mask level 1 left empty (`l2_skipped`) over
all level-2 slots (`l2_slots`), summed over every broad phase of the
traced fit (the program's `broad_phase` spans, `CollisionFn.build` and
`build_refresh`).  None where the spans carry neither."""

from perfbench import spans


def read(run):
    fits = spans.traced_fits(run)
    if fits is None:
        return None
    slots = spans.total(fits, "broad_phase", "l2_slots")
    skipped = spans.total(fits, "broad_phase", "l2_skipped")
    return 100.0 * skipped / slots if slots else None
