"""Share of the card's busy time in the collision term's broad phase, in %:
the device time of the kernels launched inside `CollisionFn.build` and
`build_refresh` (the benchmark's `broad_phase` span) over the device-busy
time of the traced window."""


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    ns = sum(d for _, _, d, span in run.trace["kernels"] if span == "broad_phase")
    if ns == 0:
        return None
    return 100.0 * ns / 1e9 / run.trace["busy_s"]
