"""Kernel launches in the traced window over the frames fitted in it."""


def read(run):
    if run.trace is None or not run.frames:
        return None
    return run.trace["launches"] / run.frames
