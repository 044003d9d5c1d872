"""Frames fitted in the window over the window's seconds (host clock)."""


def read(run):
    return run.frames / run.window_s if run.frames else None
