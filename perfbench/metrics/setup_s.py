"""Seconds from the start of the process to the first timed fit: model
and frames from the seed, the program's session, the warm-up fit."""


def read(run):
    return run.setup_s
