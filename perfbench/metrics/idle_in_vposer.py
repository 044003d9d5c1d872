"""The part of `idle_share`, in points of %, during which the host's
innermost program span was a `vposer` span: the VPoser decoder's forward,
autograd's pass back through it, and the encode of the regressors' poses
in preparation.  None where the traced fit recorded no such span (a
program without it, or a configuration without VPoser)."""

from perfbench import spans


def read(run):
    fits = spans.traced_fits(run)
    if not fits or not any(s.name == "vposer" for s in fits):
        return None
    return spans.idle_in(run, "vposer")
