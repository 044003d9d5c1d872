"""Small slice fits for the tests of the graphed evaluations
(`smplifyx_torch/utils/graphs.py`): the combined preset, its VPoser
variant and its collision-off path, each a camera stage and two body
stages (body stage 0, joints only, and the preset's last, which in the
combined preset has the hoisted collision term).  No JAX: the card's tests
use it too."""

import dataclasses
from types import SimpleNamespace

import torch

from smplifyx_torch import problem
from smplifyx_torch.fitting.params import pack, unpack
from smplifyx_torch.fitting.pipeline import fit_batch
from smplifyx_torch.models.sparse import build_joints_model

KINDS = ("combined", "vposer", "nocoll")


def slice_fit(kind: str, batch: int, num_verts: int, device, maxiters: int,
              **overrides):
    """A function that fits the slice's `batch` frames, and what it fits
    (session, model, jm, frames, x0, schedule); `overrides` go into the
    preset's Config."""
    over = {"maxiters": maxiters, **overrides}
    if kind == "vposer":
        over.update(use_vposer=True, vposer_ckpt="synthetic")
    elif kind == "nocoll":
        over.update(interpenetration=False)
    session, model = problem.slice_session(num_verts, device, **over)
    s = session.settings
    plain = dataclasses.replace(s, use_vposer=False)
    _, _, frames, x0, _ = problem.build_problem(
        batch, num_verts, settings=plain, device=device, model=model)
    if s.use_vposer:
        seg = unpack(plain, x0)
        gen = torch.Generator().manual_seed(0)
        seg["body"] = (0.3 * torch.randn(batch, s.latent_dim, generator=gen)
                       ).to(x0.device)
        frames = dataclasses.replace(
            frames, regression_body=torch.zeros_like(seg["body"]))
        x0 = pack(s, **seg)
    stages = [0, session.schedule.num_stages - 1]
    schedule = session.schedule.map(lambda a: a[stages])
    mask = (None if session.coll_stage_mask is None
            else tuple(session.coll_stage_mask[k] for k in stages))
    jm = build_joints_model(model)

    def fit():
        return fit_batch(
            model, s, session.options, schedule, frames, x0,
            session.decode_body, session.joint_map, gmm=session.gmm,
            edge_idxs=session.edge_idxs, joints_model=jm,
            coll_stage_mask=mask, lhand_gmm=session.lhand_gmm,
            rhand_gmm=session.rhand_gmm,
            collision_fn=session.collision_for(model), device=device)

    return fit, SimpleNamespace(session=session, model=model, jm=jm,
                                frames=frames, x0=x0, schedule=schedule)


def same_fit(a, b) -> dict:
    """Which of two FitResults' x, loss, evaluation counts and host reads
    differ (an empty dict: bit-equal)."""
    out = {}
    for name in ("x", "loss", "stage_evals", "camera_evals"):
        u, v = getattr(a, name), getattr(b, name)
        if not torch.equal(u, v):
            out[name] = float((u.double() - v.double()).abs().max())
    if a.host_reads != b.host_reads:
        out["host_reads"] = (a.host_reads, b.host_reads)
    return out
