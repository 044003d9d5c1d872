"""Run-to-run spread of the collision-on fit on the card, and its cause.

    python -m smplifyx_torch.tools.rerun_spread [--batch 128]

Fits the slice (`problem.build_slice`: the collision-on combined preset,
V=10475) twice on the card with each of three narrow phases, and prints one
JSON line per narrow phase: the per-lane relative difference of the two
runs' final losses (quantiles, lanes over 5%), whether the two runs ended
bit-equal, each run's median final loss and median PA-V2V in mm against
the problem's ground truth, and the messages of any operation without a
deterministic implementation.  Then one JSON line per other
narrow phase, pairing its first fit with the kernel's lane by lane: the
quantiles of the per-lane final-loss ratio and the lanes on which the
kernel ends lower, which tell a summation order that fits worse (most
lanes one way) from one that only moves lanes to other minima (both ways).

  * ``kernel``: the port's pair gather (K2 forward, K3 backward, K3 a
    segmented sum over the aux's row plans);
  * ``index_add``: K2 forward, backward by `index_add_`, which adds with
    float atomics on the card (the summation of an atomic K3);
  * ``index_add_deterministic``: the same under
    `torch.use_deterministic_algorithms(True)`, where `index_add_` takes
    its deterministic path.

If only ``index_add`` spreads, the atomics' summation order is the cause.
"""

from __future__ import annotations

import argparse
import json
import os
import warnings

# cuBLAS needs a fixed workspace to be deterministic; it is read when cuBLAS
# starts, so it is set before torch touches the card.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

from smplifyx_torch.evaluation.ehf import synthetic_part_vertex_ids  # noqa: E402
from smplifyx_torch.ops.collision import CollisionFn, _PairGather  # noqa: E402
from smplifyx_torch.ops.gather import scatter_add_reference  # noqa: E402
from smplifyx_torch.problem import (  # noqa: E402
    build_slice,
    fit_meshes,
    ground_truth_meshes,
    lane_errors_mm,
)
from smplifyx_torch.utils.timing import card_name  # noqa: E402


class _IndexAddPairGather(_PairGather):
    """The pair gather of ops/collision.py (K2 forward) with `index_add_`
    as its VJP."""

    @staticmethod
    def backward(ctx, gta, gtb):
        corner_plan, pair_plan = ctx.saved_tensors
        B, T = corner_plan.shape[0], corner_plan.shape[2] // 3
        gp = torch.cat([gta.reshape(B, -1, 9), gtb.reshape(B, -1, 9)], dim=1)
        gc9 = scatter_add_reference(pair_plan[:, 0], gp.contiguous(), T)
        dv = scatter_add_reference(corner_plan[:, 0], gc9.reshape(B, -1, 3),
                                   ctx.num_verts)
        return dv, None, None


class IndexAddCollision:
    """A collision term whose narrow-phase VJP is `index_add_`."""

    def __init__(self, fn: CollisionFn):
        self.fn = fn

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def apply(self, vertices, aux):
        ta, tb = _IndexAddPairGather.apply(vertices, aux.corner_plan,
                                           aux.pair_plan)
        return self.fn.penalty(ta, tb, aux.valid)


def pa_v2v_mm(session, model, x):
    """Per-lane PA-V2V in mm of fitted x against the ground truth."""
    fit_v, fit_j = fit_meshes(model, session.settings, session.decode_body, x)
    gt_v, gt_j = ground_truth_meshes(model, x.shape[0])
    return lane_errors_mm(fit_v, gt_v, fit_j, gt_j,
                          synthetic_part_vertex_ids(model.num_verts))["pa_v2v"]


def spread(session, model, jm, frames, x0):
    """Two fits of the same inputs -> (per-lane relative loss difference,
    bit-equal x, each fit's median final loss and median PA-V2V, the first
    fit's losses and PA-V2V)."""
    a = session.fit(model, jm, frames, x0)
    b = session.fit(model, jm, frames, x0)
    torch.cuda.synchronize()
    rel = (a.loss - b.loss).abs() / b.loss.abs()
    medians = [float(r.loss.median()) for r in (a, b)]
    pa = [pa_v2v_mm(session, model, r.x) for r in (a, b)]
    return (rel, bool(torch.equal(a.x, b.x)), medians,
            [float(p.median()) for p in pa], (a.loss, pa[0]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rerun_spread measures the card: no CUDA device")
    smi = card_name()
    session, model, jm, frames, x0 = build_slice(args.batch)
    kernel_fn = session.collision_fn
    losses = {}
    for name, fn, deterministic in (
            ("kernel", kernel_fn, False),
            ("index_add", IndexAddCollision(kernel_fn), False),
            ("index_add_deterministic", IndexAddCollision(kernel_fn), True)):
        session.collision_fn = fn
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rel, bit_equal, medians, pa_medians, losses[name] = spread(
                session, model, jm, frames, x0)
        torch.use_deterministic_algorithms(False)
        print(json.dumps({
            "narrow_phase": name, "card": smi, "B": int(x0.shape[0]),
            "V": int(model.lbs_weights.shape[0]),
            "deterministic_algorithms": deterministic,
            "bit_equal": bit_equal,
            "rel_diff_quantiles": {q: float(rel.quantile(float(q)))
                                   for q in ("0.5", "0.9", "1.0")},
            "lanes_over_5pct": int((rel > 0.05).sum()),
            "loss_median": medians,
            "pa_v2v_mm_median": pa_medians,
            "nondeterministic_ops": sorted({str(w.message)[:160]
                                            for w in caught}),
        }), flush=True)
    session.collision_fn = kernel_fn
    for name in ("index_add", "index_add_deterministic"):
        ratio = losses[name][0] / losses["kernel"][0]
        pa_ratio = losses[name][1] / losses["kernel"][1]
        print(json.dumps({
            "paired": name, "against": "kernel", "B": int(ratio.numel()),
            "loss_ratio_quantiles": {q: float(ratio.quantile(float(q)))
                                     for q in ("0.1", "0.5", "0.9")},
            "lanes_kernel_lower": int((ratio > 1).sum()),
            "lanes_equal": int((ratio == 1).sum()),
            "pa_v2v_ratio_quantiles": {q: float(pa_ratio.quantile(float(q)))
                                       for q in ("0.1", "0.5", "0.9")},
            "lanes_kernel_pa_v2v_lower": int((pa_ratio > 1).sum()),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
