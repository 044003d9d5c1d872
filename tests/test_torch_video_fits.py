"""The batched video-sequence fit against the JAX package's
`examples/video_batch.py`, on the CPU: whole fits.

Both packages fit the example's problem (`tests/_torch_parity.py::
example_inputs`, the port's `problem.video_problem`) at B=4, V=96; the
port's fit must end at the same loss level (5% per lane, as
tests/test_torch_pipeline.py holds collision-on fits) and PA-V2V (5% on
the mean), on the synthetic model over the stages that f32 rounding
leaves comparable (STAGES).  Kept apart from tests/test_torch_video.py so
that two test workers share the JAX fits."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from smplifyx_tpu.evaluation.metrics import procrustes_v2v as j_procrustes_v2v
from smplifyx_tpu.fitting.pipeline import fit_batch as j_fit_batch
from smplifyx_tpu.fitting.pipeline import recover_outputs as j_recover
from smplifyx_tpu.models.sparse import build_joints_model as j_joints_model

from smplifyx_torch.examples import video_batch
from smplifyx_torch.fitting.lbfgs import LBFGSConfig
from smplifyx_torch.fitting.pipeline import fit_batch
from smplifyx_torch.problem import video_problem

from tests._torch_parity import example_inputs, torch_threads

B, V = 4, 96


# Body-stage iterations of the whole fits, cut from the example's 40 to
# keep this file's time down; the camera stage keeps its 20.
FIT_ITERS = 10
# Body stages each case's parity fit runs.  The synthetic model's random
# faces all interpenetrate (V=96: 48 faces spanning the body), so its
# collision stages end at losses ~1e7 where f32 rounding alone sends
# lanes into other minima (test_synthetic_collision_stages_are_chaotic):
# its parity fit stops after body stage 0, the last stage without the
# collision term.  The slice's local faces run the whole schedule.
STAGES = {"slice": 3, "synthetic": 1}


def jax_fit(j, stages=3):
    """JAX's `fit_batch` of `example_inputs` over its first `stages` body
    stages, jitted -> fit(frames) -> FitResult."""
    schedule = jax.tree_util.tree_map(lambda a: a[:stages], j["schedule"])
    fit = jax.jit(lambda m, jm, f, x: j_fit_batch(
        m, j["settings"], j["options"], schedule, f, x, lambda b: b,
        j["joint_map"], edge_idxs=jnp.asarray([[5, 12], [2, 9]]),
        collision_fn=j["collision_fn"], joints_model=jm))
    jm = j_joints_model(j["model"])
    return lambda frames: fit(j["model"], jm, frames, j["x0"])


def port_problem(kind, stages=3):
    """`video_problem(B, V, kind)` with FIT_ITERS body iterations over its
    first `stages` body stages."""
    p = video_problem(B, V, kind, "cpu")
    lbfgs = dataclasses.replace(p.options.lbfgs, max_iters=FIT_ITERS)
    return dataclasses.replace(
        p, options=dataclasses.replace(p.options, lbfgs=lbfgs),
        schedule=p.schedule.map(lambda a: a[:stages]))


@pytest.fixture(scope="module", params=["slice", "synthetic"])
def fits(request):
    """The example's fit (schedule cut to STAGES[kind] body stages,
    collision settings, LBFGSConfigs with FIT_ITERS body iterations) by
    both packages at B=4, V=96."""
    kind = request.param
    j = example_inputs(B, V, kind, FIT_ITERS)
    jres = jax_fit(j, STAGES[kind])(j["frames"])
    jout, _, _ = j_recover(j["model"], j["settings"], jres.x, lambda b: b)
    j_v2v = np.asarray(j_procrustes_v2v(jout.vertices, j["out"].vertices))
    p = port_problem(kind, STAGES[kind])
    assert LBFGSConfig(**{f.name: getattr(j["options"].lbfgs, f.name)
                          for f in dataclasses.fields(LBFGSConfig)}) \
        == p.options.lbfgs
    with torch_threads(1):
        return kind, jres, j_v2v.mean(-1), video_batch.fit_sequence(p)


def test_whole_fit_matches_jax_at_loss_level(fits):
    """Collision-on fits agree at loss level (ROADMAP "Tolerances"): the
    camera stage and every lane's final loss within 5%, as
    tests/test_torch_pipeline.py holds them, and the mean PA-V2V within 5%
    (the synthetic case's fit ends after body stage 0, see STAGES)."""
    kind, jres, j_v2v, seq = fits
    res = seq.result
    assert torch.equal(res.x, seq.warmup.x)
    assert torch.equal(res.loss, seq.warmup.loss)
    np.testing.assert_allclose(res.camera_loss.numpy(),
                               np.asarray(jres.camera_loss), rtol=0.05)
    np.testing.assert_allclose(res.stage_losses.numpy(),
                               np.asarray(jres.stage_losses), rtol=0.05)
    np.testing.assert_allclose(res.loss.numpy(), np.asarray(jres.loss),
                               rtol=0.05)
    np.testing.assert_allclose(float(seq.pa_v2v.mean()), float(j_v2v.mean()),
                               rtol=0.05)
    assert np.isfinite(res.stage_losses.numpy()).all()
    assert seq.pa_v2v.shape == (B,) and seq.seconds > 0
    assert res.stage_evals.shape == (STAGES[kind], B)
    assert int(res.stage_evals.min()) > 0 and res.host_reads > 0


def _spread(a, b):
    """Per-stage max over lanes of |a / b - 1|, [S] for [S, B] losses."""
    return np.abs(np.asarray(a, np.float64) / np.asarray(b, np.float64)
                  - 1).max(-1)


def test_synthetic_collision_stages_are_chaotic(capsys):
    """Why the synthetic case's parity fit stops after body stage 0: on
    its whole schedule, two witnesses that share no code with the port's
    fit move the collision stages' losses by more than the 5% bound,
    while the camera stage and body stage 0 stay within it.  JAX against
    JAX with its 2D joints moved by one ulp, and the port against itself
    on one CPU thread and on the default count.  The spreads are printed
    (per stage, max over lanes) beside the port's against JAX's."""
    j = example_inputs(B, V, "synthetic", FIT_ITERS)
    fit = jax_fit(j)
    j0 = fit(j["frames"])
    moved = np.nextafter(np.asarray(j["frames"].gt_joints), np.float32(np.inf))
    j1 = fit(j["frames"].replace(gt_joints=jnp.asarray(moved)))
    threads = torch.get_num_threads()
    p = port_problem("synthetic")

    def fit_port():
        return fit_batch(p.model, p.settings, p.options, p.schedule, p.frames,
                         p.x0, p.decode_body, p.joint_map,
                         edge_idxs=p.edge_idxs, collision_fn=p.collision_fn,
                         joints_model=p.joints_model, device="cpu")

    p0 = fit_port()
    torch.set_num_threads(1)
    try:
        p1 = fit_port()
    finally:
        torch.set_num_threads(threads)

    def stages(r):
        return np.concatenate([np.asarray(r.camera_loss)[None],
                               np.asarray(r.stage_losses)])

    spreads = {"jax_vs_jax_one_ulp": _spread(stages(j1), stages(j0)),
               f"port_1_vs_{threads}_threads": _spread(stages(p1), stages(p0)),
               "port_vs_jax": _spread(stages(p0), stages(j0))}
    with capsys.disabled():
        print("\nsynthetic B=4 V=96, FIT_ITERS=10; camera, stages 0-2:",
              {k: v.tolist() for k, v in spreads.items()})
    for name in ("jax_vs_jax_one_ulp", "port_vs_jax"):
        assert (spreads[name][:2] < 0.05).all(), (name, spreads[name])
    assert spreads["jax_vs_jax_one_ulp"][3] > 0.05, spreads
    assert np.isfinite(stages(p0)).all() and np.isfinite(stages(p1)).all()
