"""The port's four bench programs (smplifyx_torch/bench.py,
bench_collision.py, bench_quality.py, tools/ab_flagship.py) against the
JAX package's (the root bench.py, bench_collision.py, bench_quality.py and
tools/ab_flagship.py), on the CPU.

The JAX programs run as they are, inside `jax_program`: their problem
built at B=4 and V=96 whatever batch they ask for, `jax.jit` left out so
that their fit_batch sees concrete arrays, and fit_batch and
make_collision_fn replaced by recorders that keep their arguments;
fit_batch returns a stand-in result.  So their options, schedules, inputs, call
order and printed keys come from the programs themselves; their fits run
separately through the JAX package's fit_batch at V=96, B=4 and ITERS
iterations a stage, the camera stage's included, beside the port's under
the same options.  Whole fits are held at loss level (ROADMAP
"Tolerances"): each lane within 5% (the collision fit: the median).
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import pathlib
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench as j_bench
import bench_collision as j_bench_collision
import bench_quality as j_bench_quality
import smplifyx_tpu.fitting.pipeline as j_pipeline
import smplifyx_tpu.ops.collision as j_collision
from smplifyx_tpu.models.sparse import build_joints_model as j_joints_model

from smplifyx_torch import bench, bench_collision, bench_quality
from smplifyx_torch.fitting.energy import StageWeights
from smplifyx_torch.fitting.pipeline import recover_outputs
from smplifyx_torch.tools import ab_flagship
from tests._torch_parity import torch_threads

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, V, F, ITERS = 4, 96, 256, 2
LOSS_RTOL = 0.05
# bench_quality's record rounds to 1e-3; a difference far below that can
# still round to one step apart.
RECORD_ATOL = 1e-3 + 1e-9
J_BUILD_PROBLEM = j_bench.build_problem
J_FIT_BATCH = j_pipeline.fit_batch
J_MAKE_COLLISION_FN = j_collision.make_collision_fn
CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_compile_time_secs")
AB_SPECS = ["wolfe=wolfe:0", "armijo=armijo:0", "wolfe_me90=wolfe:90",
            "warm=wolfe:0:60:warm", "short=armijo:90:2"]


def _jax_ab_module():
    spec = importlib.util.spec_from_file_location(
        "jax_ab_flagship", ROOT / "tools" / "ab_flagship.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


J_AB = _jax_ab_module()


class _Stop(Exception):
    pass


@contextlib.contextmanager
def jax_program(result=None, stop=False):
    """Run a JAX bench program at B=4, V=96 without fitting: yields a dict
    whose `calls` gets fit_batch's arguments per call, `collision` the
    make_collision_fn arguments (which build no collision term),
    `batches` the batch sizes the program asked build_problem for and
    `lines` (after the block) the program's JSON lines.  fit_batch returns
    `result`, or a stand-in with x0, losses of 1 and one evaluation per
    stage; with `stop`, the first fit_batch call ends the program.  The JAX
    config keys the programs set are restored after."""
    seen = {"calls": [], "collision": [], "batches": [], "lines": []}

    def build_problem(batch, _V=10475, smooth=False):
        seen["batches"].append(batch)
        return J_BUILD_PROBLEM(B, V, smooth)

    def fit_batch(model, settings, options, schedule, frames, x0, decode,
                  joint_map, **kw):
        seen["calls"].append(dict(model=model, settings=settings,
                                  options=options, schedule=schedule,
                                  frames=frames, x0=x0, joint_map=joint_map,
                                  **kw))
        if stop:
            raise _Stop
        if result is not None:
            return result
        n, S = x0.shape[0], schedule.body_pose_weight.shape[0]
        return j_pipeline.FitResult(
            x=x0, loss=jnp.ones(n),
            camera_loss=jnp.ones(n), flipped=jnp.zeros(n, bool),
            stage_losses=jnp.ones((S, n)),
            stage_evals=jnp.ones((S, n), jnp.int32),
            camera_evals=jnp.ones(n, jnp.int32))

    def make_collision_fn(faces, **kw):
        seen["collision"].append(dict(faces=np.asarray(faces), **kw))

    saved = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_bench, "build_problem", build_problem)
        mp.setattr(j_pipeline, "fit_batch", fit_batch)
        mp.setattr(j_collision, "make_collision_fn", make_collision_fn)
        mp.setattr(jax, "jit", lambda f, **kw: f)
        try:
            with contextlib.redirect_stdout(out):
                yield seen
        except _Stop:
            pass
        finally:
            for k, v in saved.items():
                jax.config.update(k, v)
    seen["lines"] += [json.loads(ln) for ln in out.getvalue().splitlines()
                      if ln.startswith("{")]


def same_fields(port, ref):
    """Every field of the port's dataclass `port` equals ref's attribute of
    the same name, LBFGSConfig fields included."""
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(got):
            same_fields(got, want)
        else:
            assert got == want, (f.name, got, want)


def same_schedule(port: StageWeights, ref):
    for f in dataclasses.fields(port):
        np.testing.assert_array_equal(getattr(port, f.name).numpy(),
                                      np.asarray(getattr(ref, f.name)),
                                      err_msg=f.name)


def short(opts):
    """JAX options with ITERS iterations in every stage."""
    return opts.replace(lbfgs=opts.lbfgs.replace(max_iters=ITERS),
                        camera_lbfgs=opts.camera_lbfgs.replace(
                            max_iters=ITERS))


def jax_fit(call, options, **kw):
    """The JAX package's fit_batch, jitted, on a recorded call's inputs."""
    args = {**{k: v for k, v in call.items()
               if k in ("edge_idxs", "coll_stage_mask", "collision_fn")},
            **kw}
    return jax.jit(lambda m, jm, fr, x: J_FIT_BATCH(
        m, call["settings"], options, call["schedule"], fr, x, lambda b: b,
        call["joint_map"], joints_model=jm, **args))(
            call["model"], j_joints_model(call["model"]), call["frames"],
            call["x0"])


def port_keys(jax_line):
    """The keys of the port's line for a JAX line: the JAX keys, `device`,
    `git`, and `options` on a line of one configuration."""
    extra = {"device", "git"} | (set() if "round" in jax_line
                                 else {"options"})
    return set(jax_line) | extra


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.abs(b)


# ---------------------------------------------------------------- bench


@pytest.fixture(scope="module")
def jax_bench():
    with jax_program() as seen:
        j_bench.main()
    return seen


def test_bench_options_and_schedule_are_jax_literals(jax_bench):
    calls = jax_bench["calls"]
    assert len(calls) == 1 + 3          # one warm fit, three rounds
    call = calls[0]
    same_fields(bench.options(), call["options"])
    same_schedule(bench.schedule(device="cpu"), call["schedule"])
    np.testing.assert_array_equal(np.asarray(call["edge_idxs"]),
                                  np.asarray(bench.EDGE_IDXS))
    assert call["joints_model"] is not None
    assert jax_bench["batches"] == [bench.BATCH]
    assert bench.ROUNDS == 3 and bench.BASELINE_FPS == j_bench.BASELINE_FPS


def test_bench_fit_matches_jax(jax_bench):
    call = jax_bench["calls"][0]
    jres = jax_fit(call, short(call["options"]))
    p = bench.build(B, V, device="cpu")
    np.testing.assert_array_equal(p.x0.numpy(), np.asarray(call["x0"]))
    with torch_threads(1):
        res = bench.fit(p, bench.with_iters(bench.options(), ITERS),
                        bench.schedule(device="cpu"))
    assert (rel(res.loss.numpy(), jres.loss) <= LOSS_RTOL).all(), \
        rel(res.loss.numpy(), jres.loss)


def test_bench_main_prints_the_jax_keys(jax_bench, monkeypatch):
    seconds = []
    timed_fit = bench.timed_fit

    def timed(*a, **kw):
        out = timed_fit(*a, **kw)
        seconds.append(out[1])
        return out

    monkeypatch.setattr(bench, "timed_fit", timed)
    with torch_threads(1):
        rec = bench.main(["--device", "cpu", "--batch", "2", "--num-verts",
                          str(V), "--max-iters", str(ITERS), "--rounds", "1"])
    (want,) = jax_bench["lines"]
    assert set(rec) == port_keys(want)
    assert rec["metric"] == want["metric"] and rec["unit"] == want["unit"]
    assert rec["device"] == "cpu" and rec["git"]
    assert rec["options"] == dataclasses.asdict(
        bench.with_iters(bench.options(), ITERS))
    assert rec["value"] > 0
    # Both numbers are the unrounded rate (after the warm-up fit), each
    # rounded once: rounding the printed value again can miss by 0.015.
    fps = 2 / (sum(seconds[1:]) / len(seconds[1:]))
    assert rec["value"] == round(fps, 3)
    assert rec["vs_baseline"] == round(fps / 0.05, 2)


# ---------------------------------------------------------------- collision


@pytest.fixture(scope="module")
def jax_collision():
    with jax_program() as seen:
        j_bench_collision.run_mono(B, ITERS, 8, "iter")
    return seen


def test_collision_options_schedule_and_faces_are_jaxs(jax_collision,
                                                       monkeypatch):
    with jax_program() as seen:
        jopts = j_bench_collision.build(8, 30, 8, "iter")[-1]
        jvariant = j_bench_collision.build(2, 12, 4, "iter", "armijo", 90,
                                           True, 4)[-1]
    built = []

    def record(faces, **kw):
        built.append(dict(faces=faces.numpy(), **kw))

    monkeypatch.setattr(bench_collision, "make_collision_fn", record)
    cp = bench_collision.build(B, V, device="cpu")
    want, (got,) = seen["collision"][0], built
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(value), err_msg=key)
    assert want["faces"].shape == (bench_collision.NUM_FACES, 3)

    (call,) = jax_collision["calls"][:1]
    same_fields(bench_collision.options(), jopts)
    same_fields(bench_collision.options(12, 4, "armijo", 90, True, 4),
                jvariant)
    same_schedule(cp.schedule, call["schedule"])
    assert call["coll_stage_mask"] == bench_collision.COLL_STAGE_MASK
    assert cp.problem.settings.interpenetration
    same_fields(cp.problem.settings, call["settings"])


def test_collision_fit_matches_jax_at_the_median(jax_collision):
    call = jax_collision["calls"][0]
    segm, parents = j_collision.synthetic_part_segm(F, num_parts=27, seed=0)
    faces = np.random.default_rng(7).integers(0, V, size=(F, 3)).astype(
        np.int32)
    budgets = {k: v for k, v in jax_collision["collision"][0].items()
               if k not in ("faces", "segm", "parents")}
    collision_fn = J_MAKE_COLLISION_FN(jnp.asarray(faces), segm=segm,
                                       parents=parents, **budgets)
    jres = jax_fit(call, short(call["options"]), collision_fn=collision_fn)
    cp = bench_collision.build(B, V, F, device="cpu")
    opts = bench.with_iters(bench_collision.options(ITERS), ITERS)
    with torch_threads(1):
        res, _ = bench_collision.timed_fit(cp, opts)
    got, want = res.loss.numpy(), np.asarray(jres.loss)
    assert np.isfinite(got).all()
    assert rel(np.median(got), np.median(want)) <= LOSS_RTOL, (got, want)


def test_collision_main_prints_the_jax_keys(jax_collision):
    with torch_threads(1):
        lines = bench_collision.main([str(2), str(ITERS), "8", "mono", "both",
                                      "--device", "cpu", "--num-verts",
                                      str(V), "--num-faces", str(F)])
    want = jax_collision["lines"]
    assert len(want) == 2 and len(lines) == 4      # wolfe, then armijo
    for got, ref in zip(lines, want + want):
        assert set(got) == port_keys(ref)
        assert got["mode"] == "mono" and got["device"] == "cpu"
    assert [ln["options"]["lbfgs"]["ls_mode"] for ln in lines] == \
        ["wolfe", "wolfe", "armijo", "armijo"]
    with pytest.raises(ValueError, match="tunnel"):
        bench_collision.main(["2", "2", "8", "split", "--device", "cpu"])


# ---------------------------------------------------------------- quality


@pytest.fixture(scope="module")
def quality():
    """The JAX program's call (its init included), its fit at ITERS, its
    record of that fit's x, and the port's fit of the same problem."""
    with jax_program(stop=True) as seen:
        j_bench_quality.main(B=B, ls_mode="armijo", max_evals=90,
                             max_iters=60)
    call = seen["calls"][0]
    jres = jax_fit(call, short(call["options"]))
    with jax_program(result=jres) as fitted:
        j_bench_quality.main(B=B, ls_mode="armijo", max_evals=90,
                             max_iters=60)
    p, gt = bench_quality.build(B, V, device="cpu")
    opts = bench.with_iters(bench_quality.options("armijo", 90, 60), ITERS)
    with torch_threads(1):
        res = bench.fit(p, opts, bench.schedule(device="cpu"))
    return dict(call=call, jres=jres, record=fitted["lines"][0], p=p, gt=gt,
                res=res)


def test_quality_options_and_init_are_jaxs(quality):
    call, p = quality["call"], quality["p"]
    same_fields(bench_quality.options("armijo", 90, 60), call["options"])
    with jax_program(stop=True) as seen:
        j_bench_quality.main(B=B, ls_mode="wolfe")
    same_fields(bench_quality.options(), seen["calls"][0]["options"])
    same_schedule(bench.schedule(device="cpu"), call["schedule"])
    np.testing.assert_array_equal(p.x0.numpy(), np.asarray(call["x0"]))
    np.testing.assert_array_equal(p.frames.gt_joints.numpy().shape,
                                  np.asarray(call["frames"].gt_joints).shape)
    np.testing.assert_allclose(p.frames.gt_joints.numpy(),
                               np.asarray(call["frames"].gt_joints),
                               atol=1e-3)


def test_quality_fit_matches_jax(quality):
    got, want = quality["res"].loss.numpy(), np.asarray(quality["jres"].loss)
    assert (rel(got, want) <= LOSS_RTOL).all(), rel(got, want)


def test_quality_metrics_match_jax_on_the_same_fit(quality):
    p, gt, jrec = quality["p"], quality["gt"], quality["record"]
    x = torch.as_tensor(np.array(quality["jres"].x))
    out, _, _ = recover_outputs(p.model, p.settings, x, lambda b: b,
                                device="cpu")
    j_out, _, _ = j_pipeline.recover_outputs(
        quality["call"]["model"], quality["call"]["settings"],
        quality["jres"].x, lambda b: b)
    np.testing.assert_allclose(out.vertices.numpy(),
                               np.asarray(j_out.vertices), atol=1e-5)
    m = bench_quality.quality_metrics(p.model, p.settings, x, gt, p.frames,
                                      p.joint_map)
    rec = bench_quality.record(m, "armijo", 90, 60, torch.device("cpu"),
                               np.asarray(quality["jres"].stage_evals), V, 0.0)
    assert set(rec) == set(jrec)
    for key in ("value", "p90_mm", "max_mm", "body_mm", "face_mm",
                "hands_mm", "pa_mpjpe14_mm", "reproj_px_mean",
                "reproj_px_max"):
        assert abs(rec[key] - jrec[key]) <= RECORD_ATOL, (key, rec[key],
                                                          jrec[key])
    for key in ("metric", "unit", "ls_mode", "max_evals", "max_iters",
                "platform", "num_frames", "num_verts", "stage_evals_mean"):
        assert rec[key] == jrec[key], key


def test_quality_main_writes_its_record(tmp_path):
    out = tmp_path / "quality.json"
    with torch_threads(1):
        rec = bench_quality.main([str(2), "armijo", "", str(out), "90",
                                  str(ITERS), "--device", "cpu",
                                  "--num-verts", str(V)])
    assert json.loads(out.read_text()) == rec
    assert rec["platform"] == "cpu" and rec["device"] == "cpu"
    assert rec["num_verts"] == V and rec["num_frames"] == 2
    assert rec["options"] == dataclasses.asdict(
        bench_quality.options("armijo", 90, ITERS))
    with pytest.raises(ValueError, match="QUALITY_r"):
        bench_quality.main(["2", "armijo", "cpu",
                            str(ROOT / "QUALITY_r99.json")])
    assert not (ROOT / "QUALITY_r99.json").exists()


# ---------------------------------------------------------------- A/B


@pytest.fixture(scope="module")
def jax_ab():
    with jax_program() as seen, pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["ab_flagship.py", "2", "2", *AB_SPECS])
        J_AB.main()
    return seen


def test_ab_spec_parsing_and_order_are_jaxs(jax_ab):
    names = [s.split("=")[0] for s in AB_SPECS]
    parsed = dict(map(ab_flagship.parse_spec, AB_SPECS))
    assert list(parsed) == names
    order = names + [n for _, n in ab_flagship.interleave(names, 2)]
    assert order == names + names + names
    calls = jax_ab["calls"]
    assert len(calls) == len(order)
    for name, call in zip(order, calls):
        same_fields(parsed[name], call["options"])
    assert dict(map(ab_flagship.parse_spec, ab_flagship.DEFAULT_SPECS)) \
        .keys() == {"wolfe", "armijo", "wolfe_me90"}
    with pytest.raises(ValueError, match="round"):
        ab_flagship.parse_spec("round=wolfe:0")


def test_ab_main_runs_interleaved_with_jax_keys(jax_ab, monkeypatch):
    specs = ["wolfe=wolfe:0:2", "armijo=armijo:90:2"]
    fitted = []
    fit = bench.fit

    def record(p, opts, stages, **kw):
        fitted.append(opts.lbfgs.ls_mode)
        return fit(p, opts, stages, **kw)

    monkeypatch.setattr(bench, "fit", record)
    with torch_threads(1):
        lines = ab_flagship.main(["2", "1", *specs, "--device", "cpu",
                                  "--num-verts", str(V)])
    assert fitted == ["wolfe", "armijo", "wolfe", "armijo"]
    want = jax_ab["lines"]
    first = [ln for ln in want if "first_run_s" in ln][0]
    final = [ln for ln in want if "median_s" in ln][0]
    rounds = [ln for ln in want if "round" in ln]
    assert [set(ln) for ln in rounds] == [
        {"round", *(s.split("=")[0] for s in AB_SPECS)}] * 2
    kinds = [first, first, {"round": 0, "wolfe": 0, "armijo": 0}, final,
             final]
    assert len(lines) == len(kinds)
    for got, ref in zip(lines, kinds):
        assert set(got) == port_keys(ref), (sorted(got), sorted(ref))
        assert got["device"] == "cpu"
    assert lines[3]["loss_rel_vs_first"] == 0.0
    assert all(np.isfinite(ln["loss_mean"]) for ln in lines[3:])


# ---------------------------------------------------------------- no card


@pytest.mark.parametrize("main, argv", [
    (bench.main, ["--batch", "2", "--num-verts", str(V)]),
    (bench_collision.main, ["2", "2", "--num-verts", str(V), "--num-faces",
                            str(F)]),
    (bench_quality.main, ["2", "armijo", "", "", "90", "2", "--num-verts",
                          str(V)]),
    (ab_flagship.main, ["2", "1", "a=armijo:90:2", "--num-verts", str(V)]),
], ids=["bench", "bench_collision", "bench_quality", "ab_flagship"])
def test_programs_refuse_to_start_without_a_card(main, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        main([*argv, "--device", "cuda"])
