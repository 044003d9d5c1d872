"""Port parity for the app path against the JAX package, on the CPU.

Both packages' `app.run` read one generated data folder (`problem.
write_app_inputs`: V=96, two frames) and write their results; names, file
trees, pickle keys and shapes must match and every frame's final loss must
agree within 5% (whole fits agree at loss level, not trajectory level).
Collision off on a synthetic model for three presets, as tests/test_app.py
runs them, and collision on with the folder's own model (`slice_model(96)`,
read from its .npz by both packages)."""

import dataclasses
import os

import numpy as np
import jax
import pytest
import torch

from smplifyx_tpu.app import run as j_run
from smplifyx_tpu.data import regressors as jregressors
from smplifyx_tpu.data.keypoints import create_dataset as j_create_dataset
from smplifyx_tpu.fitting.prepare import prepare_batch as j_prepare_batch
from smplifyx_tpu.models.bodymodel import synthetic_model as j_synthetic_model
from smplifyx_tpu.models.sparse import build_joints_model as j_joints_model
from smplifyx_tpu.session import build_fit_session as j_build_fit_session
from smplifyx_tpu.utils.config import load_config as j_load_config
from smplifyx_tpu.utils.config import parse_cli as j_parse_cli
from smplifyx_tpu.utils.config import save_config as j_save_config

from smplifyx_torch import cli, convert
from smplifyx_torch.app import regression_priors, run
from smplifyx_torch.data.keypoints import create_dataset
from smplifyx_torch.fitting.prepare import prepare_batch
from smplifyx_torch.models.sparse import build_joints_model
from smplifyx_torch.ops.collision import make_collision_fn
from smplifyx_torch.problem import slice_model, write_app_inputs, write_smplx_npz
from smplifyx_torch.session import build_fit_session
from smplifyx_torch.utils.config import load_config, parse_cli, save_config

from tests._torch_parity import (
    ITERS,
    LOSS_RTOL,
    PRESETS,
    configs,
    halpe_folder,
    held_to_jax,
    run_both,
)

V, FRAMES = 96, 2


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("app")
    return write_app_inputs(str(root), batch=FRAMES, num_verts=V)


@pytest.fixture(scope="module")
def models():
    """A synthetic model in both packages (the JAX one converted)."""
    jm = j_synthetic_model(num_verts=V, seed=1)
    fields = {f.name: (np.asarray(getattr(jm, f.name))
                       if hasattr(getattr(jm, f.name), "shape")
                       else getattr(jm, f.name))
              for f in dataclasses.fields(jm)}
    return jm, convert.smplx_model(fields, "cpu")


@pytest.mark.parametrize("preset", ["combined_coco25", "combined_vposer_coco25",
                                    "smplifyx"])
def test_app_matches_jax_collision_off(folder, models, tmp_path, preset):
    held_to_jax(*run_both(preset, str(tmp_path / "out"), models,
                            **folder.overrides, interpenetration=False))


def test_app_matches_jax_collision_on(folder, tmp_path):
    """The chip path at V=96: the VPoser combined preset, collision on, the
    model and part segmentation read from the folder by both packages."""
    held_to_jax(*run_both("combined_vposer_coco25", str(tmp_path / "out"),
                            **folder.overrides))


def test_resume_from_matches_jax(folder, models, tmp_path):
    """A run warm-started from a previous run's result pickles."""
    over = dict(folder.overrides, interpenetration=False)
    first = configs("combined_coco25", str(tmp_path / "first"), **over)[0]
    j_run(first, model=models[0])
    results = os.path.join(first.output_folder, "results")
    jres, tres, outs = run_both("combined_coco25", str(tmp_path / "again"),
                                 models, resume_from=results, **over)
    held_to_jax(jres, tres, outs)


def test_mixed_gender_groups_match_jax(models, tmp_path):
    """Frames annotated with different genders fit as separate groups, in
    the JAX package's order."""
    inputs = write_app_inputs(str(tmp_path / "data"), batch=4, num_verts=V,
                              genders=["male", "female", "female", "male"])
    jres, tres, outs = run_both("combined_coco25", str(tmp_path / "out"),
                                 models, **inputs.overrides,
                                 interpenetration=False)
    assert tres.names == ["frame_0001", "frame_0002", "frame_0000", "frame_0003"]
    held_to_jax(jres, tres, outs)


ARGV = ["--maxiters", "3", "--use_hands", "false", "--init_joints_idxs", "1",
        "2", "--degrees", "0", "90.5", "--gender", "male",
        "--focal_length", "1234.5", "--resume_from", "somewhere",
        "--ls_mode", "wolfe", "--ign_part_pairs", "1,2", "3,4"]


def test_parse_cli_and_save_config_match_jax(tmp_path):
    for argv in (["--config", PRESETS["combined_coco25"], *ARGV], ARGV, []):
        got, want = parse_cli(argv), j_parse_cli(argv)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    path, jpath = tmp_path / "conf.yaml", tmp_path / "jconf.yaml"
    save_config(got, str(path))
    j_save_config(want, str(jpath))
    assert path.read_text() == jpath.read_text()
    assert dataclasses.asdict(j_load_config(str(path))) == dataclasses.asdict(got)
    assert dataclasses.asdict(load_config(str(jpath))) == dataclasses.asdict(got)


@pytest.mark.parametrize("preset", list(PRESETS))
def test_cli_runs_every_preset_on_the_cpu(folder, tmp_path, preset):
    """`python -m smplifyx_torch.cli --config <preset> ... --platform cpu`
    writes conf.yaml and, per frame, 000.pkl, 000.obj and vertices.ply."""
    data = folder.overrides["data_folder"]
    if preset == "combined_halpe":
        data = halpe_folder(data, str(tmp_path / "halpe"))
    out = tmp_path / "out"
    flags = [f"--{k}={v}" for k, v in folder.overrides.items()
             if k != "data_folder"]
    cli.main(["--config", PRESETS[preset], *flags, "--data_folder", data,
              "--output_folder", str(out), "--platform", "cpu",
              "--maxiters", "1", "--interactive", "false"])
    assert (out / "conf.yaml").exists()
    assert load_config(str(out / "conf.yaml")).platform == "cpu"
    for name in folder.names:
        for path in (out / "results" / name / "000.pkl",
                     out / "results" / name / "vertices.ply",
                     out / "meshes" / name / "000.obj"):
            assert path.exists(), path


def test_entry_points_run_on_the_card_unless_asked(folder, tmp_path,
                                                   monkeypatch):
    """Without a card, the default (and "gpu", "cuda") raises before the
    output folder is touched; "tpu" is no platform of the port.  On the
    CPU, visualize writes the overlays."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    out.mkdir()
    (out / "keep").write_text("x")
    for platform in (None, "gpu", "cuda"):
        cfg = load_config(PRESETS["combined_coco25"], **folder.overrides,
                          output_folder=str(out), platform=platform)
        with pytest.raises(RuntimeError, match="CUDA"):
            run(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--config", PRESETS["combined_coco25"],
                  "--output_folder", str(out)])
    with pytest.raises(ValueError, match="platform"):
        run(load_config(PRESETS["combined_coco25"], platform="tpu",
                        output_folder=str(out)))
    assert (out / "keep").exists()
    cfg = load_config(PRESETS["combined_coco25"], **folder.overrides,
                      visualize=True, output_folder=str(out), maxiters=1,
                      interactive=False)
    res = run(cfg, device="cpu")
    for name in res.names:
        assert sorted(os.listdir(out / "images" / name)) == [
            "output.png", "stage_00.png", "stage_01.png", "stage_02.png"]


def test_collision_tables_come_from_the_first_fitted_model(folder, tmp_path):
    """Collision on, gender male and a model folder holding only
    SMPLX_MALE.npz: the session builds its collision tables from the first
    model it fits and never reads a neutral model, as the JAX package."""
    models_dir = tmp_path / "models"
    (models_dir / "smplx").mkdir(parents=True)
    male = models_dir / "smplx" / "SMPLX_MALE.npz"
    write_smplx_npz(slice_model(V, "cpu"), str(male))
    over = dict(folder.overrides, model_folder=str(models_dir), gender="male",
                output_folder=str(tmp_path / "out"), maxiters=1,
                interactive=False)
    cfg = load_config(PRESETS["combined_vposer_coco25"], **over)
    assert cfg.interpenetration
    sess = build_fit_session(cfg, device="cpu")
    assert sess.collision_fn is None
    res = run(cfg, device="cpu")
    assert np.isfinite(res.losses).all() and len(res.result_files) == FRAMES
    sess.fit(*_fit_args(sess, cfg))
    model = sess.get_model("male")
    want = make_collision_fn(model.faces, **sess.collision_args)
    for name in ("faces", "segm", "parents"):
        assert torch.equal(getattr(sess.collision_fn, name),
                           getattr(want, name)), name
    assert (sess.collision_fn.P, sess.collision_fn.T, sess.collision_fn.ign) \
        == (want.P, want.T, want.ign)
    assert not (models_dir / "smplx" / "SMPLX_NEUTRAL.npz").exists()
    jsess = j_build_fit_session(j_load_config(PRESETS["combined_vposer_coco25"],
                                              **over))
    assert jsess.get_model("male").faces.shape == tuple(model.faces.shape)


def _fit_args(sess, cfg):
    """(model, joints model, frames, x0) of the config's data folder."""
    model = sess.get_model(cfg.gender)
    records = list(create_dataset(
        format=cfg.format, data_folder=cfg.data_folder,
        use_face_contour=cfg.use_face_contour,
        joints_to_ign=cfg.joints_to_ign))
    batch = prepare_batch(cfg, records, sess.joint_weights(),
                          regression=regression_priors(cfg, records),
                          vposer=sess.vposer, device="cpu")
    return model, build_joints_model(model), batch.frames, batch.x0


def test_fit_stages_matches_jax(folder, models):
    """FitSession.fit_stages of both packages at loss level, stage by stage;
    the body stages after the head skip the camera stage."""
    over = dict(folder.overrides, interpenetration=False, maxiters=ITERS,
                interactive=False)
    jcfg = j_load_config(PRESETS["combined_coco25"], **over)
    tcfg = load_config(PRESETS["combined_coco25"], **over)
    jsess = j_build_fit_session(jcfg, model=models[0])
    tsess = build_fit_session(tcfg, model=models[1], device="cpu")
    ds = dict(format=tcfg.format, data_folder=tcfg.data_folder,
              use_face_contour=True, joints_to_ign=tcfg.joints_to_ign)
    jrecs = list(j_create_dataset(use_native_parser=False, **ds))
    jreg = [jregressors.build_regression_prior(
        "combined", 1000.0,
        expose=jregressors.load_expose(jcfg.expose_results_directory, r.fn),
        pixie=jregressors.load_pixie(jcfg.pixie_results_directory, r.fn))
        for r in jrecs]
    jbatch = j_prepare_batch(jcfg, jrecs, jsess.joint_weights(), regression=jreg)
    trecs = list(create_dataset(**ds))
    np.testing.assert_array_equal(tsess.joint_weights(), jsess.joint_weights())
    tbatch = prepare_batch(tcfg, trecs, tsess.joint_weights(),
                           regression=regression_priors(tcfg, trecs),
                           device="cpu")
    want = list(jsess.fit_stages(models[0], j_joints_model(models[0]),
                                 jbatch.frames, jax.numpy.asarray(jbatch.x0)))
    got = list(tsess.fit_stages(models[1], build_joints_model(models[1]),
                                tbatch.frames, tbatch.x0))
    assert [k for k, _ in got] == [k for k, _ in want] == [0, 1, 2]
    for (_, t), (_, j) in zip(got, want):
        jl = np.asarray(j.loss)
        assert (np.abs(t.loss.numpy() - jl) / np.abs(jl) <= LOSS_RTOL).all()
        np.testing.assert_array_equal(t.flipped.numpy(), np.asarray(j.flipped))
    assert got[0][1].camera_evals.min() > 0
    assert all(int(r.camera_evals.max()) == 0 for _, r in got[1:])
