"""Port parity for batch assembly (`prepare_batch`, `pad_prepared`) against
the JAX package, on the CPU: every FrameData field and x0 equal, or within
1e-5 where VPoser encodes the regression pose."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from smplifyx_tpu.data import keypoints as jkp
from smplifyx_tpu.data import regressors as jreg
from smplifyx_tpu.fitting import prepare as jprep
from smplifyx_tpu.models import vposer as jv
from smplifyx_tpu.priors.priors import synthetic_gmm as j_synthetic_gmm
from smplifyx_tpu.utils.config import load_config as j_load_config

from smplifyx_torch.app import regression_priors
from smplifyx_torch.data import keypoints as tkp
from smplifyx_torch.fitting import prepare as tprep
from smplifyx_torch.fitting.params import unpack
from smplifyx_torch.models import vposer as tv
from smplifyx_torch.priors.priors import synthetic_gmm
from smplifyx_torch.problem import APP_PRESET, SLICE_PRESET, write_app_inputs
from smplifyx_torch.utils.config import load_config

CLASSIC = SLICE_PRESET.replace("fit_smplx_combined_coco25", "fit_smplx_smplifyx")
VPOSER_TOL = 1e-5
REG_TOL = 1e-6

# case -> (preset, config overrides, prepare_batch keywords)
CASES = {
    "combined": (SLICE_PRESET, {}, {}),
    "all_persons": (SLICE_PRESET, dict(fit_all_persons=True, max_persons=2),
                    dict(all_persons=True)),
    "confidence_threshold": (SLICE_PRESET, dict(confidence_threshold=0.6), {}),
    "no_camera_prior": (SLICE_PRESET, dict(use_camera_prior=False), {}),
    "padded": (SLICE_PRESET, {}, dict(batch_size=5)),
    "vposer": (APP_PRESET, {}, {}),
    "vposer_no_regression": (CLASSIC, {}, {}),
    "gmm_mean": (SLICE_PRESET, dict(regression_prior=None,
                                    body_prior_type="gmm"), {}),
    "focal_length": (CLASSIC, dict(use_vposer=False), {}),
}


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Three frames at V=96 as files; frame 0 holds three people."""
    root = tmp_path_factory.mktemp("prep")
    inputs = write_app_inputs(str(root), batch=3, num_verts=96)
    keyp = root / "data" / "keypoints" / f"{inputs.names[0]}_keypoints.json"
    doc = json.loads(keyp.read_text())
    for shift in (3.0, -7.0):
        other = dict(doc["people"][0])
        other["pose_keypoints_2d"] = [v + shift for v in other["pose_keypoints_2d"]]
        doc["people"].append(other)
    keyp.write_text(json.dumps(doc))
    return root, inputs


@pytest.fixture(scope="module")
def vposers(folder):
    _, inputs = folder
    path = inputs.overrides["vposer_ckpt"]
    return jv.load_vposer(path), tv.load_vposer(path, device="cpu")


def _prepare(folder, vposers, case):
    preset, overrides, kw = CASES[case]
    _, inputs = folder
    over = {**inputs.overrides, **overrides}
    jcfg, tcfg = j_load_config(preset, **over), load_config(preset, **over)
    ds = dict(format=tcfg.format, data_folder=tcfg.data_folder,
              use_hands=True, use_face=True, use_face_contour=True,
              joints_to_ign=tcfg.joints_to_ign)
    jrecs = list(jkp.create_dataset(use_native_parser=False, **ds))
    trecs = list(tkp.create_dataset(**ds))
    weights = jkp.create_dataset(use_native_parser=False, **ds).get_joint_weights()

    def j_regression():
        if not jcfg.regression_prior:
            return None
        out = []
        for rec in jrecs:
            H, W = rec.img_size
            focal = jcfg.focal_length or float(np.sqrt(W * W + H * H))
            out.append(jreg.build_regression_prior(
                jcfg.regression_prior, focal,
                expose=jreg.load_expose(jcfg.expose_results_directory, rec.fn),
                pixie=jreg.load_pixie(jcfg.pixie_results_directory, rec.fn),
                use_camera_prior=jcfg.use_camera_prior))
        return out

    jvp, tvp = vposers if tcfg.use_vposer else (None, None)
    gmm = (j_synthetic_gmm(8, 63, seed=2), synthetic_gmm(8, 63, seed=2,
                                                         device="cpu"))
    want = jprep.prepare_batch(jcfg, jrecs, weights, regression=j_regression(),
                               vposer=jvp, gmm=gmm[0], **kw)
    got = tprep.prepare_batch(tcfg, trecs, weights,
                              regression=regression_priors(tcfg, trecs),
                              vposer=tvp, gmm=gmm[1], device="cpu", **kw)
    return tcfg, want, got


def _compare(tcfg, want, got):
    """Equal, except what comes from the regressors' Euler angles or an f32
    product (the GMM mean), held to REG_TOL as `build_regression_prior`
    is, and what VPoser encodes, to VPOSER_TOL."""
    assert got.names == want.names and got.num_real == want.num_real
    assert got.img_sizes == want.img_sizes and got.focals == want.focals
    settings = tprep.settings_from_config(tcfg)
    tol = 0.0
    if tcfg.regression_prior is not None:
        tol = VPOSER_TOL if tcfg.use_vposer else REG_TOL
    elif tcfg.body_prior_type == "gmm":
        tol = REG_TOL
    for f in dataclasses.fields(got.frames):
        a = getattr(got.frames, f.name).numpy()
        b = np.asarray(getattr(want.frames, f.name))
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        if f.name == "regression_body":
            np.testing.assert_allclose(a, b, rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    x_got = unpack(settings, got.x0)
    x_want = unpack(settings, torch.as_tensor(np.asarray(want.x0)))
    assert got.x0.shape == want.x0.shape
    for name in x_got:
        if name == "body":
            np.testing.assert_allclose(x_got[name].numpy(), x_want[name].numpy(),
                                       rtol=0, atol=tol)
        elif name == "global_orient":
            np.testing.assert_allclose(x_got[name].numpy(), x_want[name].numpy(),
                                       rtol=0, atol=min(tol, REG_TOL))
        else:
            assert torch.equal(x_got[name], x_want[name]), name


@pytest.mark.parametrize("case", list(CASES))
def test_prepare_batch_matches_jax(folder, vposers, case):
    tcfg, want, got = _prepare(folder, vposers, case)
    _compare(tcfg, want, got)
    if case == "all_persons":
        assert got.names[:2] == ["frame_0000/p0", "frame_0000/p1"]
        assert got.num_real == 4
    if case == "confidence_threshold":
        assert (got.frames.joint_weights[:, :25] == 0).sum() > 3
    if case == "gmm_mean":
        assert got.x0.abs().sum() > 0


@pytest.mark.parametrize("B", [4, 8])
def test_pad_prepared_matches_jax(folder, vposers, B):
    tcfg, want, got = _prepare(folder, vposers, "vposer")
    padded, jpadded = tprep.pad_prepared(got, B), jprep.pad_prepared(want, B)
    _compare(tcfg, jpadded, padded)
    assert padded.x0.shape[0] == B and padded.num_real == 3
    assert torch.equal(padded.x0[-1], got.x0[-1])
    assert tprep.pad_prepared(padded, 3) is padded
    with pytest.raises(ValueError):
        tprep.pad_prepared(padded, 2)


def test_prepare_batch_moves_once_and_refuses_what_jax_asserts(folder):
    root, inputs = folder
    cfg = load_config(SLICE_PRESET, **inputs.overrides)
    recs = list(tkp.create_dataset(data_folder=cfg.data_folder,
                                   use_face_contour=True,
                                   joints_to_ign=cfg.joints_to_ign))
    w = np.ones(135, np.float32)
    batch = tprep.prepare_batch(cfg, recs, w, device="cpu")
    assert all(t.device.type == "cpu" for t in vars(batch.frames).values())
    with pytest.raises(ValueError, match="batch_size"):
        tprep.prepare_batch(cfg, recs, w, batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="keypoints"):
        tprep.prepare_batch(cfg, recs, w[:100], device="cpu")
    vcfg = load_config(APP_PRESET, **inputs.overrides)
    with pytest.raises(ValueError, match="VPoser"):
        tprep.prepare_batch(vcfg, recs, w, regression=regression_priors(vcfg, recs),
                            device="cpu")


# ------------------------------------------------------------ checkpoints

def test_fit_state_round_trips_between_packages(tmp_path):
    from smplifyx_tpu.fitting import checkpoint as jck
    from smplifyx_torch.fitting import checkpoint as tck

    x = np.random.default_rng(1).normal(size=(3, 122)).astype(np.float32)
    tck.save_fit_state(str(tmp_path / "t.npz"), torch.as_tensor(x), ["a", "b", "c"], 2)
    jck.save_fit_state(str(tmp_path / "j.npz"), x, ["a", "b", "c"], 2)
    for path in ("t.npz", "j.npz"):
        for load in (tck.load_fit_state, jck.load_fit_state):
            got, names, stage = load(str(tmp_path / path))
            np.testing.assert_array_equal(got, x)
            assert (names, stage) == (["a", "b", "c"], 2)


@pytest.mark.parametrize("preset", [SLICE_PRESET, APP_PRESET])
def test_warm_start_matches_jax(folder, vposers, tmp_path, preset):
    """x0 from result pickles (one frame has none); under VPoser the saved
    pose is encoded back, within VPOSER_TOL."""
    from smplifyx_tpu.fitting import checkpoint as jck
    from smplifyx_torch.fitting import checkpoint as tck
    from smplifyx_torch.utils.io import save_result_pickle

    rng = np.random.default_rng(2)
    names = ["a", "b", "c"]
    for name in names[:2]:
        os.makedirs(tmp_path / name)
        save_result_pickle(
            str(tmp_path / name / "000.pkl"),
            camera_translation=rng.normal(size=3), camera_center=rng.normal(size=2),
            focal_length=1000.0, H=600, W=800,
            params={k: rng.normal(size=n) for k, n in (
                ("global_orient", 3), ("betas", 10), ("expression", 10),
                ("jaw_pose", 3), ("leye_pose", 3), ("reye_pose", 3),
                ("left_hand_pose", 12), ("right_hand_pose", 12))},
            body_pose=rng.normal(0, 0.2, 63))
    cfg = load_config(preset, **folder[1].overrides)
    settings = tprep.settings_from_config(cfg)
    jsettings = jprep.settings_from_config(j_load_config(preset, **folder[1].overrides))
    jvp, tvp = vposers if cfg.use_vposer else (None, None)
    got, found = tck.warm_start_from_results(str(tmp_path), names, settings, tvp)
    want, jfound = jck.warm_start_from_results(str(tmp_path), names, jsettings, jvp)
    np.testing.assert_array_equal(found, [True, True, False])
    np.testing.assert_array_equal(found, jfound)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=VPOSER_TOL if cfg.use_vposer else 0.0)
