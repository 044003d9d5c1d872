"""Port parity for the data modules and the body-model .pkl loader against
the JAX package, on the CPU: the same generated files read by both give
the same arrays, sizes and genders."""

import dataclasses
import json
import os
import pickle
import struct
import sys
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from smplifyx_tpu.data import gender as jgender
from smplifyx_tpu.data import keypoints as jkp
from smplifyx_tpu.data import regressors as jreg
from smplifyx_tpu.models import bodymodel as jbody

from smplifyx_torch.data import gender as tgender
from smplifyx_torch.data import keypoints as tkp
from smplifyx_torch.data import regressors as treg
from smplifyx_torch.models import bodymodel as tbody
from smplifyx_torch.ops.rotation import batch_rodrigues
from smplifyx_torch.problem import (
    png_bytes,
    slice_model,
    write_app_inputs,
    write_smplx_npz,
)

REG_TOL = 1e-6
FLAGS = [dict(use_hands=True, use_face=True, use_face_contour=True),
         dict(use_hands=True, use_face=True, use_face_contour=False),
         dict(use_hands=False, use_face=True, use_face_contour=True),
         dict(use_hands=False, use_face=False, use_face_contour=False)]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Three frames of the slice's problem at V=96 as a user's files, with
    a second person and a gender_gt in frame 0, and PARE results."""
    root = tmp_path_factory.mktemp("data")
    inputs = write_app_inputs(str(root), batch=3, num_verts=96,
                              genders=["male", "female", "male"])
    keyp = root / "data" / "keypoints" / f"{inputs.names[0]}_keypoints.json"
    doc = json.loads(keyp.read_text())
    second = dict(doc["people"][0])
    second["pose_keypoints_2d"] = [v + 1.5 for v in second["pose_keypoints_2d"]]
    second["gender_gt"] = "female"
    doc["people"].append(second)
    keyp.write_text(json.dumps(doc))
    rng = np.random.default_rng(4)
    os.makedirs(root / "pare")
    for name in inputs.names:
        R = batch_rodrigues(torch.as_tensor(rng.normal(0, 0.3, (24, 3)),
                                            dtype=torch.float32))
        with open(root / "pare" / f"{name}.pkl", "wb") as f:
            pickle.dump({"pred_pose": R.numpy()[None],
                         "pred_cam": np.array([[0.9, 0.02, -0.1]], np.float32),
                         "bboxes": np.array([[400.0, 300.0, 380.0, 380.0]],
                                            np.float32)}, f)
    return root, inputs


def _datasets(root, **flags):
    kw = dict(data_folder=str(root / "data"), joints_to_ign=[1, 9, 12], **flags)
    return (jkp.create_dataset(use_native_parser=False, **kw),
            tkp.create_dataset(**kw))


def _same_record(a, b):
    assert (a.fn, a.img_path, a.img_size, a.keyp_path) == \
        (b.fn, b.img_path, b.img_size, b.keyp_path)
    assert (a.gender_gt, a.gender_pd) == (b.gender_gt, b.gender_pd)
    assert a.keypoints.dtype == b.keypoints.dtype
    np.testing.assert_array_equal(a.keypoints, b.keypoints)


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(
    k[4:] for k, v in f.items() if v) or "body")
def test_dataset_matches_jax(folder, flags):
    root, _ = folder
    jds, tds = _datasets(root, **flags)
    assert len(jds) == len(tds) == 3
    assert tds.num_joints == jds.num_joints
    assert (tds.left_shoulder, tds.right_shoulder) == (jds.left_shoulder,
                                                       jds.right_shoulder)
    np.testing.assert_array_equal(tds.get_joint_weights(), jds.get_joint_weights())
    for a, b in zip(jds, tds):
        _same_record(a, b)
    _same_record(jds[1], tds[1])
    first = tds[0]
    assert first.keypoints.shape == (2, tds.num_joints, 3)
    assert first.gender_gt == ["female"] and first.gender_pd == ["male", "male"]


def test_keypoints_are_the_problem_s(folder):
    """Rows of the JSON land where the in-memory problem has them."""
    root, inputs = folder
    _, tds = _datasets(root, **FLAGS[0])
    kp = np.stack([r.keypoints[0] for r in tds])
    np.testing.assert_array_equal(kp[..., :2], inputs.frames.gt_joints.numpy())
    np.testing.assert_array_equal(kp[..., 2], inputs.frames.conf.numpy())


def test_image_sizes_match_jax(tmp_path):
    """PNG and JPEG headers (no decode); an unknown header gives None."""
    png = tmp_path / "a.png"
    png.write_bytes(png_bytes(17, 9))
    jpg = tmp_path / "b.jpg"
    app0 = b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00" + b"\x00" * 9
    sof = b"\xff\xc0" + struct.pack(">HBHHB", 11, 8, 33, 21, 1) + b"\x00" * 3
    jpg.write_bytes(b"\xff\xd8" + app0 + sof + b"\xff\xd9")
    other = tmp_path / "c.png"
    other.write_bytes(b"not an image at all, just bytes")
    for path, want in ((png, (9, 17)), (jpg, (33, 21)), (other, None)):
        assert tkp._jpeg_png_size(str(path)) == jkp._jpeg_png_size(str(path)) == want


def test_native_parser_is_not_ported(folder):
    """The native parser is ported: each choice of `use_native_parser`
    reads the same three records (tests/test_torch_blending.py holds the
    parser itself against both readers)."""
    root, _ = folder
    reads = {}
    for choice in (True, None, False):
        ds = tkp.create_dataset(data_folder=str(root / "data"),
                                use_native_parser=choice)
        assert ds.use_native_parser is (choice is not False)
        reads[choice] = list(ds)
        assert len(reads[choice]) == 3
    for a, b, c in zip(*reads.values()):
        _same_record(a, b)
        _same_record(a, c)
    with pytest.raises(ValueError, match="format"):
        tkp.create_dataset(format="mpii", data_folder=str(root / "data"))


KINDS = ["ExPose", "PIXIE", "PARE", "combined"]


@pytest.mark.parametrize("use_camera_prior", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_regression_prior_matches_jax(folder, kind, use_camera_prior):
    root, inputs = folder
    for name in inputs.names:
        files = {}
        for mod, key in ((jreg, "j"), (treg, "t")):
            files[key] = dict(
                expose=mod.load_expose(str(root / "expose"), name),
                pixie=mod.load_pixie(str(root / "pixie"), name),
                pare=mod.load_pare(str(root / "pare"), name))
        want = jreg.build_regression_prior(kind, 1000.0,
                                           use_camera_prior=use_camera_prior,
                                           **files["j"])
        got = treg.build_regression_prior(kind, 1000.0,
                                          use_camera_prior=use_camera_prior,
                                          **files["t"])
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if b is None:
                assert a is None, f.name
            else:
                assert a.dtype == np.float32 and a.shape == b.shape, f.name
                np.testing.assert_allclose(a, b, rtol=0, atol=REG_TOL,
                                           err_msg=f.name)
    with pytest.raises(ValueError, match="Unknown"):
        treg.build_regression_prior("HMR", 1000.0)


def test_rotmats_to_pose_matches_jax():
    rng = np.random.default_rng(3)
    aa = torch.as_tensor(rng.normal(0, 0.8, (40, 3)), dtype=torch.float32)
    R = batch_rodrigues(aa).numpy()
    R[0] = [[0, 0, 1], [0, 1, 0], [-1, 0, 0]]     # gimbal lock, b = pi/2
    np.testing.assert_allclose(treg.rotmats_to_pose(R), jreg.rotmats_to_pose(R),
                               rtol=0, atol=REG_TOL)


def test_group_by_gender_matches_jax(folder):
    root, _ = folder
    jds, tds = _datasets(root, **FLAGS[0])
    for default in ("neutral", "female"):
        want = jgender.group_by_gender(list(jds), default=default)
        got = tgender.group_by_gender(list(tds), default=default)
        assert {g: [r.fn for r in rs] for g, rs in got.items()} == \
            {g: [r.fn for r in rs] for g, rs in want.items()}
    assert sorted(got) == ["female", "male"]


def test_homogenus_hook_raises_helpfully(folder):
    with pytest.raises(ImportError, match="homogenus"):
        tgender.load_homogenus("/nonexistent/ckpt")
    calls = []

    class Inferer:
        def predict_gender_one_img(self, img_dir, keypoints_dir):
            calls.append((img_dir, keypoints_dir))
            return "Female"

    root, _ = folder
    _, tds = _datasets(root, **FLAGS[0])
    rec = dataclasses.replace(tds[2], gender_pd=[], gender_gt=[])
    classify = tgender.homogenus_classifier(Inferer())
    assert tgender.resolve_gender(rec, classifier=classify) == "female"
    assert calls == [(rec.img_path, rec.keyp_path)]
    with pytest.raises(ValueError, match="keyp_path"):
        classify(dataclasses.replace(rec, keyp_path=None))


def _write_pkl(model, path):
    """The model's .npz arrays as a legacy pickle: J_regressor a scipy CSC
    matrix, v_template inside an object of a package that is not there
    when the file is read (as chumpy's Ch in the published .pkl files)."""
    npz = str(path) + ".npz"
    write_smplx_npz(model, npz)
    raw = dict(np.load(npz))
    raw["J_regressor"] = sp.csc_matrix(raw["J_regressor"])
    mod = types.ModuleType("missing_chumpy")

    class Ch:
        pass

    Ch.__module__, Ch.__qualname__ = "missing_chumpy", "Ch"
    mod.Ch = Ch
    ch = Ch()
    ch.x = raw["v_template"]
    raw["v_template"] = ch
    raw["bs_style"] = b"lbs"         # non-array fields are skipped
    sys.modules["missing_chumpy"] = mod
    try:
        with open(path, "wb") as f:
            pickle.dump(raw, f)
    finally:
        del sys.modules["missing_chumpy"]
    return npz


def test_pkl_loader_matches_jax(tmp_path):
    model = slice_model(96, "cpu")
    pkl = tmp_path / "SMPLX_NEUTRAL.pkl"
    npz = _write_pkl(model, pkl)
    want = jbody.load_body_model(str(pkl), "smplx")
    got = tbody.load_body_model(str(pkl), "smplx", device="cpu")
    from_npz = tbody.load_body_model(npz, "smplx", device="cpu")
    for f in dataclasses.fields(got):
        a = getattr(got, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(want, f.name)),
                                          err_msg=f.name)
            assert torch.equal(a, getattr(from_npz, f.name)), f.name
        elif f.name != "lbs_plan":
            assert a == getattr(want, f.name), f.name
    assert torch.equal(got.v_template, model.v_template)


def test_session_resolves_npz_then_pkl(tmp_path):
    """{model_folder}/smplx/SMPLX_<GENDER>.npz first, .pkl after it."""
    from smplifyx_torch.problem import slice_config
    from smplifyx_torch.session import build_fit_session

    folder = tmp_path / "smplx"
    folder.mkdir()
    model = slice_model(96, "cpu")
    npz = _write_pkl(model, folder / "SMPLX_MALE.pkl")
    os.replace(npz, folder / "SMPLX_FEMALE.npz")
    cfg = slice_config(96, synthetic_model=False, model_folder=str(tmp_path),
                       interpenetration=False)
    session = build_fit_session(cfg, device="cpu")
    for gender in ("male", "female"):
        assert torch.equal(session.get_model(gender).v_template, model.v_template)
    with pytest.raises(FileNotFoundError):
        session.get_model("neutral")


# ------------------------------------------------------------ io and timing

def test_mesh_and_result_files_match_jax(tmp_path):
    from smplifyx_tpu.utils import io as jio
    from smplifyx_torch.utils import io as tio

    rng = np.random.default_rng(5)
    verts = rng.normal(size=(50, 3)).astype(np.float32)
    faces = rng.integers(0, 50, (30, 3))
    for binary in (True, False):
        tio.write_ply(str(tmp_path / "t.ply"), verts, faces, binary=binary)
        jio.write_ply(str(tmp_path / "j.ply"), verts, faces, binary=binary)
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
        v, f = tio.read_ply(str(tmp_path / "j.ply"))
        np.testing.assert_array_equal(v, verts)
        np.testing.assert_array_equal(f, faces)
    tio.write_obj(str(tmp_path / "t.obj"), verts, faces)
    jio.write_obj(str(tmp_path / "j.obj"), verts, faces)
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()
    kw = dict(camera_translation=verts[0], camera_center=verts[1, :2],
              focal_length=1000.0, H=600, W=800,
              params={"betas": verts[:3].reshape(-1), "jaw_pose": verts[4]},
              body_pose=rng.normal(size=63), loss=12.5)
    tio.save_result_pickle(str(tmp_path / "t.pkl"), **kw)
    jio.save_result_pickle(str(tmp_path / "j.pkl"), **kw)
    assert (tmp_path / "t.pkl").read_bytes() == (tmp_path / "j.pkl").read_bytes()
    assert tio.load_result_pickle(str(tmp_path / "j.pkl"))["loss"] == 12.5


def test_timing_matches_jax(tmp_path):
    from smplifyx_tpu.utils import timing as jtiming
    from smplifyx_torch.utils import timing as ttiming

    timer = ttiming.Timer()
    for _ in range(2):
        with timer.span("fit", block_on=torch.zeros(2)):
            pass
    with timer.span("write"):
        pass
    assert list(timer.spans) == ["fit", "write"]
    jt = jtiming.Timer(spans=dict(timer.spans))
    assert timer.report() == jt.report()
    rng = np.random.default_rng(6)
    kw = dict(losses=rng.random(7), camera_losses=rng.random(7),
              flipped=rng.random(7) > 0.5, stage_evals=rng.integers(1, 9, (3, 7)))
    assert ttiming.FitStats(**kw).summary() == jtiming.FitStats(**kw).summary()
    with ttiming.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
