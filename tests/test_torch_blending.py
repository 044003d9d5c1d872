"""The port's keypoint blending and native keypoint parser against the JAX
package's, on the CPU: blending bit-equal on seeded inputs, the same JSON
files written by `blend_directory` and the CLI, and the parser equal to
the port's Python reader and to JAX's `read_keypoints_native`, through the
dataset for every choice of `use_native_parser`."""

import json
import os

import numpy as np
import pytest

from smplifyx_tpu.data import blending as jb
from smplifyx_tpu.data import native as jnative

from smplifyx_torch.data import blend_cli
from smplifyx_torch.data import blending as tb
from smplifyx_torch.data import keypoints as tkp
from smplifyx_torch.data import native
from smplifyx_torch.ops import nvcc
from smplifyx_torch.problem import png_bytes

FLAGS = [dict(use_hands=True, use_face=True, use_face_contour=True),
         dict(use_hands=True, use_face=True, use_face_contour=False),
         dict(use_hands=False, use_face=True, use_face_contour=True),
         dict(use_hands=True, use_face=False, use_face_contour=False),
         dict(use_hands=False, use_face=False, use_face_contour=False)]


def flag_id(f):
    return "-".join(k[4:] for k, v in f.items() if v) or "body"


def heuristics(seed):
    rng = np.random.default_rng(seed)
    n = len(tb.pair_names())
    return {"openpose_means": rng.uniform(0.3, 0.7, n).astype(np.float32),
            "openpose_stds": rng.uniform(0.1, 0.3, n).astype(np.float32),
            "mmpose_means": rng.uniform(0.3, 0.7, n).astype(np.float32),
            "mmpose_stds": rng.uniform(0.1, 0.3, n).astype(np.float32)}


def detections(seed, people=None):
    rng = np.random.default_rng(seed)
    lead = () if people is None else (people,)
    op = rng.uniform(0, 1, lead + (tb.OPENPOSE_TOTAL, 3)).astype(np.float32)
    mm = rng.uniform(0, 1, lead + (tb.MMPOSE_TOTAL, 3)).astype(np.float32)
    op[..., :2] *= 800.0
    mm[..., :2] *= 800.0
    return op, mm


def test_tables_match_jax():
    assert tb.pair_names() == jb.pair_names()
    for name in ("MM_IDX", "OP_IDX", "IS_FACE"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name))
    assert tb.BODY_PAIRS == jb.BODY_PAIRS
    for k, v in tb.identity_heuristics().items():
        np.testing.assert_array_equal(v, jb.identity_heuristics()[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calibration_is_bit_equal(seed):
    h = heuristics(seed)
    conf = np.random.default_rng(seed + 10).uniform(
        0, 1, (4, len(tb.pair_names()))).astype(np.float32)
    args = (conf, h["mmpose_means"], h["mmpose_stds"], h["openpose_means"],
            h["openpose_stds"])
    np.testing.assert_array_equal(tb.calibrate_confidences(*args),
                                  jb.calibrate_confidences(*args))


@pytest.mark.parametrize("people", [None, 3], ids=["one", "batch"])
@pytest.mark.parametrize("seed", [0, 1])
def test_blend_is_bit_equal(seed, people):
    op, mm = detections(seed, people)
    mm[..., 5:9, 2] = 10.0               # MMPose certain somewhere
    op[..., 40:44, 2] = 10.0             # OpenPose certain elsewhere
    for h in (heuristics(seed), tb.identity_heuristics()):
        got = tb.blend_keypoints(op, mm, h)
        want = jb.blend_keypoints(op, mm, h)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def write_heuristics(folder, h):
    os.makedirs(folder, exist_ok=True)
    for key, values in h.items():
        with open(os.path.join(folder, key + ".json"), "w") as f:
            json.dump(dict(zip(tb.pair_names(), values.tolist())), f)


def test_load_heuristics_matches_jax(tmp_path):
    write_heuristics(tmp_path, heuristics(4))
    got, want = tb.load_heuristics(str(tmp_path)), jb.load_heuristics(str(tmp_path))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_written_json_is_the_same_file(tmp_path):
    op, mm = detections(5)
    out = tb.blend_keypoints(op, mm, heuristics(5))
    tb.write_openpose_json(out, str(tmp_path / "t.json"))
    jb.write_openpose_json(out, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def person(rng, body, face, **extra):
    return {"person_id": [-1], **extra,
            "pose_keypoints_2d": rng.uniform(0, 800, body * 3).tolist(),
            "hand_left_keypoints_2d": rng.uniform(0, 800, 63).tolist(),
            "hand_right_keypoints_2d": rng.uniform(0, 800, 63).tolist(),
            "face_keypoints_2d": rng.uniform(0, 800, face * 3).tolist()}


@pytest.fixture(scope="module")
def blend_inputs(tmp_path_factory):
    """Three images with OpenPose (BODY_25, 70 face points) and MMPose
    (Halpe-26, 68 face points) JSONs, and a heuristics folder."""
    root = tmp_path_factory.mktemp("blend")
    rng = np.random.default_rng(6)
    for sub in ("images", "op", "mm"):
        os.makedirs(root / sub)
    for name in ("a", "b", "c"):
        (root / "images" / f"{name}.png").write_bytes(png_bytes(8, 6))
        with open(root / "op" / f"{name}_keypoints.json", "w") as f:
            json.dump({"people": [person(rng, 25, 70)]}, f)
        with open(root / "mm" / f"{name}_mmpose.json", "w") as f:
            json.dump({"people": [person(rng, 26, 68)]}, f)
    write_heuristics(root / "heur", heuristics(7))
    return root


@pytest.mark.parametrize("heur", [True, False], ids=["heuristics", "identity"])
def test_blend_directory_writes_the_same_files(blend_inputs, tmp_path, heur):
    root = blend_inputs
    args = [str(root / s) for s in ("images", "op", "mm")]
    hdir = str(root / "heur") if heur else None
    got = tb.blend_directory(*args, str(tmp_path / "t"), hdir)
    want = jb.blend_directory(*args, str(tmp_path / "j"), hdir)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want] == [
        f"{n}_blended.json" for n in ("a", "b", "c")]
    for g, w in zip(got, want):
        assert open(g, "rb").read() == open(w, "rb").read()
    kp = tkp.read_keypoints(got[0], True, True, True)
    assert kp.keypoints.shape == (1, 135, 3)


def test_blend_cli(blend_inputs, tmp_path, capsys):
    root = blend_inputs
    out = tmp_path / "cli"
    blend_cli.main(["--images", str(root / "images"), "--openpose",
                    str(root / "op"), "--mmpose", str(root / "mm"), "--out",
                    str(out), "--heuristics", str(root / "heur")])
    assert "blended 3 frame(s)" in capsys.readouterr().out
    want = jb.blend_directory(*[str(root / s) for s in ("images", "op", "mm")],
                              str(tmp_path / "j"), str(root / "heur"))
    for w in want:
        assert (out / os.path.basename(w)).read_bytes() == open(w, "rb").read()


# ---------------------------------------------------------------- native


@pytest.fixture(scope="module")
def keypoint_files(tmp_path_factory):
    """OpenPose JSONs: two people, one person with extra keys of every JSON
    kind, no people at all, and a Halpe-26 body."""
    root = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(11)
    docs = {
        "two": {"version": 1.3, "people": [person(rng, 25, 70),
                                           person(rng, 25, 70)]},
        "extras": {"meta": {"a": [1, {"b": "c]"}], "d": None, "e": True},
                   "people": [person(rng, 25, 70, note="x\"y",
                                     part_candidates=[[1.5, 2], []])]},
        "empty": {"people": []},
        "halpe": {"people": [person(rng, 26, 70)]},
    }
    paths = {}
    for name, doc in docs.items():
        paths[name] = str(root / f"{name}_keypoints.json")
        with open(paths[name], "w") as f:
            json.dump(doc, f)
    return paths


@pytest.mark.parametrize("flags", FLAGS, ids=flag_id)
@pytest.mark.parametrize("name", ["two", "extras", "empty", "halpe"])
def test_native_parser_matches_both_readers(keypoint_files, name, flags):
    path = keypoint_files[name]
    got = native.read_keypoints_native(path, **flags)
    py = tkp.read_keypoints(path, **flags).keypoints
    jx = jnative.read_keypoints_native(path, **flags)
    assert got.dtype == py.dtype == jx.dtype == np.float32
    np.testing.assert_array_equal(got, py)
    np.testing.assert_array_equal(got, jx)


def test_native_library_is_the_port_s_own():
    lib = native.load()
    assert nvcc.library(native.LIBRARY) == nvcc.BUILD_DIR / "libkeypoints_torch.so"
    assert nvcc.source(native.LIBRARY).parent.name == "csrc"
    assert nvcc.source(native.LIBRARY).parent.parent.name == "smplifyx_torch"
    assert os.path.exists(lib._name)
    assert "csrc/libkeypoints.so" not in lib._name
    assert nvcc.build_command(native.LIBRARY)[:5] == [
        "g++", "-O3", "-fPIC", "-std=c++17", "-shared"]


def test_malformed_file_raises(tmp_path):
    bad = tmp_path / "bad_keypoints.json"
    bad.write_text('{"people": [{"pose_keypoints_2d": [1, 2, x]}]}')
    with pytest.raises(ValueError, match="native parse failed"):
        native.read_keypoints_native(str(bad))


def dataset_folder(root, with_gender):
    rng = np.random.default_rng(12)
    os.makedirs(root / "images")
    os.makedirs(root / "keypoints")
    for i in range(3):
        (root / "images" / f"f{i}.png").write_bytes(png_bytes(800, 600))
        extra = {"gender_gt": "female"} if with_gender and i == 1 else {}
        with open(root / "keypoints" / f"f{i}_keypoints.json", "w") as f:
            json.dump({"people": [person(rng, 25, 70, **extra)]}, f)
    return str(root)


@pytest.mark.parametrize("flags", FLAGS[:2], ids=flag_id)
def test_dataset_reads_equal_for_every_choice(tmp_path, monkeypatch, flags):
    """None and True read with the native parser, False with the Python
    reader, all to the same records; the file with a gender annotation
    takes the Python reader in every case."""
    folder = dataset_folder(tmp_path, with_gender=True)
    calls = []
    parse = native.read_keypoints_native

    def counted(path, **kw):
        calls.append(os.path.basename(path))
        return parse(path, **kw)

    monkeypatch.setattr(native, "read_keypoints_native", counted)
    reads = {}
    for choice in (None, True, False):
        calls.clear()
        ds = tkp.create_dataset(data_folder=folder, use_native_parser=choice,
                                **flags)
        reads[choice] = list(ds)
        assert calls == ([] if choice is False else
                         ["f0_keypoints.json", "f2_keypoints.json"])
    for recs in zip(*reads.values()):
        for r in recs[1:]:
            assert (r.fn, r.img_size, r.gender_gt) == (recs[0].fn,
                                                       recs[0].img_size,
                                                       recs[0].gender_gt)
            np.testing.assert_array_equal(r.keypoints, recs[0].keypoints)
    assert reads[None][1].gender_gt == ["female"]


def test_a_required_parser_that_cannot_build_raises(tmp_path, monkeypatch):
    """use_native_parser=True raises with the compiler's output and never
    gives way to the Python reader; None takes the Python reader."""
    folder = dataset_folder(tmp_path / "data", with_gender=False)
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nvcc, "_loaded", {})
    monkeypatch.setattr(nvcc, "HOST_FLAGS", ["-DNO_SUCH_FLAG", "--no-such-flag"])
    with pytest.raises(RuntimeError, match="no-such-flag"):
        tkp.create_dataset(data_folder=folder, use_native_parser=True)
    ds = tkp.create_dataset(data_folder=folder, use_native_parser=None)
    assert ds.use_native_parser is False
    assert len(list(ds)) == 3
