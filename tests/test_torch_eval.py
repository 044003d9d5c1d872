"""Port parity for the evaluation modules against the JAX package, on the CPU.

The same numpy inputs, drawn from a seed, go through the JAX functions and
their counterparts in `smplifyx_torch.evaluation` and `smplifyx_torch.ops.
camera`: metrics within 1e-5 on [N, 3] and [B, N, 3] inputs, the EHF
constants exactly, the part ids and visible sets equal, and the protocol
over one results tree within 1e-3 mm."""

import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smplifyx_tpu.evaluation import ehf as jehf
from smplifyx_tpu.evaluation import metrics as jmetrics
from smplifyx_tpu.ops import camera as jcamera
from smplifyx_tpu.utils.io import write_ply as j_write_ply

from smplifyx_torch.evaluation import ehf
from smplifyx_torch.evaluation import metrics
from smplifyx_torch.ops import camera
from smplifyx_torch.ops.rotation import batch_rodrigues

TOL = 1e-5
PAIRS = ("procrustes_align", "scale_align", "mpjpe", "v2v_error",
         "procrustes_v2v", "pelvis_mpjpe")


def _similar(rng, X, noise=0.0):
    """X under a random similarity transform, plus gaussian noise."""
    aa = torch.as_tensor(rng.normal(size=(1, 3)).astype(np.float32))
    R = batch_rodrigues(aa)[0].numpy()
    s = rng.uniform(0.5, 2.0)
    t = rng.normal(size=3).astype(np.float32)
    Y = s * ((X + rng.normal(scale=noise, size=X.shape)) @ R.T) + t
    return Y.astype(np.float32)


def _jax(name, *args):
    return np.asarray(getattr(jmetrics, name)(*[jnp.asarray(a) for a in args]))


@pytest.mark.parametrize("shape", [(50, 3), (4, 30, 3)],
                         ids=["single", "batched"])
@pytest.mark.parametrize("name", PAIRS)
def test_metric_matches_jax(name, shape):
    rng = np.random.default_rng(len(name) + len(shape))
    X = rng.normal(size=shape).astype(np.float32)
    Y = _similar(rng, X, noise=0.05)
    got = getattr(metrics, name)(torch.as_tensor(Y), torch.as_tensor(X))
    assert got.shape == _jax(name, Y, X).shape
    np.testing.assert_allclose(got.numpy(), _jax(name, Y, X), atol=TOL)


@pytest.mark.parametrize("shape", [(20, 3), (3, 20, 3)],
                         ids=["single", "batched"])
def test_procrustes_refuses_a_reflection_as_jax_does(shape):
    """A mirrored copy cannot be aligned by a proper rotation: the residual
    stays large, and both packages leave the same residual."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=shape).astype(np.float32)
    Y = X.copy()
    Y[..., 0] *= -1
    got = metrics.procrustes_align(torch.as_tensor(Y), torch.as_tensor(X))
    assert np.abs(got.numpy() - X).max() > 0.1
    np.testing.assert_allclose(got.numpy(), _jax("procrustes_align", Y, X),
                               atol=TOL)


def test_procrustes_undoes_a_similarity_transform():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(4, 50, 3)).astype(np.float32)
    Y = _similar(rng, X)
    np.testing.assert_allclose(
        metrics.procrustes_align(torch.as_tensor(Y), torch.as_tensor(X)).numpy(),
        X, atol=1e-4)
    assert metrics.procrustes_v2v(torch.as_tensor(Y),
                                  torch.as_tensor(X)).max() < 1e-3


def test_pelvis_align_matches_jax():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(2, 7, 3)).astype(np.float32)
    for hips in ((2, 3), (0, 5)):
        got = metrics.pelvis_align(torch.as_tensor(X), hips)
        want = jmetrics.pelvis_align(jnp.asarray(X), hips)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("thresh", [1e-3, 0.05, 0.3])
def test_point_fscore_matches_jax(thresh, monkeypatch):
    """Per lane against the JAX package's single-set function, in one pass
    and in chunks of a few rows (the card's path at V=10475)."""
    rng = np.random.default_rng(4)
    gt = rng.normal(size=(3, 40, 3)).astype(np.float32)
    pred = (gt[:, :33] + rng.normal(scale=0.05, size=(3, 33, 3))).astype(
        np.float32)
    whole = metrics.point_fscore(torch.as_tensor(pred), torch.as_tensor(gt),
                                 thresh)
    monkeypatch.setattr(metrics, "FSCORE_BLOCK", 3 * 40 * 3 * 4)
    chunked = metrics.point_fscore(torch.as_tensor(pred), torch.as_tensor(gt),
                                   thresh)
    for b in range(3):
        want = jmetrics.point_fscore(jnp.asarray(pred[b]), jnp.asarray(gt[b]),
                                     thresh)
        for key in ("fscore", "precision", "recall"):
            assert abs(float(whole[key][b]) - float(want[key])) <= TOL, key
            assert torch.equal(whole[key], chunked[key]), key
    same = metrics.point_fscore(torch.as_tensor(gt[0]), torch.as_tensor(gt[0]),
                                1e-3)
    assert float(same["fscore"]) == 1.0


def test_ehf_cameras_match_jax():
    for xmin, ymin in ((0.0, 0.0), (123.5, 41.25)):
        got = camera.ehf_gt_camera(xmin, ymin, device="cpu")
        want = jcamera.ehf_gt_camera(xmin, ymin)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_allclose(got.center.numpy(), np.asarray(want.center),
                                   atol=1e-7, rtol=0)
    assert camera.EHF_IMG_SIZE == jcamera.EHF_IMG_SIZE
    for shape in ((), (2, 3)):
        got = camera.identity_camera(shape, 1234.5, device="cpu")
        want = jcamera.identity_camera(shape, 1234.5)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _gt_vertices(num_verts=300, seed=5):
    """Ground-truth vertices in front of the EHF camera, projecting near
    the image's centre (as tests/test_evaluation.py places them)."""
    rng = np.random.default_rng(seed)
    cam = jcamera.ehf_gt_camera()
    R, t = np.asarray(cam.rotation), np.asarray(cam.translation)
    pts = rng.uniform([-0.3, -0.4, 1.2], [0.3, 0.4, 2.2], size=(num_verts, 3))
    return ((pts.astype(np.float32) - t) @ R).astype(np.float32)


def test_part_ids_and_visibility_match_jax():
    for n, seed in ((300, 0), (10475, 3)):
        got = ehf.synthetic_part_vertex_ids(n, seed)
        want = jehf.synthetic_part_vertex_ids(n, seed)
        for part in ("body", "face", "left_hand", "right_hand"):
            np.testing.assert_array_equal(getattr(got, part),
                                          getattr(want, part))
    gt = _gt_vertices()
    for xmin, ymin in ((0.0, 0.0), (250.0, 120.0), (5000.0, 5000.0)):
        np.testing.assert_array_equal(
            ehf.visible_indices(gt, xmin, ymin, device="cpu"),
            jehf.visible_indices(gt, xmin, ymin))


def test_evaluate_frame_matches_jax():
    gt = _gt_vertices()
    rng = np.random.default_rng(7)
    fitted = _similar(rng, gt, noise=0.005)
    parts = ehf.synthetic_part_vertex_ids(len(gt), seed=6)
    j14 = np.zeros((14, len(gt)), np.float32)
    for j in range(14):
        j14[j, rng.choice(len(gt), 5, replace=False)] = 0.2
    for box in ((0.0, 0.0), (300.0, 200.0)):
        got = ehf.evaluate_frame(fitted, gt, *box, parts, j14, device="cpu")
        want = jehf.evaluate_frame(fitted, gt, *box, parts, j14)
        for key, value in vars(want).items():
            if value is None:
                assert getattr(got, key) is None, key
            else:
                assert abs(getattr(got, key) - value) <= TOL, key
    assert 0.001 < got.v2v_all < 0.02


def _ehf_tree(tmp_path, gt, rng):
    """An EHF-layout tree of two frames: ground truth, fits, crop boxes, and
    the part-id and J14 files the CLI reads."""
    dirs = {k: tmp_path / k for k in ("EHF", "results", "bbox")}
    for d in dirs.values():
        d.mkdir()
    for name, box in (("01", "0 800 0 600"), ("02", "100 700 50 550")):
        j_write_ply(str(dirs["EHF"] / f"{name}_align.ply"), gt)
        frame = dirs["results"] / f"{name}_cropped"
        frame.mkdir()
        noise = rng.normal(scale=0.003, size=gt.shape).astype(np.float32)
        j_write_ply(str(frame / "vertices.ply"), gt + noise)
        (dirs["bbox"] / f"{name}_cropped.txt").write_text(box)
    parts = ehf.synthetic_part_vertex_ids(len(gt), seed=8)
    files = {"mano_smplx_pkl": tmp_path / "mano.pkl",
             "flame_vertex_ids": tmp_path / "flame.npy",
             "body_vertex_ids": tmp_path / "body.npy",
             "j14_regressor": tmp_path / "j14.pkl"}
    with open(files["mano_smplx_pkl"], "wb") as f:
        pickle.dump({"left_hand": parts.left_hand,
                     "right_hand": parts.right_hand}, f)
    np.save(files["flame_vertex_ids"], parts.face)
    np.save(files["body_vertex_ids"], parts.body)
    j14 = np.zeros((14, len(gt)), np.float32)
    for j in range(14):
        j14[j, rng.choice(len(gt), 5, replace=False)] = 0.2
    with open(files["j14_regressor"], "wb") as f:
        pickle.dump(j14, f)
    return dirs, files, parts, j14


def test_evaluate_ehf_and_its_cli_match_jax(tmp_path, capsys):
    gt = _gt_vertices()
    dirs, files, parts, j14 = _ehf_tree(tmp_path, gt, np.random.default_rng(9))
    args = (str(dirs["results"]), str(dirs["EHF"]), str(dirs["bbox"]))
    want = jehf.evaluate_ehf(*args, parts, j14)
    got = ehf.evaluate_ehf(*args, parts, j14, device="cpu")
    assert got["num_frames"] == want["num_frames"] == 2
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-3, key
    assert 2.0 < got["pa_v2v_all_mm"] < 10.0
    argv = ["--fitted_dir", args[0], "--gt_dir", args[1], "--bbox_dir", args[2],
            *[a for k, v in files.items() for a in (f"--{k}", str(v))],
            "--platform", "cpu"]
    cli = ehf.main(argv)
    assert json.loads(capsys.readouterr().out) == cli
    for key, value in want.items():
        assert abs(cli[key] - value) <= 1e-3, key


def test_evaluation_runs_on_the_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gt = _gt_vertices(50)
    parts = ehf.synthetic_part_vertex_ids(50)
    with pytest.raises(RuntimeError, match="CUDA"):
        ehf.evaluate_frame(gt, gt, 0.0, 0.0, parts)
    with pytest.raises(RuntimeError, match="CUDA"):
        ehf.evaluate_ehf(str(tmp_path), str(tmp_path), str(tmp_path), parts)
    with pytest.raises(RuntimeError, match="CUDA"):
        camera.ehf_gt_camera()
    m = ehf.evaluate_frame(gt, gt, 0.0, 0.0, parts, device="cpu")
    assert m.v2v_all < 1e-5
