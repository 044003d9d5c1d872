"""Port parity for the visualisation path against the JAX package, on the CPU.

Per-stage snapshots (`FitOptions.keep_stage_params`, `FitResult.stage_x`)
against JAX's `fit_batch(keep_stage_params=True)` at V=96, B=2; the
renders (`viz/render.py`, `viz/pose_grid.py`) against JAX's on the same
arrays; the viewer's page and meshes (`viz/viewer.py`) against JAX's; the
app's `visualize: true` run, the live stream (`viz/live.py`) with its HTTP
server, and the browse, pose-grid and viewer command lines with
`--platform cpu`.  Data: `problem.write_app_inputs` (V=96, two frames) and
the JAX package's generators, passed across as numpy arrays."""

import dataclasses
import http.client
import json
import os
import pickle
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import bench
from smplifyx_tpu.fitting.lbfgs import LBFGSConfig as JConfig
from smplifyx_tpu.fitting.pipeline import FitOptions as JOptions
from smplifyx_tpu.fitting.pipeline import fit_batch as j_fit_batch
from smplifyx_tpu.fitting.prepare import settings_from_config as j_settings
from smplifyx_tpu.fitting.stages import build_stage_schedule as j_schedule
from smplifyx_tpu.models.bodymodel import load_smplx_npz as j_load_npz
from smplifyx_tpu.models.sparse import build_joints_model as j_joints_model
from smplifyx_tpu.ops.camera import CameraParams as JCamera
from smplifyx_tpu.utils.config import load_config as j_load_config
from smplifyx_tpu.viz import pose_grid as jpose_grid
from smplifyx_tpu.viz import render as jrender
from smplifyx_tpu.viz import viewer as jviewer

from smplifyx_torch import convert
from smplifyx_torch.app import run, stage_outputs
from smplifyx_torch.data.keypoints import create_dataset
from smplifyx_torch.fitting.energy import smplify_energy
from smplifyx_torch.fitting.lbfgs import LBFGSConfig
from smplifyx_torch.fitting.params import unpack
from smplifyx_torch.fitting.pipeline import FitOptions, fit_batch, recover_outputs
from smplifyx_torch.fitting.prepare import prepare_batch
from smplifyx_torch.models.bodymodel import load_body_model
from smplifyx_torch.models.sparse import build_joints_model
from smplifyx_torch.ops.camera import CameraParams
from smplifyx_torch.problem import APP_PRESET, SLICE_OVERRIDES, SLICE_PRESET
from smplifyx_torch.problem import write_app_inputs
from smplifyx_torch.session import build_fit_session
from smplifyx_torch.utils.config import load_config
from smplifyx_torch.utils.io import PARAM_KEYS, load_result_pickle
from smplifyx_torch.viz import browse, pose_grid, render, viewer
from smplifyx_torch.viz.live import stream_fit

B, V, ITERS = 2, 96, 10
PIXEL_SHARE = 0.005    # renders of two forwards: f32 rounding at edges
STAGE_RTOL = 0.05      # whole fits agree at loss level (ROADMAP queue 3)


def jfields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name))
                     if hasattr(getattr(obj, f.name), "shape")
                     else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def schedule_args(cfg):
    return (cfg.body_pose_prior_weights, cfg.shape_weights, cfg.expr_weights,
            cfg.hand_pose_prior_weights, cfg.jaw_pose_prior_weights,
            cfg.hand_joints_weights, cfg.face_joints_weights,
            cfg.coll_loss_weights)


@pytest.fixture(scope="module")
def snapshots():
    """One problem fitted by both packages with the stage snapshots kept,
    and by the port without them: the combined preset, collision off,
    both orientations tried."""
    jcfg = j_load_config(SLICE_PRESET, **SLICE_OVERRIDES,
                         interpenetration=False, synthetic_num_verts=V)
    model, _, jframes, x0, jmap = bench.build_problem(B, V)
    js = j_settings(jcfg)
    edges = jnp.asarray(jcfg.body_tri_pairs)
    lb = dict(max_iters=ITERS, history=16, max_ls=4, ls_mode="armijo",
              ls_soft_accept=6, max_evals=3 * ITERS // 2)
    cam = dict(max_iters=ITERS, history=8, ls_soft_accept=6)
    jopt = JOptions(lbfgs=JConfig(**lb), camera_lbfgs=JConfig(**cam),
                    try_both_orient=True, keep_stage_params=True)
    jsched = j_schedule(*schedule_args(jcfg))
    jres = jax.jit(lambda m, jm, fr, x: j_fit_batch(
        m, js, jopt, jsched, fr, x, lambda b: b, jmap, edge_idxs=edges,
        joints_model=jm))(model, j_joints_model(model), jframes, x0)

    tmodel = convert.smplx_model(jfields(model), "cpu")
    args = dict(
        settings=convert.fit_settings(jfields(js)),
        stage_weights=convert.stage_weights(jfields(jsched), "cpu"),
        frames=convert.frame_data(jfields(jframes), "cpu"),
        x0=torch.as_tensor(np.array(x0)), decode_body=lambda b: b,
        joint_map=torch.as_tensor(np.array(jmap), dtype=torch.int64),
        edge_idxs=torch.as_tensor(np.array(edges)),
        joints_model=build_joints_model(tmodel), device="cpu")
    res = {}
    for keep in (True, False):
        opt = FitOptions(lbfgs=LBFGSConfig(**lb),
                         camera_lbfgs=LBFGSConfig(**cam),
                         try_both_orient=True, keep_stage_params=keep)
        res[keep] = fit_batch(tmodel, options=opt, **args)
    return dict(jres=jres, kept=res[True], plain=res[False], tmodel=tmodel,
                args=args)


def test_stage_x_matches_jax(snapshots):
    """[S, B, D] snapshots of the winning orientation; the energy after
    each stage within 5% of JAX's, and each snapshot's energy under its
    stage's weights is the stage's final loss."""
    j, t = snapshots["jres"], snapshots["kept"]
    assert t.stage_x.shape == j.stage_x.shape == (3, B, t.x.shape[1])
    np.testing.assert_allclose(t.stage_losses.numpy(),
                               np.asarray(j.stage_losses), rtol=STAGE_RTOL)
    np.testing.assert_array_equal(t.flipped.numpy(), np.asarray(j.flipped))
    a = snapshots["args"]
    for k in range(3):
        with torch.no_grad():
            f = smplify_energy(
                t.stage_x[k], a["settings"], snapshots["tmodel"], a["frames"],
                a["stage_weights"].stage(k), k, 3, a["decode_body"],
                a["joint_map"], joints_model=a["joints_model"])
        np.testing.assert_allclose(f.numpy(), t.stage_losses[k].numpy(),
                                   rtol=1e-5)


def test_stage_snapshots_change_no_bit(snapshots):
    """The last snapshot is the result, and keeping snapshots leaves the
    fit bit-equal to a fit without them."""
    kept, plain = snapshots["kept"], snapshots["plain"]
    assert torch.equal(kept.stage_x[-1], kept.x)
    assert plain.stage_x is None
    for name in ("x", "loss", "camera_loss", "flipped", "stage_losses",
                 "stage_evals"):
        assert torch.equal(getattr(kept, name), getattr(plain, name)), name


# ---------------------------------------------------------------- renders


def _scene(seed=0, H=96, W=128):
    """A random mesh in front of a camera, an image, keypoints."""
    rng = np.random.default_rng(seed)
    verts = rng.normal(scale=0.3, size=(80, 3)).astype(np.float32)
    faces = rng.integers(0, 80, size=(150, 3))
    img = rng.uniform(size=(H, W, 3)).astype(np.float32)
    cam = dict(rotation=np.eye(3, dtype=np.float32),
               translation=np.asarray([0.05, -0.1, 3.0], np.float32),
               focal=np.asarray([300.0, 310.0], np.float32),
               center=np.asarray([W / 2, H / 2], np.float32))
    kp = np.concatenate([rng.uniform(-5, W + 5, (25, 1)),
                         rng.uniform(-5, H + 5, (25, 1)),
                         rng.uniform(0, 1, (25, 1))], 1).astype(np.float32)
    return verts, faces, img, cam, kp


@pytest.mark.parametrize("seed", [0, 1])
def test_render_mesh_overlay_matches_jax(seed):
    verts, faces, img, cam, _ = _scene(seed)
    tcam = CameraParams(**{k: torch.as_tensor(v) for k, v in cam.items()})
    for image, size in ((img, None), (None, (70, 90))):
        got = render.render_mesh_overlay(image, torch.as_tensor(verts),
                                         torch.as_tensor(faces), tcam,
                                         img_size=size)
        want = jrender.render_mesh_overlay(image, verts, faces, JCamera(**cam),
                                           img_size=size)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        assert (got != render.render_mesh_overlay(
            image, verts, faces[:0], tcam, img_size=size)).any()


def test_overlay_keypoints_matches_jax():
    _, _, img, _, kp = _scene(2)
    got = render.overlay_keypoints(img, kp)
    want = jrender.overlay_keypoints(img, kp)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8


def _differing_share(a, b):
    assert a.shape == b.shape
    return float((a != b).any(-1).mean())


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("viz")
    return write_app_inputs(str(root), batch=B, num_verts=V)


@pytest.fixture(scope="module")
def models(folder):
    """The folder's model as each package reads it."""
    npz = os.path.join(folder.overrides["model_folder"], "smplx",
                       "SMPLX_NEUTRAL.npz")
    return j_load_npz(npz), load_body_model(npz, "smplx", device="cpu")


def _app_config(folder, out, **over):
    return load_config(APP_PRESET, **folder.overrides, output_folder=out,
                       maxiters=2, interactive=False, **over)


@pytest.fixture(scope="module")
def app_runs(folder, tmp_path_factory):
    """The port's app on the folder (VPoser combined preset, collision on)
    with visualize on and off."""
    out = tmp_path_factory.mktemp("app_out")
    runs = {}
    for vis in (True, False):
        cfg = _app_config(folder, str(out / f"vis{int(vis)}"), visualize=vis)
        runs[vis] = (cfg, run(cfg, device="cpu"))
    return runs


def test_render_result_pickle_matches_jax(app_runs, models):
    for pkl in app_runs[True][1].result_files:
        got = render.render_result_pickle(pkl, models[1], device="cpu")
        want = jrender.render_result_pickle(pkl, models[0])
        assert got.shape == want.shape == (600, 800, 3)
        assert _differing_share(got, want) <= PIXEL_SHARE
        assert (got != 255).any()


def test_render_pose_grid_matches_jax(models):
    rng = np.random.default_rng(5)
    poses = rng.normal(scale=0.3, size=(5, 63)).astype(np.float32)
    got = pose_grid.render_pose_grid(models[1], torch.as_tensor(poses),
                                     tile=64)
    want = jpose_grid.render_pose_grid(models[0], poses, tile=64)
    assert got.shape == want.shape == (128, 192, 3)
    assert _differing_share(got, want) <= PIXEL_SHARE
    assert (got != 255).any()


# ---------------------------------------------------------------- app


def test_app_visualize_writes_overlays_and_stages(app_runs, folder, models):
    """output.png, one stage_XX.png per body stage and pose_grid.png per
    frame, each with mesh pixels; the pickles' "stages" (one per body
    stage, the last equal to the final parameters), read by JAX's viewer;
    the final losses bit-equal to the run with visualize off."""
    cfg, res = app_runs[True]
    out = cfg.output_folder
    S = len(cfg.body_pose_prior_weights)
    assert {"viz_forward", "render"} <= set(res.spans)
    np.testing.assert_array_equal(res.losses, app_runs[False][1].losses)
    black = np.zeros((600, 800, 3), np.uint8)   # the folder's images
    for name, pkl in zip(res.names, res.result_files):
        img_dir = os.path.join(out, "images", name)
        files = sorted(os.listdir(img_dir))
        assert files == ["output.png", "pose_grid.png",
                         *[f"stage_{s:02d}.png" for s in range(S)]]
        for f in files:
            pixels = np.asarray(Image.open(os.path.join(img_dir, f)))
            background = 255 if f == "pose_grid.png" else black
            assert (pixels != background).any(), f
        d = load_result_pickle(pkl)
        assert len(d["stages"]) == S
        last = d["stages"][-1]
        np.testing.assert_allclose(last["camera_translation"],
                                   d["camera_translation"][0], atol=1e-6)
        for key in ("body_pose", *PARAM_KEYS):
            np.testing.assert_allclose(last[key], np.reshape(d[key], -1),
                                       atol=1e-6, err_msg=key)
    meshes = jviewer.collect_meshes(os.path.join(out, "results"), models[0],
                                    include_stages=True)
    assert len(meshes) == (S + 1) * B
    assert meshes[0]["name"] == f"{res.names[0]}/stage00"


def test_stage_outputs_rows_match_one_lane_forwards(folder, models):
    """One forward per stage over the group: each row equal, within 1e-6,
    to the forward of that lane alone."""
    cfg = _app_config(folder, "unused", visualize=True)
    sess = build_fit_session(cfg, device="cpu")
    model = models[1]
    rng = np.random.default_rng(6)
    stage_x = torch.as_tensor(rng.normal(scale=0.2, size=(3, B, sess.settings.dim))
                              .astype(np.float32))
    stage_x[..., 2] += 4.0
    got = stage_outputs(sess, model, stage_x, B)
    for s in range(3):
        for i in range(B):
            out, params, _ = recover_outputs(model, sess.settings,
                                             stage_x[s, i:i + 1],
                                             sess.decode_body, device="cpu")
            np.testing.assert_allclose(got.vertices[s][i], out.vertices[0],
                                       atol=1e-6)
            np.testing.assert_allclose(got.body_pose[s][i],
                                       params.body_pose[0], atol=1e-6)
            seg = unpack(sess.settings, stage_x[s, i])
            for k, v in seg.items():
                np.testing.assert_array_equal(got.segs[s][k][i], v.numpy())


# ---------------------------------------------------------------- viewer


def test_export_viewer_html_matches_jax(tmp_path, models):
    rng = np.random.default_rng(7)
    faces = models[1].faces.numpy()
    meshes = [{"name": f"m{i}", "faces": faces,
               "vertices": rng.normal(size=(V, 3)).astype(np.float32)}
              for i in range(3)]
    for title in (None, "the same title"):
        kw = {} if title is None else {"title": title}
        got = viewer.export_viewer_html(meshes, str(tmp_path / "t.html"), **kw)
        want = jviewer.export_viewer_html(meshes, str(tmp_path / "j.html"),
                                          **kw)
        page, jpage = open(got).read(), open(want).read()
        if title is None:
            assert "<title>smplifyx_torch results</title>" in page
            page = page.replace("smplifyx_torch results",
                                "smplifyx_tpu results")
        assert page == jpage


@pytest.mark.parametrize("stages", [True, False])
def test_collect_meshes_matches_jax(app_runs, models, stages, monkeypatch):
    """The port's meshes from the port's pickles against JAX's, forwarded
    in one batch and in chunks of three lanes (each row within 1e-6 of the
    one-batch forward's)."""
    results = os.path.join(app_runs[True][0].output_folder, "results")
    want = jviewer.collect_meshes(results, models[0], include_stages=stages)
    got = viewer.collect_meshes(results, models[1], include_stages=stages)
    monkeypatch.setattr(viewer, "FORWARD_CHUNK", 3)
    chunked = viewer.collect_meshes(results, models[1], include_stages=stages)
    assert [m["name"] for m in got] == [m["name"] for m in want]
    assert len(got) == (4 if stages else 1) * B
    for g, c, w in zip(got, chunked, want):
        np.testing.assert_allclose(g["vertices"], w["vertices"], atol=1e-5)
        np.testing.assert_array_equal(g["faces"], w["faces"])
        # another batch size: f32 products in another blocking
        np.testing.assert_allclose(c["vertices"], g["vertices"], atol=1e-6)


def _get(port, path):
    """GET from the local server over a direct connection (no proxy)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        assert resp.status == 200, (path, resp.status)
        return resp.read().decode()
    finally:
        conn.close()


def test_stream_fit_and_live_server(folder, models, tmp_path):
    """stream_fit writes every frame's pickle after each stage, with the
    snapshots so far; the live server answers / with (S+1) meshes per
    frame and /version changes after a pickle is rewritten."""
    cfg = _app_config(folder, "unused", interpenetration=False)
    sess = build_fit_session(cfg, device="cpu")
    model = models[1]
    records = list(create_dataset(
        format=cfg.format, data_folder=cfg.data_folder,
        use_face_contour=cfg.use_face_contour, joints_to_ign=cfg.joints_to_ign))
    prepared = prepare_batch(cfg, records, sess.joint_weights(),
                             vposer=sess.vposer, device="cpu")
    out = tmp_path / "live"
    seen = []
    for stage, res in stream_fit(sess, model, build_joints_model(model),
                                 prepared, str(out)):
        d = load_result_pickle(str(out / prepared.names[0] / "000.pkl"))
        seen.append((stage, len(d["stages"]), float(res.loss[0]), d["loss"]))
    S = len(cfg.body_pose_prior_weights)
    assert [s[:2] for s in seen] == [(k, k + 1) for k in range(S)]
    assert all(s[2] == s[3] for s in seen)

    server = viewer.serve_live_viewer(str(out), model)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        page = _get(port, "/")
        payload = json.loads(re.search(r"const MESHES = (\[.*?\]);\n",
                                       page).group(1))
        assert len(payload) == (S + 1) * B
        ver = json.loads(_get(port, "/version"))["ver"]
        pkl = out / prepared.names[0] / "000.pkl"
        d = load_result_pickle(str(pkl))
        d["loss"] = 0.0
        d["rewritten"] = True
        with open(pkl, "wb") as f:
            pickle.dump(d, f)
        assert json.loads(_get(port, "/version"))["ver"] != ver
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


# ---------------------------------------------------------------- CLIs


def test_browse_viewer_and_pose_grid_clis(app_runs, folder, tmp_path,
                                          monkeypatch, capsys):
    """The three command lines with --platform cpu; without it they run on
    the card and raise here."""
    results = os.path.join(app_runs[True][0].output_folder, "results")
    models_dir = folder.overrides["model_folder"]
    overlays = browse.main(["--results", results, "--out",
                            str(tmp_path / "overlays"), "--images",
                            os.path.join(folder.overrides["data_folder"],
                                         "images"),
                            "--model_folder", models_dir, "--platform", "cpu"])
    assert [os.path.basename(p) for p in overlays] == [
        f"{n}_overlay.png" for n in app_runs[True][1].names]
    for path in overlays:
        assert np.asarray(Image.open(path)).any()
    html = tmp_path / "view.html"
    viewer.main(["--results", results, "--out", str(html), "--stages",
                 "--model_folder", models_dir, "--platform", "cpu"])
    assert html.read_text().count('"name":') == 4 * B
    grid = tmp_path / "grid.png"
    pose_grid.main([str(grid), "--n", "4", "--tile", "64",
                    "--model_folder", models_dir, "--vposer_ckpt",
                    folder.overrides["vposer_ckpt"], "--platform", "cpu"])
    pixels = np.asarray(Image.open(grid))
    assert pixels.shape == (128, 128, 3) and (pixels != 255).any()
    capsys.readouterr()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((browse.main, ["--results", results, "--out",
                                      str(tmp_path / "x")]),
                       (viewer.main, ["--results", results, "--out",
                                      str(tmp_path / "x.html")]),
                       (pose_grid.main, [str(tmp_path / "x.png")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv + ["--model_folder", models_dir])
