"""The port's FitService on the CPU: every case of tests/test_serve.py
(coalescing, gender grouping, determinism, the HTTP frontend, 400 and 503
with backpressure), plus records with no person, stop() flushing the
queue, a failing group, vertices, a served batch against the JAX
package's FitService and against the port's own `session.fit`.

Tiny sizes: V=96, maxiters 2, 4 L-BFGS iterations per stage, the
collision term off, buckets of at least 4 lanes."""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from smplifyx_tpu.data.keypoints import FrameRecord as JFrameRecord
from smplifyx_tpu.models.bodymodel import synthetic_model as j_synthetic_model
from smplifyx_tpu.serve import FitService as JFitService
from smplifyx_tpu.utils.config import load_config as j_load_config

from smplifyx_torch import convert
from smplifyx_torch.data.keypoints import FrameRecord
from smplifyx_torch.fitting.pipeline import recover_outputs
from smplifyx_torch.fitting.prepare import pad_prepared, prepare_batch
from smplifyx_torch.models.sparse import build_joints_model
from smplifyx_torch.serve import (
    FitService,
    ServiceOverloadedError,
    record_from_request,
    serve_http,
)
from smplifyx_torch.utils.config import load_config

OVERRIDES = dict(
    data_folder="/nonexistent", output_folder="unused_serve",
    regression_prior="", use_camera_prior=False, interpenetration=False,
    maxiters=2, lbfgs_iters_per_stage=4, synthetic_model=True,
    synthetic_num_verts=96)
PRESET = "cfg/fit_smplx_combined_coco25.yaml"


def make_cfg(**over):
    return load_config(PRESET, **{**OVERRIDES, **over})


def make_record(seed=0, name="frame", num_joints=135, people=1):
    rng = np.random.default_rng(seed)
    kp = np.zeros((people, num_joints, 3), np.float32)
    kp[..., 0] = rng.uniform(100, 500, (people, num_joints))
    kp[..., 1] = rng.uniform(100, 600, (people, num_joints))
    kp[..., 2] = 0.9
    return FrameRecord(fn=f"{name}_{seed}", img_path=f"{name}_{seed}.jpg",
                       keypoints=kp, img_size=(640, 640))


@pytest.fixture(scope="module")
def jax_model():
    return j_synthetic_model(num_verts=96, seed=0)


@pytest.fixture(scope="module")
def model(jax_model):
    return convert.smplx_model(
        {f.name: (np.asarray(getattr(jax_model, f.name))
                  if hasattr(getattr(jax_model, f.name), "shape")
                  else getattr(jax_model, f.name))
         for f in dataclasses.fields(jax_model)}, "cpu")


@pytest.fixture(scope="module")
def service(model):
    # min_bucket=4: the single fit and the 4-way coalesce share one bucket
    svc = FitService.from_config(make_cfg(), model=model, device="cpu",
                                 max_wait_s=0.3, max_batch=8, min_bucket=4)
    yield svc
    svc.stop()
    assert not svc._worker.is_alive()


class TestFitService:
    def test_single_fit(self, service):
        res = service.fit(make_record(0), timeout=300)
        assert np.isfinite(res["loss"])
        assert len(res["camera_translation"]) == 3
        assert "body" in res["params"]
        assert res["gender"] == "neutral"
        assert all(e >= 1 for e in res["stage_evals"])
        assert len(res["body_pose_decoded"]) == 63
        assert "vertices" not in res

    def test_concurrent_submissions_coalesce(self, service):
        """Concurrent submits land in one micro-batch, and every future
        resolves with its own request's result."""
        before = service.batches_dispatched
        futures = [service.submit(make_record(i)) for i in range(4)]
        results = [f.result(timeout=300) for f in futures]
        assert all(np.isfinite(r["loss"]) for r in results)
        assert service.batches_dispatched == before + 1
        assert [r["name"] for r in results] == [f"frame_{i}" for i in range(4)]

    def test_deterministic_across_calls(self, service):
        a = service.fit(make_record(7), timeout=300)
        b = service.fit(make_record(7), timeout=300)
        assert a["loss"] == b["loss"]
        np.testing.assert_array_equal(a["params"]["body"], b["params"]["body"])

    def test_gender_override_groups_separately(self, service):
        before = service.batches_dispatched
        f1 = service.submit(make_record(1), gender="male")
        f2 = service.submit(make_record(2), gender="female")
        r1, r2 = f1.result(timeout=300), f2.result(timeout=300)
        assert (r1["gender"], r2["gender"]) == ("male", "female")
        # one drain, two gender groups -> two dispatches
        assert service.batches_dispatched == before + 2

    def test_annotated_gender_groups_by_record(self, service):
        rec = make_record(3)
        rec.gender_gt = ["female"]
        assert service.fit(rec, timeout=300)["gender"] == "female"

    def test_no_person_record_fails_only_its_own_future(self, service):
        empty = dataclasses.replace(make_record(4),
                                    keypoints=np.zeros((0, 135, 3), np.float32))
        good = [make_record(5), make_record(6)]
        futures = [service.submit(good[0]), service.submit(empty),
                   service.submit(good[1])]
        with pytest.raises(ValueError, match="no detected people"):
            futures[1].result(timeout=300)
        results = [futures[0].result(timeout=300), futures[2].result(timeout=300)]
        assert [r["name"] for r in results] == ["frame_5", "frame_6"]
        # rows kept their requests: each equals its own fit served alone
        alone = service.fit(make_record(6), timeout=300)
        assert alone["loss"] == results[1]["loss"]


class TestRecordFromRequest:
    def test_shapes(self):
        rec = record_from_request(
            {"keypoints": np.zeros((135, 3)).tolist(),
             "image_size": [480, 640], "name": "x"}, num_joints=135)
        assert rec.keypoints.shape == (1, 135, 3)
        assert rec.keypoints.dtype == np.float32
        assert rec.img_size == (480, 640)
        assert rec.fn == "x"

    def test_bad_shape_raises(self):
        with pytest.raises(ValueError, match="keypoints"):
            record_from_request({"keypoints": np.zeros((17, 3)).tolist(),
                                 "image_size": [480, 640]}, num_joints=135)


def _post(base, payload, timeout=300):
    req = urllib.request.Request(base + "/fit", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


class TestHTTP:
    def test_fit_and_health(self, service):
        server = serve_http(service, port=0)
        try:
            host, port = server.server_address[:2]
            base = f"http://{host}:{port}"
            with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
                health = json.loads(r.read())
            assert health["ok"] is True
            result = _post(base, {
                "keypoints": make_record(3).keypoints[0].tolist(),
                "image_size": [640, 640], "name": "http_frame"})
            assert np.isfinite(result["loss"])
            assert result["name"] == "http_frame"
            with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
                after = json.loads(r.read())
            assert after["fits_completed"] == health["fits_completed"] + 1
            assert after["batches_dispatched"] == health["batches_dispatched"] + 1
        finally:
            server.shutdown()

    def test_bad_request_400(self, service):
        server = serve_http(service, port=0)
        try:
            host, port = server.server_address[:2]
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(f"http://{host}:{port}",
                      {"keypoints": [[0, 0, 0]], "image_size": [10, 10]},
                      timeout=60)
            assert ei.value.code == 400
        finally:
            server.shutdown()


@pytest.fixture()
def blocked_service(service):
    """A second FitService on the module's session, with a 2-deep queue
    and its _fit_group gated on an event, so that the test decides when
    the worker drains."""
    svc = FitService(service.session, max_batch=1, max_wait_s=0.01,
                     max_queue=2, min_bucket=4)
    entered, release = threading.Event(), threading.Event()
    orig = svc._fit_group

    def gated(gender, reqs):
        entered.set()
        assert release.wait(timeout=120)
        return orig(gender, reqs)

    svc._fit_group = gated
    yield svc, entered, release
    release.set()
    svc.stop()


class TestBackpressure:
    def test_submit_sheds_load_when_full(self, blocked_service):
        svc, entered, release = blocked_service
        f1 = svc.submit(make_record(50))      # the worker takes this one...
        assert entered.wait(timeout=60)       # ...and blocks inside the fit
        f2 = svc.submit(make_record(51))      # queue slot 1
        f3 = svc.submit(make_record(52))      # queue slot 2 (full now)
        with pytest.raises(ServiceOverloadedError):
            svc.submit(make_record(53))
        release.set()
        for f in (f1, f2, f3):
            assert np.isfinite(f.result(timeout=300)["loss"])

    def test_http_503_when_overloaded(self, blocked_service):
        svc, entered, release = blocked_service
        server = serve_http(svc, port=0)
        try:
            host, port = server.server_address[:2]
            base = f"http://{host}:{port}"

            def payload(i):
                return {"keypoints": make_record(i).keypoints[0].tolist(),
                        "image_size": [640, 640], "name": f"bp_{i}"}

            def post_async(i):
                th = threading.Thread(target=lambda: _post(base, payload(i)),
                                      daemon=True)
                th.start()
                return th

            threads = [post_async(60)]
            assert entered.wait(timeout=60)
            threads += [post_async(61), post_async(62)]
            deadline = time.monotonic() + 30
            while svc._queue.qsize() < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert svc._queue.qsize() == 2
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(base, payload(63), timeout=30)
            assert exc.value.code == 503
            body = json.loads(exc.value.read())
            assert "overloaded" in body["error"]
            assert body["retry_after_s"] == svc.max_wait_s
            release.set()
            for th in threads:
                th.join(timeout=300)
                assert not th.is_alive()
        finally:
            release.set()
            server.shutdown()


def test_stop_flushes_queued_requests(service):
    """Requests queued before stop() are all fitted; submit() after it
    raises."""
    svc = FitService(service.session, max_batch=2, max_wait_s=0.0,
                     min_bucket=4)
    futures = [svc.submit(make_record(70 + i)) for i in range(5)]
    svc.stop(timeout=300)
    assert not svc._worker.is_alive()
    assert all(f.done() for f in futures)
    assert [f.result()["name"] for f in futures] == [
        f"frame_{70 + i}" for i in range(5)]
    assert svc.fits_completed == 5 and svc.batches_dispatched >= 3
    with pytest.raises(RuntimeError, match="stopped"):
        svc.submit(make_record(80))


def test_a_failing_group_fails_its_futures_and_the_worker_lives_on(service):
    svc = FitService(service.session, max_batch=4, max_wait_s=0.2,
                     min_bucket=4)
    orig, calls = svc._fit_group, []

    def failing_once(gender, reqs):
        calls.append(len(reqs))
        if len(calls) == 1:
            raise RuntimeError("kernel build failed")
        return orig(gender, reqs)

    svc._fit_group = failing_once
    try:
        futures = [svc.submit(make_record(90 + i)) for i in range(2)]
        for f in futures:
            with pytest.raises(RuntimeError, match="kernel build failed"):
                f.result(timeout=300)
        assert svc._worker.is_alive()
        assert np.isfinite(svc.fit(make_record(92), timeout=300)["loss"])
    finally:
        svc.stop()


def test_include_vertices(service, model):
    svc = FitService(service.session, max_batch=4, max_wait_s=0.0,
                     include_vertices=True, min_bucket=4)
    try:
        res = svc.fit(make_record(11), timeout=300)
    finally:
        svc.stop()
    verts = np.asarray(res["vertices"], np.float32)
    assert verts.shape == (96, 3)
    sess = service.session
    out, _, _ = recover_outputs(
        model, sess.settings, _served_x(sess, [res]), sess.decode_body,
        device="cpu")
    np.testing.assert_array_equal(verts, out.vertices[0].numpy())


def _served_x(sess, results):
    """The flat parameters [n, D] of served results."""
    from smplifyx_torch.fitting.params import pack

    seg = {k: torch.as_tensor(np.asarray([r["params"][k] for r in results]),
                              dtype=torch.float32)
           for k in results[0]["params"]}
    return pack(sess.settings, **seg)


def test_served_batch_is_the_session_fit_of_its_bucket(service, model):
    """A served batch equals `session.fit` of the same records, prepared,
    padded to the same bucket and fitted directly, to the bit."""
    records = [make_record(100 + i) for i in range(3)]
    futures = [service.submit(r) for r in records]
    served = [f.result(timeout=300) for f in futures]
    sess = service.session
    prepared = prepare_batch(sess.cfg, records, sess.joint_weights(),
                             vposer=sess.vposer, gmm=sess.gmm, device="cpu")
    prepared = pad_prepared(prepared, 4)
    res = sess.fit(model, build_joints_model(model), prepared.frames,
                   prepared.x0)
    assert [r["loss"] for r in served] == res.loss[:3].tolist()
    assert torch.equal(_served_x(sess, served), res.x[:3])
    assert [r["stage_evals"] for r in served] == res.stage_evals[:, :3].T.tolist()


def test_served_results_match_jax_service(service, jax_model):
    """The same records served by the JAX package's FitService: each
    frame's loss within the whole-fit tolerance (5%, ROADMAP
    "Tolerances").  Where both spent the same evaluations in every stage,
    the trajectories did not part, and the parameters agree to f32
    rounding (1e-5 per unit of scale)."""
    jcfg = j_load_config(PRESET, **OVERRIDES)
    jsvc = JFitService.from_config(jcfg, model=jax_model, max_wait_s=0.3,
                                   max_batch=8, min_bucket=4)
    try:
        records = [make_record(120 + i) for i in range(4)]
        jfutures = [jsvc.submit(JFrameRecord(
            fn=r.fn, img_path=r.img_path, keypoints=r.keypoints,
            img_size=r.img_size)) for r in records]
        want = [f.result(timeout=600) for f in jfutures]
    finally:
        jsvc.stop()
    futures = [service.submit(r) for r in records]
    got = [f.result(timeout=300) for f in futures]
    assert [g["name"] for g in got] == [w["name"] for w in want]
    np.testing.assert_allclose([g["loss"] for g in got],
                               [w["loss"] for w in want], rtol=0.05)
    same_path = 0
    for g, w in zip(got, want):
        assert g["params"].keys() == w["params"].keys()
        if g["stage_evals"] != w["stage_evals"]:
            continue
        same_path += 1
        for k, v in w["params"].items():
            scale = max(1.0, float(np.abs(v).max()))
            np.testing.assert_allclose(g["params"][k], v, rtol=0,
                                       atol=1e-5 * scale, err_msg=k)
        np.testing.assert_allclose(g["body_pose_decoded"],
                                   w["body_pose_decoded"], rtol=0, atol=1e-5)
    assert same_path >= 2


def test_service_runs_on_the_card_unless_asked(monkeypatch, model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FitService.from_config(make_cfg(), model=model)
    svc = FitService.from_config(make_cfg(platform="cpu"), model=model)
    try:
        assert svc.session.device.type == "cpu"
    finally:
        svc.stop()
