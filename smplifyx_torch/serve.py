"""Resident batching fit service: the serving counterpart of the one-shot
app (`python -m smplifyx_torch.serve --config cfg/<preset>.yaml`).

The port of `smplifyx_tpu/serve.py`.  A batched fit costs about the same
on the card at 8 lanes as at 128 (the loops are steered from the host), so
the service coalesces concurrent requests into micro-batches:

  * `FitService` owns a `FitSession` (session.py: models, priors, schedule)
    and one worker thread, the only thread that touches torch; `submit()`
    enqueues a `FrameRecord` and returns a `concurrent.futures.Future`.
  * The worker drains the queue up to `max_batch` or `max_wait_s`
    (whichever comes first), groups the requests by resolved gender, pads
    each group to a power-of-two bucket (at least `min_bucket`), fits it
    on `session.device`, and resolves the futures with per-frame results.
  * `serve_http` wraps a service in a stdlib ThreadingHTTPServer: POST /fit
    with an OpenPose-style JSON body -> fitted parameters; GET /healthz for
    liveness.  Handler threads parse JSON into numpy and wait on futures.

Latency is one bucket's fit plus the coalescing wait, so `max_wait_s`
trades latency for batch size.  `tools/load_serve.py` measures both.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from smplifyx_torch.data.gender import resolve_gender
from smplifyx_torch.data.keypoints import FrameRecord
from smplifyx_torch.fitting.params import unpack
from smplifyx_torch.fitting.pipeline import recover_outputs
from smplifyx_torch.fitting.prepare import pad_prepared, prepare_batch
from smplifyx_torch.models.sparse import build_joints_model
from smplifyx_torch.session import FitSession, build_fit_session
from smplifyx_torch.utils.config import Config


class ServiceOverloadedError(RuntimeError):
    """Raised by submit() when the bounded request queue is full: the
    backpressure signal (the HTTP frontend answers 503)."""


@dataclass
class FitRequest:
    record: FrameRecord
    future: Future = field(default_factory=Future)
    gender: Optional[str] = None  # explicit override of resolution chain


class FitService:
    """Micro-batching fit executor over a persistent FitSession."""

    def __init__(
        self,
        session: FitSession,
        max_batch: int = 32,
        max_wait_s: float = 0.25,
        include_vertices: bool = False,
        default_gender: Optional[str] = None,
        max_queue: int = 0,
        min_bucket: int = 1,
    ):
        """max_queue bounds the pending-request queue (0 = unbounded);
        submit() on a full queue raises ServiceOverloadedError instead of
        letting latency grow without bound (clients see an immediate 503
        and can retry elsewhere).

        min_bucket floors the power-of-two padding bucket, as in the JAX
        package, where it lets a lone request and a small burst share one
        compiled program."""
        self.session = session
        self.max_batch = int(max_batch)
        self.min_bucket = int(min_bucket)
        self.max_wait_s = float(max_wait_s)
        self.include_vertices = include_vertices
        self.default_gender = default_gender or session.cfg.gender
        self._queue: "queue.Queue[FitRequest]" = queue.Queue(
            maxsize=int(max_queue))
        # Shutdown is signalled out of band, not by a sentinel in the
        # queue: with a bounded queue a sentinel's put can block behind
        # submitters refilling the freed slot.
        self._stop = threading.Event()
        self._models = {}          # gender -> (model, joints model)
        self._joint_weights = session.joint_weights()
        self._lock = threading.Lock()
        self.fits_completed = 0
        self.batches_dispatched = 0
        self._worker = threading.Thread(target=self._run, name="fit-service",
                                        daemon=True)
        self._worker.start()

    @classmethod
    def from_config(cls, cfg: Config, model=None, device=None,
                    **kw) -> "FitService":
        """A service over `build_fit_session(cfg, model, device)`; `device`
        overrides the config's `platform`."""
        return cls(build_fit_session(cfg, model=model, device=device), **kw)

    # -- client API ------------------------------------------------------

    def submit(self, record: FrameRecord,
               gender: Optional[str] = None) -> Future:
        """Enqueue one frame; the Future resolves to a result dict
        {name, gender, loss, camera_translation, params: {...},
        body_pose_decoded, stage_evals[, vertices]}."""
        if self._stop.is_set():
            raise RuntimeError("FitService is stopped")
        req = FitRequest(record=record, gender=gender)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise ServiceOverloadedError(
                f"request queue full ({self._queue.maxsize} pending)"
            ) from None
        return req.future

    def fit(self, record: FrameRecord, gender: Optional[str] = None,
            timeout: Optional[float] = None) -> dict:
        """Blocking convenience wrapper around submit()."""
        return self.submit(record, gender=gender).result(timeout=timeout)

    def stop(self, timeout: float = 30.0):
        """Flush queued requests, then stop the worker.  Never blocks on the
        queue itself; worst case it joins with the timeout."""
        self._stop.set()
        self._worker.join(timeout=timeout)

    # -- worker ----------------------------------------------------------

    def _drain(self) -> Optional[list]:
        """Block for the first request (checking the shutdown flag every
        0.1 s), then coalesce up to max_batch or max_wait_s.  Returns None
        only once the queue is empty and stop() was called, so every
        request enqueued before stop() is still fitted."""
        while True:
            try:
                first = self._queue.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():
                    return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _get_models(self, gender: str):
        """(model, joints model) of a gender on the session's device, built
        once.  The session builds the collision tables from the first model
        it fits, and every gender reuses them."""
        with self._lock:
            if gender not in self._models:
                model = self.session.get_model(gender)
                self._models[gender] = (model, build_joints_model(model))
            return self._models[gender]

    def _resolve_gender(self, req: FitRequest) -> str:
        if req.gender:
            return req.gender
        return resolve_gender(req.record, default=self.default_gender)

    def _run(self):
        while True:
            batch = self._drain()
            if batch is None:
                return
            groups: dict[str, list[FitRequest]] = {}
            for req in batch:
                try:
                    groups.setdefault(self._resolve_gender(req), []).append(req)
                except Exception as e:  # a bad record fails its own future
                    req.future.set_exception(e)
            for gender, reqs in sorted(groups.items()):
                # The worker must outlive any failure of a group (a kernel
                # build included): it goes to that group's futures.
                try:
                    self._fit_group(gender, reqs)
                except Exception as e:
                    for r in reqs:
                        if not r.future.done():
                            r.future.set_exception(e)

    def _fit_group(self, gender: str, reqs: list[FitRequest]):
        sess = self.session
        model, joints_model = self._get_models(gender)
        # prepare_batch drops records with no detected person; fail those
        # futures here so that row i of the prepared batch is reqs[i].
        kept = []
        for r in reqs:
            if r.record.keypoints.shape[0] < 1:
                r.future.set_exception(ValueError(
                    f"record {r.record.fn!r} has no detected people "
                    f"(keypoints shape {tuple(r.record.keypoints.shape)})"))
            else:
                kept.append(r)
        reqs = kept
        if not reqs:
            return
        prepared = prepare_batch(sess.cfg, [r.record for r in reqs],
                                 self._joint_weights, vposer=sess.vposer,
                                 gmm=sess.gmm, device=sess.device)
        n = prepared.num_real
        if n != len(reqs):
            raise RuntimeError(f"prepared {n} rows for {len(reqs)} requests")
        # Power-of-two bucket, as the app pads its gender groups.
        prepared = pad_prepared(prepared, max(self.min_bucket,
                                              1 << (n - 1).bit_length()))
        res = sess.fit(model, joints_model, prepared.frames, prepared.x0)
        with torch.no_grad():
            seg = unpack(sess.settings, res.x[:n])
            host = {"loss": res.loss[:n], "stage_evals": res.stage_evals[:, :n],
                    "decoded": sess.decode_body(seg["body"])}
            if self.include_vertices:
                # the full mesh only for clients who ask for vertices
                out, _, _ = recover_outputs(model, sess.settings, res.x[:n],
                                            sess.decode_body, joint_map=None,
                                            device=sess.device)
                host["vertices"] = out.vertices
        # one copy to the host per result array
        host = {k: v.cpu().numpy() for k, v in host.items()}
        seg_np = {k: v.cpu().numpy() for k, v in seg.items()}

        with self._lock:
            self.batches_dispatched += 1
            self.fits_completed += n
        for i, req in enumerate(reqs):
            result = {
                "name": req.record.fn,
                "gender": gender,
                "loss": float(host["loss"][i]),
                "camera_translation": seg_np["cam_t"][i].tolist(),
                "params": {k: v[i].tolist() for k, v in seg_np.items()},
                "body_pose_decoded": host["decoded"][i].tolist(),
                # objective evaluations per body stage spent on this frame
                "stage_evals": host["stage_evals"][:, i].tolist(),
            }
            if self.include_vertices:
                result["vertices"] = host["vertices"][i].tolist()
            req.future.set_result(result)


# -- HTTP frontend -------------------------------------------------------


def record_from_request(payload: dict, num_joints: int) -> FrameRecord:
    """Build a FrameRecord from a /fit JSON payload.

    Expected fields: `keypoints` ([K,3] or [P,K,3] nested lists, OpenPose
    order for the configured format), `image_size` ([H, W]); optional
    `name`, `gender`."""
    kp = np.asarray(payload["keypoints"], np.float32)
    if kp.ndim == 2:
        kp = kp[None]
    if kp.ndim != 3 or kp.shape[-1] != 3 or kp.shape[1] != num_joints:
        raise ValueError(
            f"keypoints must be [P, {num_joints}, 3] (got {kp.shape})")
    H, W = (int(v) for v in payload["image_size"])
    name = str(payload.get("name", "request"))
    return FrameRecord(fn=name, img_path=name + ".jpg", keypoints=kp,
                       img_size=(H, W))


def serve_http(service: FitService, host: str = "127.0.0.1", port: int = 0):
    """Start a ThreadingHTTPServer for the service; returns the server
    (serving on a daemon thread; server.server_address holds the bound
    port, server.shutdown() stops it)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    num_joints = int(service._joint_weights.shape[0])

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {
                    "ok": True,
                    "fits_completed": service.fits_completed,
                    "batches_dispatched": service.batches_dispatched,
                })
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/fit":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n))
                record = record_from_request(payload, num_joints)
                result = service.fit(
                    record, gender=payload.get("gender"),
                    timeout=float(payload.get("timeout_s", 300.0)))
                self._send(200, result)
            except ServiceOverloadedError as e:
                self._send(503, {"error": f"overloaded: {e}",
                                 "retry_after_s": service.max_wait_s})
            except Exception as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):  # quiet
            pass

    class Server(ThreadingHTTPServer):
        # socketserver's default listen backlog of 5 resets connections
        # under concurrent bursts, and coalescing wants bursts.
        request_queue_size = 128
        daemon_threads = True

    server = Server((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def main(argv=None) -> None:
    """python -m smplifyx_torch.serve --config cfg/preset.yaml [--key value]

    The batch CLI's config surface; runs on the card unless `--platform
    cpu`.  The address comes from SMPLIFYX_SERVE_HOST (127.0.0.1) and
    SMPLIFYX_SERVE_PORT (8123)."""
    import os

    from smplifyx_torch.utils.config import parse_cli

    cfg = parse_cli(argv)
    host = os.environ.get("SMPLIFYX_SERVE_HOST", "127.0.0.1")
    port = int(os.environ.get("SMPLIFYX_SERVE_PORT", "8123"))
    service = FitService.from_config(cfg)
    server = serve_http(service, host=host, port=port)
    bound = server.server_address
    print(f"smplifyx_torch fit service on http://{bound[0]}:{bound[1]} "
          f"on {service.session.device} (POST /fit, GET /healthz)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()
        service.stop()


if __name__ == "__main__":
    main()
