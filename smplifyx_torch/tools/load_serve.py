"""Load on the fit service: N concurrent HTTP clients against FitService.

    python -m smplifyx_torch.tools.load_serve [clients] [per_client]
        [max_wait_s] [gpu|cpu] [num_verts] [cfg_path] [interp] [max_batch]

The port of `tools/load_serve.py`, with the same positional arguments
(platform `gpu`, the default, is the card; `cpu` the CPU).  Starts the HTTP
frontend on 127.0.0.1 at an ephemeral port, warms it up with one request
and one burst of `clients`, then drives it with `clients` threads that each
post `per_client` /fit requests back to back, and prints one JSON line:
completed, errors, p50/p95/max end-to-end latency in seconds, achieved
frames/s, batches and frames per batch.  `interp=1` keeps the config's
collision term; 0 (the default) turns it off.  `drive` measures a service
that is already running (chip_smoke.py's `serve` phase).
"""

from __future__ import annotations

import json
import sys
import threading
import time
import urllib.request

import numpy as np
import torch


def random_keypoints(num_joints: int, count: int) -> np.ndarray:
    """[count, K, 3] keypoints spread over a 640x640 image at confidence
    0.9 (the JAX tool's payloads), from seed 0."""
    rng = np.random.default_rng(0)
    kp = np.zeros((count, num_joints, 3), np.float32)
    kp[..., 0] = rng.uniform(100, 500, (count, num_joints))
    kp[..., 1] = rng.uniform(100, 600, (count, num_joints))
    kp[..., 2] = 0.9
    return kp


def post(base: str, keypoints: np.ndarray, image_size, name: str,
         timeout: float = 600.0) -> dict:
    """POST one frame to {base}/fit; the fitted result."""
    body = json.dumps({"keypoints": keypoints.tolist(),
                       "image_size": list(image_size),
                       # outlive a first fit that builds the kernels
                       "timeout_s": timeout - 10.0, "name": name}).encode()
    req = urllib.request.Request(base + "/fit", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def drive(base: str, service, keypoints: np.ndarray, image_size,
          clients: int, per_client: int) -> dict:
    """`clients` threads, each posting `per_client` requests back to back
    (frame k of client c is keypoints[(c * per_client + k) % len]); returns
    the load line's numbers and the first errors."""
    latencies, errors = [], []
    lock = threading.Lock()

    def client(cid):
        for k in range(per_client):
            i = cid * per_client + k
            t0 = time.perf_counter()
            try:
                post(base, keypoints[i % len(keypoints)], image_size,
                     f"load_{i}")
            except Exception as e:  # recorded and reported, not raised
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")
                continue
            with lock:
                latencies.append(time.perf_counter() - t0)

    b0 = service.batches_dispatched
    t_start = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    batches = service.batches_dispatched - b0
    lat = np.sort(np.asarray(latencies, np.float64))
    done = int(lat.size)
    return {
        "clients": clients, "per_client": per_client,
        "completed": done, "errors": len(errors),
        "p50_s": float(np.percentile(lat, 50)) if done else None,
        "p95_s": float(np.percentile(lat, 95)) if done else None,
        "max_s": float(lat.max()) if done else None,
        "wall_s": wall, "achieved_fps": done / wall,
        "batches": batches, "frames_per_batch": done / max(batches, 1),
        "first_errors": errors[:3],
    }


def main(clients=8, per_client=8, max_wait_s=0.25, platform="gpu",
         num_verts=10475, cfg_path="cfg/fit_smplx_combined_coco25.yaml",
         interp=False, max_batch=32):
    from smplifyx_torch.models.bodymodel import synthetic_model
    from smplifyx_torch.serve import FitService, serve_http
    from smplifyx_torch.utils.config import load_config
    from smplifyx_torch.utils.device import device_for_platform, resolve_device

    dev = resolve_device(device_for_platform(platform))
    over = {} if interp else {"interpenetration": False}
    cfg = load_config(
        cfg_path, data_folder="/nonexistent", output_folder="unused_load",
        regression_prior="", use_camera_prior=False,
        use_gender_classifier=False, vposer_ckpt="synthetic",
        synthetic_model=True, synthetic_num_verts=num_verts, **over)
    model = synthetic_model(num_verts=num_verts, seed=0, device=dev)
    svc = FitService.from_config(cfg, model=model, device=dev,
                                 max_batch=max_batch, max_wait_s=max_wait_s,
                                 max_queue=256)
    server = serve_http(svc, port=0)
    try:
        host, port = server.server_address[:2]
        base = f"http://{host}:{port}"
        K = int(svc._joint_weights.shape[0])
        kp = random_keypoints(K, clients * per_client + clients + 1)
        size = (640, 640)
        # Warm-up: the first fit (kernel builds) and one burst of `clients`.
        post(base, kp[-1], size, "warm")
        warm = [threading.Thread(target=post, args=(base, kp[i], size,
                                                    f"warm_{i}"))
                for i in range(clients)]
        for t in warm:
            t.start()
        for t in warm:
            t.join()
        row = drive(base, svc, kp, size, clients, per_client)
    finally:
        server.shutdown()
        svc.stop()
    errors = row.pop("first_errors")
    print(json.dumps({
        "metric": "serve_load", "config": cfg_path,
        "interpenetration": bool(cfg.interpenetration),
        "device": str(dev),
        "card": torch.cuda.get_device_name(0) if dev.type == "cuda" else None,
        "max_wait_s": max_wait_s, "max_batch": max_batch,
        "num_verts": num_verts, **row}))
    if errors:
        print(json.dumps({"first_errors": errors}), file=sys.stderr)


if __name__ == "__main__":
    a = sys.argv[1:]
    main(clients=int(a[0]) if a else 8,
         per_client=int(a[1]) if len(a) > 1 else 8,
         max_wait_s=float(a[2]) if len(a) > 2 else 0.25,
         platform=a[3] if len(a) > 3 else "gpu",
         num_verts=int(a[4]) if len(a) > 4 else 10475,
         cfg_path=(a[5] if len(a) > 5
                   else "cfg/fit_smplx_combined_coco25.yaml"),
         interp=bool(int(a[6])) if len(a) > 6 else False,
         max_batch=int(a[7]) if len(a) > 7 else 32)
