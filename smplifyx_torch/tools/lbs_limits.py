"""What holds kernel K1 (linear-blend skinning) above its bound on the card.

    python -m smplifyx_torch.tools.lbs_limits [--out build/lbs_limits]

Builds three libraries into <out> (one nvcc each, started together) and
times each, with the slice model's skinning (`problem.slice_model`, 4
weights per vertex), at the main path's full-mesh shapes (B=256 and 128,
V=10475) and at its landmark subset (B=256, V=224):

  * `kernel`: `csrc/lbs.cu` as shipped;
  * `rows_only`: the same source built with `-DLBS_NO_SUM`, which
    switches the sum off, so a block stages A, the plan and each tile's
    rows and stores the rows back unchanged: K1's memory path alone;
  * `copy`: a plain float4 copy of v_posed into out, the same bytes in and
    out, as a yardstick of what a copy reaches on this card.

Device ms: 50 launches queued behind a spin kernel, between two CUDA
events, over 50 (warm L2, as on the main path); the three take turns
(kernel, rows_only, copy, copy, rows_only, kernel) and each prints both of
its times.  Prints the card's name and power limit, then one JSON line per
shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from smplifyx_torch.models.sparse import build_joints_model
from smplifyx_torch.ops import lbs, nvcc
from smplifyx_torch.problem import slice_model
from smplifyx_torch.utils.timing import card_name

COPY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void copy4(const float4* __restrict__ v, float4* __restrict__ out,
                      long long n) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n; i += step)
        out[i] = v[i];
}
// The signature of lbs_forward; copies the [B, V, 3] rows (B * V a
// multiple of 4).
extern "C" int lbs_forward(const int*, const float*, const float*,
                           const float* v, float* out, int B, int V, int,
                           int, void* stream) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    copy4<<<8 * sms, 256, 0, (cudaStream_t)stream>>>(
        (const float4*)v, (float4*)out, (long long)B * V * 3 / 4);
    return (int)cudaGetLastError();
}
"""


def build(out: Path) -> dict:
    out.mkdir(parents=True, exist_ok=True)
    (out / "copy.cu").write_text(COPY_SOURCE)
    commands = {
        "kernel": nvcc.build_command("lbs", out / "libkernel.so"),
        "rows_only": nvcc.build_command("lbs", out / "librows_only.so")
        + ["-DLBS_NO_SUM"],
        "copy": nvcc.build_command("copy", out / "libcopy.so", out / "copy.cu"),
    }
    procs = {}
    for name, command in commands.items():
        procs[name] = subprocess.Popen(
            command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n{log}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).lbs_forward
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def device_ms(launch, reps=50) -> float:
    for _ in range(5):
        launch()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)      # covers the enqueue of the reps
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/lbs_limits")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("lbs_limits times kernels on a CUDA card")
    print(card_name(), flush=True)
    libs = build(Path(args.out))
    model = slice_model(device="cuda")
    jm = build_joints_model(model)
    shapes = (("full_mesh_stages", 256, model.lbs_weights, model.lbs_plan),
              ("full_mesh", 128, model.lbs_weights, model.lbs_plan),
              ("subset", 256, jm.sub_lbs, jm.lbs_plan))
    stream = torch.cuda.current_stream().cuda_stream
    for label, B, W, plan in shapes:
        V, J = W.shape
        gen = torch.Generator(device="cuda").manual_seed(B + V)
        A = torch.randn(B, J, 16, device="cuda", generator=gen) * 0.3
        v = torch.randn(B, V, 3, device="cuda", generator=gen)
        out = torch.empty_like(v)

        def launch(fn):
            err = fn(plan.cols.data_ptr(), plan.vals.data_ptr(), A.data_ptr(),
                     v.data_ptr(), out.data_ptr(), B, V, J,
                     plan.cols.shape[1], stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError_t {err}")

        times = {name: [] for name in libs}
        order = list(libs) + list(reversed(libs))
        for name in order:
            times[name].append(device_ms(lambda: launch(libs[name])))
        launch(libs["kernel"])
        torch.cuda.synchronize()
        err = (out - lbs.lbs_reference(W, A, v)).abs().max().item()
        nbytes = 4.0 * (2 * B * V * 3 + B * J * 16) + 8.0 * int((W != 0).sum())
        print(json.dumps({"shape": label, "B": B, "V": V,
                          "K": int(plan.cols.shape[1]), "ms": times,
                          "kernel_max_abs_err": err,
                          "bytes_bound_ms": 1e3 * nbytes / 3.35e12}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
