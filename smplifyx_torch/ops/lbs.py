"""Linear-blend skinning: the hand-written CUDA kernel K1 and its plain version.

`lbs_apply(weights, A, v_posed)` computes, for weights [V, J], per-lane
transforms A [B, J, 16] (row-major 4x4) and posed rest vertices
v_posed [B, V, 3]:

    T = weights @ A[b]                    # [V, 16]
    out[b, v] = T[v, 0:3, 0:3] v_posed[b, v] + T[v, 0:3, 3]

It replaces the TPU kernel `smplifyx_tpu/ops/lbs_pallas.py::_kernel`.  On
a CUDA tensor the forward is the kernel in `csrc/lbs.cu` (see the note
there for its bound on an H100 and what the design does about it); on a
CPU tensor it is `lbs_reference`, and only because the tensor lies on the
CPU.  There is no fallback: a CUDA tensor launches the kernel or raises.

The backward is the JAX package's `_bwd` in torch ops (rebuild T, then
dA = W^T dT and dv = R^T g); weights get no gradient, they are model data.

The kernel is built with nvcc into `build/` at the repository root at
first use and loaded with ctypes.  `lbs_apply.launches` counts launches.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import time
from pathlib import Path

import torch

_REPO = Path(__file__).resolve().parents[2]
_SOURCE = _REPO / "smplifyx_torch" / "csrc" / "lbs.cu"
_BUILD_DIR = _REPO / "build"
_LIBRARY = _BUILD_DIR / "liblbs.so"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_J = 64  # the kernel sizes its shared memory for J <= 64

_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def build_command() -> list:
    """The nvcc command that builds the kernel library (for logs/timing)."""
    return [_nvcc(), *_NVCC_FLAGS, "-o", str(_LIBRARY), str(_SOURCE)]


def build(force: bool = False) -> tuple[float, str]:
    """Compile csrc/lbs.cu into build/liblbs.so; returns the seconds taken
    and ptxas's register/spill report ((0.0, "") when an up-to-date library
    exists and force is False)."""
    if (not force and _LIBRARY.exists()
            and _LIBRARY.stat().st_mtime >= _SOURCE.stat().st_mtime):
        return 0.0, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _LIBRARY.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = build_command()
    cmd[cmd.index("-o") + 1] = str(tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {_SOURCE}:\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, _LIBRARY)
    seconds = time.perf_counter() - t0
    report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
              if "registers" in ln or "spill" in ln]
    return seconds, " | ".join(report)


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(_LIBRARY))
        lib.lbs_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.lbs_forward.restype = ctypes.c_int
        _lib = lib
    return _lib


def lbs_reference(weights: torch.Tensor, A: torch.Tensor,
                  v_posed: torch.Tensor) -> torch.Tensor:
    """Plain version: weights [V, J], A [B, J, 16], v_posed [B, V, 3] ->
    [B, V, 3] (the counterpart of lbs_pallas.py::_lbs_reference)."""
    T = torch.einsum("vj,bjk->bvk", weights, A)
    x, y, z = v_posed[..., 0], v_posed[..., 1], v_posed[..., 2]
    vx = T[..., 0] * x + T[..., 1] * y + T[..., 2] * z + T[..., 3]
    vy = T[..., 4] * x + T[..., 5] * y + T[..., 6] * z + T[..., 7]
    vz = T[..., 8] * x + T[..., 9] * y + T[..., 10] * z + T[..., 11]
    return torch.stack([vx, vy, vz], dim=-1)


def _check(weights, A, v_posed):
    if not (weights.device == A.device == v_posed.device):
        raise ValueError(
            f"lbs_apply: tensors on {weights.device}, {A.device}, "
            f"{v_posed.device}; they must share one device"
        )
    for name, t in (("weights", weights), ("A", A), ("v_posed", v_posed)):
        if t.dtype != torch.float32:
            raise TypeError(f"lbs_apply: {name} is {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"lbs_apply: {name} must be contiguous")
    if weights.dim() != 2 or A.dim() != 3 or v_posed.dim() != 3:
        raise ValueError("lbs_apply: expected weights [V, J], A [B, J, 16], "
                         "v_posed [B, V, 3]")
    V, J = weights.shape
    B = v_posed.shape[0]
    if tuple(A.shape) != (B, J, 16) or tuple(v_posed.shape) != (B, V, 3):
        raise ValueError(
            f"lbs_apply: shapes weights {tuple(weights.shape)}, A "
            f"{tuple(A.shape)}, v_posed {tuple(v_posed.shape)} do not agree"
        )


def _kernel_forward(weights, A, v_posed):
    """Launch K1 on the current stream (CUDA tensors only)."""
    V, J = weights.shape
    B = v_posed.shape[0]
    if J > MAX_J:
        raise ValueError(f"lbs kernel takes J <= {MAX_J}, got {J}")
    out = torch.empty_like(v_posed)
    with torch.cuda.device(v_posed.device):
        stream = torch.cuda.current_stream(v_posed.device).cuda_stream
        err = _load().lbs_forward(
            weights.data_ptr(), A.data_ptr(), v_posed.data_ptr(),
            out.data_ptr(), B, V, J, stream,
        )
    if err != 0:
        raise RuntimeError(f"lbs kernel launch failed: cudaError_t {err}")
    lbs_apply.launches += 1
    return out


class _LBSFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weights, A, v_posed):
        ctx.save_for_backward(weights, A, v_posed)
        if v_posed.device.type == "cpu":
            return lbs_reference(weights, A, v_posed)
        if v_posed.device.type != "cuda":
            raise ValueError(f"lbs_apply: unsupported device {v_posed.device}")
        return _kernel_forward(weights, A, v_posed)

    @staticmethod
    def backward(ctx, g):
        weights, A, v_posed = ctx.saved_tensors
        dA = dv = None
        x, y, z = v_posed[..., 0], v_posed[..., 1], v_posed[..., 2]
        gx, gy, gz = g[..., 0], g[..., 1], g[..., 2]
        if ctx.needs_input_grad[1]:
            basis = torch.stack([x, y, z, torch.ones_like(x)], dim=-1)
            dT = torch.cat(
                [gx[..., None] * basis, gy[..., None] * basis,
                 gz[..., None] * basis, torch.zeros_like(basis)], dim=-1,
            )                                            # [B, V, 16]
            dA = torch.einsum("vj,bvk->bjk", weights, dT)
        if ctx.needs_input_grad[2]:
            T = torch.einsum("vj,bjk->bvk", weights, A)
            dvx = T[..., 0] * gx + T[..., 4] * gy + T[..., 8] * gz
            dvy = T[..., 1] * gx + T[..., 5] * gy + T[..., 9] * gz
            dvz = T[..., 2] * gx + T[..., 6] * gy + T[..., 10] * gz
            dv = torch.stack([dvx, dvy, dvz], dim=-1)
        return None, dA, dv


def lbs_apply(weights: torch.Tensor, A: torch.Tensor,
              v_posed: torch.Tensor) -> torch.Tensor:
    """Skinned vertices [B, V, 3]; differentiable in A and v_posed."""
    _check(weights, A, v_posed)
    return _LBSFunction.apply(weights, A, v_posed)


lbs_apply.launches = 0
