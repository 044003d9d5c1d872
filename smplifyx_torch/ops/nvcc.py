"""Build and load the port's hand-written CUDA kernels.

Every kernel source `smplifyx_torch/csrc/<name>.cu` has a plain C interface
and is compiled by nvcc for sm_90a into `build/lib<name>.so` at the
repository root (git-ignored), then loaded with ctypes.  One flag list, one
build directory and one stale check serve every kernel; a library is
rebuilt when its source is newer.  Nothing here runs at import time: the
CPU tests import every module on a host without nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import time
from pathlib import Path

_REPO = Path(__file__).resolve().parents[2]
BUILD_DIR = _REPO / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}


def source(name: str) -> Path:
    return _REPO / "smplifyx_torch" / "csrc" / f"{name}.cu"


def library(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def build_command(name: str, out: Path | None = None,
                  src: Path | None = None) -> list:
    """The nvcc command that builds one kernel library (from `src` in place
    of the kernel's source, where given)."""
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out or library(name)),
            str(src or source(name))]


def _stale(name: str) -> bool:
    lib = library(name)
    return not lib.exists() or lib.stat().st_mtime < source(name).stat().st_mtime


def build(*names: str, force: bool = False) -> dict:
    """Compile the named kernels, one nvcc process each, all started
    together.  Returns {name: (seconds, ptxas register/spill report)};
    an up-to-date library is skipped ((0.0, "")) unless force is set.
    Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not force and not _stale(name):
            continue
        tmp = library(name).with_suffix(f".{os.getpid()}.tmp.so")
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            build_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    report = {name: (0.0, "") for name in names}
    failed = []
    for name, (tmp, t0, proc) in procs.items():
        output, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building "
                          f"{source(name)}:\n{output}")
            continue
        os.replace(tmp, library(name))
        ptxas = [ln.strip() for ln in output.splitlines()
                 if "entry function" in ln or "registers" in ln or "spill" in ln]
        report[name] = (seconds, " | ".join(ptxas))
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The kernel library `name`, built if stale and loaded once.
    `signatures` maps each C function to its ctypes argtypes; every
    function returns the launch's cudaError_t as an int."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib
