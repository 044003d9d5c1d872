"""Build and load the port's native libraries: its hand-written CUDA
kernels and its host-side keypoint parser.

Every kernel source `smplifyx_torch/csrc/<name>.cu` has a plain C interface
and is compiled by nvcc for sm_90a into `build/lib<name>.so` at the
repository root (git-ignored), then loaded with ctypes.  The host libraries
(`HOST_SOURCES`: the keypoint parser) take the host C++ compiler with the
flags of the JAX package's csrc/Makefile instead.  One build directory and
one stale check serve every library; a library is rebuilt when its source
is newer, into a temporary name renamed into place, so processes building
at once do not see each other's half-written files.  Nothing here runs at
import time: the CPU tests import every module on a host without nvcc.
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
# library name -> C++ source in smplifyx_torch/csrc, built by the host
# compiler with csrc/Makefile's flags
HOST_SOURCES = {"keypoints_torch": "keypoint_parser.cpp"}
HOST_CXX = "g++"
HOST_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_loaded: dict = {}


def source(name: str) -> Path:
    return _REPO / "smplifyx_torch" / "csrc" / HOST_SOURCES.get(name,
                                                                f"{name}.cu")


def library(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def build_command(name: str, out: Path | None = None,
                  src: Path | None = None) -> list:
    """The command that builds one library (from `src` in place of its
    source, where given): nvcc for a kernel, the host compiler for a host
    library."""
    compiler = ([HOST_CXX, *HOST_FLAGS] if name in HOST_SOURCES
                else [_nvcc(), *NVCC_FLAGS])
    return [*compiler, "-o", str(out or library(name)),
            str(src or source(name))]


def _stale(name: str) -> bool:
    lib = library(name)
    return not lib.exists() or lib.stat().st_mtime < source(name).stat().st_mtime


def build(*names: str, force: bool = False) -> dict:
    """Compile the named libraries, one compiler process each, all started
    together.  Returns {name: (seconds, ptxas register/spill report)};
    an up-to-date library is skipped ((0.0, "")) unless force is set.
    Raises with the compiler's output if any build fails."""
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
            failed.append(f"{build_command(name)[0]} failed "
                          f"({proc.returncode}) building {source(name)}:\n"
                          f"{output}")
            continue
        os.replace(tmp, library(name))
        ptxas = [ln.strip() for ln in output.splitlines()
                 if "entry function" in ln or "registers" in ln or "spill" in ln]
        report[name] = (seconds, " | ".join(ptxas))
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library `name`, built if stale and loaded once.  `signatures`
    maps each C function to its ctypes argtypes; every function returns an
    int (a kernel's: the launch's cudaError_t)."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib
