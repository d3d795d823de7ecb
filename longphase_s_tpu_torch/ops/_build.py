"""Build the port's CUDA kernels and bind them with ctypes.

All ``csrc/*.cu`` files are compiled by ``nvcc`` into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds),
at first use, into ``longphase_s_tpu_torch/_build/`` under a name keyed by
a hash of the sources and flags. A failed build raises. Nothing here runs
at import time: the CPU tests import every module on machines without
``nvcc``.

``LAUNCHES`` counts kernel launches by name. Each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: dict[str, int] = {"vote_scan": 0, "pair_pack": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "lps_vote_scan": [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float,
                      _I, _I, _I, _I, _P, _P, _P, _P],
    "lps_pair_pack": [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _P, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def sources() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(".cu"))


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"liblps_cuda_{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise KernelBuildError(f"nvcc not found on PATH or in {cuda_home}/bin: "
                           "the CUDA kernels cannot be built")


def build(path: str) -> None:
    """Compile every ``csrc/*.cu`` into ``path`` (written atomically)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


def library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            path = _library_path()
            if not os.path.exists(path):
                build(path)
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_launch(name: str, err: int) -> None:
    """Raise if the C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
