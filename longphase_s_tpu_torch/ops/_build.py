"""Build the port's CUDA kernels and bind them with ctypes.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), all of them started together, at first use, into
``longphase_s_tpu_torch/_build/`` under names keyed by a hash of the
source, the shared ``csrc/*.cuh`` headers and the flags. ``ptxas`` reports each kernel's registers, shared
memory and spills into a ``.ptxas.txt`` file beside its library
(``ptxas_report``). A failed build raises. Nothing here runs at import
time: the CPU tests import every module on machines without ``nvcc``.

``LAUNCHES`` counts kernel launches by name. Each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels. The serial vote-scan kernel counts under
``vote_scan_carry`` where a launch takes or returns a carry or offsets the
ranks (the site-sharded schedules; the kernel's carry instantiation),
under ``vote_scan`` otherwise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import types

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

LAUNCHES: dict[str, int] = {"vote_cast": 0, "vote_scan": 0,
                            "vote_scan_carry": 0, "bucket_count": 0,
                            "bucket_scatter": 0, "pair_cast": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "lps_vote_cast": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                      _I, _I, _I, _I, _P, _P, _P],
    "lps_vote_scan": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                      _P, _P],
    "lps_pair_tile": [_I, _I],
    "lps_bucket_count": [_P, _P, _L, _I, _I, _P, _P],
    "lps_bucket_scatter": [_P, _P, _L, _I, _I, _P, _P, _P],
    "lps_pair_cast": [_P, _P, _P, _P, _L, _P, _P, _P, _P, _I, _I, _I, _I,
                      _I, _I, _F, _I, _I, _I, _I, _P, _P, _P],
    # csrc/chain_latency.cu: the bench's clock64 probe, no pipeline's
    "lps_chain_latency": [_P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: types.SimpleNamespace | None = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def sources() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(".cu"))


def _library_path(source: str) -> str:
    """Keyed by the flags, the source and every shared header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                     if f.endswith(".cuh"))
    for path in (source, *headers):
        with open(path, "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


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


def build(targets: dict[str, str]) -> None:
    """Compile each source into its library path (``{source: path}``), one
    ``nvcc`` a source, all at once; each library is written atomically."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for source, path in targets.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source]
        jobs.append((cmd, tmp, path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, tmp, path, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}")
            continue
        with open(f"{path}.ptxas.txt", "w") as f:
            f.write(out)
        os.replace(tmp, path)
    if failed:
        raise KernelBuildError("\n".join(failed))


def library() -> types.SimpleNamespace:
    """The kernels' C entries by name, built on first use and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            paths = {s: _library_path(s) for s in sources()}
            missing = {s: p for s, p in paths.items() if not os.path.exists(p)}
            if missing:
                build(missing)
            lib = types.SimpleNamespace()
            for path in paths.values():
                cdll = ctypes.CDLL(path)
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(cdll, name, None)
                    if fn is not None:
                        fn.argtypes = argtypes
                        fn.restype = ctypes.c_int
                        setattr(lib, name, fn)
            absent = [n for n in _SIGNATURES if not hasattr(lib, n)]
            if absent:
                raise KernelBuildError(f"no source defines {absent}")
            _lib = lib
        return _lib


def ptxas_report() -> str:
    """What ``ptxas -v`` said for every kernel of the built libraries
    (registers, shared memory, spills, stack)."""
    out = []
    for source in sources():
        path = f"{_library_path(source)}.ptxas.txt"
        if os.path.exists(path):
            with open(path) as f:
                out.append(f.read())
    return "".join(out)


def check_launch(name: str, err: int) -> None:
    """Raise if the C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
