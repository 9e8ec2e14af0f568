"""Build and load the Hopper kernels.

Each ``tpu_cypher_torch/csrc/*.cu`` source compiles with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, no ``ninja``: a source builds in seconds).
Builds go to ``tpu_cypher_torch/_build/<hash of the sources and flags>/``,
so an edited source rebuilds and an unchanged one is reused. All sources
build at once, one ``nvcc`` process each, started together; a build's
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside the
library as ``<name>.log``.

Nothing builds when this module is imported: the first kernel launch (or
an explicit ``build_all()``) does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
))))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILD_SECONDS: Dict[str, float] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


def sources() -> List[str]:
    return sorted(
        os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR) if f.endswith(".cu")
    )


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def _lib_path(out_dir: str, name: str) -> str:
    return os.path.join(out_dir, f"lib{name}.so")


def build_all() -> Dict[str, float]:
    """Build every source that has no library yet, all in parallel.
    Returns {kernel source name: build seconds} for this process's builds
    (0.0 for a library found ready). Raises ``KernelBuildError`` with the
    compiler's output when a source does not build."""
    from .. import bucketing

    with _LOCK:
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for src in sources():
            name = os.path.splitext(os.path.basename(src))[0]
            if name in _BUILD_SECONDS:
                continue
            if os.path.isfile(_lib_path(out_dir, name)):
                _BUILD_SECONDS[name] = 0.0
                continue
            tmp = _lib_path(out_dir, f"{name}.{os.getpid()}.tmp")
            log = open(os.path.join(out_dir, f"{name}.log"), "w")
            procs[name] = (
                subprocess.Popen(
                    [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                    stdout=log,
                    stderr=subprocess.STDOUT,
                ),
                tmp,
                log,
            )
        failed = []
        for name, (proc, tmp, log) in procs.items():
            rc = proc.wait()
            log.close()
            secs = time.perf_counter() - t0
            if rc != 0:
                with open(log.name) as f:
                    failed.append(f"{name} (nvcc exit {rc}):\n{f.read()}")
                continue
            os.replace(tmp, _lib_path(out_dir, name))
            _BUILD_SECONDS[name] = secs
            bucketing.note_build(secs)
        if failed:
            raise KernelBuildError("kernel build failed: " + "\n".join(failed))
        return dict(_BUILD_SECONDS)


def build_log(name: str) -> Optional[str]:
    """The ``nvcc``/``ptxas`` report of one source's build, if built here."""
    path = os.path.join(build_dir(), f"{name}.log")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return f.read()


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    got = _LIBS.get(name)
    if got is not None:
        return got
    build_all()
    with _LOCK:
        got = _LIBS.get(name)
        if got is None:
            got = ctypes.CDLL(_lib_path(build_dir(), name))
            _LIBS[name] = got
    return got


class KernelLaunchError(RuntimeError):
    """A launch function returned a nonzero ``cudaError_t``; the gate
    raises it as a typed ``DeviceError`` (``errors.classify``)."""


def check(rc: int, kernel: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch function."""
    if rc != 0:
        raise KernelLaunchError(
            f"CUDA kernel {kernel} failed to launch: cudaError {rc}"
        )
