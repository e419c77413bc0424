"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/*.cu`` source has a plain ``extern "C"`` launcher. It is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``dgl_operator_tpu_torch/_build/``, named by a hash of the source and
the flags (an edited source rebuilds), and loaded with ``ctypes``. The
sources include no PyTorch header, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class BuildResult:
    path: str        # the shared library
    seconds: float   # nvcc wall time; 0.0 when an earlier build was reused
    log: str         # nvcc's output (``-Xptxas -v`` register/spill lines)


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location (the order PyTorch's own
    extension builder searches); raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None and os.path.exists(DEFAULT_NVCC):
        found = DEFAULT_NVCC
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); it is "
            "needed to build the CUDA kernels in "
            f"{os.path.relpath(CSRC, os.path.dirname(_PKG))}")
    return found


def _target(source: str) -> Tuple[str, str]:
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    lib = os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")
    return lib, lib + ".log"


def build(source: str) -> BuildResult:
    """Compile ``csrc/<source>`` unless a build of this exact source is
    already there; raises with nvcc's output when it fails."""
    lib, log_path = _target(source)
    if os.path.exists(lib):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return BuildResult(lib, 0.0, log)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=NVCC_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, lib)   # atomic: a concurrent builder sees all or none
    return BuildResult(lib, seconds, log)


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(build(source).path)
        return lib
