"""Build the hand-written CUDA kernels and the host graph core at first
use and load them.

Each ``csrc/*.cu`` source has a plain ``extern "C"`` launcher. It is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``dgl_operator_tpu_torch/_build/``, named by a hash of the source, the
``csrc/*.cuh`` headers it may include and the flags (an edited source
or header rebuilds), and loaded with ``ctypes``. The
sources include no PyTorch header, so a build takes seconds.

``native/graphcore.cc``, the host graph core under the sampler and the
partitioner, is compiled the same way by the host C++ compiler
(``$CXX``, else ``g++``) with ``HOST_CXXFLAGS``: no ``-march=native``
and no ``-ffast-math``, so that no float sum of the partitioner is
contracted or reordered. The control plane's executables
(``native/controlplane/``: ``tpu-operator``, ``tpu-watcher``) are
linked the same way by :func:`build_host_exe`, hash-named like the
libraries.
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
from typing import Callable, Dict, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
NATIVE = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
HOST_CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")
# an executable: the same flags without -shared
HOST_EXE_CXXFLAGS = tuple(f for f in HOST_CXXFLAGS if f != "-shared")
HOST_CXX_TIMEOUT_S = 300

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class BuildResult:
    path: str        # the shared library
    seconds: float   # compile wall time; 0.0 when an earlier build was reused
    log: str         # the compiler's output (nvcc: ``-Xptxas -v`` lines)


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


def host_cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++``."""
    return os.environ.get("CXX") or "g++"


def _compile(path: str, compiler: Callable[[], str],
             flags: Sequence[str], key: str, timeout: int,
             extra: Sequence[str] = (), stem: Optional[str] = None,
             suffix: str = ".so") -> BuildResult:
    """Compile ``path`` (and the ``extra`` sources after it) with
    ``compiler() *flags`` into ``<stem>-<hash><suffix>`` under
    ``BUILD_DIR``, the hash over the sources, ``key`` and the flags,
    unless that output is already there; raises with the compiler's
    output when it fails. The output appears by an atomic rename, so
    processes that build at once each see all of it or none."""
    sources = (path, *extra)
    blob = b""
    for src in sources:
        with open(src, "rb") as f:
            blob += f.read()
    digest = hashlib.sha256(blob + " ".join((key, *flags)).encode())
    stem = stem or os.path.splitext(os.path.basename(path))[0]
    lib = os.path.join(BUILD_DIR,
                       f"{stem}-{digest.hexdigest()[:16]}{suffix}")
    log_path = lib + ".log"
    if os.path.exists(lib):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return BuildResult(lib, 0.0, log)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [compiler(), *flags, "-o", tmp, *sources]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
    except FileNotFoundError as e:
        raise RuntimeError(f"compiler {cmd[0]!r} not found; it is needed "
                           f"to build {os.path.basename(path)}") from e
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"{cmd[0]} failed on {os.path.basename(path)} "
            f"(exit {proc.returncode}):\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, lib)   # atomic: a concurrent builder sees all or none
    return BuildResult(lib, seconds, log)


def _headers_digest() -> str:
    """A hash of every ``csrc/*.cuh`` header, which the sources include:
    an edited header rebuilds every kernel."""
    digest = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        if name.endswith(".cuh"):
            with open(os.path.join(CSRC, name), "rb") as f:
                digest.update(name.encode() + f.read())
    return digest.hexdigest()


def build(source: str) -> BuildResult:
    """Compile ``csrc/<source>`` with nvcc unless a build of this exact
    source and headers is already there; raises with nvcc's output when
    it fails."""
    return _compile(os.path.join(CSRC, source), nvcc_path, NVCC_FLAGS,
                    _headers_digest(), NVCC_TIMEOUT_S)


def build_host(source: str) -> BuildResult:
    """Compile ``native/<source>`` with the host C++ compiler unless a
    build of this exact source, compiler and flags is already there;
    raises with the compiler's output when it fails."""
    cxx = host_cxx()
    return _compile(os.path.join(NATIVE, source), lambda: cxx,
                    HOST_CXXFLAGS, cxx, HOST_CXX_TIMEOUT_S)


def build_host_exe(name: str, sources: Sequence[str],
                   headers: Sequence[str] = ()) -> BuildResult:
    """Link the executable ``name`` from ``native/<sources>`` with the
    host C++ compiler and ``HOST_EXE_CXXFLAGS`` into
    ``_build/<name>-<hash>``, the hash over the sources, the
    ``native/<headers>`` they include, the compiler and the flags,
    unless that executable is already there; raises with the compiler's
    output when it fails."""
    cxx = host_cxx()
    key = cxx
    for h in headers:
        with open(os.path.join(NATIVE, h), "rb") as f:
            key += hashlib.sha256(f.read()).hexdigest()
    paths = [os.path.join(NATIVE, s) for s in sources]
    return _compile(paths[0], lambda: cxx, HOST_EXE_CXXFLAGS, key,
                    HOST_CXX_TIMEOUT_S, extra=paths[1:], stem=name,
                    suffix="")


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use; that
    first load is the kernel's compile in the obs plane
    (``obs/prof.py::record_compile``, ``fn`` the source's stem, with the
    nvcc seconds, 0 for a build found on disk)."""
    with _lock:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        t0 = time.perf_counter()
        res = build(source)
        lib = _libs[source] = ctypes.CDLL(res.path)
    from dgl_operator_tpu_torch.obs import prof
    prof.record_compile(os.path.splitext(source)[0], 0,
                        time.perf_counter() - t0, False,
                        nvcc_seconds=round(res.seconds, 3))
    return lib


def load_host(source: str,
              bind: Callable[[ctypes.CDLL], ctypes.CDLL]) -> ctypes.CDLL:
    """The loaded library of ``native/<source>``, built on first use
    and passed once through ``bind`` (which declares its functions'
    argument and result types)."""
    key = os.path.join("native", source)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = _libs[key] = bind(ctypes.CDLL(build_host(source).path))
        return lib
