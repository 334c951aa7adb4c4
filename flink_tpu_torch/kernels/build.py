"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, on first use, into ``flink_tpu_torch/_build/`` (listed in
``.gitignore``).  The library's name carries a hash of its source and flags,
so an edited source rebuilds and concurrent builds race benignly (write to
a temporary name, then ``os.replace``).  Libraries are loaded with
``ctypes``; nothing here runs at import time, so the CPU tests import this
module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: where the CUDA toolkit installs nvcc when it is on neither path above
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: seconds each source took to compile in this process (0 when cached)
build_seconds: Dict[str, float] = {}
#: ptxas's resource report (registers, shared memory, spills) per source
ptxas_report: Dict[str, str] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    :data:`DEFAULT_NVCC`.  Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels build only where the CUDA "
                       "toolkit is installed")


def library_path(source: str) -> str:
    """Where ``csrc/<source>`` builds to: named by a hash of the source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for name in [source, *headers]:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build(source: str) -> str:
    """Compile ``csrc/<source>`` unless its hashed library exists; returns
    the library path.  Raises with nvcc's output when the build fails."""
    so_path = library_path(source)
    if os.path.exists(so_path):
        build_seconds.setdefault(source, 0.0)
        return so_path
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.tmp.{os.getpid()}"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source} ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, so_path)
    build_seconds[source] = time.perf_counter() - t0
    ptxas_report[source] = (res.stdout + res.stderr).strip()
    return so_path


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    lib = _libs.get(source)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(build(source))
    return lib


def probe_lib() -> ctypes.CDLL:
    """``csrc/probe.cu`` with its entry point's C signature declared."""
    lib = load("probe.cu")
    fn = lib.flink_probe_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, ci, ci, vp]
        fn.restype = ci
    return lib


def probe_fold_lib() -> ctypes.CDLL:
    """``csrc/probe_fold.cu`` with its entry point's C signature declared."""
    lib = load("probe_fold.cu")
    fn = lib.flink_probe_fold_launch
    if fn.argtypes is None:
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 11 + [ci, ci, ci, cl, ci, ci, ci, ci, vp]
        fn.restype = ci
    return lib
