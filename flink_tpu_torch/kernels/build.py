"""Build and load the port's hand-written CUDA kernels and its native host
layer.

Each ``csrc/*.cu`` source is compiled with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, on first use, into ``flink_tpu_torch/_build/`` (listed in
``.gitignore``).  The host layer ``csrc/host_mirror.cc`` (the C keydict and
the window value mirror), the spill store of cold-key paging
``csrc/spill_store.cc`` and the batch codec ``csrc/codec.cc`` (FLZ blocks,
delta varints, CRCs) build beside them with ``g++`` (:func:`build_host`);
they need no card, so the CPU tests build and run them.
A library's name carries a hash of its source and flags, so an edited
source rebuilds and concurrent builds race benignly (write to a temporary
name, then ``os.replace``).  Libraries are loaded with ``ctypes``; nothing
here runs at import time, so the CPU tests import this module on a machine
with no ``nvcc``.  A failed build raises with the compiler's output.
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
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
              "-fvisibility=hidden")
#: the host compiler of :func:`build_host`
HOST_CXX = "g++"
#: the native host layer's source
HOST_SOURCE = "host_mirror.cc"
#: the spill store's source (the storage tier of cold-key paging)
SPILL_SOURCE = "spill_store.cc"
#: the batch codec's source (FLZ blocks, delta varints, CRC-32/32C)
CODEC_SOURCE = "codec.cc"

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


def _is_host(source: str) -> bool:
    return source.endswith(".cc")


def library_path(source: str) -> str:
    """Where ``csrc/<source>`` builds to: named by a hash of the source, the
    shared headers (``csrc/*.cuh``, for a CUDA source) and the flags."""
    host = _is_host(source)
    digest = hashlib.sha256(" ".join(HOST_FLAGS if host
                                     else NVCC_FLAGS).encode())
    headers = [] if host else sorted(f for f in os.listdir(CSRC_DIR)
                                     if f.endswith(".cuh"))
    for name in [source, *headers]:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def find_host_compiler() -> str:
    """Path of :data:`HOST_CXX`; raises when it is not installed."""
    found = shutil.which(HOST_CXX)
    if found is None:
        raise RuntimeError(f"{HOST_CXX} not found: the port's native host "
                           f"code (csrc/{HOST_SOURCE}, csrc/{SPILL_SOURCE}, "
                           f"csrc/{CODEC_SOURCE}) "
                           f"needs a C++17 compiler")
    return found


def _compile(source: str, find_compiler, flags) -> str:
    """Compile ``csrc/<source>`` unless its hashed library exists; returns
    the library path.  The compiler is looked up (``find_compiler()``) only
    when a build is needed.  Raises with the compiler's output when it
    fails."""
    so_path = library_path(source)
    if os.path.exists(so_path):
        build_seconds.setdefault(source, 0.0)
        return so_path
    compiler = find_compiler()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.tmp.{os.getpid()}"
    cmd = [compiler, *flags, "-o", tmp, os.path.join(CSRC_DIR, source)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed for "
                           f"{source} ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, so_path)
    build_seconds[source] = time.perf_counter() - t0
    ptxas_report[source] = (res.stdout + res.stderr).strip()
    return so_path


def build(source: str) -> str:
    """Compile the CUDA source ``csrc/<source>`` with nvcc (see
    :func:`_compile`)."""
    return _compile(source, find_nvcc, NVCC_FLAGS)


def build_host(source: str = HOST_SOURCE) -> str:
    """Compile the C++ source ``csrc/<source>`` with :data:`HOST_CXX` and
    :data:`HOST_FLAGS` (see :func:`_compile`)."""
    return _compile(source, find_host_compiler, HOST_FLAGS)


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    lib = _libs.get(source)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path = build_host(source) if _is_host(source) else build(source)
            lib = _libs[source] = ctypes.CDLL(path)
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


def scatter_fold_lib() -> ctypes.CDLL:
    """``csrc/scatter_fold.cu`` with its entry point's C signature
    declared."""
    lib = load("scatter_fold.cu")
    fn = lib.flink_scatter_fold_launch
    if fn.argtypes is None:
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] + [ci] * 5 + [vp, vp, ci, vp, vp, vp, ci, vp, vp,
                                          vp, cl, vp, ci, vp])
        fn.restype = ci
    return lib


def host_mirror_lib() -> ctypes.CDLL:
    """``csrc/host_mirror.cc`` (the C keydict, its worker pool and the
    window value mirror) with every entry point's C signature declared."""
    lib = load(HOST_SOURCE)
    if lib.ftt_wm_import_pane.argtypes is not None:   # declared last
        return lib
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    vp, u8p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)
    sigs = {
        "ftt_keydict_create": (vp, [i64]),
        "ftt_keydict_destroy": (None, [vp]),
        "ftt_keydict_size": (i64, [vp]),
        "ftt_keydict_lookup_or_insert": (None, [vp, vp, i64, vp]),
        "ftt_keydict_lookup": (None, [vp, vp, i64, vp]),
        "ftt_keydict_reverse": (None, [vp, vp]),
        "ftt_keydict_reverse_range": (None, [vp, i64, i64, vp]),
        "ftt_hw_threads": (i32, []),
        "ftt_wm_create": (vp, [vp, i32, u8p, u8p, vp]),
        "ftt_wm_destroy": (None, [vp]),
        "ftt_wm_drop_pane": (None, [vp, i64]),
        "ftt_wm_pane_count": (i64, [vp]),
        "ftt_wm_live_panes": (None, [vp, vp]),
        "ftt_wm_probe_update": (None, [vp, vp, vp, i64, vp, u8p, vp, i64, vp,
                                       i64, i32, i32]),
        "ftt_wm_probe_update2": (None, [vp, vp, vp, i64, vp, u8p, vp, i64,
                                        vp, i64, i32, i32, i64, vp]),
        "ftt_wm_fire": (i64, [vp, vp, i32, vp, vp, vp]),
        "ftt_wm_apply_delta": (None, [vp, i64, i64, vp, vp, u8p]),
        "ftt_wm_export_pane": (i32, [vp, i64, i64, vp, vp]),
        "ftt_wm_import_pane": (None, [vp, i64, i64, vp, vp]),
    }
    with _lock:
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
    return lib


def spill_store_lib() -> ctypes.CDLL:
    """``csrc/spill_store.cc`` (the paging tier's cell store and the spill
    keyed backend's key-value store) with every entry point's C signature
    declared."""
    lib = load(SPILL_SOURCE)
    if lib.ftt_spill_kv_compact.argtypes is not None:   # declared last
        return lib
    i64, ci, vp, cp = (ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_char_p)
    sigs = {
        "ftt_spill_open": (vp, [cp, i64, i64]),
        "ftt_spill_close": (None, [vp]),
        "ftt_spill_put_cells": (i64, [vp, i64, vp, vp, vp, vp, ci, vp, vp]),
        "ftt_spill_get_cells": (i64, [vp, i64, vp, vp, ci, vp, vp, vp, ci, vp,
                                      vp]),
        "ftt_spill_delete_cells": (i64, [vp, i64, vp, vp]),
        "ftt_spill_clear": (None, [vp]),
        "ftt_spill_count": (i64, [vp]),
        "ftt_spill_mem_used": (i64, [vp]),
        "ftt_spill_log_bytes": (i64, [vp]),
        "ftt_spill_kv_open": (vp, [cp, i64]),
        "ftt_spill_kv_close": (None, [vp]),
        "ftt_spill_kv_put": (ci, [vp, cp, i64, cp, i64]),
        "ftt_spill_kv_get": (i64, [vp, cp, i64, vp, i64]),
        "ftt_spill_kv_delete": (ci, [vp, cp, i64]),
        "ftt_spill_kv_count": (i64, [vp]),
        "ftt_spill_kv_mem_used": (i64, [vp]),
        "ftt_spill_kv_log_bytes": (i64, [vp]),
        "ftt_spill_kv_log_garbage": (i64, [vp]),
        "ftt_spill_kv_iter_begin": (vp, [vp]),
        "ftt_spill_kv_iter_next": (i64, [vp, vp, i64]),
        "ftt_spill_kv_iter_end": (None, [vp]),
        "ftt_spill_kv_flush": (ci, [vp]),
        "ftt_spill_kv_compact": (i64, [vp]),
    }
    with _lock:
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
    return lib


def codec_lib() -> ctypes.CDLL:
    """``csrc/codec.cc`` (the batch codec's delta varints, FLZ blocks and
    CRCs) with every entry point's C signature declared."""
    lib = load(CODEC_SOURCE)
    if lib.ftt_crc32c.argtypes is not None:   # declared last
        return lib
    i64, u32, vp = ctypes.c_int64, ctypes.c_uint32, ctypes.c_void_p
    sigs = {
        "ftt_delta_varint_encode_i64": (i64, [vp, i64, vp, i64]),
        "ftt_delta_varint_decode_i64": (i64, [vp, i64, i64, vp]),
        "ftt_lz_bound": (i64, [i64]),
        "ftt_lz_compress": (i64, [vp, i64, vp, i64]),
        "ftt_lz_decompress": (i64, [vp, i64, vp, i64]),
        "ftt_crc32": (u32, [vp, i64, u32]),
        "ftt_crc32c": (u32, [vp, i64, u32]),
    }
    with _lock:
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
    return lib
