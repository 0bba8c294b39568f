"""Build and load the search kernels.

``csrc/search.cu`` is compiled with nvcc into a shared library with a plain
C interface, at first use, into ``jepsen_tpu_torch/_build/`` under a name
keyed by a hash of the sources and flags; it is loaded with ctypes. nvcc is
taken from ``$NVCC``, then ``$PATH``, then ``$CUDA_HOME/bin`` (default
``/usr/local/cuda``). A failure to build or load raises :class:`BuildError`:
there is no fallback. A toolkit or driver older than CUDA 12.3 has no
conditional graph nodes for the segment loop: the build fails, or
:func:`require_conditional_nodes` raises. The compiler's ``-Xptxas -v``
report (registers, shared memory and spills per kernel) is kept beside
the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

from jepsen_tpu_torch.obs import metrics as obs_metrics

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = (os.path.join(_PKG, "csrc", "search.cu"),)
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_N = ctypes.POINTER(ctypes.c_int)
#: argument types of each entry point: pointers, ints, the stream, then
#: the count its kernel launches are added to
SIGNATURES = {
    "jt_expand": [_P] * 23 + [_I] * 8 + [_P, _N],
    "jt_sort_rows": [_P] * 3 + [_I] * 8 + [_P, _N],
    "jt_merge_runs": [_P] * 3 + [_I] * 8 + [_P, _N],
    "jt_group_scan": [_P] * 4 + [_I] * 5 + [_P, _N],
    # then seg (null but at a pair's end) and the stream
    "jt_dedup_truncate": [_P] * 20 + [_I] * 7 + [_P, _P, _N],
    "jt_seg_active": [_P, _P, _I, _I, _P, _N],
    # the segment graph: the four entry points' pointers and ints for one
    # shape, whether K3 runs, then where its handle and its body's launch
    # counts go
    "jt_segment_graph_create": ([_P] * 36 + [_I] * 13
                                + [ctypes.POINTER(_P), _N]),
    "jt_segment_graph_launch": [_P, _P],
    "jt_segment_graph_destroy": [_P],
    "jt_cuda_versions": [_N, _N],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

#: the reference's persistent-compilation-cache pair: in the port, the
#: kernel library found built in ``_build/`` (a hit) against built now
PERSISTENT_HIT = obs_metrics.counter(
    "jtpu_persistent_cache_hit_total",
    "kernel library builds found in _build/ for these sources")
PERSISTENT_MISS = obs_metrics.counter(
    "jtpu_persistent_cache_miss_total",
    "kernel library builds made now with nvcc")


class BuildError(RuntimeError):
    """The kernels could not be built or loaded."""


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise BuildError("nvcc not found: set NVCC or CUDA_HOME, or put nvcc "
                     "on PATH")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"jt_search-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless a build of these sources exists; return
    its path."""
    path = library_path()
    if os.path.exists(path):
        PERSISTENT_HIT.inc()
        return path
    PERSISTENT_MISS.inc()
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES]
    os.makedirs(BUILD_DIR, exist_ok=True)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(path[:-3] + ".log", "w") as fh:
        fh.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise BuildError(f"nvcc failed ({proc.returncode}):\n"
                         f"{proc.stderr[-4000:]}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise BuildError(f"cannot load {path}: {e}") from e
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.jt_error_string.argtypes = [ctypes.c_int]
            lib.jt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


#: the first CUDA version whose graphs have conditional nodes, as CUDA
#: numbers it (1000 * major + 10 * minor)
CONDITIONAL_NODES = 12030


def require_conditional_nodes() -> None:
    """Raise :class:`BuildError` unless both the toolkit the library was
    built with and the driver support conditional graph nodes (the
    segment graph's WHILE node)."""
    runtime, driver = ctypes.c_int(0), ctypes.c_int(0)
    load().jt_cuda_versions(ctypes.byref(runtime), ctypes.byref(driver))
    if min(runtime.value, driver.value) < CONDITIONAL_NODES:
        raise BuildError(
            f"the segment graph needs CUDA 12.3 or later (conditional "
            f"nodes): the library was built with CUDA {_version(runtime)}"
            f" and the driver supports CUDA {_version(driver)}")


def _version(v: ctypes.c_int) -> str:
    return f"{v.value // 1000}.{v.value % 1000 // 10}"


def error_string(code: int) -> str:
    if _lib is None:
        return f"error {code}"
    return _lib.jt_error_string(code).decode()
