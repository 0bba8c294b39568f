"""Native (C++) host engines, compiled on first use.

The device search is CUDA (``csrc/search.cu``); the host side around it
uses native code where a hot loop would otherwise be interpreter-bound:
``wgl_engine.cc``, the C++ WGL search behind
:mod:`jepsen_tpu_torch.checker.native`. The source ships in this package
and is built with the system C++ compiler, no package manager involved.

Artifacts go to ``jepsen_tpu_torch/_build/`` under a name keyed by a
content hash of the source and the compile flags, so an edited source or
new flags rebuild while a repeat load costs one stat. The compiler's
command and output are kept beside the library as ``<name>_<key>.log``,
so a failed build can be read. ``JEPSEN_TPU_CXX`` names the compiler
(default ``g++``); ``JEPSEN_TPU_NO_NATIVE=1`` disables every native
engine (each caller has a pure-Python fallback).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_cache: dict = {}


def disabled() -> bool:
    return os.environ.get("JEPSEN_TPU_NO_NATIVE", "") not in ("", "0")


def source_path(name: str) -> str:
    return os.path.join(_HERE, f"{name}.cc")


def build(name: str) -> Optional[str]:
    """Compile ``<name>.cc`` into a cached shared library; return its path,
    or None when native code is disabled or cannot be built."""
    if disabled():
        return None
    src = source_path(name)
    try:
        with open(src, "rb") as fh:
            blob = fh.read()
    except OSError:
        return None
    key = hashlib.sha256(blob + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"{name}_{key}.so")
    if os.path.exists(out):
        return out
    with _lock:
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = out + f".tmp.{os.getpid()}"
        cmd = [os.environ.get("JEPSEN_TPU_CXX", "g++"), *_FLAGS, "-o", tmp,
               src]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=120)
            log, ok = proc.stdout + proc.stderr, proc.returncode == 0
        except (subprocess.SubprocessError, OSError) as e:
            log, ok = repr(e), False
        with open(out[:-3] + ".log", "w") as fh:
            fh.write(" ".join(cmd) + "\n" + log)
        if not ok:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        os.replace(tmp, out)  # atomic: concurrent builds converge
    return out


def load(name: str) -> Optional[ctypes.CDLL]:
    """build() and dlopen, once per process. None when unavailable."""
    with _lock:
        if name in _cache:
            return _cache[name]
    path = build(name)
    lib = None
    if path is not None:
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            lib = None
    with _lock:
        _cache[name] = lib
    return lib
