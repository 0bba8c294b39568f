"""The native engine: the C++ twin of the host WGL search.

Wraps ``jepsen_tpu_torch/native/wgl_engine.cc``, the same search as
:func:`jepsen_tpu_torch.checker.wgl.check_packed` (the reference's
knossos WGL, checker.clj:85-94) compiled to machine code for the host.
It returns the same result dict, so counterexample rendering and the
severity merge treat the engines alike, and it explores the same
configurations in the same order (equal ``configs-explored``). Histories
the fixed-width masks cannot hold (candidate offsets past 512, more than
128 crashed ops) come back UNKNOWN and callers fall back to the
unbounded Python search. Counterpart of ``jepsen_tpu/checker/native.py``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Any, Dict, Optional

import numpy as np

from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.checker.wgl import _describe_op
from jepsen_tpu_torch.models.core import KernelSpec
from jepsen_tpu_torch.ops.encode import PackedHistory

#: KernelSpec.name -> engine kernel id (wgl_engine.cc KERNEL_*).
KERNEL_IDS = {
    "cas-register": 0,
    "mutex": 1,
    "noop": 2,
    "set": 3,
    "unordered-queue": 4,
    "fifo-queue": 5,
}

#: the engine's ABI version (wgl_engine.cc jepsen_wgl_abi_version)
ABI_VERSION = 2

_VALID, _INVALID, _BUDGET, _WINDOW, _BAD_KERNEL, _CANCELLED = 1, 0, 2, 3, 4, 5

_lib_state: Dict[str, Any] = {}
_lib_lock = threading.Lock()


def _lib():
    """Load and prototype the engine once per process (None if it cannot
    be built)."""
    with _lib_lock:
        if "lib" in _lib_state:
            return _lib_state["lib"]
        from jepsen_tpu_torch import native
        lib = native.load("wgl_engine")
        if lib is not None:
            try:
                lib.jepsen_wgl_abi_version.restype = ctypes.c_int64
                if lib.jepsen_wgl_abi_version() != ABI_VERSION:
                    lib = None  # a cached .so of another ABI
            except AttributeError:
                lib = None
        if lib is not None:
            lib.jepsen_wgl_check.restype = ctypes.c_int64
            lib.jepsen_wgl_check.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64),
            ]
        _lib_state["lib"] = lib
        return lib


def available() -> bool:
    """True iff the native engine compiled and loaded on this host."""
    return _lib() is not None


def library_path() -> Optional[str]:
    """The path of the loaded engine library, or None."""
    lib = _lib()
    return None if lib is None else lib._name


def check_packed_native(p: PackedHistory, kernel: KernelSpec,
                        max_configs: Optional[int] = None,
                        should_stop=None) -> Dict[str, Any]:
    """Check one packed single-key history with the C++ engine.

    The contract of :func:`wgl.check_packed`: ``{'valid': True | False |
    'unknown', ...}``, with ``engine: "native"``. ``should_stop`` (a
    nullary callable, the competition protocol) is polled by a watcher
    thread that sets the engine's stop flag; ctypes releases the GIL for
    the call, so the engine runs in parallel with Python racers.
    """
    lib = _lib()
    if lib is None:
        return {"valid": UNKNOWN, "engine": "native",
                "error": "native engine unavailable on this host"}
    kid = KERNEL_IDS.get(kernel.name)
    if kid is None:
        return {"valid": UNKNOWN, "engine": "native",
                "error": f"kernel {kernel.name!r} has no native id"}
    if p.n_required == 0:
        return {"valid": True, "configs-explored": 0, "engine": "native"}
    if max_configs is not None and max_configs <= 0:
        # as the Python engines (explored > max_configs after one pop); 0
        # is the C ABI's "unbounded", never passed through
        return {"valid": UNKNOWN, "engine": "native",
                "error": f"config budget {max_configs} exhausted",
                "configs-explored": 0, "max-linearized-prefix": 0,
                "tiers-escalated": False}

    cols = [np.ascontiguousarray(a, dtype=np.int32)
            for a in (p.f, p.v1, p.v2, p.inv, p.ret)]
    ptrs = [c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)) for c in cols]
    out = (ctypes.c_int64 * 19)()
    stop_flag = ctypes.c_uint8(0)

    watcher = None
    stop_watcher = threading.Event()
    if should_stop is not None:
        def _watch():
            while not stop_watcher.wait(0.005):
                if should_stop():
                    stop_flag.value = 1
                    return
        watcher = threading.Thread(target=_watch, daemon=True)
        watcher.start()
    try:
        # Window escalation: start at the 128-offset masks every realistic
        # history fits, widen to 256/512 on overflow (wider configs cost
        # hash and compare time). More than 128 crashed ops overflow the
        # separate crash mask, which no wider window fixes. One config
        # budget is shared across tiers: a tier that spent B configs
        # before overflowing leaves max_configs - B for the next, and
        # configs-explored is the total.
        mask_ladder = ((2,) if p.n - p.n_required > 128 else (2, 4, 8))
        spent = 0
        escalated = False
        for tier, mw in enumerate(mask_ladder):
            escalated = tier > 0
            budget = (0 if max_configs is None
                      else max(1, int(max_configs) - spent))
            status = lib.jepsen_wgl_check(
                kid, mw, int(p.init_state), p.n, p.n_required, *ptrs,
                budget, ctypes.pointer(stop_flag), out)
            spent += int(out[0])
            if status != _WINDOW:
                break
            if max_configs is not None and spent >= int(max_configs):
                # a window overflow with nothing left for the wider tier:
                # the unbounded search with the full budget might answer
                status, escalated = _BUDGET, True
                break
    finally:
        stop_watcher.set()
        if watcher is not None:
            watcher.join(timeout=1.0)

    explored = spent
    best_k = int(out[1])
    if status == _VALID:
        return {"valid": True, "configs-explored": explored,
                "engine": "native"}
    if status == _INVALID:
        n_states = int(out[2])
        return {"valid": False, "configs-explored": explored,
                "max-linearized-prefix": best_k,
                "frontier-op": (_describe_op(p, best_k)
                                if best_k < p.n else None),
                "final-states": sorted(int(out[3 + i])
                                       for i in range(n_states)),
                "engine": "native"}
    if status == _BUDGET:
        # tiers-escalated: narrower tiers spent part of the budget before
        # overflowing, so the last tier ran with less; an unbounded-window
        # search with the caller's whole budget might still answer, and
        # the facade does not take such a verdict as final
        return {"valid": UNKNOWN, "engine": "native",
                "error": f"config budget {max_configs} exhausted",
                "configs-explored": explored,
                "max-linearized-prefix": best_k,
                "tiers-escalated": escalated}
    if status == _WINDOW:
        return {"valid": UNKNOWN, "engine": "native",
                "error": "candidate window exceeds the native engine's "
                         "widest (512-offset) masks, or >128 crashed ops",
                "configs-explored": explored}
    if status == _CANCELLED:
        return {"valid": UNKNOWN, "engine": "native",
                "configs-explored": explored, "error": "cancelled"}
    return {"valid": UNKNOWN, "engine": "native",
            "error": f"native engine status {status}"}


def check_history_native(history, model, max_configs: Optional[int] = None,
                         should_stop=None) -> Dict[str, Any]:
    """Pack a history against a model and check it with the native engine.

    UNKNOWN when the model has no integer kernel or the history does not
    fit its word (the device path's fallbacks too).
    """
    from jepsen_tpu_torch.ops.encode import pack_with_init
    try:
        packed, kernel = pack_with_init(history, model)
    except ValueError as e:
        return {"valid": UNKNOWN, "engine": "native", "error": str(e)}
    return check_packed_native(packed, kernel, max_configs, should_stop)


def check_keyed_native(keyed: Dict[Any, Any], model,
                       max_configs: Optional[int] = None) -> Dict[str, Any]:
    """Check a ``{key: history}`` map on the native engine, keys in
    parallel.

    The host twin of :func:`jepsen_tpu_torch.checker.gpu.check_keyed_gpu`
    (reference independent.clj:246-296): each key's search is one engine
    call without the GIL, spread over threads by ``real_pmap``. Keys the
    engine cannot settle come back UNKNOWN; callers fall back per key.
    """
    from jepsen_tpu_torch.util import real_pmap

    ks = list(keyed.keys())

    def one(k):
        return check_history_native(keyed[k], model, max_configs)

    results = dict(zip(ks, real_pmap(one, ks)))
    valid: Any = True
    for r in results.values():
        if r["valid"] is False:
            valid = False
            break
        if r["valid"] is UNKNOWN:
            valid = UNKNOWN
    return {"valid": valid, "results": results, "engine": "native"}
