"""The process's record of a device that wedged mid-run.

Counterpart of the run-time half of ``jepsen_tpu/accel.py``
(``runtime_wedged``, ``note_runtime_wedge``): the segment supervisor's
watchdog (:mod:`jepsen_tpu_torch.resilience`) notes here that a device
segment never came back, on which device, and the record stays for the
life of the process. A wedged CUDA device refuses every later search on
CUDA: the supervisor answers UNKNOWN at once, before it touches the card,
and the engine (:mod:`jepsen_tpu_torch.checker.engine`) hands out no CUDA
state again. A search on the CPU is never refused: a caller who wants an
answer after a wedge resumes the wedge result's checkpoint there with
``device="cpu"``.

A wedged segment's worker thread cannot be killed: it is abandoned, and
the record keeps it, so that :func:`_reset_for_tests` clears the record
only once the worker has ended. The CUDA-init probe is not part of this
module.
"""

from __future__ import annotations

import threading
import warnings
from typing import Any, Dict, List, Optional

import torch

_lock = threading.Lock()
_state: Dict[str, Any] = {}


class WedgeError(Exception):
    """A supervised call exceeded its deadline."""


def runtime_wedged(device=None) -> bool:
    """True once a mid-run device wedge was recorded in this process;
    given a ``device``, true only where a search on it is refused: a CUDA
    device once any CUDA device wedged (a CPU search is never refused)."""
    with _lock:
        if not _state.get("runtime_wedged"):
            return False
        if device is None:
            return True
        return (torch.device(device).type == "cuda"
                and "cuda" in _state.get("device-types", ()))


def wedged_devices() -> List[str]:
    """The devices whose segments wedged, in the order they first did."""
    with _lock:
        return list(_state.get("devices", ()))


def note_runtime_wedge(caller: str, deadline_s: float, device=None,
                       worker: Optional[threading.Thread] = None,
                       **detail) -> bool:
    """Record that a device execution wedged mid-run on ``device`` (None:
    CUDA), counted each time, with a visible warning the first; ``worker``
    is the abandoned thread still running the segment, if any. Returns
    True the first time."""
    dev = torch.device("cuda" if device is None else device)
    with _lock:
        first = not _state.get("runtime_wedged")
        _state["runtime_wedged"] = True
        _state["wedges"] = _state.get("wedges", 0) + 1
        if str(dev) not in _state.setdefault("devices", []):
            _state["devices"].append(str(dev))
        _state.setdefault("device-types", set()).add(dev.type)
        if worker is not None:
            _state.setdefault("workers", []).append(worker)
    if first:
        extra = "".join(f" {k}={v}" for k, v in sorted(detail.items()))
        warnings.warn(
            f"device execution wedged past {deadline_s:.1f}s mid-run on "
            f"{dev}; {caller} gives up with an UNKNOWN result and its last "
            f"checkpoint{extra} (subsequent supervised searches on CUDA "
            f"answer UNKNOWN at once; resume the checkpoint with "
            f"device='cpu'; JTPU_SEGMENT_DEADLINE_S tunes the watchdog)",
            RuntimeWarning, stacklevel=3)
    return first


def wedge_count() -> int:
    """The wedges noted in this process (every one, not only the
    first)."""
    with _lock:
        return int(_state.get("wedges", 0))


def abandoned_workers() -> List[threading.Thread]:
    """The worker threads that wedged segments left behind, ended or
    not."""
    with _lock:
        return list(_state.get("workers", ()))


def _reset_for_tests(timeout: float = 30.0) -> None:
    """Forget the wedge, once every abandoned worker has ended (each is
    joined for up to ``timeout`` seconds; one still running raises and
    leaves the record as it is). Then the engine lets go of the buffers
    those workers held."""
    for t in abandoned_workers():
        t.join(timeout)
        if t.is_alive():
            raise RuntimeError(f"the abandoned segment worker {t.name} is "
                               f"still running; the wedge record stays")
    with _lock:
        _state.clear()
    from jepsen_tpu_torch.checker import engine
    engine.release_abandoned()
