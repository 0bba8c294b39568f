"""The CUDA-init probe, and the process's record of a device that wedged
mid-run.

Counterpart of ``jepsen_tpu/accel.py``. Its init half
(:func:`probe_default_backend`, :func:`ensure_usable`) initialises CUDA
in a child interpreter first, under ``JEPSEN_ACCEL_PROBE_TIMEOUT``
seconds (default 300): a CUDA initialisation that hangs holds its lock,
so a hang in this process could never be undone. The verdict
is cached for the process; an initialised CUDA context is proof enough
and ``JEPSEN_ACCEL_OK=1`` skips the probe. Unlike the reference, which
pins its process to its CPU backend when the probe hangs, the port never
moves work to the CPU by itself: :func:`ensure_usable` raises
:class:`AcceleratorUnavailable`, and a caller who wants the CPU asks for
``device="cpu"``.

Its run-time half (``runtime_wedged``, ``note_runtime_wedge``): the segment supervisor's
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
only once the worker has ended.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import warnings
from typing import Any, Dict, List, Optional

import torch

_lock = threading.Lock()
_state: Dict[str, Any] = {}


class WedgeError(Exception):
    """A supervised call exceeded its deadline."""


# ---------------------------------------------------------------------------
# The CUDA-init probe
# ---------------------------------------------------------------------------

#: Seconds CUDA gets to initialise in the probe child (the reference's
#: default; JEPSEN_ACCEL_PROBE_TIMEOUT, read at each probe, overrides).
PROBE_TIMEOUT_S = 300.0

#: The probe child's program: ``cuInit`` and the first card's primary
#: context, through libcuda alone (no torch to import, so
#: the child costs little more than what it probes); the tests substitute
#: one that hangs.
_PROBE_CODE = (
    "import ctypes, sys\n"
    "cu = ctypes.CDLL('libcuda.so.1')\n"
    "n, dev, ctx = ctypes.c_int(), ctypes.c_int(), ctypes.c_void_p()\n"
    "ok = (cu.cuInit(0) == 0\n"
    "      and cu.cuDeviceGetCount(ctypes.byref(n)) == 0 and n.value > 0\n"
    "      and cu.cuDeviceGet(ctypes.byref(dev), 0) == 0\n"
    "      and cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev) == 0)\n"
    "print('JEPSEN_ACCEL', 'cuda' if ok else 'none', flush=True)\n"
    "sys.exit(0 if ok else 1)\n")

_probe: Dict[str, Any] = {}
_probe_lock = threading.Lock()


class AcceleratorUnavailable(RuntimeError):
    """CUDA did not initialise in the probe child within its timeout, or
    failed there; the port does not move the work to the CPU."""


def _probe_timeout() -> float:
    v = os.environ.get("JEPSEN_ACCEL_PROBE_TIMEOUT")
    if v:
        try:
            return float(v)
        except ValueError:
            pass
    return PROBE_TIMEOUT_S


def _spawn_probe(timeout: float) -> Optional[str]:
    """Initialise CUDA in a child interpreter with this process's
    environment: the platform it names, or None on a hang, a crash or no
    CUDA. A child past its timeout is killed."""
    try:
        pr = subprocess.run([sys.executable, "-c", _PROBE_CODE],
                            capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return None
    except OSError:
        return None
    if pr.returncode != 0:
        return None
    for line in reversed((pr.stdout or "").splitlines()):
        if line.startswith("JEPSEN_ACCEL "):
            return line.split()[1]
    return None


def probe_default_backend(timeout: Optional[float] = None) -> Optional[str]:
    """The cached probe verdict: ``"cuda"``, or None when CUDA hung or
    failed to initialise in the child. No child is spawned where CUDA is
    initialised in this process already, or ``JEPSEN_ACCEL_OK`` is set."""
    with _probe_lock:
        if "platform" in _probe:
            return _probe["platform"]
        if os.environ.get("JEPSEN_ACCEL_OK") or torch.cuda.is_initialized():
            plat = "cuda"
        else:
            plat = _spawn_probe(_probe_timeout() if timeout is None
                                else timeout)
        _probe["platform"] = plat
        return plat


def ensure_usable(caller: str = "checker", timeout: Optional[float] = None,
                  device=None) -> str:
    """Gate a device call: ``"cpu"`` for a CPU ``device`` (no probe),
    else the probe's platform; raises :class:`AcceleratorUnavailable`
    when CUDA did not initialise within the timeout. Cheap after the
    first call."""
    if device is not None and torch.device(device).type == "cpu":
        return "cpu"
    plat = probe_default_backend(timeout)
    if plat is None:
        wait = _probe_timeout() if timeout is None else timeout
        raise AcceleratorUnavailable(
            f"the card did not initialise within {wait:.0f}s in the "
            f"CUDA-init probe; {caller} does not fall back to the CPU "
            f"(pass device='cpu' to check there, or set "
            f"JEPSEN_ACCEL_PROBE_TIMEOUT to wait longer)")
    return plat


def _reset_probe_for_tests() -> None:
    with _probe_lock:
        _probe.clear()


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
