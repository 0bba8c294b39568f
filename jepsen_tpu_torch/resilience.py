"""The failure taxonomy, poison bisection, and the segment loop of the
single-history search.

Counterpart of ``jepsen_tpu/resilience.py``'s failure classes
(``classify_failure``, ``result_failure_class``), its gang bisection
``bisect_poison``, and the segment loop of ``supervised_check_packed``.
Each rung runs as the keyed batch does, a batch of one through
:func:`jepsen_tpu_torch.checker.gpu.run_batch`: segments of levels that
grow from 64 up to ``segment_iters``, with the carry on the device and the
kernels testing ``active`` there, so the host launches a segment's levels
without waiting and reads the ``active`` flag once at its end. Verdicts
and level counts equal an unsegmented run's, because an inactive level
changes nothing.

A ``deadline`` is cooperative: it is tested at each segment barrier, and
once it has passed the search stops there, releases the engine's lock and
returns the serve daemon's timeout shape. (The reference's daemon
abandons a late check's thread, which holds no lock across its device
calls; this search holds :attr:`Engine.lock` for its whole ladder, so an
abandoned search must stop by itself.)

The reference's checkpoint files, watchdog, retry policy, CPU fallback,
OOM shrink and fault injection are not part of this port yet.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from jepsen_tpu_torch import interop
from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.checker.engine import default_engine
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.kernels.search import LevelShape
from jepsen_tpu_torch.models.core import KernelSpec
from jepsen_tpu_torch.ops.encode import PackedHistory

# ---------------------------------------------------------------------------
# Failure taxonomy
# ---------------------------------------------------------------------------

#: Device memory exhaustion.
OOM = "oom"
#: A device call that did not finish within its deadline.
WEDGE = "wedge"
#: Plausibly recoverable runtime errors (resets, unavailability).
TRANSIENT = "transient"
#: A cross-device collective that timed out or aborted.
DCN = "dcn"
#: Everything else: a programming error or corrupted state.
FATAL = "fatal"

#: Classes the serve daemon's breaker treats as neutral: a fault that a
#: retry absorbs is no sign of a sick shape bucket.
RETRYABLE = (DCN, TRANSIENT)

_CLASSES = (OOM, WEDGE, DCN, TRANSIENT, FATAL)


class WedgeError(Exception):
    """A supervised call exceeded its deadline."""


#: Substrings marking an out-of-memory failure in the error text; the
#: first is what ``torch.OutOfMemoryError`` says on a CUDA device.
_OOM_MARKERS = ("CUDA out of memory", "out of memory", "Out of memory",
                "OutOfMemoryError", "RESOURCE_EXHAUSTED",
                "RESOURCE EXHAUSTED", "OOM", "failed to allocate")

#: Substrings marking transient runtime faults worth a same-shape retry.
_TRANSIENT_MARKERS = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED",
                      "CANCELLED", "preempt", "Connection reset",
                      "Socket closed", "temporarily unavailable")

#: Substrings marking a collective or interconnect fault (tested before
#: the transient markers).
_DCN_MARKERS = ("collective", "all-reduce", "all_reduce", "all-gather",
                "all_gather", "AllReduce", "AllGather", "NCCL",
                "DCN", "cross-host", "cross_host", "barrier timed out",
                "coordination service", "distributed runtime",
                "heartbeat", "HostLostError")


def classify_failure(exc: BaseException) -> str:
    """Map an exception to its failure class (OOM, WEDGE, DCN, TRANSIENT,
    FATAL), by type and by the text of the error."""
    if isinstance(exc, WedgeError):
        return WEDGE
    if isinstance(exc, (MemoryError, torch.OutOfMemoryError)):
        return OOM
    text = f"{type(exc).__name__}: {exc}"
    if any(m in text for m in _OOM_MARKERS):
        return OOM
    if any(m in text for m in _DCN_MARKERS):
        return DCN
    if isinstance(exc, (ConnectionError, TimeoutError, InterruptedError)):
        return TRANSIENT
    if any(m in text for m in _TRANSIENT_MARKERS):
        return TRANSIENT
    return FATAL


def result_failure_class(result: Optional[Dict[str, Any]]
                         ) -> Optional[str]:
    """The failure class of a finished check result: its ``error-class``
    (``check_safe`` sets it on a raised check, the daemon on a timeout),
    else the class of a ``gave-up`` event in its ``attempts`` trail, else
    None (a clean result, valid or not)."""
    if not isinstance(result, dict):
        return None
    cls = result.get("error-class")
    if cls in _CLASSES:
        return cls
    for ev in reversed(result.get("attempts") or []):
        if isinstance(ev, dict) and ev.get("outcome") == "gave-up":
            c = ev.get("event")
            if c in _CLASSES:
                return c
    return None


def bisect_poison(members: list, run_gang: Callable[[list], list]
                  ) -> tuple:
    """Run ``run_gang`` over the whole gang; when the call fails (raises,
    or returns one failure dict instead of a list aligned with its
    members), split the gang in half and run each half again, down to the
    member(s) that provoke the failure. A classified failure of two or
    more members is split; a failure of one member, or one with no
    class, is that span's result, and its members are the poison.

    Members are independent searches, so a half re-run answers what the
    whole gang would have. Returns ``(results, poison_indices,
    bisections)`` with ``results`` aligned to ``members``."""
    results: list = [None] * len(members)
    poison: list = []
    bisections = 0

    def fail_dict(exc: BaseException) -> Dict[str, Any]:
        return {"valid": UNKNOWN,
                "error": f"{type(exc).__name__}: {exc}",
                "error-class": classify_failure(exc)}

    def go(span: list) -> None:
        nonlocal bisections
        try:
            out = run_gang([members[i] for i in span])
        except Exception as e:  # noqa: BLE001 -- the gang call failed
            out = fail_dict(e)
        if isinstance(out, list):
            for i, r in zip(span, out):
                results[i] = r
            return
        if len(span) > 1 and result_failure_class(out) is not None:
            bisections += 1
            mid = (len(span) + 1) // 2
            go(span[:mid])
            go(span[mid:])
            return
        for i in span:
            results[i] = dict(out)
            poison.append(i)

    go(list(range(len(members))))
    return results, poison, bisections


def timeout_result(levels: int, rung: tuple) -> Dict[str, Any]:
    """The serve daemon's timeout shape for a search stopped at its
    deadline (never summarised: its pool is not a refutation)."""
    return {"valid": UNKNOWN, "error": ":info/timeout",
            "error-class": WEDGE, "backend": "gpu", "levels": int(levels),
            "rung": rung}


# ---------------------------------------------------------------------------
# The segment loop
# ---------------------------------------------------------------------------


def supervised_check_packed(p: PackedHistory, kernel: KernelSpec,
                            capacity: Optional[int] = None,
                            window: Optional[int] = None,
                            expand: Optional[int] = None,
                            segment_iters: Optional[int] = None,
                            device: Optional[torch.device] = None,
                            ops: G.Ops = G.KERNELS,
                            deadline: Optional[float] = None
                            ) -> Dict[str, Any]:
    """Check one packed history rung by rung, in growing segments
    (see :func:`jepsen_tpu_torch.checker.gpu.check_packed_gpu`).
    ``ops=gpu.PLAIN`` runs the kernels' plain versions instead, on any
    device: the reference a run on the card is held against.
    ``deadline`` is a ``time.monotonic()`` instant: at the first segment
    barrier past it the search stops and returns
    :func:`timeout_result`."""
    dev = G.resolve_device(device)
    if window is not None:
        G._check_window(window)
    cols_np, early = G._prep_single(p, kernel)
    if early is not None:
        return early
    if capacity is not None:
        G._check_window(window or G.WINDOW)
        ladder = ((capacity, window or G.WINDOW, expand),)
    else:
        ladder = G._ladder_for(G._window_needed(p), dev)
    crw = G._crash_width(p.n - p.n_required) or 0
    n, cr_pad = cols_np["f"].shape[0], cols_np["cf"].shape[0]
    nr = int(cols_np["nr"])
    lmax = G._level_budget(n, cr_pad)
    seg, first = G._segment_schedule(segment_iters, lmax)
    eng = default_engine()
    work: list = []
    out: Dict[str, Any] = {}
    with eng.lock:
        cols = eng.cols(cols_np, dev)
        for cap, win, exp in ladder:
            shape = LevelShape(C=cap, W=win, E=min(exp or cap, cap), n=n,
                               CR=cr_pad, model=kernel.name)
            carry, scratch = eng.state(shape, dev)
            host = G._carry0_host(cap, win, cr_pad, cols_np["ini"], nr,
                                  stats_rows=lmax + 1)
            interop.carry_from_numpy(host, dev, out=carry)
            scratch.acc.zero_()
            late = []

            def barrier(act: torch.Tensor) -> bool:
                go = bool(act.any())
                if go and time.monotonic() >= deadline:
                    late.append(True)
                    return False
                return go

            segs = G.run_batch(cols, carry, scratch, shape, seg, ops, first,
                               barrier=None if deadline is None else barrier)
            if late:
                return timeout_result(int(carry.scal[0, K.LEVEL]),
                                      (cap, win, exp))
            host = interop.carry_to_numpy(carry)
            done, lossy, wovf, best, levels, pool = G._summarize_carry(host)
            out = G._result(done, lossy, wovf, best, levels, p, pool=pool)
            out["rung"] = (cap, win, exp)
            out["best-k"] = best
            out["crash-width"] = crw
            out["tiebreak"] = "lex"
            work.append(((cap, win, exp), crw, "lex", levels))
            out["work"] = list(work)
            out["segments"] = len(segs)
            out["segment-iters"] = seg
            out["searchstats"] = dict(zip(
                G.SEARCHSTAT_COLS,
                (int(x) for x in np.asarray(host[13])[:levels].sum(0))))
            if out["valid"] is not UNKNOWN:
                return out
            if wovf and win >= G.MAX_WINDOW and not lossy:
                return out  # a bigger pool won't fix a window overflow
    return out
