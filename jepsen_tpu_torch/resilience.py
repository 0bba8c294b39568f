"""The failure taxonomy, poison bisection, retry policy, checkpoints, and
the segment supervisor of the single-history search.

Counterpart of ``jepsen_tpu/resilience.py``'s failure classes
(``classify_failure``, ``result_failure_class``), its gang bisection
``bisect_poison``, its ``RetryPolicy``, ``retry_until_deadline`` and
``deadline_stop``, its ``Checkpoint`` (the same ``.npz`` layout: a
checkpoint written by either package loads in the other), the OOM shrink
``_shrink_carry`` and the stats-lane fits, and ``supervised_check_packed``
with ``supervised_check_history``.

Each rung runs in segments of levels that grow from 64 up to
``segment_iters``. On the card a segment is one launch of a CUDA graph
(:func:`jepsen_tpu_torch.checker.gpu.run_segment`): the carry stays on
the device and the fifth kernel tests ``active`` there after each level
pair, so the host reads the search once per segment, at its end. That
segment end is where the supervisor works: a fault-injection seam before
each segment, a checkpoint copied to the host where one is asked for (a
path, a callback, or an explicit ``policy``: the plain call copies
nothing more), transient failures retried after the policy's backoff, an
OOM answered by halving the pool and resuming the rung's last checkpoint
in the smaller shape, and fatal failures rethrown with the trail.
Verdicts and level counts equal an unsegmented run's, because an
inactive level changes nothing.

A ``deadline`` is cooperative: it is tested at each segment barrier, and
once it has passed the search stops there, releases the engine's lock and
returns the serve daemon's timeout shape. (The reference's daemon
abandons a late check's thread, which holds no lock across its device
calls; this search holds :attr:`Engine.lock` for its whole ladder, so an
abandoned search must stop by itself.)

Before any device state is allocated the plan gate
(:mod:`jepsen_tpu_torch.checker.plan`) checks the ladder and seeds each
rung's pool from its footprint; at each barrier a device short of memory
halves the pool once per rung (the headroom pre-shrink,
:mod:`jepsen_tpu_torch.obs.devices`).

``deadline_s`` (``JTPU_SEGMENT_DEADLINE_S``) is the reference's segment
watchdog (:class:`SegmentWatchdog`): a segment that does not come back
in time is a wedge. The wedge is recorded for the process
(:mod:`jepsen_tpu_torch.accel`), the abandoned worker keeps the shape's
buffers (the engine never hands them out again) and the engine's lock is
released. The result is UNKNOWN with the wedge as its ``error`` and the
search's last segment end as its ``checkpoint``; a later check on CUDA
answers UNKNOWN at once. The port goes on nowhere by itself: a caller who
wants the answer resumes that checkpoint on the CPU,
``supervised_check_packed(p, kernel, device="cpu", resume=cp)``, where
the search runs its plain versions as it does on any CPU tensor.

The supervisor is instrumented as the reference's is: the OOM, wedge,
transient, backoff and pre-emptive-halving counters; a
``checker.segment`` span around each segment with its compile or execute
phase; the segment's host-timed seconds, levels, live rows and transfer
bytes in the device metrics (:mod:`jepsen_tpu_torch.checker.gpu`) and in
the result (``device-s``, ``segment-levels``, ``frontier-hwm``,
``transfer-bytes``, ``cost``); the stats lane's rows recorded at each
segment end (:mod:`jepsen_tpu_torch.obs.searchstats`, the result's
``searchstats`` rollup); the live observatory; and a ``torch.profiler``
capture around the whole search under ``JTPU_PROF=1``. With
``JTPU_TRACE=0`` the carry has no stats lane (13 slots, its checkpoint
too), K4 writes no counter row, and no span, artifact, ``searchstats`` or
``cost`` appears.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import queue
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from jepsen_tpu_torch import accel, interop, obs
from jepsen_tpu_torch.accel import WedgeError
from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.checker import plan as plan_mod
from jepsen_tpu_torch.checker.engine import default_engine
from jepsen_tpu_torch.kernels import cost as kcost
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.kernels.search import LevelShape
from jepsen_tpu_torch.models.core import KernelSpec, Model
from jepsen_tpu_torch.obs import devices as obs_devices
from jepsen_tpu_torch.obs import metrics as obs_metrics
from jepsen_tpu_torch.obs import observatory as obs_observatory
from jepsen_tpu_torch.obs import searchstats as obs_searchstats
from jepsen_tpu_torch.ops.encode import PackedHistory, pack_with_init

log = logging.getLogger("jepsen.resilience")

# the reference's supervisor counters (resilience.py:66-83); a DCN-class
# fault, retried like a transient one, counts as a transient retry here:
# one card has no interconnect of its own
_OOM_TOTAL = obs_metrics.counter(
    "jtpu_search_oom_total",
    "device OOMs answered by pool-halving during supervised searches")
_WEDGE_TOTAL = obs_metrics.counter(
    "jtpu_search_wedge_total",
    "device segments abandoned by the wedge watchdog")
_TRANSIENT_TOTAL = obs_metrics.counter(
    "jtpu_search_transient_retries_total",
    "transient device failures retried from their checkpoint")
_BACKOFF_SECONDS = obs_metrics.counter(
    "jtpu_search_backoff_seconds_total",
    "seconds slept in supervised-search retry backoff")
_PREEMPT_TOTAL = obs_metrics.counter(
    "jtpu_search_preemptive_halve_total",
    "pool halvings triggered by low device-memory headroom BEFORE any "
    "OOM fired (see JTPU_HEADROOM_MIN)")

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
# Retry policy
# ---------------------------------------------------------------------------


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        return default


@dataclass
class RetryPolicy:
    """Per-class retry behavior. Backoff is capped exponential:
    ``min(cap, base * 2**(attempt-1))``, jittered to [50%, 100%] so
    synchronized workers don't stampede a recovering endpoint.
    Base/cap default from JEPSEN_RETRY_BASE / JEPSEN_RETRY_CAP."""

    max_retries: int = 3
    backoff_base_s: float = field(
        default_factory=lambda: _env_float("JEPSEN_RETRY_BASE", 0.05))
    backoff_cap_s: float = field(
        default_factory=lambda: _env_float("JEPSEN_RETRY_CAP", 10.0))
    jitter: bool = True
    #: OOM shrink floor: a pool this small that still OOMs is hopeless.
    min_capacity: int = 8
    rng: random.Random = field(default_factory=random.Random, repr=False)

    def delay(self, attempt: int) -> float:
        d = min(self.backoff_cap_s,
                self.backoff_base_s * (2 ** max(attempt - 1, 0)))
        if self.jitter:
            d *= 0.5 + self.rng.random() / 2
        return d


def retry_until_deadline(fn: Callable[[], Any], deadline_s: float,
                         policy: Optional[RetryPolicy] = None
                         ) -> tuple:
    """Run ``fn`` until it returns truthy or ``deadline_s`` elapses,
    sleeping ``policy.delay(attempt)`` between attempts; exceptions count
    as failed attempts. Returns ``(ok, attempts, last_error)``, with
    ``last_error`` a short string, or None on success."""
    policy = policy or RetryPolicy()
    t_end = time.monotonic() + deadline_s
    attempts = 0
    last_err: Optional[str] = None
    while True:
        attempts += 1
        try:
            if fn():
                return True, attempts, None
            last_err = "probe returned falsy"
        except Exception as e:  # noqa: BLE001 -- a probe failure is data
            last_err = _errstr(e)
        remaining = t_end - time.monotonic()
        if remaining <= 0:
            return False, attempts, last_err
        time.sleep(min(policy.delay(attempts), remaining))


def deadline_stop(deadline_s: float,
                  inner: Optional[Callable[[], bool]] = None
                  ) -> Callable[[], bool]:
    """A ``should_stop`` predicate that fires ``deadline_s`` seconds from
    now (and whenever ``inner`` fires)."""
    t_end = time.monotonic() + deadline_s

    def stop() -> bool:
        if inner is not None and inner():
            return True
        return time.monotonic() > t_end

    return stop


def _errstr(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

#: Field names of the search carry in the reference's carry order: the
#: checkpoint format.
CARRY_FIELDS = ("k", "mask", "cmask", "state", "alive", "done", "lossy",
                "wovf", "level", "best", "pool_k", "pool_state",
                "pool_alive")

#: The optional 14th carry slot: the per-level counter log ([LMAX+1,
#: NSTAT] int32, level-indexed), carried while tracing is on. A
#: checkpoint without it loads, and the lane is added as zeros; with
#: tracing off it is dropped.
CARRY_STATS_FIELD = "slog"


@dataclass
class Checkpoint:
    """A host snapshot of the device search, sufficient to resume it on
    either package's search. ``rung`` is the REQUESTED ladder rung;
    ``expand_eff`` and the carry's own row count give the effective
    (possibly OOM-shrunk) shape. Serializes to one ``.npz`` file, in the
    reference's layout. ``watermark`` and ``n_required`` are the stream
    runner's (:mod:`jepsen_tpu_torch.stream`): the events and required ops
    of the stable prefix the carry has checked; -1 offline."""

    carry: tuple
    rung: tuple                      # (capacity, window, expand) requested
    window: int
    expand_eff: Optional[int]
    crash_width: int
    segment: int                     # segments completed so far
    watermark: int = -1
    n_required: int = -1

    @property
    def capacity_eff(self) -> int:
        return int(self.carry[0].shape[0])

    @property
    def level(self) -> int:
        return int(self.carry[8])

    def save(self, path: str) -> None:
        """Write the ``.npz`` through a temporary file and ``os.replace``,
        so that a crash mid-save leaves the previous checkpoint readable."""
        meta = dict(
            rung=np.asarray([-1 if x is None else x for x in self.rung],
                            np.int64),
            window=np.int64(self.window),
            expand_eff=np.int64(-1 if self.expand_eff is None
                                else self.expand_eff),
            crash_width=np.int64(self.crash_width),
            segment=np.int64(self.segment),
            watermark=np.int64(self.watermark),
            n_required=np.int64(self.n_required))
        names = CARRY_FIELDS + (CARRY_STATS_FIELD,)   # zip stops at 13
        arrays = {f"carry_{n}": np.asarray(v)
                  for n, v in zip(names, self.carry)}
        tmp = f"{path}.tmp.{os.getpid()}.npz"
        np.savez(tmp, **meta, **arrays)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "Checkpoint":
        with np.load(path) as z:
            rung = tuple(None if int(x) < 0 else int(x)
                         for x in z["rung"])
            exp = int(z["expand_eff"])
            carry = tuple(z[f"carry_{n}"] for n in CARRY_FIELDS)
            if f"carry_{CARRY_STATS_FIELD}" in z.files:
                carry = carry + (z[f"carry_{CARRY_STATS_FIELD}"],)
            # the flag and count slots come back as 0-d arrays
            carry = (carry[:5]
                     + (np.bool_(carry[5]), np.bool_(carry[6]),
                        np.bool_(carry[7]), np.int32(carry[8]),
                        np.int32(carry[9]))
                     + carry[10:])
            return cls(carry=carry, rung=rung, window=int(z["window"]),
                       expand_eff=None if exp < 0 else exp,
                       crash_width=int(z["crash_width"]),
                       segment=int(z["segment"]),
                       watermark=(int(z["watermark"])
                                  if "watermark" in z.files else -1),
                       n_required=(int(z["n_required"])
                                   if "n_required" in z.files else -1))


def _shrink_carry(carry: tuple, new_cap: int) -> tuple:
    """Re-embed a checkpoint into a smaller pool: keep the first
    ``new_cap`` rows (the pool is sorted deepest-first, so the prefix is
    the best frontier). Returns (carry, dropped): if any LIVE row fell
    off, the search is lossy from here on: a completion is still a
    witness, but pool death no longer refutes."""
    (k, mask, cmask, state, alive, done, lossy, wovf, level, best,
     pk, ps, pa) = carry[:13]
    dropped = bool(np.any(np.asarray(alive)[new_cap:]))
    lossy = np.bool_(bool(lossy) or dropped)
    # the stats lane is level-indexed: it rides through unchanged
    return ((np.asarray(k)[:new_cap], np.asarray(mask)[:new_cap],
             np.asarray(cmask)[:new_cap], np.asarray(state)[:new_cap],
             np.asarray(alive)[:new_cap], done, lossy, wovf, level, best,
             np.asarray(pk)[:new_cap], np.asarray(ps)[:new_cap],
             np.asarray(pa)[:new_cap]) + tuple(carry[13:]), dropped)


def _fit_carry_stats(carry: tuple, stats: bool, lmax: int) -> tuple:
    """Match a carry's optional stats lane to the search about to run
    it: a zero lane is appended to a 13-lane carry (the pre-resume levels
    then count nothing; the verdict lanes are untouched), and dropped
    when ``stats`` is off."""
    if stats and len(carry) == 13:
        return carry + (np.zeros((lmax + 1, G.NSTAT), np.int32),)
    if not stats and len(carry) > 13:
        return carry[:13]
    return carry


def _grow_carry_stats(carry: tuple, lmax: int) -> tuple:
    """Re-pad an existing stats lane to a larger level budget; the rows
    already counted ride through unchanged."""
    if len(carry) <= 13:
        return carry
    slog = np.asarray(carry[13])
    rows = lmax + 1
    if slog.shape[0] >= rows:
        return carry
    grown = np.zeros((rows, slog.shape[1]), np.int32)
    grown[:slog.shape[0]] = slog
    return carry[:13] + (grown,)


def _carry_active(carry: tuple, lmax: int) -> bool:
    """Host mirror of the device's ``active``: not done, some pool row
    alive, the level budget not spent."""
    done, alive, level = carry[5], carry[4], carry[8]
    return (not bool(done)) and bool(np.any(alive)) and int(level) <= lmax


# ---------------------------------------------------------------------------
# Segment execution and the watchdog
# ---------------------------------------------------------------------------

#: Fault-injection seam for the tests: a callable invoked with a context
#: dict ({rung, effective, segment, level, backend}) right before each
#: device segment; raising from it stands for that failure at that point.
#: None in production.
_inject_fault: Optional[Callable[[Dict[str, Any]], None]] = None

class SegmentWatchdog:
    """The segment watchdog of one search (the reference's
    ``_call_segment`` with its ``deadline_s``). :meth:`call` runs a
    segment's device work ``step(stop)``: without a deadline in the
    caller's thread; with one, in a daemon thread named
    ``jepsen-device-segment`` on the caller's device and CUDA stream,
    waited for up to the deadline. The thread is started at the first
    segment and serves the search's later ones (a thread a segment costs
    about 0.5 ms to start on a shared host). An overrun raises
    :class:`WedgeError`, whose ``worker`` is the thread: abandoned, never
    killed, its ``stop()`` true, so that it launches nothing more once it
    comes back, and it ends after that segment. A failure in the worker is
    raised here, for the supervisor to classify. A segment graph the
    worker captures is safe from the caller's CUDA calls: csrc/search.cu
    captures in the thread-local mode. :meth:`close` ends the thread."""

    def __init__(self, device: torch.device, deadline_s: Optional[float]):
        self.device, self.deadline_s = device, deadline_s
        self._stream = (torch.cuda.current_stream(device)
                        if deadline_s and device.type == "cuda" else None)
        self._jobs: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread: Optional[threading.Thread] = None

    def call(self, step: Callable[[Callable[[], bool]], Any]) -> Any:
        if not self.deadline_s:
            return step(lambda: False)
        if self._thread is None:
            self._thread = threading.Thread(target=self._serve, daemon=True,
                                            name="jepsen-device-segment")
            self._thread.start()
        box: Dict[str, Any] = {}
        done, abandoned = threading.Event(), threading.Event()
        self._jobs.put((step, box, done, abandoned.is_set))
        if not done.wait(self.deadline_s):
            abandoned.set()
            err = WedgeError(f"device segment exceeded its "
                             f"{self.deadline_s:.1f}s deadline")
            err.worker = self._thread
            self.close()
            raise err
        if "err" in box:
            raise box["err"]
        return box["ok"]

    def close(self) -> None:
        """The thread ends after the segment it is in, if any."""
        if self._thread is not None:
            self._jobs.put(None)
            self._thread = None

    def _serve(self) -> None:
        ctx = (contextlib.ExitStack() if self._stream is None
               else _on_stream(self.device, self._stream))
        with ctx:
            while True:
                job = self._jobs.get()
                if job is None:
                    return
                step, box, done, stop = job
                try:
                    box["ok"] = step(stop)
                except BaseException as e:  # noqa: BLE001 -- relayed
                    box["err"] = e
                done.set()


@contextlib.contextmanager
def _on_stream(device: torch.device, stream):
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


class SegmentEnd(NamedTuple):
    """What a segment end read: each key's ``active`` flag, level and
    live pool rows, the host carry (where asked for), and the CUDA
    launches one iteration of the segment graph makes (None on the host
    loop)."""

    act: list
    level: list
    nalive: list
    host: Optional[tuple]
    body: Optional[int]


def _device_segment(stop: Callable[[], bool], cols: dict,
                    cols_np: Optional[dict], carry: G.Carry,
                    scratch: G.Scratch, host: Optional[tuple],
                    shape: LevelShape, seg_len: int, ops: G.Ops,
                    keep: bool) -> Optional[SegmentEnd]:
    """One segment on a shape's buffers: the stacked columns ``cols_np``
    and the host carry ``host`` go up where given, the segment runs, and
    its end is read (with the whole carry where ``keep``). Returns its
    :class:`SegmentEnd`, or None when ``stop()`` turned true on the
    way."""
    dev = carry.scal.device
    if cols_np is not None:
        interop.batch_cols_from_numpy(cols_np, dev, out=cols)
    if host is not None:
        interop.carry_from_numpy(host, dev, out=carry)
        scratch.acc.zero_()
    if stop():
        return None
    words, graph = G.run_segment(cols, carry, scratch, shape, cols["nr"],
                                 seg_len, ops)
    _, act, lv, nalive = G.end_segment(carry, shape, words, graph)
    if stop():
        return None
    return SegmentEnd(act, lv, nalive,
                      interop.carry_to_numpy(carry) if keep else None,
                      None if graph is None else sum(graph.body.values()))


# ---------------------------------------------------------------------------
# The segment supervisor
# ---------------------------------------------------------------------------


def supervised_check_packed(p: PackedHistory, kernel: KernelSpec,
                            **kwargs) -> Dict[str, Any]:
    """Check one packed history rung by rung, in growing segments
    (see :func:`jepsen_tpu_torch.checker.gpu.check_packed_gpu`).
    Keyword arguments: ``capacity``, ``window``, ``expand``,
    ``segment_iters``, ``device``, ``ops``, ``deadline``, ``policy``,
    ``resume``, ``checkpoint_path``, ``on_checkpoint``, ``deadline_s``.
    ``ops=gpu.PLAIN`` runs the kernels' plain versions instead, on any
    device: the reference a run on the card is held against.
    ``deadline`` is a ``time.monotonic()`` instant: at the first segment
    barrier past it the search stops and returns
    :func:`timeout_result`.

    As the reference's: ``resume`` continues a saved :class:`Checkpoint`
    of the same packed history (from either package); ``checkpoint_path``
    and ``on_checkpoint`` save and observe a checkpoint at each segment
    end; ``policy`` (default :class:`RetryPolicy`) sets the retries, the
    backoff and the OOM floor. The plan gate
    (:func:`jepsen_tpu_torch.checker.plan.gate_ladder`) runs before any
    device state is allocated: an explicit rung that cannot run raises
    ``PlanRejectedError``, a rung whose pool does not fit the byte budget
    starts smaller (a ``plan-seeded-pool-N`` event), and the result
    carries the ``plan`` entry. At each segment barrier a device headroom
    below ``JTPU_HEADROOM_MIN`` halves the pool once per rung
    (``preemptive-halve-to-N``).

    ``deadline_s`` (``JTPU_SEGMENT_DEADLINE_S`` when None; unset or 0: no
    watchdog) runs each segment in a watchdog thread
    (:class:`SegmentWatchdog`). A segment past it is a wedge: recorded for
    the process (:mod:`jepsen_tpu_torch.accel`), its buffers left to the
    abandoned worker and the engine's lock released. The result is then
    UNKNOWN, with the wedge as its ``error`` and the last host
    :class:`Checkpoint` as its ``checkpoint``, which ``resume=`` continues
    on ``device="cpu"``. A later check on CUDA in the process answers
    UNKNOWN at once; one on the CPU runs.

    A checkpoint comes to the host at a segment end only where a path, a
    callback, an explicit ``policy`` or a watchdog asks for it; otherwise
    an OOM resumes from the rung's start (or its resumed checkpoint), and
    so does a wedge's ``checkpoint``. The result carries ``attempts``, the
    supervision trail; a fatal failure is raised with the trail as
    ``exc.resilience_trail``.

    The result also carries the reference's telemetry: ``device-s`` (the
    host-timed seconds of first calls, ``compile``, and of the others,
    ``execute``), ``segment-levels``, ``frontier-hwm`` and
    ``transfer-bytes`` (what this search copied between host and card);
    with tracing on, ``searchstats`` (the stats lane's rollup) and
    ``cost`` (one entry per shape: one level's work from
    :mod:`jepsen_tpu_torch.kernels.cost`, and the levels it ran). The
    observatory publishes each segment end, and ``JTPU_PROF=1`` captures
    the search with ``torch.profiler``."""
    dev = kwargs.get("device")
    try:
        with obs.profiler.capture(
                cuda=torch.device("cuda" if dev is None else dev).type
                == "cuda"):
            out = _supervised_check_packed(p, kernel, **kwargs)
    except BaseException:
        # a raised search must not leave the observatory "searching"
        obs_observatory.finish(valid="error")
        raise
    obs_observatory.finish(valid=out.get("valid"), levels=out.get("levels"))
    return out


def _supervised_check_packed(p: PackedHistory, kernel: KernelSpec,
                             capacity: Optional[int] = None,
                             window: Optional[int] = None,
                             expand: Optional[int] = None,
                             segment_iters: Optional[int] = None,
                             device: Optional[torch.device] = None,
                             ops: G.Ops = G.KERNELS,
                             deadline: Optional[float] = None,
                             policy: Optional[RetryPolicy] = None,
                             resume: Optional[Checkpoint] = None,
                             checkpoint_path: Optional[str] = None,
                             on_checkpoint: Optional[
                                 Callable[[Checkpoint], None]] = None,
                             deadline_s: Optional[float] = None
                             ) -> Dict[str, Any]:
    # a CUDA device that wedged earlier in the process is not fed again
    if accel.runtime_wedged("cuda" if device is None else device):
        return _wedged_earlier()
    dev = G.resolve_device(device)
    if window is not None:
        G._check_window(window)
    cols_np, early = G._prep_single(p, kernel)
    if early is not None:
        return early
    if deadline_s is None:
        deadline_s = _env_float("JTPU_SEGMENT_DEADLINE_S", 0.0) or None
    keep = bool(checkpoint_path or on_checkpoint is not None
                or policy is not None or deadline_s)
    policy = policy or RetryPolicy()
    eng = default_engine()
    eng.lock.acquire()
    held = True
    if accel.runtime_wedged(dev):
        # the device wedged while this check waited for the lock
        eng.lock.release()
        return _wedged_earlier()
    trail: list = []
    work: list = []
    out: Dict[str, Any] = {}
    watchdog: Optional[SegmentWatchdog] = None
    try:
        # the CUDA-init probe (once a process), before anything touches
        # the card; it raises rather than move the search to the CPU
        accel.ensure_usable("supervised_check_packed", device=dev)
        wneed = G._window_needed(p)
        if capacity is not None:
            G._check_window(window or G.WINDOW)
            ladder = ((capacity, window or G.WINDOW, expand),)
        else:
            ladder = G._ladder_for(wneed, dev)
        plan_entry = None
        if plan_mod.gate_enabled():
            ladder, plan_entry = plan_mod.gate_ladder(
                plan_mod.PlanDims.from_packed(p, wneed), kernel, ladder,
                kind="segment", explicit=capacity is not None,
                derate=capacity is None,
                where="the supervised device search", device=dev)
        if resume is not None:
            idx = next((i for i, r in enumerate(ladder)
                        if tuple(r) == tuple(resume.rung)), None)
            ladder = ((tuple(resume.rung),) + tuple(ladder) if idx is None
                      else ladder[idx:])
        crw = G._crash_width(p.n - p.n_required) or 0
        n, cr_pad = cols_np["f"].shape[0], cols_np["cf"].shape[0]
        nr = int(cols_np["nr"])
        lmax = G._level_budget(n, cr_pad)
        seg, first = G._segment_schedule(segment_iters, lmax)
        hr_min = obs_devices.headroom_threshold()
        stacked = interop.stack_cols([cols_np])
        # telemetry (the reference's resilience.py:600-640): the stats lane
        # and everything below ride with tracing
        stats = obs.enabled()
        device_s = {"compile": 0.0, "execute": 0.0}
        seg_levels: list = []
        frontier_hwm = 0
        transfer_bytes = 0
        cost_entries: Dict[tuple, Dict[str, Any]] = {}
        watchdog = SegmentWatchdog(dev, deadline_s)
        # filled by the first segment, under the watchdog
        cols = eng.batch_cols(stacked, dev, copy=False)
        cols_up = False
        for cap, win, exp in ladder:
            if resume is not None and tuple(resume.rung) == (cap, win, exp):
                host = tuple(resume.carry)
                cap_eff, exp_eff = resume.capacity_eff, resume.expand_eff
                seg_idx = resume.segment
                resume = None
            else:
                cap_eff, exp_eff, seg_idx = cap, exp, 0
                if plan_entry is not None:
                    cap_s, exp_s, pred, blim = plan_mod.seed_rung(
                        cap, win, exp, breq=n, crw=cr_pad,
                        floor=policy.min_capacity, device=dev)
                    if cap_s != cap_eff:
                        trail.append({"rung": (cap, win, exp),
                                      "effective": (cap_s, win, exp_s),
                                      "segment": 0, "level": 0,
                                      "event": "plan",
                                      "outcome": f"plan-seeded-pool-{cap_s}",
                                      "predicted-bytes": pred,
                                      "bytes-limit": blim})
                        log.warning(
                            "predicted footprint at %s rows exceeds the %s B "
                            "byte budget; seeding the pool at %s rows "
                            "(predicted %s B)", cap, blim, cap_s, pred)
                        cap_eff, exp_eff = cap_s, exp_s
                host = G._carry0_host(cap_eff, win, cr_pad, cols_np["ini"],
                                      nr, stats_rows=(lmax + 1) if stats
                                      else 0)
            # the rung's last checkpoint: where a failed segment resumes
            host = _fit_carry_stats(host, stats, lmax)
            if stats:
                host = _grow_carry_stats(host, lmax)
            # the stats lane's rows on the host, filled at segment ends
            slog = np.array(host[13]) if stats else None
            saved_idx = seg_idx
            level, live = int(host[8]), _carry_active(host, lmax)
            carry = shape = None
            transients = ooms = 0
            preempted = False
            abort: Optional[str] = None
            wedge_cp: Optional[Checkpoint] = None
            obs_observatory.begin(level_budget=lmax,
                                  rung=(cap_eff, win, exp_eff),
                                  segment_iters=seg, backend="default")
            while live:
                # a device short of memory halves the pool before the
                # allocator fails; once per rung, since freed pages stay
                # cached and the headroom would not come back
                headroom = obs_devices.headroom_ratio(device=dev)
                if (headroom is not None and hr_min > 0 and not preempted
                        and headroom < hr_min
                        and cap_eff // 2 >= policy.min_capacity):
                    if carry is not None:
                        host = interop.carry_to_numpy(carry)
                        saved_idx = seg_idx
                    host, dropped = _shrink_carry(host, cap_eff // 2)
                    cap_eff //= 2
                    if isinstance(exp_eff, int):
                        exp_eff = max(1, min(exp_eff // 2, cap_eff))
                    carry, preempted = None, True
                    _PREEMPT_TOTAL.inc()
                    trail.append({"rung": (cap, win, exp),
                                  "effective": (cap_eff, win, exp_eff),
                                  "segment": seg_idx, "level": int(host[8]),
                                  "event": OOM,
                                  "outcome": f"preemptive-halve-to-{cap_eff}",
                                  "headroom": round(headroom, 4),
                                  "lossy": dropped})
                    log.warning(
                        "device headroom %.1f%% below the %.1f%% floor; "
                        "pre-emptively halving the pool to %s rows",
                        100 * headroom, 100 * hr_min, cap_eff)
                # the schedule of an unbroken run: a resumed search ends
                # its segments on the same levels
                seg_len = min(seg, first << min(seg_idx, 16))
                ctx = {"rung": (cap, win, exp),
                       "effective": (cap_eff, win, exp_eff),
                       "segment": seg_idx, "level": level,
                       "backend": "default"}
                shape_key = ("segment", kernel.name, cap_eff, win, exp_eff,
                             n, cr_pad, stats)
                # decided up front, marked run only on success: a segment
                # that dies in its first call pays it again on the retry
                phase = G.call_phase(shape_key)
                lvl0 = level
                try:
                    if _inject_fault is not None:
                        _inject_fault(dict(ctx))
                    with obs.span("checker.segment", phase=phase,
                                  segment=seg_idx, level=lvl0,
                                  rung=[cap_eff, win, exp_eff],
                                  backend=ctx["backend"]) as sp:
                        t0 = time.perf_counter()
                        upload = None
                        if carry is None:
                            shape = LevelShape(C=cap_eff, W=win,
                                               E=min(exp_eff or cap_eff,
                                                     cap_eff),
                                               n=n, CR=cr_pad,
                                               model=kernel.name)
                            carry, scratch = eng.state(shape, dev, stats)
                            upload = host
                        step = functools.partial(
                            _device_segment, cols=cols,
                            cols_np=None if cols_up else stacked,
                            carry=carry, scratch=scratch, host=upload,
                            shape=shape, seg_len=seg_len, ops=ops,
                            keep=keep)
                        end = watchdog.call(step)
                        seg_s = time.perf_counter() - t0
                        sp.set(level_end=end.level[0])
                        if end.body is not None:
                            sp.set(body=end.body)
                    moved_up = ((0 if cols_up else G.cols_nbytes(stacked))
                                + (0 if upload is None
                                   else _carry_nbytes(upload)))
                    cols_up = True
                except WedgeError as e:
                    _WEDGE_TOTAL.inc()
                    accel.note_runtime_wedge(
                        "supervised_check_packed", deadline_s or 0.0,
                        device=dev, worker=getattr(e, "worker", None),
                        level=ctx["level"])
                    # the abandoned worker keeps this state; the engine
                    # never hands it out again, and its lock is free
                    eng.abandon(shape, dev, cols)
                    eng.lock.release()
                    held = False
                    carry, seg_idx = None, saved_idx
                    level = int(host[8])
                    trail.append({**ctx, "event": WEDGE,
                                  "outcome": "gave-up", "error": _errstr(e)})
                    abort = f"device segment wedged: {e}"
                    wedge_cp = Checkpoint(carry=host, rung=(cap, win, exp),
                                          window=win, expand_eff=exp_eff,
                                          crash_width=crw, segment=seg_idx)
                    break
                except Exception as e:  # noqa: BLE001 -- classified below
                    cls = classify_failure(e)
                    # resume from the last checkpoint, in a new upload
                    carry, seg_idx = None, saved_idx
                    level = int(host[8])
                    if cls == OOM:
                        ooms += 1
                        _OOM_TOTAL.inc()
                        new_cap = cap_eff // 2
                        if new_cap < policy.min_capacity:
                            trail.append({**ctx, "event": OOM,
                                          "outcome": "gave-up",
                                          "error": _errstr(e)})
                            abort = (f"OOM at the {policy.min_capacity}-"
                                     f"row pool floor: {e}")
                            break
                        host, dropped = _shrink_carry(host, new_cap)
                        cap_eff = new_cap
                        if isinstance(exp_eff, int):
                            exp_eff = max(1, min(exp_eff // 2, cap_eff))
                        delay = policy.delay(ooms)
                        trail.append({**ctx, "event": OOM,
                                      "outcome": f"pool-halved-to-{cap_eff}",
                                      "lossy": dropped,
                                      "backoff-s": round(delay, 3),
                                      "error": _errstr(e)})
                        log.warning(
                            "device OOM at level %s; halving the pool to %s "
                            "rows and resuming the checkpoint (backoff "
                            "%.2fs)", ctx["level"], cap_eff, delay)
                        _BACKOFF_SECONDS.inc(delay)
                        time.sleep(delay)
                    elif cls in (TRANSIENT, DCN):
                        transients += 1
                        _TRANSIENT_TOTAL.inc()
                        if transients > policy.max_retries:
                            trail.append({**ctx, "event": cls,
                                          "outcome": "retries-exhausted",
                                          "error": _errstr(e)})
                            _attach_trail(e, trail)
                            raise
                        delay = policy.delay(transients)
                        trail.append({**ctx, "event": cls,
                                      "outcome": f"retry-{transients}",
                                      "backoff-s": round(delay, 3),
                                      "error": _errstr(e)})
                        log.warning(
                            "%s device failure (%s); retrying the segment "
                            "from its checkpoint in %.2fs", cls,
                            _errstr(e), delay)
                        _BACKOFF_SECONDS.inc(delay)
                        time.sleep(delay)
                    else:
                        trail.append({**ctx, "event": FATAL,
                                      "outcome": "raised",
                                      "error": _errstr(e)})
                        _attach_trail(e, trail)
                        raise
                    continue
                seg_idx += 1
                transients = 0
                level, live = end.level[0], bool(end.act[0])
                # success: account the segment (the reference's
                # resilience.py:875-914); the stats rows and the cost
                # model ride with tracing
                rung_eff = (cap_eff, win, exp_eff)
                G.mark_executed(shape_key)
                device_s[phase] += seg_s
                G.note_call_phase("segment", phase, seg_s)
                seg_levels.append(level - lvl0)
                alive = end.nalive[0]
                frontier_hwm = max(frontier_hwm, alive)
                G._LEVELS_TOTAL.inc(level - lvl0)
                G._SEGMENTS_TOTAL.inc()
                G._FRONTIER_HWM.set_max(alive)
                moved_down = 4 * (1 + 3 * shape.B) + (
                    0 if end.host is None else _carry_nbytes(end.host))
                dup_rate = trunc = None
                if stats:
                    # the stats rows this segment wrote come down with
                    # the segment end; the rest of the lane stays put
                    rows = carry.stats[0, lvl0:level].cpu().numpy()
                    slog[lvl0:level] = rows
                    moved_down += rows.nbytes
                    ent = cost_entries.get(shape_key)
                    if ent is None:
                        ent = cost_entries[shape_key] = kcost.cost_entry(
                            "segment", rung_eff, shape, 0)
                    ent["levels"] += level - lvl0
                    obs_searchstats.record(slog[:level], rung=rung_eff)
                    if rows.size:
                        dup_rate = obs_searchstats.dup_rate(rows)
                        trunc = int(rows[:, 3].sum())
                G._TRANSFER_BYTES.inc(moved_up, direction="host-to-device")
                G._TRANSFER_BYTES.inc(moved_down, direction="device-to-host")
                transfer_bytes += moved_up + moved_down
                obs_observatory.publish(
                    level=level, frontier=alive, segments=seg_idx,
                    seg_seconds=seg_s, levels_delta=level - lvl0,
                    expansions=(level - lvl0) * shape.E, rung=rung_eff,
                    backend=ctx["backend"], headroom=headroom,
                    warmup=phase == "compile", dup_rate=dup_rate,
                    trunc=trunc)
                if keep:
                    host, saved_idx = end.host, seg_idx
                    cp = Checkpoint(carry=host, rung=(cap, win, exp),
                                    window=win, expand_eff=exp_eff,
                                    crash_width=crw, segment=seg_idx)
                    if checkpoint_path:
                        cp.save(checkpoint_path)
                    if on_checkpoint is not None:
                        on_checkpoint(cp)
                if live and deadline is not None and (
                        time.monotonic() >= deadline):
                    return timeout_result(level, (cap, win, exp))
            if carry is not None:
                host = interop.carry_to_numpy(carry)
                nb = _carry_nbytes(host)
                G._TRANSFER_BYTES.inc(nb, direction="device-to-host")
                transfer_bytes += nb
            done, lossy, wovf, best, levels, pool = G._summarize_carry(host)
            rung_eff = (cap_eff, win, exp_eff)
            trail.append({"rung": (cap, win, exp), "effective": rung_eff,
                          "event": ("rung-aborted" if abort is not None
                                    else "rung-complete"),
                          "segments": seg_idx, "levels": levels,
                          "backend": "default"})
            if abort is not None:
                out = {"valid": UNKNOWN, "backend": "gpu", "levels": levels,
                       "error": abort}
                if wedge_cp is not None:
                    out["checkpoint"] = wedge_cp
            else:
                out = G._result(done, lossy, wovf, best, levels, p,
                                pool=pool)
            out["rung"] = rung_eff
            if rung_eff != (cap, win, exp):
                out["rung-requested"] = (cap, win, exp)
            out["best-k"] = best
            out["crash-width"] = crw
            out["tiebreak"] = "lex"
            work.append((rung_eff, crw, "lex", levels))
            out["work"] = list(work)
            if plan_entry is not None:
                out["plan"] = plan_entry
            out["segments"] = seg_idx
            out["segment-iters"] = seg
            out["attempts"] = list(trail)
            out["device-s"] = {k: round(v, 6) for k, v in device_s.items()}
            out["segment-levels"] = list(seg_levels)
            out["frontier-hwm"] = frontier_hwm
            out["transfer-bytes"] = transfer_bytes
            if stats:
                ss = obs_searchstats.rollup(np.asarray(host[13])[:levels])
                out["searchstats"] = ss
                obs_searchstats.finalize(ss)
                if cost_entries:
                    out["cost"] = [dict(e) for e in cost_entries.values()]
            if out["valid"] is not UNKNOWN or abort is not None:
                return out
            if wovf and win >= G.MAX_WINDOW and not lossy:
                return out  # a bigger pool won't fix a window overflow
    finally:
        if watchdog is not None:
            watchdog.close()
        if held:
            eng.lock.release()
    return out


def _wedged_earlier() -> Dict[str, Any]:
    """The result of a check on CUDA after a CUDA segment wedged in this
    process: it never touches the card."""
    error = ("a device segment wedged earlier in this process; CUDA "
             "takes no more searches (device='cpu' does)")
    return {"valid": UNKNOWN, "backend": "gpu", "error": error,
            "attempts": [{"event": WEDGE, "outcome": "gave-up",
                          "error": error}]}


def _carry_nbytes(carry: tuple) -> int:
    return int(sum(np.asarray(x).nbytes for x in carry))


def _attach_trail(e: BaseException, trail: list) -> None:
    try:
        e.resilience_trail = trail
    except Exception:  # noqa: BLE001 -- some exceptions take no attributes
        pass


def supervised_check_history(history, model: Model,
                             **kwargs) -> Optional[Dict[str, Any]]:
    """Pack and run :func:`supervised_check_packed`. None when the model
    has no integer kernel, or the history does not fit its word."""
    try:
        pk = pack_with_init(history, model)
    except ValueError:
        return None
    if pk is None:
        return None
    packed, kernel = pk
    return supervised_check_packed(packed, kernel, **kwargs)
