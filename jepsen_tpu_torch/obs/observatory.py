"""Search observatory: live progress of the in-flight device search.

A copy of the reference's ``jepsen_tpu/obs/observatory.py``: the same
gauges and ``progress.json``. The port publishes after each segment
end (one CUDA graph launch).

The span tracer makes runs *post-hoc* legible; a multi-minute segmented
search would still be a black box while it ran, nothing to see between
``checker.segment`` spans. The segmented supervisor
(:mod:`jepsen_tpu_torch.resilience`) already returns to the host after every
bounded device segment, which is exactly a progress heartbeat: this
module is the publication side of that heartbeat.

After each segment end the supervisor calls
:func:`publish` with the carry's level, the live frontier width, the
segment wall time and the effective rung. The observatory

* updates live gauges (``jtpu_search_level`` / ``_frontier_rows`` /
  ``_segments_done`` / ``_levels_per_s`` / ``_configs_per_s`` /
  ``_eta_seconds``) alongside the tracer's cumulative counters,
* maintains a **levels/s EWMA** and derives an ETA against the level
  budget (an upper bound — a witness can complete the search early),
* mirrors the whole snapshot to ``progress.json`` in the run's store
  directory (plain tmp+replace writes, throttled), which other
  processes read (:func:`read_progress`; the reference's ``watch`` CLI
  and ``/live`` endpoint, not ported yet).

Kill switch: with ``JTPU_TRACE=0`` no ``progress.json`` is ever
written (artifacts stay byte-identical to the pre-observability tree);
the in-memory snapshot still updates either way.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

from jepsen_tpu_torch.obs import metrics as obs_metrics
from jepsen_tpu_torch.obs import trace as obs_trace

#: The live-progress artifact's filename inside a run's store directory.
PROGRESS_NAME = "progress.json"

#: EWMA smoothing for the levels/s rate (per published segment).
EWMA_ALPHA = 0.3

#: Min seconds between progress.json rewrites (terminal publishes and
#: state transitions always write).
WRITE_INTERVAL_S = 0.1

_LEVEL = obs_metrics.gauge(
    "jtpu_search_level",
    "current level of the in-flight supervised search")
_LEVEL_BUDGET = obs_metrics.gauge(
    "jtpu_search_level_budget",
    "iteration budget of the in-flight supervised search")
_FRONTIER_ROWS = obs_metrics.gauge(
    "jtpu_search_frontier_rows",
    "live pool rows at the last segment boundary")
_SEGMENTS_DONE = obs_metrics.gauge(
    "jtpu_search_segments_done",
    "segments completed by the in-flight supervised search (this rung)")
_LEVELS_PER_S = obs_metrics.gauge(
    "jtpu_search_levels_per_s",
    "EWMA of search levels advanced per second")
_CONFIGS_PER_S = obs_metrics.gauge(
    "jtpu_search_configs_per_s",
    "EWMA of candidate configurations explored per second")
_ETA = obs_metrics.gauge(
    "jtpu_search_eta_seconds",
    "level-budget ETA of the in-flight search from the levels/s EWMA "
    "(an upper bound: a witness completes the search early)")
_INFLIGHT = obs_metrics.gauge(
    "jtpu_search_inflight", "1 while a supervised search is running")


class Observatory:
    """Thread-safe single-slot live view of the current supervised
    search (one device search runs at a time per process — the keyed
    batch path is a single device call and publishes nothing)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._progress: Optional[Dict[str, Any]] = None
        self._path: Optional[str] = None
        self._rate: Optional[float] = None
        self._exp_rate: Optional[float] = None
        self._last_write = 0.0
        self._seq = 0

    # -- sink lifecycle -----------------------------------------------------

    def attach(self, store_dir: Optional[str]) -> None:
        """Point progress.json at a run's store directory (no file is
        written until the first publish). No-op when dir-less or
        disabled."""
        with self._lock:
            self._path = (os.path.join(store_dir, PROGRESS_NAME)
                          if store_dir and obs_trace.enabled() else None)

    def detach(self) -> None:
        with self._lock:
            self._path = None

    # -- publication --------------------------------------------------------

    def begin(self, *, level_budget: int, rung, segment_iters: int,
              backend: str = "default") -> None:
        """Mark a supervised search (rung) in flight; resets the rate
        EWMA — a new rung's per-segment cost is unrelated to the last
        one's."""
        with self._lock:
            self._rate = self._exp_rate = None
            self._progress = {
                "state": "searching", "ts": time.time(),
                "level": 0, "level-budget": int(level_budget),
                "frontier-rows": None, "segments": 0,
                "segments-est": (-(-int(level_budget) // segment_iters)
                                 if segment_iters else None),
                "segment-iters": int(segment_iters),
                "rung": list(rung), "backend": backend,
                "levels-per-s": None, "configs-per-s": None,
                "eta-s": None, "headroom": None,
            }
            self._seq += 1
        _INFLIGHT.set(1)
        _LEVEL_BUDGET.set(level_budget)

    def publish(self, *, level: int, frontier: int, segments: int,
                seg_seconds: float, levels_delta: int, expansions: int,
                rung=None, backend: Optional[str] = None,
                headroom: Optional[float] = None,
                warmup: bool = False,
                imbalance: Optional[float] = None,
                fleet: Optional[Dict[str, Any]] = None,
                dup_rate: Optional[float] = None,
                trunc: Optional[int] = None) -> None:
        """One segment boundary's worth of progress. ``expansions`` is
        the candidate configurations explored this segment (levels x
        expanded rows) — the configs-explored/s numerator. ``warmup``
        marks a segment whose wall time included the shape's first call
        (the kernel library's load and the graph capture): its
        level/ETA still publish, but it is excluded from the rate EWMA
        (a compile-inflated denominator would poison the ETA for many
        segments of smoothing). ``imbalance`` is the live
        jtpu_shard_imbalance_ratio (max/mean live rows per shard) so
        skew is visible DURING a sharded/fleet run, not only on bench's
        ``# search:`` line; ``fleet`` is the elastic-fleet heartbeat
        ({hosts, remeshes, steals} — the reference's fleet piggybacks its
        per-round state on this publication, which is exactly what the
        fleet supervisor's host-loss detection reads back).
        ``dup_rate``/``trunc`` are this segment's search-analytics bits
        (jepsen_tpu_torch.obs.searchstats): the duplicate-kill fraction of
        the sorted candidate rows and the unique rows lost to pool
        truncation — so pruning health and lossiness are visible in the
        `watch` ticker while the search runs."""
        if warmup:
            inst = einst = None
        else:
            inst = (levels_delta / seg_seconds) if seg_seconds > 0 \
                else None
            einst = (expansions / seg_seconds) if seg_seconds > 0 \
                else None
        with self._lock:
            p = self._progress
            if p is None:
                return
            if inst is not None:
                self._rate = (inst if self._rate is None else
                              EWMA_ALPHA * inst
                              + (1 - EWMA_ALPHA) * self._rate)
            if einst is not None:
                self._exp_rate = (einst if self._exp_rate is None else
                                  EWMA_ALPHA * einst
                                  + (1 - EWMA_ALPHA) * self._exp_rate)
            p["ts"] = time.time()
            p["level"] = int(level)
            p["frontier-rows"] = int(frontier)
            p["segments"] = int(segments)
            if rung is not None:
                p["rung"] = [None if x is None else int(x) for x in rung]
            if backend is not None:
                p["backend"] = backend
            if headroom is not None:
                p["headroom"] = round(float(headroom), 4)
            if imbalance is not None:
                p["imbalance"] = round(float(imbalance), 3)
            if dup_rate is not None:
                p["dup-rate"] = round(float(dup_rate), 4)
            if trunc is not None:
                p["trunc-losses"] = int(trunc) + int(
                    p.get("trunc-losses") or 0)
            if fleet is not None:
                p["fleet"] = dict(fleet)
            p["levels-per-s"] = (round(self._rate, 3)
                                 if self._rate else None)
            p["configs-per-s"] = (round(self._exp_rate, 1)
                                  if self._exp_rate else None)
            remaining = max(0, p["level-budget"] - int(level))
            p["eta-s"] = (round(remaining / self._rate, 2)
                          if self._rate else None)
            self._seq += 1
            snap = dict(p)
            rate, exp_rate = self._rate, self._exp_rate
        _LEVEL.set(level)
        _FRONTIER_ROWS.set(frontier)
        _SEGMENTS_DONE.set(segments)
        if rate is not None:
            _LEVELS_PER_S.set(rate)
        if exp_rate is not None:
            _CONFIGS_PER_S.set(exp_rate)
        if snap["eta-s"] is not None:
            _ETA.set(snap["eta-s"])
        self._write(snap)

    def finish(self, valid: Any = None, levels: Optional[int] = None
               ) -> None:
        """Mark the in-flight search finished (the terminal publish is
        never throttled, so watchers see the final state)."""
        with self._lock:
            p = self._progress
            if p is None or p.get("state") != "searching":
                return  # no search in flight (early-out paths)
            p.update(state="done", ts=time.time(),
                     valid=(valid if isinstance(valid, (bool, type(None)))
                            else str(valid)))
            if levels is not None:
                p["level"] = int(levels)
            self._seq += 1
            snap = dict(p)
        _INFLIGHT.set(0)
        self._write(snap, force=True)

    # -- reading ------------------------------------------------------------

    def snapshot(self) -> Optional[Dict[str, Any]]:
        """The current progress dict (a copy), or None before any
        search ran in this process."""
        with self._lock:
            return dict(self._progress) if self._progress else None

    def seq(self) -> int:
        """Monotonic publish counter (cheap change detection for
        in-process watchers)."""
        with self._lock:
            return self._seq

    # -- file sink ----------------------------------------------------------

    def _write(self, snap: Dict[str, Any], force: bool = False) -> None:
        with self._lock:
            path = self._path
            now = time.monotonic()
            if path is None or (not force
                                and now - self._last_write
                                < WRITE_INTERVAL_S):
                return
            self._last_write = now
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(snap, f)
            os.replace(tmp, path)
        except OSError:
            # the sink must never kill the search it observes
            with self._lock:
                self._path = None


#: The process-global observatory the supervised search publishes to.
OBSERVATORY = Observatory()


def attach(store_dir: Optional[str]) -> None:
    OBSERVATORY.attach(store_dir)


def detach() -> None:
    OBSERVATORY.detach()


def begin(**kw) -> None:
    OBSERVATORY.begin(**kw)


def publish(**kw) -> None:
    OBSERVATORY.publish(**kw)


def finish(valid: Any = None, levels: Optional[int] = None) -> None:
    OBSERVATORY.finish(valid=valid, levels=levels)


def snapshot() -> Optional[Dict[str, Any]]:
    return OBSERVATORY.snapshot()


# ---------------------------------------------------------------------------
# Cross-process reading
# ---------------------------------------------------------------------------


def read_progress(run_dir: str) -> Optional[Dict[str, Any]]:
    """progress.json of a run directory, or None when absent/unreadable
    (a run predating the observatory, JTPU_TRACE=0, or a run killed
    before its first segment)."""
    path = os.path.join(run_dir, PROGRESS_NAME)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None
