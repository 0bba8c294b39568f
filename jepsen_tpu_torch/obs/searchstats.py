"""Search analytics: per-level frontier/pruning rollups of the device
search.

A copy of the reference's ``jepsen_tpu/obs/searchstats.py``. In the
port the counters are the stats row K4 (``dedup_truncate``) writes for
each level; with tracing off it is given no stats buffer and writes
none.

The search body in :mod:`jepsen_tpu_torch.checker.gpu` computes duplicate and
dominance masks every level and (until this module) discarded them.
With tracing on, stats-enabled executables log five int32 counters per
level into an extra carry lane (``SEARCHSTAT_COLS`` order — expanded
rows, dedup kills, dominance kills, truncation losses, live frontier
width), extracted host-side at segment barriers / final outputs — never
inside the traced body. This module is the host half:

* :func:`rollup` — the scalar summary attached to checker results
  (frontier-area, duplicate-rate, prune-efficiency);
* a run-scoped sink mirroring the full per-level series to
  ``searchstats.json`` (tmp+replace, throttled — torn-tolerant like
  progress.json), which other processes read;
* :func:`read_searchstats` / :func:`sparkline` — the consumer side.

P-compositionality (arXiv:1504.00204) motivates the instrument: a
dense keyed batch's cost is a search-*shape* problem, and these counters
are the data a decomposition pass would be designed against.

Kill switch: with ``JTPU_TRACE=0`` the checker selects stats-off
executables, nothing is recorded, and no ``searchstats.json`` is ever
written — artifacts stay byte-identical.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from jepsen_tpu_torch.obs import trace as obs_trace

#: The per-run analytics artifact's filename inside a store directory.
SEARCHSTATS_NAME = "searchstats.json"

#: Counter-column order of the device stats lane. MUST match
#: ``checker.gpu.SEARCHSTAT_COLS`` (asserted by tests/test_searchstats
#: .py); duplicated here so the obs package stays import-light.
COLS = ("expanded", "dup", "dominated", "trunc", "frontier")
NSTAT = len(COLS)

#: Min seconds between searchstats.json rewrites (finalize always
#: writes).
WRITE_INTERVAL_S = 0.25


def dup_rate(levels) -> float:
    """Fraction of sorted candidate rows killed as duplicates:
    dup / (dup + dominated + trunc + frontier). High values mean the
    expansion regenerates configurations the pool already holds — the
    signature of a dense contended history re-deriving the same
    interleavings (the item-2 decomposition target)."""
    a = np.asarray(levels, np.int64).reshape(-1, NSTAT)
    if a.size == 0:
        return 0.0
    dup = int(a[:, 1].sum())
    total = dup + int(a[:, 2].sum() + a[:, 3].sum() + a[:, 4].sum())
    return round(dup / total, 4) if total else 0.0


def rollup(levels) -> Dict[str, Any]:
    """Scalar summary of a per-level counter log (the ``searchstats``
    key of checker results and bench records)."""
    a = np.asarray(levels, np.int64).reshape(-1, NSTAT)
    expanded = int(a[:, 0].sum()) if a.size else 0
    dup = int(a[:, 1].sum()) if a.size else 0
    dom = int(a[:, 2].sum()) if a.size else 0
    trunc = int(a[:, 3].sum()) if a.size else 0
    area = int(a[:, 4].sum()) if a.size else 0
    peak = int(a[:, 4].max()) if a.size else 0
    survivors = dup + dom + trunc + area
    return {
        "levels": int(a.shape[0]),
        "expanded-total": expanded,
        "dup-kills": dup,
        "dominance-kills": dom,
        "trunc-losses": trunc,
        "frontier-area": area,
        "frontier-peak": peak,
        "dup-rate": round(dup / survivors, 4) if survivors else 0.0,
        "prune-efficiency": (round((dup + dom) / survivors, 4)
                             if survivors else 0.0),
    }


class SearchStats:
    """Thread-safe single-slot sink for the current search's per-level
    counter log (one device search runs at a time per process, exactly
    the observatory's contract)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._path: Optional[str] = None
        self._levels: Optional[np.ndarray] = None
        self._rung: Optional[tuple] = None
        self._last_write = 0.0

    def attach(self, store_dir: Optional[str]) -> None:
        """Point searchstats.json at a run's store directory and reset
        the in-memory series. No-op when dir-less or JTPU_TRACE=0."""
        with self._lock:
            self._path = (os.path.join(store_dir, SEARCHSTATS_NAME)
                          if store_dir and obs_trace.enabled() else None)
            self._levels = None
            self._rung = None

    def detach(self) -> None:
        with self._lock:
            self._path = None

    def record(self, levels, rung: Optional[tuple] = None) -> None:
        """Set the current series to the FULL per-level prefix seen so
        far (segment callers pass ``slog[:level]`` each barrier — the
        replace semantics make a torn write self-healing on the next
        one). A new rung replaces the old series: the ladder restarted
        the search."""
        a = np.asarray(levels, np.int64).reshape(-1, NSTAT)
        with self._lock:
            self._levels = a
            if rung is not None:
                self._rung = tuple(int(x) if x is not None else None
                                   for x in rung)
            path = self._path
            now = time.monotonic()
            if path is None or now - self._last_write < WRITE_INTERVAL_S:
                return
            self._last_write = now
            doc = self._doc_locked()
        self._write(doc)

    def finalize(self, summary: Optional[Dict[str, Any]] = None) -> None:
        """Terminal write (never throttled) with the result's rollup
        attached, so watchers and `jtpu explain` see the final series."""
        with self._lock:
            if self._path is None or self._levels is None:
                return
            doc = self._doc_locked()
            if summary is not None:
                doc["summary"] = dict(summary)
        self._write(doc)

    def snapshot(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._doc_locked() if self._levels is not None \
                else None

    # -- internals ----------------------------------------------------------

    def _doc_locked(self) -> Dict[str, Any]:
        a = self._levels if self._levels is not None \
            else np.zeros((0, NSTAT), np.int64)
        return {"ts": time.time(),
                "cols": list(COLS),
                "rung": list(self._rung) if self._rung else None,
                "levels": a.tolist(),
                "summary": rollup(a)}

    def _write(self, doc: Dict[str, Any]) -> None:
        with self._lock:
            path = self._path
        if path is None:
            return
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except OSError:
            # the sink must never kill the search it observes
            with self._lock:
                self._path = None


#: The process-global sink the checker paths record into.
SEARCHSTATS = SearchStats()


def attach(store_dir: Optional[str]) -> None:
    SEARCHSTATS.attach(store_dir)


def detach() -> None:
    SEARCHSTATS.detach()


def record(levels, rung: Optional[tuple] = None) -> None:
    SEARCHSTATS.record(levels, rung=rung)


def finalize(summary: Optional[Dict[str, Any]] = None) -> None:
    SEARCHSTATS.finalize(summary)


def snapshot() -> Optional[Dict[str, Any]]:
    return SEARCHSTATS.snapshot()


# ---------------------------------------------------------------------------
# Cross-process reading + rendering (jtpu explain / the web UI)
# ---------------------------------------------------------------------------


def read_searchstats(run_dir: str) -> Optional[Dict[str, Any]]:
    """searchstats.json of a run directory, or None when absent,
    torn, or malformed (JTPU_TRACE=0 runs, pre-analytics runs, or a
    run SIGKILLed mid-write — the explain surfaces degrade instead of
    erroring)."""
    path = os.path.join(run_dir, SEARCHSTATS_NAME)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict):
        return None
    lv = doc.get("levels")
    if not isinstance(lv, list):
        return None
    # clamp torn rows rather than reject the document
    doc["levels"] = [r for r in lv
                     if isinstance(r, list) and len(r) == NSTAT]
    return doc


_BLOCKS = " ▁▂▃▄▅▆▇█"


def sparkline(values: Sequence[float], width: int = 48) -> str:
    """Unicode block sparkline of a numeric series, downsampled to
    ``width`` buckets by max (peaks must survive: a one-level frontier
    spike is exactly what the reader is looking for)."""
    vals: List[float] = [float(v) for v in values]
    if not vals:
        return ""
    if len(vals) > width:
        n = len(vals)
        vals = [max(vals[i * n // width:
                         max(i * n // width + 1, (i + 1) * n // width)])
                for i in range(width)]
    top = max(vals)
    if top <= 0:
        return _BLOCKS[1] * len(vals)
    return "".join(
        _BLOCKS[1 + int(round((len(_BLOCKS) - 2) * v / top))]
        for v in vals)
