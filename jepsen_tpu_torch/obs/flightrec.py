"""Flight recorder: the last N seconds, dumped at the moment of death.

A copy of the reference's ``jepsen_tpu/obs/flightrec.py``: the same dump
layout, rate limit, pruning and readers, over the port's tracer, registry
and time series.

Post-incident questions ("what was in flight when the breaker
tripped?") can't be answered from ``/metrics`` — the daemon is gone.
The recorder keeps no state of its own: the tracer's span ring and the
tsdb's finest-resolution rings *are* the in-memory window. On a
trigger — breaker trip, drain, SIGTERM (the reference's fourth,
all-fleet-hosts-lost, comes with the fleet) — it snapshots the last
``JTPU_FLIGHTREC_SECONDS`` (default 120) of both, plus the live metrics
snapshot, into an **atomic** ``flightrec/<reason>-<ms>.json`` (tmp +
``os.replace``, the store's crash-safety idiom: a dump is either whole
or absent, and a SIGKILL mid-dump leaves no half file). Dumps are
rate-limited per reason and capped in number (oldest deleted), so a
flapping breaker can't fill the disk.

Read back with ``python -m jepsen_tpu_torch flightrec [dump]`` or the
daemon's ``/flightrec`` view. Span timestamps are tracer-monotonic ns;
each dump carries a ``wall-ts``/``mono-ns`` anchor pair so they can be
dated.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from jepsen_tpu_torch.obs import metrics as obs_metrics
from jepsen_tpu_torch.obs import trace as obs_trace

log = logging.getLogger("jepsen.flightrec")

#: Dump directory name inside the daemon root.
DIR_NAME = "flightrec"

DEFAULT_SECONDS = 120.0

#: At most this many dumps kept (oldest deleted first).
MAX_DUMPS = 16

#: Minimum seconds between two dumps for the same reason.
REASON_COOLDOWN_S = 1.0


def seconds_from_env() -> float:
    v = os.environ.get("JTPU_FLIGHTREC_SECONDS")
    if not v:
        return DEFAULT_SECONDS
    try:
        return max(1.0, float(v))
    except ValueError:
        log.warning("JTPU_FLIGHTREC_SECONDS=%r is not a number; "
                    "using %s", v, DEFAULT_SECONDS)
        return DEFAULT_SECONDS


class FlightRecorder:
    def __init__(self, root: str, seconds: Optional[float] = None,
                 tsdb=None):
        # guarded-by: none — configuration, immutable after init
        self.dir = os.path.join(root, DIR_NAME)
        self.seconds = seconds_from_env() if seconds is None \
            else float(seconds)
        self.tsdb = tsdb                            # guarded-by: none
        self._lock = threading.Lock()
        self._last_by_reason: Dict[str, float] = {}
        self.dumps = 0                              # guarded-by: _lock

    def _window_spans(self) -> List[dict]:
        tr = obs_trace.tracer()
        cutoff = (time.monotonic_ns() - tr.epoch_ns) \
            - int(self.seconds * 1e9)
        return [r for r in tr.spans() if int(r.get("ts", 0)) >= cutoff]

    def dump(self, reason: str, extra: Optional[dict] = None
             ) -> Optional[str]:
        """Write one dump; returns its path, or None when rate-limited
        or the write failed (a recorder must never take the daemon
        down with it)."""
        now = time.monotonic()
        with self._lock:
            last = self._last_by_reason.get(reason)
            if last is not None and now - last < REASON_COOLDOWN_S:
                return None
            self._last_by_reason[reason] = now
            self.dumps += 1
        try:
            return self._write(reason, extra)
        except Exception as e:
            log.warning("flight-recorder dump (%s) failed: %s",
                        reason, e)
            return None

    def _write(self, reason: str, extra: Optional[dict]) -> str:
        spans = self._window_spans()
        traces = sorted({r["trace"] for r in spans if "trace" in r})
        doc: Dict[str, Any] = {
            "reason": reason,
            "wall-ts": time.time(),
            "mono-ns": time.monotonic_ns(),
            "epoch-ns": obs_trace.tracer().epoch_ns,
            "window-s": self.seconds,
            "spans": spans,
            "trace-ids": traces,
            "metrics": obs_metrics.REGISTRY.snapshot(),
        }
        if self.tsdb is not None:
            doc["tsdb"] = self.tsdb.recent(self.seconds)
        if extra:
            doc["extra"] = extra
        name = f"{reason}-{int(doc['wall-ts'] * 1000)}.json"
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, name)
        tmp = os.path.join(self.dir, f".{name}.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(doc, f, separators=(",", ":"), default=repr)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._prune()
        log.warning("flight recorder: dumped %s (%d spans, %d traces)",
                    path, len(spans), len(traces))
        return path

    def _prune(self) -> None:
        dumps = sorted(f for f in os.listdir(self.dir)
                       if f.endswith(".json") and not f.startswith("."))
        for f in dumps[:-MAX_DUMPS]:
            try:
                os.unlink(os.path.join(self.dir, f))
            except OSError:
                pass


def list_dumps(root: str) -> List[Dict[str, Any]]:
    """Dump inventory for one daemon root (newest first): ``{"name",
    "path", "reason", "wall-ts", "bytes", "spans", "trace-ids"}`` per
    readable dump; unreadable files are skipped, not fatal."""
    d = os.path.join(root, DIR_NAME)
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(d), reverse=True)
    except OSError:
        return out
    for name in names:
        if not name.endswith(".json") or name.startswith("."):
            continue
        path = os.path.join(d, name)
        try:
            with open(path) as f:
                doc = json.load(f)
            out.append({"name": name, "path": path,
                        "reason": doc.get("reason"),
                        "wall-ts": doc.get("wall-ts"),
                        "bytes": os.path.getsize(path),
                        "spans": len(doc.get("spans") or []),
                        "trace-ids": len(doc.get("trace-ids") or [])})
        except (OSError, ValueError):
            continue
    return out


def load_dump(root: str, name: str) -> Optional[dict]:
    """One dump by file name (no path traversal — the name must be a
    bare ``<reason>-<ms>.json``)."""
    if os.path.basename(name) != name or not name.endswith(".json"):
        return None
    path = os.path.join(root, DIR_NAME, name)
    try:
        with open(path) as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None
