"""Bounded, crash-tolerant time series over the metrics registry.

A copy of the reference's ``jepsen_tpu/obs/tsdb.py``: the same rings,
resolutions, ``metrics.tsdb`` records and queries, over the port's
registry and journal.

``/metrics`` and ``progress.json`` answer "now"; this module answers
"the last hour". A sampler thread walks :data:`~jepsen_tpu_torch.obs.metrics.
REGISTRY` on a wall-clock cadence (``JTPU_TSDB_CADENCE``, default 2s)
and folds each metric's movement into fixed-size ring buffers — one
ring per (metric, label set, resolution), downsampled into 10s / 1m /
10m frames, so memory is bounded by the label-set catalog, never by
uptime:

* counters   → per-frame **deltas** (rate queries are frame sums);
* gauges     → last-write-wins absolute value per frame;
* histograms → per-frame bucket/count/sum deltas, so windowed
  quantiles come from :func:`~jepsen_tpu_torch.obs.metrics.
  quantile_from_buckets` over summed deltas — the same nearest-rank
  estimator the live registry uses.

Every sample also appends one CRC'd record to ``metrics.tsdb`` (the
exact torn-tail-tolerant framing of :mod:`jepsen_tpu_torch.journal`), so a
restarted daemon :meth:`~TSDB.resume`\\ s its history: the pre-kill
series prefix survives SIGKILL minus at most the torn final record.
The file is compacted in place (checkpoint record, tmp + ``os.replace``)
once it outgrows ~2 ring-lengths of ticks, so it is bounded too.

The SLO engine (:mod:`jepsen_tpu_torch.obs.slo`) subscribes via
:attr:`~TSDB.on_tick`; the flight recorder snapshots :meth:`~TSDB.
recent`. ``JTPU_TSDB=0`` is the kill switch — the serve daemon then
constructs none of this and behaves byte-identically to the pre-tsdb
layout (no ``metrics.tsdb``, no new routes, keys, or metric series).
"""

from __future__ import annotations

import logging
import math
import os
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from jepsen_tpu_torch import journal
from jepsen_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger("jepsen.tsdb")

#: The segment file's name inside the daemon root.
TSDB_NAME = "metrics.tsdb"

#: (label, frame seconds, ring length). Spans: 10s x 360 = 1h,
#: 1m x 360 = 6h, 10m x 432 = 3d — queries pick the finest resolution
#: whose span covers the window.
RESOLUTIONS: Tuple[Tuple[str, float, int], ...] = (
    ("10s", 10.0, 360), ("1m", 60.0, 360), ("10m", 600.0, 432))

DEFAULT_CADENCE_S = 2.0

#: Compact once the segment holds this many records (~2x the finest
#: ring, so a resume never replays much more than the rings retain).
COMPACT_RECORDS = 1500

_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def enabled() -> bool:
    """Whether the time-series layer is on (JTPU_TSDB, default on)."""
    return os.environ.get("JTPU_TSDB", "1").lower() not in (
        "0", "false", "no", "off")


def cadence_from_env() -> float:
    """Sampling cadence from JTPU_TSDB_CADENCE (seconds, default 2)."""
    v = os.environ.get("JTPU_TSDB_CADENCE")
    if not v:
        return DEFAULT_CADENCE_S
    try:
        return max(0.1, float(v))
    except ValueError:
        log.warning("JTPU_TSDB_CADENCE=%r is not a number; using %s",
                    v, DEFAULT_CADENCE_S)
        return DEFAULT_CADENCE_S


def _series_key(labels: Dict[str, Any]) -> str:
    """The registry's formatted label string for a label dict — ring
    keys reuse the snapshot's own series keys verbatim."""
    return obs_metrics._fmt_labels(obs_metrics._labels_key(labels)) or ""


def _key_pairs(sk: str) -> List[Tuple[str, str]]:
    return _LABEL_RE.findall(sk or "")


def _matches(sk: str, want: frozenset) -> bool:
    return want <= frozenset(_key_pairs(sk))


class TSDB:
    """The sampler + ring store + segment writer. One lock guards the
    in-memory state; the sampler thread is the only writer of the
    segment file (compaction included), so queries never block on IO.

    ``now_fn`` / ``resolutions`` / ``cadence`` are injectable so tests
    drive a fake clock through :meth:`sample_once` without threads."""

    def __init__(self, root: str, cadence: Optional[float] = None,
                 now_fn: Callable[[], float] = None,
                 registry: Optional[obs_metrics.Registry] = None,
                 resolutions: Tuple[Tuple[str, float, int], ...]
                 = RESOLUTIONS,
                 persist: bool = True):
        self.root = root
        self.path = os.path.join(root, TSDB_NAME)
        # guarded-by: none — configuration, immutable after init
        self.cadence = cadence_from_env() if cadence is None else cadence
        self.now_fn = now_fn or time.time           # guarded-by: none
        self.registry = registry or obs_metrics.REGISTRY
        self.resolutions = tuple(resolutions)       # guarded-by: none
        self.persist = persist                      # guarded-by: none
        #: post-tick callbacks (the SLO engine); subscribe before
        #: :meth:`start` — the list itself is then never mutated.
        self.on_tick: List[Callable[[float], None]] = []
        self._lock = threading.Lock()
        # {resolution: {name: {serieskey: deque([frame, ...])}}}
        self._rings: Dict[str, Dict[str, Dict[str, deque]]] = \
            {label: {} for label, _, _ in self.resolutions}
        self._kinds: Dict[str, str] = {}
        self._bounds: Dict[str, List[float]] = {}
        self._cum: Dict[str, Dict[str, Any]] = {}
        #: durable side-channel for ingest cursors (the federation
        #: layer's per-host frame positions): carried by every
        #: checkpoint and advanced by replayed tick ``src`` markers, so
        #: external ingestion is exactly-once across SIGKILL+restart.
        self.meta: Dict[str, Any] = {}              # guarded-by: _lock
        # sampler-thread-private (stop() joins before touching)
        self._writer: Optional[journal.JsonRecordWriter] = None  # guarded-by: none
        self._file_records = 0                      # guarded-by: none
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None  # guarded-by: none
        self.ticks = 0                              # guarded-by: none
        self.resumed_records = 0                    # guarded-by: none

    # -- lifecycle ----------------------------------------------------

    def start(self) -> None:
        """Resume from disk, open the segment writer, start sampling."""
        os.makedirs(self.root, exist_ok=True)
        self.resume()
        if self.persist and self._writer is None:
            try:
                self._writer = journal.JsonRecordWriter(self.path)
            except OSError as e:
                log.warning("couldn't open %s (%s); tsdb runs "
                            "memory-only", self.path, e)
        self._thread = threading.Thread(
            target=self._loop, name="jtpu-tsdb", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the sampler, take one final sample, close the file."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        try:
            self.sample_once()
        except Exception:
            log.warning("final tsdb sample failed", exc_info=True)
        w = self._writer
        if w is not None:
            w.close()
            self._writer = None

    def _loop(self) -> None:
        while not self._stop.wait(self.cadence):
            try:
                self.sample_once()
            except Exception:
                log.warning("tsdb sample failed", exc_info=True)

    # -- resume -------------------------------------------------------

    def resume(self) -> None:
        """Rebuild the rings from ``metrics.tsdb`` (checkpoint record
        then tick replay). Torn final record = the crash-loss bound;
        the registry's cumulative baseline intentionally resets — the
        restarted process's counters restart near zero, so the first
        live delta is just its whole new value."""
        if not os.path.exists(self.path):
            return
        try:
            records, stats = journal.read_json_records(self.path)
        except OSError as e:
            log.warning("couldn't read %s: %s", self.path, e)
            return
        with self._lock:
            for rec in records:
                k = rec.get("k")
                if k == "ckpt":
                    self._load_ckpt(rec)
                elif k == "tick":
                    self._apply_tick(rec)
        self.resumed_records = len(records)
        self._file_records = len(records)
        if stats.get("torn") or stats.get("corrupt"):
            log.warning("tsdb resume from %s: %s", self.path, stats)

    def _load_ckpt(self, rec: dict) -> None:
        # lock held
        self._kinds.update({str(k): str(v)
                            for k, v in (rec.get("kinds") or {}).items()})
        for name, b in (rec.get("bounds") or {}).items():
            self._bounds[str(name)] = [float(x) for x in b]
        for mk, mv in (rec.get("meta") or {}).items():
            if isinstance(mv, dict):
                self.meta.setdefault(str(mk), {}).update(mv)
            else:
                self.meta[str(mk)] = mv
        npoints = {label: n for label, _, n in self.resolutions}
        for label, names in (rec.get("rings") or {}).items():
            if label not in self._rings:
                continue
            for name, series in (names or {}).items():
                for sk, frames in (series or {}).items():
                    ring = deque(frames, maxlen=npoints[label])
                    self._rings[label].setdefault(
                        str(name), {})[str(sk)] = ring

    def _apply_tick(self, rec: dict) -> None:
        # lock held
        t = float(rec.get("t", 0.0))
        for name, b in (rec.get("hb") or {}).items():
            self._bounds.setdefault(str(name), [float(x) for x in b])
        for name, series in (rec.get("c") or {}).items():
            for sk, d in (series or {}).items():
                self._ingest_counter(name, sk, t, float(d))
        for name, series in (rec.get("g") or {}).items():
            for sk, v in (series or {}).items():
                self._ingest_gauge(name, sk, t, float(v))
        for name, series in (rec.get("h") or {}).items():
            for sk, fr in (series or {}).items():
                if isinstance(fr, list) and len(fr) == 3:
                    self._ingest_hist(name, sk, t, int(fr[0]),
                                      float(fr[1]), list(fr[2]))
        src = rec.get("src")
        if isinstance(src, list) and len(src) == 3:
            # federated frame marker: advance the ingest cursor with
            # the same record that carried the data — replay therefore
            # never double-ingests a frame
            self.meta.setdefault("fed", {})[str(src[0])] = \
                [str(src[1]), int(src[2])]

    # -- ingestion ----------------------------------------------------

    def _ring(self, label: str, npoints: int, name: str, sk: str) -> deque:
        series = self._rings[label].setdefault(name, {})
        ring = series.get(sk)
        if ring is None:
            ring = series[sk] = deque(maxlen=npoints)
        return ring

    def _ingest_counter(self, name: str, sk: str, t: float,
                        delta: float) -> None:
        self._kinds[name] = "counter"
        for label, res, npoints in self.resolutions:
            ring = self._ring(label, npoints, name, sk)
            t0 = math.floor(t / res) * res
            if ring and ring[-1][0] == t0:
                ring[-1][1] += delta
            else:
                ring.append([t0, delta])

    def _ingest_gauge(self, name: str, sk: str, t: float,
                      value: float) -> None:
        self._kinds[name] = "gauge"
        for label, res, npoints in self.resolutions:
            ring = self._ring(label, npoints, name, sk)
            t0 = math.floor(t / res) * res
            if ring and ring[-1][0] == t0:
                ring[-1][1] = value
            else:
                ring.append([t0, value])

    def _ingest_hist(self, name: str, sk: str, t: float, dcount: int,
                     dsum: float, dbuckets: List[float]) -> None:
        self._kinds[name] = "histogram"
        for label, res, npoints in self.resolutions:
            ring = self._ring(label, npoints, name, sk)
            t0 = math.floor(t / res) * res
            if ring and ring[-1][0] == t0:
                fr = ring[-1]
                fr[1] += dcount
                fr[2] += dsum
                old = fr[3]
                for i, d in enumerate(dbuckets):
                    if i < len(old):
                        old[i] += d
                    else:
                        old.append(d)
            else:
                ring.append([t0, dcount, dsum, list(dbuckets)])

    # -- sampling -----------------------------------------------------

    def sample_once(self) -> float:
        """One tick: diff the registry against the last sample, fold
        the movement into every resolution's rings, append the tick
        record. Returns the tick's wall-clock time. Called by the
        sampler thread, or directly by tests with a fake ``now_fn``."""
        wall = float(self.now_fn())
        snap = self.registry.snapshot()
        cdoc: Dict[str, Dict[str, float]] = {}
        gdoc: Dict[str, Dict[str, float]] = {}
        hdoc: Dict[str, Dict[str, list]] = {}
        hb: Dict[str, List[float]] = {}
        with self._lock:
            for name, m in snap.items():
                if not isinstance(m, dict):
                    continue  # the top-level "ts" field
                kind = m.get("kind")
                series = m.get("series") or {}
                if kind == "counter":
                    cum = self._cum.setdefault(name, {})
                    for sk, v in series.items():
                        v = float(v)
                        d = v - float(cum.get(sk, 0.0))
                        if d < 0:
                            d = v  # the registry was reset under us
                        cum[sk] = v
                        if d:
                            cdoc.setdefault(name, {})[sk] = d
                            self._ingest_counter(name, sk, wall, d)
                elif kind == "gauge":
                    for sk, v in series.items():
                        v = float(v)
                        gdoc.setdefault(name, {})[sk] = v
                        self._ingest_gauge(name, sk, wall, v)
                elif kind == "histogram":
                    cum = self._cum.setdefault(name, {})
                    for sk, doc in series.items():
                        if not isinstance(doc, dict):
                            continue
                        buckets = [int(b) for b in doc.get("buckets", [])]
                        cnt = int(doc.get("count", 0))
                        sm = float(doc.get("sum", 0.0))
                        if name not in self._bounds:
                            b = [float(x) for x in doc.get("bounds", [])]
                            self._bounds[name] = b
                            hb[name] = b
                        prev = cum.get(sk)
                        if prev is None or cnt < prev[2]:
                            db, dc, ds = list(buckets), cnt, sm
                        else:
                            db = [max(0, b - p) for b, p
                                  in zip(buckets, prev[0])]
                            dc = cnt - prev[2]
                            ds = sm - prev[1]
                        cum[sk] = [buckets, sm, cnt]
                        if dc:
                            fr = [dc, round(ds, 9), db]
                            hdoc.setdefault(name, {})[sk] = fr
                            self._ingest_hist(name, sk, wall, dc, ds, db)
        rec: Dict[str, Any] = {"k": "tick", "t": round(wall, 3)}
        for key, doc in (("hb", hb), ("c", cdoc), ("g", gdoc),
                         ("h", hdoc)):
            if doc:
                rec[key] = doc
        w = self._writer
        if w is not None and len(rec) > 2:
            w.append(rec)
            self._file_records += 1
            if self._file_records >= COMPACT_RECORDS:
                self._compact(wall)
        self.ticks += 1
        for cb in list(self.on_tick):
            try:
                cb(wall)
            except Exception:
                log.warning("tsdb on_tick callback failed", exc_info=True)
        return wall

    def ingest_external(self, t: float,
                        c: Optional[dict] = None,
                        g: Optional[dict] = None,
                        h: Optional[dict] = None,
                        hb: Optional[dict] = None,
                        src: Optional[list] = None) -> None:
        """Fold one externally-sampled tick (a federated host frame,
        already delta-encoded and re-keyed) into the rings AND the
        segment file. The appended record is a normal ``tick``, so
        :meth:`resume` replays federated history exactly like local
        history; ``src = [host, boot, seq]`` rides along and advances
        the durable ingest cursor atomically with the data (see
        :meth:`_apply_tick`). Sampler-thread-only (call from an
        ``on_tick`` callback): the segment writer is private to that
        thread, like :meth:`sample_once`."""
        rec: Dict[str, Any] = {"k": "tick", "t": round(float(t), 3)}
        for key, doc in (("hb", hb), ("c", c), ("g", g), ("h", h)):
            if doc:
                rec[key] = doc
        if src is not None:
            rec["src"] = [str(src[0]), str(src[1]), int(src[2])]
        with self._lock:
            self._apply_tick(rec)
        w = self._writer
        if w is not None and len(rec) > 2:
            w.append(rec)
            self._file_records += 1
            if self._file_records >= COMPACT_RECORDS:
                self._compact(float(t))

    # -- compaction ---------------------------------------------------

    def _ckpt_doc(self, wall: float) -> dict:
        # lock held
        rings: Dict[str, Any] = {}
        for label, names in self._rings.items():
            out_n: Dict[str, Any] = {}
            for name, series in names.items():
                out_s = {sk: [self._copy_frame(fr) for fr in ring]
                         for sk, ring in series.items() if ring}
                if out_s:
                    out_n[name] = out_s
            if out_n:
                rings[label] = out_n
        doc = {"k": "ckpt", "t": round(wall, 3), "kinds": self._kinds,
               "bounds": self._bounds, "rings": rings}
        if self.meta:
            doc["meta"] = self.meta
        return doc

    def _compact(self, wall: float) -> None:
        """Rewrite the segment as one checkpoint record (tmp +
        ``os.replace``). Sampler-thread-only, like every writer path."""
        with self._lock:
            ckpt = self._ckpt_doc(wall)
        tmp = os.path.join(self.root, f".{TSDB_NAME}.{os.getpid()}")
        try:
            with open(tmp, "wb") as f:
                f.write(journal.encode_json_record(ckpt))
                f.flush()
                os.fsync(f.fileno())
            if self._writer is not None:
                self._writer.close()
            os.replace(tmp, self.path)
            self._writer = journal.JsonRecordWriter(self.path)
            self._file_records = 1
        except OSError as e:
            log.warning("tsdb compaction of %s failed: %s", self.path, e)

    # -- queries ------------------------------------------------------

    @staticmethod
    def _copy_frame(fr: list) -> list:
        return [fr[0], fr[1], fr[2], list(fr[3])] if len(fr) == 4 \
            else list(fr)

    def resolution_for(self, window_s: float) -> str:
        """The finest resolution whose ring span covers ``window_s``."""
        for label, res, npoints in self.resolutions:
            if res * npoints >= window_s:
                return label
        return self.resolutions[-1][0]

    def series(self, name: str, resolution: str = None,
               **labels) -> List[list]:
        """The ring frames (oldest first) for one exact label set at
        one resolution (default: the finest)."""
        resolution = resolution or self.resolutions[0][0]
        sk = _series_key(labels)
        with self._lock:
            ring = self._rings.get(resolution, {}).get(name, {}).get(sk)
            return [self._copy_frame(fr) for fr in ring] if ring else []

    def series_keys(self, name: str) -> List[str]:
        """Every label-set key the store holds for ``name``."""
        keys: set = set()
        with self._lock:
            for names in self._rings.values():
                keys.update(names.get(name, {}).keys())
        return sorted(keys)

    def kind(self, name: str) -> Optional[str]:
        with self._lock:
            return self._kinds.get(name)

    def meta_view(self, key: str) -> Any:
        """A copy of one durable-meta entry (ingest cursors etc.)."""
        with self._lock:
            v = self.meta.get(key)
            return dict(v) if isinstance(v, dict) else v

    def bounds(self, name: str) -> Optional[List[float]]:
        """A histogram's bucket bounds as sampled (None until seen)."""
        with self._lock:
            b = self._bounds.get(name)
            return list(b) if b else None

    def window_delta(self, name: str, window_s: float,
                     now: Optional[float] = None, **match) -> float:
        """Counter movement inside the window, summed across every
        series whose labels include ``match``."""
        now = float(self.now_fn()) if now is None else now
        label = self.resolution_for(window_s)
        want = frozenset((str(k), str(v)) for k, v in match.items())
        lo = now - window_s
        total = 0.0
        with self._lock:
            for sk, ring in self._rings.get(label, {}).get(
                    name, {}).items():
                if not _matches(sk, want):
                    continue
                for fr in ring:
                    if fr[0] >= lo:
                        total += fr[1]
        return total

    def window_hist(self, name: str, window_s: float,
                    now: Optional[float] = None, **match
                    ) -> Tuple[int, float, List[int]]:
        """``(count, sum, bucket-deltas)`` inside the window, summed
        across every series whose labels include ``match``."""
        now = float(self.now_fn()) if now is None else now
        label = self.resolution_for(window_s)
        want = frozenset((str(k), str(v)) for k, v in match.items())
        lo = now - window_s
        cnt, sm = 0, 0.0
        buckets: List[int] = []
        with self._lock:
            for sk, ring in self._rings.get(label, {}).get(
                    name, {}).items():
                if not _matches(sk, want):
                    continue
                for fr in ring:
                    if len(fr) != 4 or fr[0] < lo:
                        continue
                    cnt += fr[1]
                    sm += fr[2]
                    for i, d in enumerate(fr[3]):
                        if i < len(buckets):
                            buckets[i] += d
                        else:
                            buckets.append(d)
        return cnt, sm, buckets

    def quantile(self, name: str, q: float, window_s: float,
                 now: Optional[float] = None, **match) -> Optional[float]:
        """Nearest-rank quantile over the window's bucket deltas —
        e.g. ``quantile("jtpu_serve_request_seconds", 0.99, 600)`` is
        the last-10-minutes p99. None when the window is empty."""
        cnt, _sm, buckets = self.window_hist(name, window_s, now, **match)
        with self._lock:
            bounds = self._bounds.get(name)
        if not bounds or cnt <= 0:
            return None
        n = len(bounds) + 1
        buckets = (buckets + [0] * n)[:n]
        return obs_metrics.quantile_from_buckets(q, buckets,
                                                 tuple(bounds))

    def latest(self, name: str, resolution: str = None,
               **labels) -> Optional[float]:
        """The newest frame's value for one gauge/counter series."""
        frames = self.series(name, resolution, **labels)
        return frames[-1][1] if frames else None

    def recent(self, window_s: float,
               now: Optional[float] = None) -> Dict[str, Any]:
        """Finest-resolution frames inside the window for every series
        — the flight recorder's metric annex."""
        now = float(self.now_fn()) if now is None else now
        label = self.resolutions[0][0]
        lo = now - window_s
        out: Dict[str, Any] = {}
        with self._lock:
            for name, series in self._rings.get(label, {}).items():
                doc = {}
                for sk, ring in series.items():
                    frames = [self._copy_frame(fr) for fr in ring
                              if fr[0] >= lo]
                    if frames:
                        doc[sk] = frames
                if doc:
                    out[name] = doc
        return {"resolution": label, "series": out}
