"""Live cross-host telemetry federation over the host-dir file seam.

The port's copy of ``jepsen_tpu/obs/federation.py``. The daemon's time
series (:mod:`jepsen_tpu_torch.obs.tsdb`) samples its own registry; this
module makes the fleet hosts' counters, spans and device gauges part of
it while the hosts run:

* each fleet host runs a :class:`FrameExporter` that appends a compact
  CRC'd **telemetry frame** to ``telemetry.frames`` in its host dir on a
  ``JTPU_FED_CADENCE`` cadence (default 1 s): the host's registry
  movement since the last frame (the counter, gauge and histogram deltas
  of a tsdb ``tick``), the span ring's tail and, since the device gauges
  live in the same registry, the device memory. Frames use the op
  journal's record framing (:mod:`jepsen_tpu_torch.journal`), so a
  SIGKILLed exporter leaves at worst one torn final record that every
  reader skips;

* the serve daemon's :class:`Federator` rides the tsdb sampler's tick
  (``on_tick``, the sampler thread): it scans the host dirs, reads the
  frames past each host's durable cursor, labels every series with
  ``host="..."`` and folds them into the one ``metrics.tsdb`` through
  :meth:`TSDB.ingest_external`. The cursor rides inside the same tick
  record as the data, so a replay after SIGKILL ingests each frame once;

* the SLO engine and ``/usage`` sum over label subsets of that store, so
  fleet-wide burn rates follow once the series carry hosts. A host that
  dies stops producing frames: its series go stale and resume when it
  rejoins with a new boot id;

* :func:`trace_find` answers "which requests?" from the files alone:
  the serve WAL gives id, tenant, trace id, verdict and usage, the
  federated span frames and the hosts' trace files give the hosts of a
  trace (``python -m jepsen_tpu_torch trace find`` and ``GET
  /trace/find`` both call it).

``JTPU_FEDERATE=0`` constructs no exporter, collector, route, gauge or
healthz key.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from jepsen_tpu_torch import journal
from jepsen_tpu_torch.obs import fleet as obs_fleet
from jepsen_tpu_torch.obs import metrics as obs_metrics
from jepsen_tpu_torch.obs import trace as obs_trace

log = logging.getLogger("jepsen.federation")

#: Per-host frame file inside the host dir (next to ``heartbeat.json``).
FRAMES_NAME = "telemetry.frames"

DEFAULT_CADENCE_S = 1.0

#: Span records carried per frame at most — the ring tail, not the ring.
SPAN_TAIL_CAP = 200

#: Exporter-side compaction: at this many appended records the file is
#: rewritten (tmp + replace) keeping only the newest ``FRAMES_KEEP``.
FRAMES_COMPACT = 1200
FRAMES_KEEP = 300

#: Head-fingerprint length for the collector's incremental reader:
#: enough of the first record (its CRC prefix + boot id land well
#: inside) to tell a replaced file from an appended-to one.
_FP_LEN = 64

#: Span attributes worth shipping across the host boundary. ``phase``
#: must ride along: the Federator's straggler feed excludes
#: ``phase="compile"`` segments, and stripping the attribute here
#: would turn a shape's first segment (kernel build, buffers, graph
#: capture) into false skew.
_SPAN_KEYS = ("name", "ts", "dur", "trace", "host", "tenant", "round",
              "rung", "gang", "id", "valid", "phase")

_OFF_VALUES = ("0", "false", "no", "off")


def enabled() -> bool:
    """The ``JTPU_FEDERATE`` kill switch (default on). The ONE parser
    for the env — ``ServeConfig``, the fleet's exporters, and the
    detector construction all route through it, so ``0`` / ``false`` /
    ``no`` / ``off`` each disable the whole plane consistently."""
    return os.environ.get("JTPU_FEDERATE", "1").strip().lower() \
        not in _OFF_VALUES


def cadence_from_env() -> float:
    v = os.environ.get("JTPU_FED_CADENCE")
    if not v:
        return DEFAULT_CADENCE_S
    try:
        return max(0.05, float(v))
    except ValueError:
        log.warning("JTPU_FED_CADENCE=%r is not a number; using %s",
                    v, DEFAULT_CADENCE_S)
        return DEFAULT_CADENCE_S


def read_frames(host_dir: str) -> List[dict]:
    """Every decodable frame record in a host dir, file order. A torn
    final record (exporter SIGKILLed mid-append) is silently skipped —
    the journal framing's torn-tail discipline."""
    path = os.path.join(host_dir, FRAMES_NAME)
    if not os.path.exists(path):
        return []
    try:
        records, _stats = journal.read_json_records(path)
    except OSError:
        return []
    return [r for r in records if r.get("k") == "frame"]


# ---------------------------------------------------------------------------
# Exporter (host side)
# ---------------------------------------------------------------------------


class FrameExporter:
    """Periodically appends one telemetry frame to the host dir.

    ``metrics=True`` (a worker process with its own registry) ships
    registry snapshot deltas; ``metrics=False`` (an in-process
    LocalHost sharing the daemon's registry, which the daemon's own
    sampler already covers) ships only the span tail — shipping the
    shared registry twice would double-count every counter.
    ``span_host`` restricts the exported tail to spans carrying that
    ``host=`` attribute, so several LocalHost exporters can share one
    tracer ring without cross-shipping each other's segments.

    Single exporter thread owns the writer and all cursors; torn-tail
    safety comes from the record framing, not locks.
    """

    def __init__(self, host_dir: str, host: Optional[str] = None,
                 metrics: bool = True,
                 registry: Optional[obs_metrics.Registry] = None,
                 cadence: Optional[float] = None,
                 span_host: Optional[str] = None,
                 now_fn: Callable[[], float] = time.time):
        self.host_dir = host_dir
        base = os.path.basename(os.path.normpath(host_dir))
        self.host = host or base or host_dir
        self.metrics = metrics
        self.registry = registry if registry is not None \
            else obs_metrics.REGISTRY
        self.cadence = cadence_from_env() if cadence is None \
            else max(0.05, float(cadence))
        self.span_host = span_host
        self.now_fn = now_fn
        #: Boot id: strictly increasing across restarts of the same
        #: host (millisecond clock + pid jitter), so readers order
        #: "old boot, then rejoin" correctly from the ids alone.
        self.boot = int(self.now_fn() * 1000) * 1000 + os.getpid() % 1000
        self._seq = 0
        self._cum: Dict[str, Dict[str, Any]] = {}
        #: histogram families whose bounds already shipped this boot
        self._bounds_sent: Set[str] = set()
        self._span_ts = -1
        self._writer: Optional[journal.JsonRecordWriter] = None
        self._tail: deque = deque(maxlen=FRAMES_KEEP)
        self._records = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def path(self) -> str:
        return os.path.join(self.host_dir, FRAMES_NAME)

    # -- lifecycle ----------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name=f"jtpu-fed-export-{self.host}",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        try:
            self.export_once()  # flush the final span tail
        except Exception:
            log.warning("final frame export failed", exc_info=True)
        w = self._writer
        if w is not None:
            w.close()
            self._writer = None

    def _loop(self) -> None:
        while not self._stop.wait(self.cadence):
            try:
                self.export_once()
            except Exception:
                log.warning("frame export failed", exc_info=True)

    # -- one frame ----------------------------------------------------

    def export_once(self) -> dict:
        """Build and append one frame. An empty frame (no movement, no
        new spans) is still written — its ``t`` is the host's liveness
        beacon on the telemetry plane."""
        wall = float(self.now_fn())
        self._seq += 1
        doc: Dict[str, Any] = {"k": "frame", "host": self.host,
                               "b": self.boot, "seq": self._seq,
                               "t": round(wall, 3)}
        if self.metrics:
            self._metric_deltas(doc)
        spans = self._span_tail()
        if spans:
            doc["spans"] = spans
        self._append(doc)
        return doc

    def _metric_deltas(self, doc: Dict[str, Any]) -> None:
        """Registry movement since the last frame — the tsdb tick's
        exact delta vocabulary, so the collector can hand the docs to
        :meth:`TSDB.ingest_external` after re-keying."""
        try:
            # refresh the device gauges so the memory picture rides
            # the same "g" section (no-op rows on CPU)
            from jepsen_tpu_torch.obs import devices as obs_devices
            obs_devices.poll()
        except Exception:  # noqa: BLE001 — telemetry must not raise
            pass
        snap = self.registry.snapshot()
        cdoc: Dict[str, Dict[str, float]] = {}
        gdoc: Dict[str, Dict[str, float]] = {}
        hdoc: Dict[str, Dict[str, list]] = {}
        hb: Dict[str, List[float]] = {}
        for name, m in snap.items():
            if not isinstance(m, dict):
                continue
            kind = m.get("kind")
            series = m.get("series") or {}
            if kind == "counter":
                cum = self._cum.setdefault(name, {})
                for sk, v in series.items():
                    v = float(v)
                    d = v - float(cum.get(sk, 0.0))
                    if d < 0:
                        d = v
                    cum[sk] = v
                    if d:
                        cdoc.setdefault(name, {})[sk] = round(d, 9)
            elif kind == "gauge":
                for sk, v in series.items():
                    gdoc.setdefault(name, {})[sk] = float(v)
            elif kind == "histogram":
                cum = self._cum.setdefault(name, {})
                for sk, hs in series.items():
                    if not isinstance(hs, dict):
                        continue
                    buckets = [int(b) for b in hs.get("buckets", [])]
                    cnt = int(hs.get("count", 0))
                    sm = float(hs.get("sum", 0.0))
                    if name not in self._bounds_sent:
                        hb[name] = [float(x) for x in
                                    hs.get("bounds", [])]
                        self._bounds_sent.add(name)
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
                        hdoc.setdefault(name, {})[sk] = \
                            [dc, round(ds, 9), db]
        for key, d in (("hb", hb), ("c", cdoc), ("g", gdoc),
                       ("h", hdoc)):
            if d:
                doc[key] = d

    def _span_tail(self) -> List[dict]:
        if not obs_trace.enabled():
            return []
        try:
            recs = obs_trace.tracer().spans()
        except Exception:  # noqa: BLE001 — telemetry must not raise
            return []
        fresh = [sp for sp in recs
                 if isinstance(sp.get("ts"), (int, float))
                 and sp["ts"] > self._span_ts]
        fresh.sort(key=lambda sp: sp["ts"])
        out: List[dict] = []
        for sp in fresh:
            if self.span_host is not None \
                    and sp.get("host") != self.span_host:
                # another exporter's span: skip it, but move the
                # cursor past it so it is never rescanned
                self._span_ts = sp["ts"]
                continue
            if len(out) >= SPAN_TAIL_CAP:
                # overflow: the cursor stays at the last span actually
                # shipped, so the remainder exports next frame instead
                # of vanishing
                break
            out.append({k: sp[k] for k in _SPAN_KEYS if k in sp})
            self._span_ts = sp["ts"]
        return out

    # -- file ---------------------------------------------------------

    def _append(self, doc: dict) -> None:
        if self._writer is None:
            try:
                os.makedirs(self.host_dir, exist_ok=True)
                self._writer = journal.JsonRecordWriter(self.path)
            except OSError as e:
                log.warning("couldn't open %s: %s", self.path, e)
                return
        self._writer.append(doc)
        self._tail.append(doc)
        self._records += 1
        if self._records >= FRAMES_COMPACT:
            self._rewrite()

    def _rewrite(self) -> None:
        """Bound the file: rewrite with the newest frames only
        (dot-prefixed tmp + fsync + rename — a reader sees the old
        file or the new one, never a mix)."""
        tmp = os.path.join(self.host_dir,
                           f".{FRAMES_NAME}.{os.getpid()}")
        try:
            with open(tmp, "wb") as f:
                for doc in self._tail:
                    f.write(journal.encode_json_record(doc))
                f.flush()
                os.fsync(f.fileno())
            if self._writer is not None:
                self._writer.close()
            os.replace(tmp, self.path)
            self._writer = journal.JsonRecordWriter(self.path)
            self._records = len(self._tail)
        except OSError as e:
            log.warning("frame compaction of %s failed: %s",
                        self.path, e)


# ---------------------------------------------------------------------------
# Collector (leader side)
# ---------------------------------------------------------------------------


class Federator:
    """Folds host frames into the daemon's tsdb on the sampler tick.

    Register with ``db.on_tick.insert(0, fed.collect)`` so federated
    points land *before* the SLO engine's evaluation on the same tick.
    All file I/O is best-effort: a vanished host dir, an unreadable
    file, or a torn record marks the host stale and never raises into
    the sampler."""

    def __init__(self, root: str, db, straggler=None,
                 pattern: str = "fleet-host-*"):
        self.root = root
        self.db = db
        self.straggler = straggler
        self.pattern = pattern
        self._lock = threading.Lock()
        # guarded-by: _lock — wall-clock t of each host's newest frame
        self._seen: Dict[str, float] = {}
        self.frames_ingested = 0                    # guarded-by: _lock
        # sampler thread only — per-file (inode, byte offset past the
        # last complete record, head fingerprint), so a ~1s tick
        # decodes only appended records instead of every host's whole
        # file
        self._offsets: Dict[str, Tuple[int, int, bytes]] = {}

    def _host_dirs(self) -> List[str]:
        try:
            return sorted(
                d for d in glob.glob(os.path.join(self.root,
                                                  self.pattern))
                if os.path.isdir(d))
        except OSError:
            return []

    def _read_new(self, host_dir: str) -> List[dict]:
        """Frame records appended to a host's file since the last
        pass. An inode change, a shrink below the cursor, or a changed
        head fingerprint (filesystems reuse inodes, so a same-size
        replacement could otherwise pass) means the file was replaced
        — exporter compaction or a host rejoin: the offset resets to 0
        and the durable ``(boot, seq)`` cursor dedups the replayed
        prefix. Bytes past the last newline are a torn or in-flight
        tail — the offset never advances past them, so a record
        completed by the next append is decoded then, not lost."""
        path = os.path.join(host_dir, FRAMES_NAME)
        try:
            f = open(path, "rb")
        except OSError:
            self._offsets.pop(path, None)
            return []
        try:
            with f:
                st = os.fstat(f.fileno())
                ino, off, fp = self._offsets.get(path, (-1, 0, b""))
                head = f.read(_FP_LEN)
                if ino != st.st_ino or st.st_size < off \
                        or not head.startswith(fp):
                    off = 0
                if st.st_size <= off:
                    self._offsets[path] = (st.st_ino, off, head)
                    return []
                f.seek(off)
                data = f.read()
        except OSError:
            return []
        end = data.rfind(b"\n")
        if end < 0:
            self._offsets[path] = (st.st_ino, off, head)
            return []
        out: List[dict] = []
        for line in data[:end].split(b"\n"):
            rec = journal.decode_json_record(line)
            if rec is not None and rec.get("k") == "frame":
                out.append(rec)
        self._offsets[path] = (st.st_ino, off + end + 1, head)
        return out

    # -- the tick -----------------------------------------------------

    def collect(self, now: float) -> int:
        """One ingest pass (sampler thread). Returns frames folded."""
        cursors: Dict[str, list] = \
            dict(self.db.meta_view("fed") or {})
        n = 0
        for d in self._host_dirs():
            for rec in self._read_new(d):
                host = str(rec.get("host")
                           or os.path.basename(os.path.normpath(d)))
                try:
                    b = int(rec.get("b", 0))
                    seq = int(rec.get("seq", 0))
                    t = float(rec.get("t", now))
                except (TypeError, ValueError):
                    continue
                with self._lock:
                    if t > self._seen.get(host, 0.0):
                        self._seen[host] = t
                cur = cursors.get(host)
                if cur is not None:
                    try:
                        cb, cs = int(cur[0]), int(cur[1])
                    except (TypeError, ValueError, IndexError):
                        cb, cs = -1, -1
                    # frames at or behind the durable cursor were
                    # ingested by a previous pass (possibly a previous
                    # daemon life — the cursor replays with the tsdb)
                    if b < cb or (b == cb and seq <= cs):
                        continue
                self._ingest(host, rec, b, seq, now)
                cursors[host] = [str(b), seq]
                n += 1
        if n and self.straggler is not None:
            for h in self.straggler.poll_new():
                obs_trace.event("serve.fleet.straggler-flagged",
                                host=h)
        return n

    def _ingest(self, host: str, rec: dict, b: int, seq: int,
                now: float) -> None:
        rekey = obs_fleet._with_host
        cdoc = {name: {rekey(sk, host): float(v)
                       for sk, v in (series or {}).items()}
                for name, series in (rec.get("c") or {}).items()}
        gdoc = {name: {rekey(sk, host): float(v)
                       for sk, v in (series or {}).items()}
                for name, series in (rec.get("g") or {}).items()}
        hdoc = {name: {rekey(sk, host): fr
                       for sk, fr in (series or {}).items()}
                for name, series in (rec.get("h") or {}).items()}
        if self.straggler is not None:
            for sp in rec.get("spans") or []:
                # compile-phase segments are excluded: every host pays
                # a shape's first call (buffers, graph capture) mid-run,
                # and at wildly varying scale — it is not skew (the
                # detector's own first-sample discard only covers
                # phase-less producers' initial compile)
                if sp.get("name") == "checker.segment" \
                        and sp.get("dur") \
                        and sp.get("phase") != "compile":
                    self.straggler.observe_segment(
                        str(sp.get("host") or host),
                        float(sp["dur"]) / 1e9)
            t = float(rec.get("t", now))
            self.straggler.observe_heartbeat(host, max(0.0, now - t))
        self.db.ingest_external(rec.get("t", now), c=cdoc, g=gdoc,
                                h=hdoc, hb=rec.get("hb"),
                                src=[host, b, seq])
        with self._lock:
            self.frames_ingested += 1

    # -- reads --------------------------------------------------------

    def ages(self, now: Optional[float] = None) -> Dict[str, float]:
        """Per-host ``last_seen_age_s`` — wall seconds since the
        newest frame each host produced (a dead host's age just
        grows; its series are stale, not broken)."""
        now = time.time() if now is None else float(now)
        with self._lock:
            return {h: round(max(0.0, now - t), 3)
                    for h, t in sorted(self._seen.items())}

    def hosts(self) -> List[str]:
        with self._lock:
            return sorted(self._seen)


def fleet_ages(root: str, pattern: str = "fleet-host-*",
               now: Optional[float] = None) -> Dict[str, float]:
    """Stateless :meth:`Federator.ages` — per-host frame age straight
    from the files, for out-of-process readers (``top``)."""
    now = time.time() if now is None else float(now)
    out: Dict[str, float] = {}
    for d in sorted(glob.glob(os.path.join(root, pattern))):
        last, host = 0.0, os.path.basename(os.path.normpath(d))
        for rec in read_frames(d):
            try:
                t = float(rec.get("t", 0.0))
            except (TypeError, ValueError):
                continue
            host = str(rec.get("host") or host)
            last = max(last, t)
        if last:
            out[host] = round(max(0.0, now - last), 3)
    return out


# ---------------------------------------------------------------------------
# Trace search
# ---------------------------------------------------------------------------


def _trace_hosts(serve_dir: str,
                 pattern: str = "fleet-host-*") -> Dict[str, Set[str]]:
    """trace id -> hosts whose spans carry it, from the federated
    frames, the per-host trace sinks, and the daemon's own sink (the
    local-backend case, where segment spans carry ``host=`` but live
    in the leader's file)."""
    out: Dict[str, Set[str]] = {}

    def note(tid: Any, host: Any) -> None:
        if tid and host:
            out.setdefault(str(tid), set()).add(str(host))

    for d in sorted(glob.glob(os.path.join(serve_dir, pattern))):
        base = os.path.basename(os.path.normpath(d))
        for rec in read_frames(d):
            for sp in rec.get("spans") or []:
                note(sp.get("trace"),
                     sp.get("host") or rec.get("host") or base)
        tj = os.path.join(d, obs_trace.TRACE_NAME)
        if os.path.exists(tj):
            try:
                with open(tj, errors="replace") as f:
                    for line in f:
                        try:
                            sp = json.loads(line)
                        except ValueError:
                            continue  # torn tail of a live sink
                        note(sp.get("trace"), sp.get("host") or base)
            except OSError:
                pass
    own = os.path.join(serve_dir, obs_trace.TRACE_NAME)
    if os.path.exists(own):
        try:
            with open(own, errors="replace") as f:
                for line in f:
                    try:
                        sp = json.loads(line)
                    except ValueError:
                        continue
                    note(sp.get("trace"), sp.get("host"))
        except OSError:
            pass
    return out


def _result_error_class(serve_dir: str, rid: str) -> Optional[str]:
    path = os.path.join(serve_dir, f"{rid}.json")
    try:
        with open(path) as f:
            result = json.load(f)
    except (OSError, ValueError):
        return None
    ec = result.get("error-class")
    return str(ec) if ec else None


def trace_find(serve_dir: str, tenant: Optional[str] = None,
               min_device_s: Optional[float] = None,
               error_class: Optional[str] = None,
               host: Optional[str] = None,
               limit: int = 50) -> List[dict]:
    """Search the serve run for requests matching every given filter.

    Row sources: the serve WAL's ``accepted``/``done`` records (id,
    tenant, trace id, verdict, seconds, usage device-seconds), result
    files (error class, read lazily), and the federated span index
    (host attribution). Newest first, capped at ``limit``. Purely
    file-based — works against a live daemon's dir or a dead one's.
    """
    wal = os.path.join(serve_dir, "serve.wal")
    rows: Dict[str, Dict[str, Any]] = {}
    if os.path.exists(wal):
        try:
            records, _stats = journal.read_json_records(wal)
        except OSError:
            records = []
        for rec in records:
            rid = rec.get("id")
            if not rid:
                continue
            ev = rec.get("event")
            if ev == "accepted":
                r = rows.setdefault(str(rid), {"id": str(rid)})
                r["tenant"] = rec.get("tenant", "anon")
                r["ts"] = rec.get("ts")
                if rec.get("trace"):
                    r["trace"] = str(rec["trace"])
            elif ev == "done":
                r = rows.setdefault(str(rid), {"id": str(rid)})
                r["valid"] = rec.get("valid")
                r["seconds"] = rec.get("seconds")
                if rec.get("tenant"):
                    r.setdefault("tenant", rec["tenant"])
                u = rec.get("usage")
                if isinstance(u, dict):
                    r["device-s"] = u.get("device-s")
    span_hosts = _trace_hosts(serve_dir)
    out: List[dict] = []
    for r in rows.values():
        hs = sorted(span_hosts.get(r.get("trace") or "", ()))
        if hs:
            r["hosts"] = hs
        if tenant is not None and r.get("tenant") != tenant:
            continue
        if min_device_s is not None:
            try:
                dev = float(r.get("device-s") or 0.0)
            except (TypeError, ValueError):
                dev = 0.0
            if dev < float(min_device_s):
                continue
        if host is not None and host not in (r.get("hosts") or ()):
            continue
        if error_class is not None:
            ec = _result_error_class(serve_dir, r["id"])
            if ec != error_class:
                continue
            r["error-class"] = ec
        out.append(r)
    out.sort(key=lambda r: (-(r.get("ts") or 0.0), r.get("id")))
    out = out[:max(0, int(limit))]
    if error_class is None:
        for r in out:
            ec = _result_error_class(serve_dir, r["id"])
            if ec:
                r["error-class"] = ec
    return out
