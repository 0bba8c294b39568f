"""Span tracer: where did the wall-clock go?

A copy of the reference's ``jepsen_tpu/obs/trace.py``: the same span
names, record layout, ``trace.jsonl`` and Chrome export.

A *span* is a named, attributed interval measured on the monotonic
clock (``time.monotonic_ns`` — wall-clock steps from a misbehaving NTP
daemon or a clock-scrambling nemesis must not corrupt the timeline the
tracer exists to explain). Spans nest per thread via a thread-local
stack, so a ``checker.segment`` span is parented under the serve
daemon's ``serve.request`` span automatically.

Recording is two-tier, mirroring the WAL's philosophy
(:mod:`jepsen_tpu_torch.journal`):

* an **in-memory ring** (bounded deque, ``JTPU_TRACE_RING`` entries,
  default 8192) always holds the most recent spans for in-process
  consumers (tests, the resilience supervisor's diagnostics);
* during a stored run, every finished span is also appended as one
  JSON line to ``trace.jsonl`` in the run directory — written with a
  single unbuffered write per span, so a SIGKILL loses at most the
  in-flight line and :func:`read_trace` tolerates the torn tail
  exactly like the WAL reader.

A record is ``{"name", "ts", "dur", "tid", "sid", "pid", ...attrs}``
with ``ts``/``dur`` in nanoseconds relative to the tracer's epoch.
:func:`to_chrome` converts a record list to Chrome trace-event JSON
(the ``traceEvents`` array form), which Perfetto and ``chrome://
tracing`` load directly; ``python -m jepsen_tpu_torch trace`` exports,
summarizes (:func:`summarize`, :func:`self_time_rollup`) and searches
it.

Request-scoped tracing rides a per-thread **trace context**
(:meth:`Tracer.set_context`): while a context is set, every span and
event recorded on that thread additionally carries a ``trace`` field
(the W3C-style 32-hex trace id) and — for root spans with no local
parent — a ``parent`` field naming the remote parent span id. The
serve daemon sets the context around each request's execution, ships
it in its request journal, and keeps it across a restart; the stitcher
(:func:`jepsen_tpu_torch.obs.fleet.stitch_request`) reassembles one
request's waterfall from the trace files. :func:`parse_traceparent` /
:func:`format_traceparent` speak the ``00-<trace>-<span>-<flags>``
header format.

Kill switch: ``JTPU_TRACE=0`` makes :func:`span`/:func:`event` return
shared no-op objects — no ring append, no file, no measurable work.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from jepsen_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger("jepsen.obs")

#: The trace artifact's filename inside a run's store directory.
TRACE_NAME = "trace.jsonl"

_SPANS_DROPPED = obs_metrics.counter(
    "jtpu_trace_spans_dropped_total",
    "spans evicted from the bounded in-memory ring (raise "
    "JTPU_TRACE_RING, or rely on trace.jsonl, which never drops)")

DEFAULT_RING = 8192


def enabled() -> bool:
    """Whether observability is on at all (JTPU_TRACE, default on).
    Shared by the tracer and the metrics artifacts: with it off, a run
    writes no trace.jsonl / metrics.json and behaves byte-for-byte like
    the pre-observability tree."""
    return os.environ.get("JTPU_TRACE", "1").lower() not in (
        "0", "false", "no", "off")


def ring_size() -> int:
    v = os.environ.get("JTPU_TRACE_RING")
    if not v:
        return DEFAULT_RING
    try:
        return max(16, int(v))
    except ValueError:
        log.warning("JTPU_TRACE_RING=%r is not an integer; using %s",
                    v, DEFAULT_RING)
        return DEFAULT_RING


class _NoopSpan:
    """The disabled-path span: a shared, attribute-dropping context
    manager so instrumented call sites cost a dict construction and
    nothing else when JTPU_TRACE=0."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NOOP_SPAN = _NoopSpan()


class _Span:
    """One live span. Use as a context manager; ``set(**attrs)`` adds
    attributes any time before exit (e.g. a result computed inside the
    block). An exception exiting the block is recorded as an ``error``
    attribute — the span still closes, so a crashed phase is visible in
    the waterfall instead of vanishing."""

    __slots__ = ("tracer", "name", "attrs", "sid", "pid", "tid", "t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> "_Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        tr = self.tracer
        self.sid = next(tr._ids)
        self.tid = threading.get_ident()
        stack = tr._stack()
        self.pid = stack[-1] if stack else 0
        stack.append(self.sid)
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, etype, evalue, tb):
        dur = time.monotonic_ns() - self.t0
        stack = self.tracer._stack()
        if stack and stack[-1] == self.sid:
            stack.pop()
        if etype is not None:
            self.attrs["error"] = f"{etype.__name__}: {evalue}"
        rec = {"name": self.name,
               "ts": self.t0 - self.tracer.epoch_ns,
               "dur": dur, "tid": self.tid, "sid": self.sid}
        if self.pid:
            rec["pid"] = self.pid
        ctx = self.tracer._ctx()
        if ctx["trace"] is not None:
            rec["trace"] = ctx["trace"]
            if not self.pid and ctx["parent"] is not None:
                # a context root: parent lives in another process
                rec["parent"] = ctx["parent"]
        if self.attrs:
            rec.update({k: v for k, v in self.attrs.items()
                        if k not in rec})
        self.tracer._record(rec)
        return False


class _CtxGuard:
    """Save/set/restore for a thread's trace context (the re-entrant
    form of :meth:`Tracer.set_context`)."""

    __slots__ = ("tracer", "trace", "parent", "_saved")

    def __init__(self, tracer: "Tracer", trace_id: Optional[str],
                 parent_span_id: Optional[str]):
        self.tracer = tracer
        self.trace = trace_id
        self.parent = parent_span_id

    def __enter__(self) -> "_CtxGuard":
        self._saved = self.tracer.current_context()
        self.tracer.set_context(self.trace, self.parent)
        return self

    def __exit__(self, *exc):
        self.tracer.set_context(*self._saved)
        return False


class Tracer:
    """Thread-safe span recorder: bounded ring plus an optional
    ``trace.jsonl`` sink. A sink write failure disables the sink (a run
    must never die because its telemetry file did) — visible via
    :attr:`failed` and a log line, like the WAL's contract."""

    def __init__(self, path: Optional[str] = None,
                 ring: Optional[int] = None):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=ring or ring_size())
        self._local = threading.local()
        self._ids = itertools.count(1)
        self.epoch_ns = time.monotonic_ns()
        self.recorded = 0
        self.dropped = 0
        self.failed: Optional[str] = None
        self._f = None
        self.path: Optional[str] = None
        if path:
            self.attach(path)

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = []
            self._local.stack = st
        return st

    def _ctx(self) -> dict:
        c = getattr(self._local, "ctx", None)
        if c is None:
            c = {"trace": None, "parent": None}
            self._local.ctx = c
        return c

    # -- trace context (request-scoped distributed tracing) -----------------

    def set_context(self, trace_id: Optional[str],
                    parent_span_id: Optional[str] = None) -> None:
        """Bind this THREAD's spans to one distributed trace: until
        cleared, every record gains ``trace=trace_id`` (and context
        roots gain ``parent=parent_span_id``). Thread-local by design —
        concurrent serve workers each carry their own request's id."""
        c = self._ctx()
        c["trace"], c["parent"] = trace_id, parent_span_id

    def clear_context(self) -> None:
        self.set_context(None, None)

    def current_context(self) -> Tuple[Optional[str], Optional[str]]:
        c = self._ctx()
        return c["trace"], c["parent"]

    def context(self, trace_id: Optional[str],
                parent_span_id: Optional[str] = None) -> "_CtxGuard":
        """``with tracer().context(tid):`` — set-and-restore, so nested
        request execution (e.g. a gang member re-run) can't leak its id
        onto the worker thread's later requests."""
        return _CtxGuard(self, trace_id, parent_span_id)

    # -- recording ----------------------------------------------------------

    def span(self, name: str, /, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def event(self, name: str, /, **attrs) -> None:
        """A zero-duration instant record (Chrome ``ph: "i"``)."""
        rec = {"name": name,
               "ts": time.monotonic_ns() - self.epoch_ns,
               "dur": 0, "tid": threading.get_ident(),
               "sid": next(self._ids)}
        stack = self._stack()
        if stack:
            rec["pid"] = stack[-1]
        ctx = self._ctx()
        if ctx["trace"] is not None:
            rec["trace"] = ctx["trace"]
            if not stack and ctx["parent"] is not None:
                rec["parent"] = ctx["parent"]
        if attrs:
            rec.update({k: v for k, v in attrs.items() if k not in rec})
        self._record(rec)

    def _record(self, rec: dict) -> None:
        line = None
        if self._f is not None and self.failed is None:
            line = json.dumps(rec, separators=(",", ":"),
                              default=repr).encode("utf-8") + b"\n"
        dropped = False
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                # the deque evicts its oldest record on this append
                self.dropped += 1
                dropped = True
            self._ring.append(rec)
            self.recorded += 1
            if line is not None and self._f is not None \
                    and self.failed is None:
                try:
                    # one unbuffered write per span: the kernel has the
                    # whole line, so a SIGKILL loses at most the span
                    # being written (read_trace drops the torn tail)
                    self._f.write(line)
                except OSError as e:
                    self.failed = f"{type(e).__name__}: {e}"
                    log.warning(
                        "trace sink %s failed (%s); tracing continues "
                        "in-memory only", self.path, self.failed)
        if dropped:
            _SPANS_DROPPED.inc()

    # -- sink lifecycle -----------------------------------------------------

    def attach(self, path: str) -> None:
        """Open (append) a trace.jsonl sink; replaces any current one."""
        with self._lock:
            self._detach_locked()
            try:
                self._f = open(path, "ab", buffering=0)
                self.path = path
                self.failed = None
            except OSError as e:
                log.warning("couldn't open trace sink %s: %s", path, e)
                self._f, self.path = None, None

    def _detach_locked(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
        self._f, self.path = None, None

    def detach(self) -> None:
        with self._lock:
            self._detach_locked()

    # -- reading ------------------------------------------------------------

    def spans(self) -> List[dict]:
        """A snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._ring)


# ---------------------------------------------------------------------------
# The process-global tracer (what the instrumentation uses)
# ---------------------------------------------------------------------------

_GLOBAL = Tracer()


def tracer() -> Tracer:
    return _GLOBAL


def span(name: str, /, **attrs):
    """``with span("checker.segment", level=...):`` — records into the
    global tracer, or a shared no-op when JTPU_TRACE=0."""
    if not enabled():
        return NOOP_SPAN
    return _GLOBAL.span(name, **attrs)


def event(name: str, /, **attrs) -> None:
    if enabled():
        _GLOBAL.event(name, **attrs)


def set_context(trace_id: Optional[str],
                parent_span_id: Optional[str] = None) -> None:
    """Bind the calling thread's spans to a distributed trace id on the
    global tracer (no-op storage when JTPU_TRACE=0 — nothing records
    anyway, but callers needn't gate)."""
    _GLOBAL.set_context(trace_id, parent_span_id)


def clear_context() -> None:
    _GLOBAL.clear_context()


def current_context() -> Tuple[Optional[str], Optional[str]]:
    return _GLOBAL.current_context()


def context(trace_id: Optional[str],
            parent_span_id: Optional[str] = None):
    """``with trace.context(tid):`` on the global tracer."""
    return _GLOBAL.context(trace_id, parent_span_id)


# ---------------------------------------------------------------------------
# W3C-style traceparent (00-<32 hex trace>-<16 hex span>-<2 hex flags>)
# ---------------------------------------------------------------------------


def new_trace_id() -> str:
    """A fresh 32-hex (128-bit) trace id."""
    return os.urandom(16).hex()


def parse_traceparent(header: Any) -> Optional[Tuple[str, str]]:
    """``traceparent`` header -> ``(trace_id, parent_span_id)``, or
    ``None`` for anything malformed (wrong field widths, non-hex,
    all-zero ids) — an invalid inbound header means *mint a fresh
    trace*, never a crash."""
    if not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    ver, tid, sid = parts[0], parts[1], parts[2]
    if len(ver) != 2 or len(tid) != 32 or len(sid) != 16:
        return None
    try:
        int(ver, 16), int(tid, 16), int(sid, 16)
    except ValueError:
        return None
    if tid == "0" * 32 or sid == "0" * 16:
        return None
    return tid, sid


def format_traceparent(trace_id: str, span_id: Any = None) -> str:
    """``(trace_id, span id)`` -> a traceparent header value. Span ids
    are the tracer's integer sids, rendered 16-hex; with none yet
    assigned (e.g. echoing at admission), a random non-zero id is
    minted — the spec forbids all-zero span ids."""
    if isinstance(span_id, str) and span_id:
        sid = span_id
    elif span_id:
        sid = f"{int(span_id) & (2 ** 64 - 1):016x}"
    else:
        sid = os.urandom(8).hex()
        if sid == "0" * 16:  # astronomically unlikely, spec-forbidden
            sid = "0" * 15 + "1"
    return f"00-{trace_id}-{sid}-01"


def start_run(store_dir: Optional[str]) -> None:
    """Attach the global tracer's file sink to a run's store directory
    (:func:`jepsen_tpu_torch.obs.start_run` calls this). No-op when
    disabled or dir-less — the ring keeps working either way."""
    if not store_dir or not enabled():
        return
    _GLOBAL.attach(os.path.join(store_dir, TRACE_NAME))


def finish_run() -> None:
    """Close the file sink (the ring survives for in-process readers)."""
    _GLOBAL.detach()


def sync_event() -> None:
    """Record a ``trace.sync`` wall-clock anchor (``wall_ns`` =
    ``time.time_ns()`` at a known monotonic ``ts``). Long-lived
    processes that share a trace (the serve daemon, fleet workers) emit
    one after attaching their sink so the stitcher can align their
    monotonic epochs exactly — same-machine processes share a wall
    clock even though each tracer's epoch differs."""
    if enabled():
        _GLOBAL.event("trace.sync", wall_ns=time.time_ns())


# ---------------------------------------------------------------------------
# Artifact reading + export
# ---------------------------------------------------------------------------


def read_trace(path: str) -> Tuple[List[dict], Dict[str, int]]:
    """Torn-tail-tolerant trace.jsonl reader (the WAL reader's contract:
    a run SIGKILLed mid-span-write leaves at most one partial final
    line, dropped silently as ``torn``; an undecodable *earlier* line is
    real corruption — skipped, counted, warned about). ``stats`` also
    counts the distinct request trace ids present (``traces``)."""
    stats = {"spans": 0, "torn": 0, "corrupt": 0, "traces": 0}
    with open(path, "rb") as f:
        data = f.read()
    lines = data.split(b"\n")
    terminated = data.endswith(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    out: List[dict] = []
    for i, line in enumerate(lines):
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict) or "name" not in rec \
                    or "ts" not in rec:
                raise ValueError("not a span record")
            out.append(rec)
            stats["spans"] += 1
        except (ValueError, TypeError):
            if i == len(lines) - 1 and not terminated:
                stats["torn"] += 1
            else:
                stats["corrupt"] += 1
                log.warning("trace %s: dropping corrupt record at "
                            "line %d", path, i + 1)
    stats["traces"] = len({r["trace"] for r in out if r.get("trace")})
    return out, stats


def by_trace(records: List[dict]) -> Dict[str, List[dict]]:
    """Group records by their request trace id (records without one —
    background daemon work — are omitted)."""
    out: Dict[str, List[dict]] = {}
    for r in records:
        t = r.get("trace")
        if t:
            out.setdefault(str(t), []).append(r)
    return out


#: Chrome trace-event metadata keys a span record maps onto directly;
#: everything else rides in ``args``.
_RESERVED = ("name", "ts", "dur", "tid", "sid", "pid")


def to_chrome(records: List[dict], process_name: str = "jtpu") -> dict:
    """Records -> Chrome trace-event JSON (object form). Loads in
    Perfetto (ui.perfetto.dev) and chrome://tracing. Complete events
    (``ph: "X"``) for spans, instants (``ph: "i"``) for zero-duration
    events; timestamps are microseconds as the format requires."""
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
        "args": {"name": process_name}}]
    for r in records:
        args = {k: v for k, v in r.items() if k not in _RESERVED}
        if "pid" in r:
            args["parent"] = r["pid"]
        ev = {"name": str(r.get("name", "?")), "cat": "jtpu",
              "pid": 1, "tid": int(r.get("tid", 0)),
              "ts": r.get("ts", 0) / 1e3, "args": args}
        if r.get("dur", 0) > 0:
            ev["ph"] = "X"
            ev["dur"] = r["dur"] / 1e3
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def summarize(records: List[dict],
              trace: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """Per-name rollup: count, total/max duration (ns) — the payload of
    ``trace summary`` and the ``# trace:`` recovery line. With
    ``trace``, rolls up only that request's spans."""
    if trace is not None:
        records = [r for r in records if r.get("trace") == trace]
    out: Dict[str, Dict[str, Any]] = {}
    for r in records:
        s = out.setdefault(str(r.get("name", "?")),
                           {"count": 0, "total-ns": 0, "max-ns": 0})
        s["count"] += 1
        d = int(r.get("dur", 0) or 0)
        s["total-ns"] += d
        s["max-ns"] = max(s["max-ns"], d)
    return dict(sorted(out.items()))


def self_time_rollup(records: List[dict],
                     trace: Optional[str] = None
                     ) -> Dict[str, Dict[str, Any]]:
    """Per-name SELF-time rollup: each span's duration minus its direct
    children's (via the ``pid`` parent link), so an outer span that
    merely contains a slow inner one stops dominating the table. The
    ``trace summary --top N`` payload: ``{name: {count, self-ns,
    p95-ns}}`` with p95 over the per-span self times. With ``trace``,
    restricted to one request's spans."""
    if trace is not None:
        records = [r for r in records if r.get("trace") == trace]
    child_ns: Dict[int, int] = {}
    for r in records:
        pid = r.get("pid")
        if pid:
            child_ns[pid] = child_ns.get(pid, 0) \
                + int(r.get("dur", 0) or 0)
    selves: Dict[str, List[int]] = {}
    for r in records:
        dur = int(r.get("dur", 0) or 0)
        if dur <= 0:
            continue
        own = max(0, dur - child_ns.get(r.get("sid"), 0))
        selves.setdefault(str(r.get("name", "?")), []).append(own)
    out: Dict[str, Dict[str, Any]] = {}
    for name, vals in selves.items():
        vals.sort()
        # nearest-rank p95: the smallest value covering 95% of spans
        idx = min(len(vals) - 1, max(0, -(-95 * len(vals) // 100) - 1))
        out[name] = {"count": len(vals), "self-ns": sum(vals),
                     "p95-ns": vals[idx]}
    return dict(sorted(out.items()))
