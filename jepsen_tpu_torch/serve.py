"""The check daemon: many tenants' histories, checked in gangs on the GPU.

Counterpart of ``jepsen_tpu/serve.py``'s check daemon (``ServeConfig``,
``CheckRequest``, ``CircuitBreaker``, ``TokenBucket``,
``RequestJournal``, ``BatchScheduler``, ``CheckDaemon``, the HTTP
handler and ``run_daemon``). One process keeps a warm engine
(:class:`jepsen_tpu_torch.checker.engine.Engine`: the kernel library and
each shape's buffers) and takes histories over HTTP:

* **Crash safety**: every accepted request is journaled (``serve.wal``,
  the CRC'd record format of :mod:`jepsen_tpu_torch.journal`, fsync per
  record) before it is queued; a restarted daemon replays the accepted
  requests that have no ``done`` record. A request's check is the offline
  one (``linearizable`` under ``check_safe``), so a served verdict equals
  an offline re-check of the journaled history.
* **Admission control**: a bounded queue and per-tenant quotas (429 with
  ``Retry-After``), an optional per-tenant token bucket, and a byte
  budget: each request's device footprint
  (:func:`jepsen_tpu_torch.checker.plan.request_footprint`) is summed over
  queued and running work against :func:`~jepsen_tpu_torch.checker.plan.
  plan_bytes_limit`.
* **Fair dequeue**: round robin across tenants, FIFO within one.
* **Concurrent batching**: queued requests of the leader's shape bucket
  (:meth:`Engine.bucket_key`) and model join its gang, up to
  ``batch_max`` members within ``batch_wait_ms``; the gang is searched as
  one batch (:func:`jepsen_tpu_torch.checker.gpu.check_packed_gang_gpu`):
  each level of every member is one launch of each kernel. A failing gang
  is bisected (:func:`jepsen_tpu_torch.resilience.bisect_poison`) down to
  its poison member, which alone fails and alone counts toward its
  bucket's breaker. Members the gang leaves UNKNOWN run again on the
  serial path.
* **Deadlines**: a request past its deadline answers ``":info/timeout"``.
  In a gang its lane is cancelled on the device at the next segment
  barrier while the others go on; alone, its search stops at the next
  segment barrier and releases the engine's lock, and the worker stops
  waiting for it at the deadline.
* **Per-bucket circuit breaker**: repeated OOM or wedge failures in one
  bucket open it (503 with ``Retry-After``) while others serve; after a
  jittered cooldown one probe is admitted.
* **Warm-state bound**: the engine keeps at most ``engine_max_buckets``
  warm buckets (LRU), freeing the evicted buckets' buffers.
* **Auth and drain**: an optional bearer token on ``POST /check``,
  ``POST /drain`` and the stream routes; a drain finishes the running
  work and the sealed streams' checks, and leaves the queued requests and
  the open streams journaled for the next incarnation.
* **Streams** (:mod:`jepsen_tpu_torch.stream`, imported only while
  ``JTPU_SERVE_STREAM`` is on): a client appends a history in sequenced,
  CRC'd chunks and an online check runs over its growing stable prefix,
  refuting an invalid prefix before the stream ends. Each session has its
  own WAL under ``streams/<sid>/``, replayed at start; appends answer 429
  when the ops not yet checked pass ``stream_buffer_ops`` or the session's
  footprint does not fit the byte budget.

HTTP API (:func:`make_handler`): ``POST /check`` (body ``{"tenant",
"model", "history": [op dicts], "deadline-s"?}``: 202 ``{"id", "state"}``,
400, 429, 503), ``GET /check/<id>`` (``{"state", "result"?}``; 500 for a
gang's poison member), ``POST /drain``, ``GET /healthz``; with streams
on, ``POST /stream`` (``{"tenant", "model"}``: 202 ``{"id", "state"}``,
400, 429, 503), ``POST /stream/<id>/ops`` (``{"seq", "ops", "crc"?}``:
202, 400, 404, 409 with the ``need``ed sequence number, 429, 503),
``POST /stream/<id>/close`` (``{"chunks"?}``: 200, 409) and ``GET
/stream/<id>`` (the session's status, with its ``result`` once done).

Telemetry, as the reference's daemon has it: ``GET /metrics`` (the
process's metrics registry in Prometheus text: the daemon's
``jtpu_serve_*`` families, latency histograms with trace-id exemplars,
and the device, search and engine families); the daemon's own
``trace.jsonl`` in its directory; a trace id for each request, taken
from a ``traceparent`` header or body field or made at admission,
journaled with the request and kept on replay, answered in a
``traceparent`` header; the request's phase breakdown (queue, coalesce,
compile, device, verdict) in ``GET /check/<id>``; admission refused with
429 ``headroom`` while the card's memory headroom is under
``headroom_min``; and warm buckets evicted while it is under
``engine_headroom_min``. ``JTPU_TRACE=0`` leaves out the trace ids, the
trace file and the phases.

Searches run on CUDA unless the configuration asks for the CPU
(``ServeConfig.device="cpu"``). Not ported: the fleet placer, the time
series, SLOs, usage metering, the flight recorder, the progress
heartbeat, the results browser, and the batch-verify mode.
"""

from __future__ import annotations

import hmac
import json
import logging
import os
import random
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from jepsen_tpu_torch import journal as journal_ns
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.obs import metrics as obs_metrics
from jepsen_tpu_torch.obs import trace as obs_trace

log = logging.getLogger("jepsen_tpu_torch.serve")

#: The request journal's filename inside the daemon directory.
WAL_NAME = "serve.wal"

#: Prometheus text exposition's content type.
PROMETHEUS_CTYPE = "text/plain; version=0.0.4; charset=utf-8"

# the reference daemon's families (jepsen_tpu/serve.py:110-168, 931)
_QUEUE_DEPTH = obs_metrics.gauge(
    "jtpu_serve_queue_depth",
    "requests queued (all tenants) in the check daemon")
_INFLIGHT = obs_metrics.gauge(
    "jtpu_serve_inflight", "requests currently being checked")
_ADMITTED = obs_metrics.counter(
    "jtpu_serve_admitted_total",
    "requests accepted past admission control, labeled tenant")
_REJECTED = obs_metrics.counter(
    "jtpu_serve_rejected_total",
    "requests refused by admission control, labeled reason "
    "(queue-full|tenant-quota|footprint|headroom|breaker-open|draining"
    "|rate-limited|bad-request|malformed)")
_COMPLETED = obs_metrics.counter(
    "jtpu_serve_completed_total",
    "requests checked to a verdict, labeled valid")
_TIMEOUTS = obs_metrics.counter(
    "jtpu_serve_deadline_timeouts_total",
    "requests answered :info/timeout by the per-request deadline")
_REPLAYED = obs_metrics.counter(
    "jtpu_serve_replayed_total",
    "journaled requests re-queued by restart replay")
_QUEUE_WAIT = obs_metrics.histogram(
    "jtpu_serve_queue_wait_seconds",
    "seconds a request spent queued before a worker picked it up",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
             60.0, 300.0))
_BATCH_SIZE = obs_metrics.histogram(
    "jtpu_serve_batch_size",
    "realized gang size per batched dispatch (1 = a request that "
    "found no same-bucket cohort inside the coalesce window)",
    buckets=(1, 2, 4, 8, 16, 32, 64))
_COALESCE_WAIT = obs_metrics.histogram(
    "jtpu_serve_batch_coalesce_wait_seconds",
    "seconds a gang leader spent coalescing cohort members before "
    "dispatch (bounded by --batch-wait-ms)",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5))
_BATCH_BISECTIONS = obs_metrics.counter(
    "jtpu_serve_batch_bisections_total",
    "gang splits performed by poison-request bisection after a failed "
    "batched device call")
_BATCH_POISON = obs_metrics.counter(
    "jtpu_serve_batch_poison_total",
    "requests isolated as the poison member of a failed gang, labeled "
    "tenant — only these count toward their bucket's circuit breaker")
_RATE_LIMITED = obs_metrics.counter(
    "jtpu_serve_rate_limited_total",
    "requests answered 429 by the per-tenant token bucket, labeled "
    "tenant")
_REQUEST_SECONDS = obs_metrics.histogram(
    "jtpu_serve_request_seconds",
    "end-to-end seconds from admission to verdict, labeled tenant")


def _exemplar(trace_id: Optional[str]) -> Optional[Dict[str, str]]:
    return {"trace_id": trace_id} if trace_id else None


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return int(v)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        return default


def _env_on(name: str, default: str) -> bool:
    return os.environ.get(name, default).strip().lower() not in (
        "0", "false", "no", "off")


def models() -> Dict[str, Any]:
    """Model name -> constructor, the names a request may give."""
    from jepsen_tpu_torch.models import (CASRegister, FIFOQueue, Mutex, NoOp,
                                         SetModel, UnorderedQueue)
    return {"cas-register": CASRegister, "mutex": Mutex, "set": SetModel,
            "unordered-queue": UnorderedQueue, "fifo-queue": FIFOQueue,
            "noop": NoOp}


@dataclass
class ServeConfig:
    """The daemon's settings; each default reads its ``JTPU_SERVE_*``
    environment variable."""

    root: str = "store/serve"          # WAL and result files
    workers: int = field(
        default_factory=lambda: _env_int("JTPU_SERVE_WORKERS", 1))
    queue_max: int = field(
        default_factory=lambda: _env_int("JTPU_SERVE_QUEUE", 64))
    tenant_max: int = field(
        default_factory=lambda: _env_int("JTPU_SERVE_TENANT_MAX", 16))
    deadline_s: Optional[float] = field(
        default_factory=lambda: _env_float(
            "JTPU_SERVE_DEADLINE_S", 0.0) or None)
    breaker_fails: int = field(
        default_factory=lambda: _env_int("JTPU_SERVE_BREAKER_FAILS", 3))
    breaker_cooldown_s: float = field(
        default_factory=lambda: _env_float(
            "JTPU_SERVE_BREAKER_COOLDOWN_S", 5.0))
    bytes_budget: Optional[int] = field(
        default_factory=lambda: _env_int(
            "JTPU_SERVE_BYTES_BUDGET", 0) or None)
    #: admission refuses (429 ``headroom``) while the card's memory
    #: headroom is under this ratio (0: off; none on the CPU)
    headroom_min: float = field(
        default_factory=lambda: _env_float("JTPU_SERVE_HEADROOM_MIN", 0.02))
    #: after each request, the stalest warm buckets are evicted while the
    #: card's headroom is under this ratio (0: off)
    engine_headroom_min: float = field(
        default_factory=lambda: _env_float("JTPU_ENGINE_HEADROOM_MIN", 0.0))
    warm: bool = field(
        default_factory=lambda: _env_on("JTPU_SERVE_WARM", "1"))
    warm_rungs: int = field(
        default_factory=lambda: _env_int("JTPU_SERVE_WARM_RUNGS", 1))
    #: "gpu": the device search (the host search only where it answers
    #: UNKNOWN); "cpu": the exact host search, with no gangs
    backend: str = field(
        default_factory=lambda: os.environ.get(
            "JTPU_SERVE_BACKEND", "gpu"))
    #: the device the searches run on: None means CUDA; "cpu" runs the
    #: kernels' plain versions and is used only when asked for
    device: Optional[str] = None
    #: JTPU_SERVE_BATCH=0 turns gangs off (every request runs alone)
    batch_enabled: bool = field(
        default_factory=lambda: _env_on("JTPU_SERVE_BATCH", "1"))
    batch_max: int = field(
        default_factory=lambda: _env_int("JTPU_SERVE_BATCH_MAX", 8))
    #: how long a gang's leader waits for members of its bucket
    batch_wait_ms: float = field(
        default_factory=lambda: _env_float(
            "JTPU_SERVE_BATCH_WAIT_MS", 5.0))
    #: bearer token for POST /check and POST /drain (None: no auth)
    auth_token: Optional[str] = field(
        default_factory=lambda: os.environ.get(
            "JTPU_SERVE_TOKEN") or None)
    #: LRU bound on the engine's warm buckets (0: no bound)
    engine_max_buckets: int = field(
        default_factory=lambda: _env_int("JTPU_ENGINE_MAX_BUCKETS", 0))
    #: per-tenant token bucket: requests/s sustained (0: off) and burst
    rate_limit: float = field(
        default_factory=lambda: _env_float("JTPU_SERVE_RATE", 0.0))
    rate_burst: int = field(
        default_factory=lambda: _env_int("JTPU_SERVE_RATE_BURST", 0))
    #: the stream routes and the online check (JTPU_SERVE_STREAM); off,
    #: the daemon has no stream route, directory or healthz key
    stream_enabled: bool = field(
        default_factory=lambda: _env_on("JTPU_SERVE_STREAM", "1"))
    #: how far past the next sequence number a chunk may come and still
    #: be buffered; past it the append answers 409 with ``need``
    stream_reorder: int = field(
        default_factory=lambda: _env_int("JTPU_SERVE_STREAM_REORDER", 64))
    #: ops a stream may hold past its checked stable prefix before its
    #: appends answer 429
    stream_buffer_ops: int = field(
        default_factory=lambda: _env_int("JTPU_SERVE_STREAM_BUFFER",
                                         250000))
    #: streams open at once (each has a runner thread); past it an open
    #: answers 429
    stream_max: int = field(
        default_factory=lambda: _env_int("JTPU_SERVE_STREAM_MAX", 8))

    @property
    def stream_on(self) -> bool:
        """Whether the stream routes exist, read at call time:
        JTPU_SERVE_STREAM=0 wins over ``stream_enabled``."""
        if os.environ.get("JTPU_SERVE_STREAM", "").strip() == "0":
            return False
        return bool(self.stream_enabled)


@dataclass
class CheckRequest:
    """One tenant's history; ``history`` stays raw op dicts, so the
    journal record is the request."""

    id: str
    tenant: str
    model: str
    history: list
    deadline_s: Optional[float] = None
    state: str = "queued"              # queued | running | done
    submitted: float = field(default_factory=time.time)
    queued_at: float = field(default_factory=time.monotonic)
    result: Optional[Dict[str, Any]] = None
    bucket: Optional[tuple] = None
    footprint: Optional[int] = None
    dims: Optional[Any] = None         # plan.PlanDims, to price a gang
    probe: bool = False                # a half-open breaker's probe
    started_at: Optional[float] = None  # monotonic, set at dequeue
    trace: Optional[str] = None        # the request's trace id
    trace_parent: Optional[str] = None  # the inbound traceparent's span
    coalesce_s: float = 0.0            # a gang leader's gather wait

    def public(self) -> Dict[str, Any]:
        doc = {"id": self.id, "tenant": self.tenant,
               "model": self.model, "state": self.state,
               "submitted": self.submitted}
        if self.trace:
            doc["trace"] = self.trace
        if self.bucket is not None:
            doc["bucket"] = list(self.bucket)
        if self.footprint is not None:
            doc["predicted-bytes"] = self.footprint
        if self.result is not None:
            doc["result"] = self.result
        return doc


class CircuitBreaker:
    """Per shape bucket: ``closed`` serves, ``open`` rejects with the
    remaining cooldown as ``Retry-After``, ``half-open`` admits one probe.
    Only OOM and wedge failures (the daemon files its timeouts as wedge)
    count; an invalid history is a verdict, not a fault, and a retryable
    class is neutral."""

    MAX_COOLDOWN_S = 300.0

    def __init__(self, fails: int, cooldown_s: float,
                 rng: Optional[random.Random] = None):
        self.fails = max(1, int(fails))
        self.cooldown_s = float(cooldown_s)
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        #: bucket -> {"state", "fails", "until", "cooldown", "probing"}
        self._b: Dict[tuple, Dict[str, Any]] = {}

    def _rec(self, bucket: tuple) -> Dict[str, Any]:
        rec = self._b.get(bucket)
        if rec is None:
            rec = self._b[bucket] = {
                "state": "closed", "fails": 0, "until": 0.0,
                "cooldown": self.cooldown_s, "probing": False}
        return rec

    def allow(self, bucket: Optional[tuple]
              ) -> Tuple[bool, Optional[float], bool]:
        """(admit?, retry_after_s, is_probe) for a new request in this
        bucket; an open breaker whose cooldown passed turns half-open and
        admits one probe."""
        if bucket is None:
            return True, None, False
        now = time.monotonic()
        with self._lock:
            rec = self._rec(bucket)
            if rec["state"] == "closed":
                return True, None, False
            if rec["state"] == "open":
                if now < rec["until"]:
                    return False, max(rec["until"] - now, 0.1), False
                rec["state"] = "half-open"
                rec["probing"] = False
            if rec["probing"]:
                return False, rec["cooldown"] / 2, False
            rec["probing"] = True
            return True, None, True

    def record(self, bucket: Optional[tuple], failure_class: Optional[str],
               probe: bool) -> None:
        """Account one finished request: an OOM or wedge counts toward
        the trip threshold (and re-opens a half-open breaker with doubled
        cooldown); a success resets."""
        if bucket is None:
            return
        from jepsen_tpu_torch.resilience import OOM, RETRYABLE, WEDGE
        now = time.monotonic()
        with self._lock:
            rec = self._rec(bucket)
            if failure_class in RETRYABLE:
                rec["probing"] = False
            elif failure_class in (OOM, WEDGE):
                rec["fails"] += 1
                if rec["state"] == "half-open" or \
                        rec["fails"] >= self.fails:
                    if rec["state"] == "half-open":
                        rec["cooldown"] = min(rec["cooldown"] * 2,
                                              self.MAX_COOLDOWN_S)
                    # jittered, so that tenants in step do not all hit the
                    # half-open probe at once
                    jit = 0.75 + self._rng.random() / 2
                    rec.update(state="open", probing=False,
                               until=now + rec["cooldown"] * jit)
                    log.warning("breaker OPEN for bucket %s (%s, cooldown "
                                "%.1fs)", bucket, failure_class,
                                rec["cooldown"])
            else:
                rec.update(state="closed", fails=0, probing=False,
                           cooldown=self.cooldown_s, until=0.0)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        now = time.monotonic()
        with self._lock:
            return {"/".join(str(x) for x in b): {
                        "state": r["state"], "fails": r["fails"],
                        "cooldown-s": round(r["cooldown"], 3),
                        "retry-in-s": (round(max(r["until"] - now, 0), 3)
                                       if r["state"] == "open" else None)}
                    for b, r in self._b.items()}


class TokenBucket:
    """A tenant's admission rate: ``rate`` tokens a second, refilled
    lazily up to ``burst``. :meth:`take` returns 0.0 on admit, else the
    seconds until a token frees. Callers hold the daemon's lock."""

    def __init__(self, rate: float, burst: float):
        self.rate = max(1e-9, float(rate))
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self._t = time.monotonic()

    def take(self) -> float:
        now = time.monotonic()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._t) * self.rate)
        self._t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / self.rate


class RequestJournal:
    """The append-only request WAL (``serve.wal``): one CRC'd record per
    event, synced to the disk before :meth:`append` returns; a write that
    fails raises, so a request is never acknowledged unjournaled."""

    def __init__(self, path: str):
        self.path = path
        self._w = journal_ns.JsonRecordWriter(path, fsync=True)

    def append(self, doc: dict) -> None:
        self._w.append(doc)
        if self._w.failed is not None:
            raise OSError(f"request journal {self.path}: {self._w.failed}")

    def close(self) -> None:
        self._w.close()

    @staticmethod
    def replay(path: str) -> Tuple[list, dict]:
        """The requests a previous incarnation accepted and never
        finished (``accepted`` records with no ``done`` or ``dropped``),
        in acceptance order, and the reader's stats."""
        if not os.path.exists(path):
            return [], {"records": 0, "torn": 0, "corrupt": 0}
        records, stats = journal_ns.read_json_records(path)
        accepted: "OrderedDict[str, dict]" = OrderedDict()
        for r in records:
            ev, rid = r.get("event"), r.get("id")
            if not rid:
                continue
            if ev == "accepted":
                accepted[rid] = r
            elif ev in ("done", "dropped"):
                accepted.pop(rid, None)
        return list(accepted.values()), stats


class BatchScheduler:
    """Forms gangs: the worker that dequeued a request (the leader) takes
    queued requests of the leader's bucket and model from the heads of the
    tenant queues, round robin, up to ``batch_max`` members, the members
    the byte budget can hold (:func:`plan.gang_footprint`), and the wait
    ``wait_s``."""

    def __init__(self, daemon: "CheckDaemon", batch_max: int,
                 wait_s: float):
        self.daemon = daemon
        self.batch_max = max(1, int(batch_max))
        self.wait_s = max(0.0, float(wait_s))

    def max_fit(self, leader: CheckRequest) -> int:
        """The largest gang of the leader's dims that fits the budget."""
        from jepsen_tpu_torch.checker import plan
        n = self.batch_max
        budget = self.daemon._budget()
        if budget and leader.dims is not None:
            while n > 1:
                gfp = plan.gang_footprint(leader.dims, n,
                                          self.daemon.device)
                if gfp is None or gfp <= budget:
                    break
                n -= 1
        return n

    def gather(self, leader: CheckRequest) -> list:
        """The leader's gang: ``[leader]`` alone when it has no bucket or
        the daemon is draining, else the leader and the members that came
        within the wait."""
        d = self.daemon
        gang = [leader]
        if (leader.bucket is None or self.batch_max <= 1
                or d.draining or d._stop.is_set()):
            return gang
        limit = self.max_fit(leader)
        t0 = time.monotonic()
        deadline = t0 + self.wait_s
        while len(gang) < limit:
            nxt = d._take_matching(leader)
            if nxt is not None:
                gang.append(nxt)
                continue
            now = time.monotonic()
            if now >= deadline or d.draining or d._stop.is_set():
                break
            with d._work:
                d._work.wait(timeout=min(deadline - now, 0.05))
        leader.coalesce_s = time.monotonic() - t0
        _COALESCE_WAIT.observe(leader.coalesce_s, tenant=leader.tenant,
                               exemplar=_exemplar(leader.trace))
        _BATCH_SIZE.observe(len(gang))
        return gang


class CheckDaemon:
    """The queue, the workers, the journal and admission, behind the HTTP
    handler. :meth:`start` replays the journal and starts the workers;
    :meth:`drain` and :meth:`stop` end it."""

    def __init__(self, config: Optional[ServeConfig] = None):
        from jepsen_tpu_torch.checker import gpu as G
        from jepsen_tpu_torch.checker.engine import default_engine
        self.config = config or ServeConfig()
        if self.config.backend not in ("gpu", "cpu"):
            raise ValueError(f"unknown backend {self.config.backend!r}")
        #: the searches' device (None unless the device search serves)
        self.device = (G.resolve_device(self.config.device)
                       if self.config.backend == "gpu" else None)
        os.makedirs(self.config.root, exist_ok=True)
        # the process's engine, which the check path uses: warming it is
        # warming the buffers the requests run on
        self.engine = default_engine()
        self.journal = RequestJournal(
            os.path.join(self.config.root, WAL_NAME))
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queues: Dict[str, deque] = {}
        self._rr: deque = deque()            # tenant round-robin order
        self._by_id: Dict[str, CheckRequest] = {}
        self._inflight: Dict[str, CheckRequest] = {}
        self._seq = 0
        self._depth = 0
        self._footprint_committed = 0        # queued + running bytes
        self.draining = False
        self.drained = threading.Event()
        self._stop = threading.Event()
        self._threads: list = []
        self._started = time.time()
        self._service_ewma: Optional[float] = None
        self.stats = {"admitted": 0, "rejected": 0, "completed": 0,
                      "timeouts": 0, "replayed": 0, "batches": 0,
                      "max-batch": 0, "bisections": 0, "poisoned": 0,
                      "rate-limited": 0}
        self._rate: Dict[str, TokenBucket] = {}
        self.replay_stats: Dict[str, Any] = {}
        self.breaker = CircuitBreaker(self.config.breaker_fails,
                                      self.config.breaker_cooldown_s)
        self.batcher = (BatchScheduler(self, self.config.batch_max,
                                       self.config.batch_wait_ms / 1000.0)
                        if self.config.batch_enabled
                        and self.config.batch_max > 1 else None)
        if self.config.engine_max_buckets > 0:
            self.engine.set_max_warm_buckets(self.config.engine_max_buckets)
        self._trace_path: Optional[str] = None
        #: stream sessions by id (a slot reserved by an open in progress
        #: holds None); None while streaming is off, and then
        #: jepsen_tpu_torch.stream is never imported
        self._streams: Optional[Dict[str, Any]] = (
            {} if self.config.stream_on else None)
        self._stream_seq = 0

    # -- planning -----------------------------------------------------------

    def _plan_request(self, model_name: str, h: History
                      ) -> Tuple[Optional[tuple], Optional[int],
                                 Optional[Any]]:
        """(bucket, footprint bytes, plan dims) of a request; all None
        when it will not reach the device (the host search serves it, and
        it commits no device bytes)."""
        if self.device is None:
            return None, None, None
        from jepsen_tpu_torch.checker import plan
        from jepsen_tpu_torch.ops.encode import pack_with_init
        try:
            pk = pack_with_init(h, models()[model_name]())
        except ValueError:
            return None, None, None
        if pk is None:
            return None, None, None
        packed, kernel = pk
        dims = plan.PlanDims.from_packed(packed)
        return (self.engine.bucket_key(packed, kernel),
                plan.request_footprint(dims, self.device), dims)

    def _budget(self) -> Optional[int]:
        from jepsen_tpu_torch.checker import plan
        if self.config.bytes_budget:
            return self.config.bytes_budget
        return None if self.device is None else plan.plan_bytes_limit(
            self.device)

    def _retry_after(self) -> float:
        """Seconds until a queue slot should free: the service-time EWMA
        (seconds a request) times the depth over the workers, within
        [1, 60]."""
        with self._lock:
            depth = self._depth + len(self._inflight)
            ewma = self._service_ewma
        est = (ewma or 1.0) * max(depth, 1) / max(self.config.workers, 1)
        return float(min(max(est, 1.0), 60.0))

    # -- admission ----------------------------------------------------------

    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.stats[key] += n

    def submit(self, doc: Dict[str, Any], replayed: bool = False
               ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        """Admission-controlled enqueue: ``(http_status, body,
        headers)``; 202 means journaled and queued."""
        def reject(code: int, reason: str, retry: Optional[float] = None,
                   **extra):
            if not replayed:
                self._bump("rejected")
                _REJECTED.inc(reason=reason)
            hdrs = {}
            if retry is not None:
                hdrs["Retry-After"] = str(max(1, int(round(retry))))
            body = {"error": reason, **extra}
            if retry is not None:
                body["retry-after-s"] = round(retry, 3)
            return code, body, hdrs

        if self.draining:
            return reject(503, "draining", retry=30.0)
        tenant = str(doc.get("tenant") or "default")
        model_name = str(doc.get("model") or "cas-register")
        ops = doc.get("history")
        if model_name not in models():
            return reject(400, "bad-request",
                          detail=f"unknown model {model_name!r}")
        if not isinstance(ops, list) or not ops:
            return reject(400, "bad-request",
                          detail="history must be a non-empty list of op "
                                 "dicts")
        deadline = doc.get("deadline-s", self.config.deadline_s)
        try:
            deadline = float(deadline) if deadline else None
        except (TypeError, ValueError):
            return reject(400, "bad-request", detail="bad deadline-s")
        # the structural gate before journaling: a malformed history is a
        # 400 with rule ids now, not an UNKNOWN verdict later
        try:
            h = History.of(ops)
        except (TypeError, ValueError, KeyError) as e:
            return reject(400, "malformed", detail=str(e))
        from jepsen_tpu_torch.analysis import summarize
        from jepsen_tpu_torch.analysis.history_lint import (errors,
                                                            lint_history)
        errs = errors(lint_history(h))
        if errs:
            return reject(400, "malformed", lint=summarize(errs),
                          detail=errs[0].format())
        bucket, footprint, dims = None, None, None
        try:
            bucket, footprint, dims = self._plan_request(model_name, h)
        except Exception as e:  # noqa: BLE001 -- pricing is advisory
            log.warning("request planning failed (%s); admitting on depth "
                        "alone", e)
        probe = False
        if not replayed:
            # replayed requests were admitted by a previous incarnation
            # and are owed a verdict: they skip these checks
            if self.config.rate_limit > 0:
                with self._lock:
                    tb = self._rate.get(tenant)
                    if tb is None:
                        burst = self.config.rate_burst or max(
                            1, int(round(self.config.rate_limit)))
                        tb = self._rate[tenant] = TokenBucket(
                            self.config.rate_limit, burst)
                    wait = tb.take()
                if wait > 0.0:
                    self._bump("rate-limited")
                    _RATE_LIMITED.inc(tenant=tenant)
                    return reject(429, "rate-limited", retry=wait,
                                  tenant=tenant)
            ok, retry, probe = self.breaker.allow(bucket)
            if not ok:
                return reject(503, "breaker-open", retry=retry,
                              bucket=list(bucket))
            with self._lock:
                depth = self._depth
                tdepth = len(self._queues.get(tenant, ()))
                committed = self._footprint_committed
            if depth >= self.config.queue_max:
                return reject(429, "queue-full", retry=self._retry_after(),
                              depth=depth)
            if tdepth >= self.config.tenant_max:
                return reject(429, "tenant-quota",
                              retry=self._retry_after(), tenant=tenant,
                              depth=tdepth)
            budget = self._budget()
            if budget and footprint and committed + footprint > budget:
                return reject(429, "footprint", retry=self._retry_after(),
                              **{"predicted-bytes": footprint,
                                 "committed-bytes": committed,
                                 "budget-bytes": budget})
            if self.config.headroom_min > 0 and self.device is not None:
                from jepsen_tpu_torch.obs import devices as obs_devices
                head = obs_devices.headroom_ratio(device=self.device)
                if head is not None and head < self.config.headroom_min:
                    return reject(429, "headroom",
                                  retry=self._retry_after(),
                                  headroom=round(head, 4))
        with self._lock:
            self._seq += 1
            rid = doc.get("id") if replayed else None
            rid = rid or f"r{self._seq:06d}-{os.getpid()}"
        # the trace id: a replayed request keeps its journaled one, else
        # an inbound traceparent's, else a new one; none with tracing off
        trace_id, trace_parent = None, None
        if obs_trace.enabled():
            tp = obs_trace.parse_traceparent(doc.get("traceparent"))
            if replayed and doc.get("trace"):
                trace_id = str(doc["trace"])
                trace_parent = (str(doc["trace-parent"])
                                if doc.get("trace-parent") else None)
            elif tp is not None:
                trace_id, trace_parent = tp
            else:
                trace_id = obs_trace.new_trace_id()
        req = CheckRequest(id=rid, tenant=tenant, model=model_name,
                           history=ops, deadline_s=deadline, bucket=bucket,
                           footprint=footprint, dims=dims, probe=probe,
                           trace=trace_id, trace_parent=trace_parent)
        if not replayed:
            rec = {"event": "accepted", "id": req.id, "tenant": tenant,
                   "model": model_name, "deadline-s": deadline,
                   "ts": req.submitted, "history": ops}
            if trace_id:
                rec["trace"] = trace_id
                if trace_parent:
                    rec["trace-parent"] = trace_parent
            self.journal.append(rec)
        with self._work:
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
                self._rr.append(tenant)
            q.append(req)
            self._by_id[req.id] = req
            self._depth += 1
            if footprint:
                self._footprint_committed += footprint
            if not replayed:
                self.stats["admitted"] += 1
            depth = self._depth
            self._work.notify()
        _QUEUE_DEPTH.set(depth)
        if not replayed:
            _ADMITTED.inc(tenant=tenant)
        body = {"id": req.id, "state": "queued", "tenant": tenant}
        if bucket is not None:
            body["bucket"] = list(bucket)
        hdrs: Dict[str, str] = {}
        if req.trace:
            body["trace"] = req.trace
            hdrs["traceparent"] = obs_trace.format_traceparent(req.trace)
        return 202, body, hdrs

    # -- the worker side ----------------------------------------------------

    def _running(self, req: CheckRequest) -> CheckRequest:
        """Mark a request just taken off its queue as running (caller
        holds the lock)."""
        self._depth -= 1
        req.state = "running"
        req.started_at = time.monotonic()
        self._inflight[req.id] = req
        _QUEUE_DEPTH.set(self._depth)
        _INFLIGHT.set(len(self._inflight))
        return req

    def _dequeue(self) -> Optional[CheckRequest]:
        """Fair dequeue: rotate the tenant ring, FIFO within a tenant.
        Blocks until work arrives; None once stopping or draining (the
        queued remainder stays journaled)."""
        with self._work:
            while True:
                if self._stop.is_set() or self.draining:
                    return None
                for _ in range(len(self._rr)):
                    t = self._rr[0]
                    self._rr.rotate(-1)
                    q = self._queues.get(t)
                    if q:
                        return self._running(q.popleft())
                self._work.wait(timeout=0.5)

    def _take_matching(self, leader: CheckRequest
                       ) -> Optional[CheckRequest]:
        """One queued request that can join the leader's gang: the same
        bucket and model, taken from a tenant queue's head only (rotating
        the ring as :meth:`_dequeue` does), so the fill is tenant-fair and
        each tenant's order is kept. None when no head matches now."""
        with self._work:
            if self._stop.is_set() or self.draining:
                return None
            for _ in range(len(self._rr)):
                t = self._rr[0]
                self._rr.rotate(-1)
                q = self._queues.get(t)
                if q and q[0].bucket == leader.bucket \
                        and q[0].model == leader.model:
                    return self._running(q.popleft())
        return None

    def _check(self, req: CheckRequest,
               deadline: Optional[float] = None) -> Dict[str, Any]:
        """One request through the offline path (``linearizable`` under
        ``check_safe``), so that a served verdict and an offline re-check
        of the journaled history are one computation. ``deadline`` (a
        ``time.monotonic()`` instant) stops the device search at its next
        segment barrier."""
        from jepsen_tpu_torch.checker import check_safe
        from jepsen_tpu_torch.checker.wgl import linearizable
        from jepsen_tpu_torch.ops.encode import pack_with_init
        model = models()[req.model]()
        checker = linearizable(model, backend=self.config.backend,
                               device=self.device)
        h = History.of(req.history)
        if self.config.warm and req.bucket is not None:
            # a request has a bucket only when it packed at admission
            self._warm(pack_with_init(h, model))
        opts = {"deadline": deadline} if deadline is not None else {}
        return check_safe(checker, {"name": f"serve-{req.id}"}, h, opts)

    def _warm(self, pk: tuple) -> None:
        """Warm the bucket of a (packed history, kernel) pair."""
        try:
            self.engine.warm(pk[0], pk[1], rungs=self.config.warm_rungs,
                             device=self.device)
        except Exception as e:  # noqa: BLE001 -- warming is advisory
            log.warning("bucket warm failed (%s); checking cold", e)

    @staticmethod
    def _trace_phases(trace_id: Optional[str]) -> Tuple[float, float]:
        """(compile_s, device_s) of one trace id from the tracer's ring:
        ``engine.warm`` spans are compile time; the device spans
        (``checker.segment``, ``checker.device.*``) split by their
        ``phase``, except those under a warm span. The two families never
        nest in each other, so nothing counts twice."""
        comp = dev = 0.0
        if not trace_id:
            return comp, dev
        recs = [r for r in obs_trace.tracer().spans()
                if r.get("trace") == trace_id]
        parent = {r.get("sid"): r.get("pid") for r in recs}
        warm_sids = {r.get("sid") for r in recs
                     if r.get("name") == "engine.warm"}

        def under_warm(rec: dict) -> bool:
            sid, hops = rec.get("pid"), 0
            while sid and hops < 64:
                if sid in warm_sids:
                    return True
                sid, hops = parent.get(sid), hops + 1
            return False

        for rec in recs:
            name = str(rec.get("name", ""))
            dur = int(rec.get("dur", 0) or 0) / 1e9
            if name == "engine.warm":
                comp += dur
                continue
            if name != "checker.segment" \
                    and not name.startswith("checker.device."):
                continue
            if under_warm(rec):
                continue
            if rec.get("phase") == "compile":
                comp += dur
            elif rec.get("phase") == "execute":
                dev += dur
        return comp, dev

    def _phase_doc(self, req: CheckRequest, queue_s: float, secs: float,
                   extra_trace: Optional[str] = None) -> Dict[str, float]:
        """The request's phase breakdown (``GET /check/<id>``): queue and
        coalesce from the scheduler's clocks, compile and device from the
        request's spans (and a gang leader's, ``extra_trace``), verdict
        the rest of the service time."""
        comp, dev = self._trace_phases(req.trace)
        if extra_trace and extra_trace != req.trace:
            c2, d2 = self._trace_phases(extra_trace)
            comp, dev = comp + c2, dev + d2
        return {"queue_s": round(queue_s, 6),
                "coalesce_s": round(req.coalesce_s or 0.0, 6),
                "compile_s": round(comp, 6),
                "device_s": round(dev, 6),
                "verdict_s": round(max(0.0, secs - comp - dev), 6)}

    def _run_one(self, req: CheckRequest) -> None:
        from jepsen_tpu_torch.resilience import WEDGE, result_failure_class
        queue_s = time.monotonic() - req.queued_at
        _QUEUE_WAIT.observe(queue_s, tenant=req.tenant,
                            exemplar=_exemplar(req.trace))
        t0 = time.monotonic()
        box: Dict[str, Any] = {}
        timed_out = False
        with obs_trace.context(req.trace, req.trace_parent), \
                obs_trace.span("serve.request", id=req.id,
                               tenant=req.tenant, model=req.model,
                               queue_s=round(queue_s, 6)):
            if req.deadline_s:
                # the worker stops waiting at the deadline; the search
                # itself stops at its next segment barrier and releases
                # the engine
                deadline = t0 + req.deadline_s
                ctx = obs_trace.current_context()

                def checked():
                    # the search's spans join the request's trace
                    obs_trace.set_context(*ctx)
                    box.update(r=self._check(req, deadline))

                worker = threading.Thread(
                    target=checked, daemon=True,
                    name=f"jtpu-serve-check-{req.id}")
                worker.start()
                worker.join(req.deadline_s)
                timed_out = worker.is_alive() or (
                    box.get("r", {}).get("error") == ":info/timeout")
            else:
                box["r"] = self._check(req)
        if timed_out:
            result = {"valid": "unknown", "error": ":info/timeout",
                      "deadline-s": req.deadline_s, "error-class": WEDGE}
            self._bump("timeouts")
            _TIMEOUTS.inc()
        else:
            result = box.get("r") or {"valid": "unknown",
                                      "error": "worker died"}
        secs = time.monotonic() - t0
        result = dict(result)
        result["serve"] = {"id": req.id, "tenant": req.tenant,
                           "seconds": secs, "timed-out": timed_out}
        if req.trace:
            result["serve"]["trace"] = req.trace
            result["serve"]["phases"] = self._phase_doc(req, queue_s, secs)
        self.breaker.record(req.bucket, result_failure_class(result),
                            req.probe)
        self._finish(req, result, secs)

    def _run_gang(self, gang: list) -> None:
        """Search a gang as one batch under poison bisection. Members the
        gang leaves UNKNOWN (other than by their deadline) run again on
        the serial path, so every verdict is one the serial daemon would
        give."""
        from jepsen_tpu_torch.checker import UNKNOWN
        from jepsen_tpu_torch.checker import gpu as G
        from jepsen_tpu_torch.ops.encode import pack_with_init
        from jepsen_tpu_torch.resilience import (bisect_poison,
                                                 result_failure_class)
        t0 = time.monotonic()
        leader = gang[0]
        queue_s = []
        for req in gang:
            w = t0 - req.queued_at
            queue_s.append(w)
            _QUEUE_WAIT.observe(w, tenant=req.tenant,
                                exemplar=_exemplar(req.trace))
        # the gang runs under its leader's trace; each member's trace
        # gets an event naming it
        if leader.trace:
            for i, req in enumerate(gang[1:], start=1):
                if req.trace:
                    with obs_trace.context(req.trace, req.trace_parent):
                        obs_trace.event("serve.gang.join", id=req.id,
                                        leader=leader.trace,
                                        size=len(gang), index=i)
        # the membership is journaled before the search: a crash mid-gang
        # replays every member (none has a done record); replay ignores
        # this record, which has no id
        self.journal.append({
            "event": "gang", "ids": [r.id for r in gang],
            "tenants": [r.tenant for r in gang],
            "bucket": list(gang[0].bucket or ()), "ts": time.time()})
        with self._lock:
            self.stats["batches"] += 1
            self.stats["max-batch"] = max(self.stats["max-batch"],
                                          len(gang))
        model = models()[gang[0].model]()
        packs = []
        try:
            for req in gang:
                pk = pack_with_init(History.of(req.history), model)
                if pk is None:
                    raise ValueError("model has no word kernel")
                packs.append(pk)
        except ValueError as e:
            log.warning("gang pack failed (%s); running %d member(s) "
                        "alone", e, len(gang))
            for req in gang:
                self._run_one(req)
            return
        kernel = packs[0][1]
        if self.config.warm:
            self._warm(packs[0])
        now = time.monotonic()
        deadlines = [(now + req.deadline_s) if req.deadline_s else None
                     for req in gang]

        def run_gang(span):
            return G.check_packed_gang_gpu(
                [packs[i][0] for i in span], kernel,
                deadlines=[deadlines[i] for i in span], device=self.device)

        with obs_trace.context(leader.trace, leader.trace_parent), \
                obs_trace.span("serve.gang", id=leader.id, size=len(gang)):
            results, poison, bisections = bisect_poison(
                list(range(len(gang))), run_gang)
        poison_set = set(poison)
        if bisections:
            self._bump("bisections", bisections)
            _BATCH_BISECTIONS.inc(bisections)
        for i, r in enumerate(results):
            if i not in poison_set and (
                    not isinstance(r, dict)
                    or (r.get("valid") is UNKNOWN
                        and r.get("error") != ":info/timeout")):
                results[i] = self._check(gang[i])
        secs = time.monotonic() - t0
        # survivors first (each resets its bucket's fail count), poison
        # last: a gang with one poison member moves its bucket's breaker
        # by exactly one failure
        order = ([i for i in range(len(gang)) if i not in poison_set]
                 + list(poison))
        gang_ids = [r.id for r in gang]
        for i in order:
            req = gang[i]
            result = dict(results[i])
            timed_out = result.get("error") == ":info/timeout"
            if timed_out:
                result.setdefault("deadline-s", req.deadline_s)
                self._bump("timeouts")
                _TIMEOUTS.inc()
            result["serve"] = {
                "id": req.id, "tenant": req.tenant, "seconds": secs,
                "timed-out": timed_out,
                "gang": {"size": len(gang), "index": i,
                         "bisections": bisections,
                         "poison": i in poison_set}}
            if req.trace:
                result["serve"]["trace"] = req.trace
                result["serve"]["phases"] = self._phase_doc(
                    req, queue_s[i], secs, extra_trace=leader.trace)
            if i in poison_set:
                self._bump("poisoned")
                _BATCH_POISON.inc(tenant=req.tenant)
            self.breaker.record(req.bucket, result_failure_class(result),
                                req.probe)
            self._finish(req, result, secs, batch_size=len(gang),
                         gang=gang_ids)

    def _finish(self, req: CheckRequest, result: Dict[str, Any],
                secs: float, batch_size: int = 1,
                gang: Optional[list] = None) -> None:
        # the result file first (tmp + replace), then the done record: a
        # crash between them runs the request again, never loses it
        path = os.path.join(self.config.root, f"{req.id}.json")
        tmp = os.path.join(self.config.root,
                           f".{req.id}.json.tmp.{os.getpid()}")
        try:
            with open(tmp, "w") as f:
                json.dump(result, f, default=repr)
            os.replace(tmp, path)
        except OSError as e:
            log.warning("couldn't persist result for %s: %s", req.id, e)
        done = {"event": "done", "id": req.id,
                "valid": repr(result.get("valid")), "seconds": secs}
        if gang is not None:
            done["gang"] = list(gang)
        self.journal.append(done)
        _REQUEST_SECONDS.observe(time.monotonic() - req.queued_at,
                                 tenant=req.tenant,
                                 exemplar=_exemplar(req.trace))
        _COMPLETED.inc(valid=str(result.get("valid")))
        if req.trace and obs_trace.enabled():
            with obs_trace.context(req.trace, req.trace_parent):
                obs_trace.event("serve.verdict", id=req.id,
                                valid=repr(result.get("valid")),
                                seconds=round(secs, 6))
        with self._work:
            req.result = result
            req.state = "done"
            self._inflight.pop(req.id, None)
            _INFLIGHT.set(len(self._inflight))
            if req.footprint:
                self._footprint_committed = max(
                    0, self._footprint_committed - req.footprint)
            # seconds a request: a gang's wall time over its members
            per = secs / max(1, batch_size)
            self._service_ewma = (per if self._service_ewma is None
                                  else 0.3 * per + 0.7 * self._service_ewma)
            self.stats["completed"] += 1
            self._work.notify_all()

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            req = self._dequeue()
            if req is None:
                return
            gang = (self.batcher.gather(req)
                    if self.batcher is not None else [req])
            try:
                if len(gang) > 1:
                    self._run_gang(gang)
                else:
                    self._run_one(req)
            except Exception:  # noqa: BLE001 -- a worker must not die
                log.exception("worker crashed on %s", [r.id for r in gang])
                for r in gang:
                    if r.state != "done":
                        self._finish(r, {"valid": "unknown",
                                         "error": "serve worker crashed"},
                                     0.0)
            if self.config.engine_headroom_min > 0:
                # memory pressure evicts the stalest warm buckets
                try:
                    self.engine.evict_below_headroom(
                        self.config.engine_headroom_min)
                except Exception as e:  # noqa: BLE001 -- advisory
                    log.warning("headroom eviction failed: %s", e)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "CheckDaemon":
        """Attach the daemon's ``trace.jsonl`` (tracing on), replay the
        journal, then start the workers."""
        if obs_trace.enabled():
            self._trace_path = os.path.join(self.config.root,
                                            obs_trace.TRACE_NAME)
            obs_trace.tracer().attach(self._trace_path)
            obs_trace.sync_event()
        pending, stats = RequestJournal.replay(self.journal.path)
        self.replay_stats = dict(stats, requeued=len(pending))
        for doc in pending:
            code, body, _ = self.submit(doc, replayed=True)
            if code == 202:
                self._bump("replayed")
                _REPLAYED.inc()
            else:
                # journaled but no longer admissible: a terminal record,
                # so the next restart does not try it again
                self.journal.append({"event": "dropped",
                                     "id": doc.get("id"),
                                     "reason": body.get("error")})
        if self._streams is not None:
            self._stream_replay()
        for i in range(max(1, self.config.workers)):
            t = threading.Thread(target=self._worker_loop, daemon=True,
                                 name=f"jtpu-serve-worker-{i}")
            t.start()
            self._threads.append(t)
        log.info("check daemon up: %d worker(s), %d replayed request(s)",
                 len(self._threads), self.stats["replayed"])
        return self

    def drain(self, timeout_s: float = 600.0) -> Dict[str, Any]:
        """Stop admission, let the running requests and the sealed
        streams' checks finish, leave the queued requests and the open
        streams journaled for the next incarnation."""
        with self._work:
            self.draining = True
            queued = self._depth
            self._work.notify_all()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if not self._inflight:
                    break
            time.sleep(0.05)
        # a sealed stream owes its verdict; an open one is resumed later
        while self._streams is not None and time.monotonic() < deadline:
            with self._lock:
                finishing = [s for s in self._streams.values()
                             if s is not None and s.state == "closed"]
            if not finishing:
                break
            time.sleep(0.05)
        with self._lock:
            inflight = len(self._inflight)
            completed = self.stats["completed"]
        self.drained.set()
        return {"drained": True, "was-queued": queued,
                "inflight-remaining": inflight, "completed": completed}

    def stop(self) -> None:
        self._stop.set()
        with self._work:
            self._work.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)
        if self._streams is not None:
            with self._lock:
                sessions = [s for s in self._streams.values()
                            if s is not None]
            for s in sessions:
                if s.runner is not None:
                    s.runner.stop()
            for s in sessions:
                if s.runner is not None:
                    s.runner.join(timeout=2.0)
                s.stop_wal()
        self.journal.close()
        tr = obs_trace.tracer()
        if self._trace_path is not None and tr.path == self._trace_path:
            # only this daemon's sink: another's stays attached
            tr.detach()

    # -- streams --------------------------------------------------------------
    # Reached only while self._streams is not None: with streaming off the
    # handler has no stream route and jepsen_tpu_torch.stream is never
    # imported.

    def _make_runner(self, session) -> Any:
        from jepsen_tpu_torch import stream as stream_ns
        model = models().get(session.model)
        runner = stream_ns.StreamRunner(
            session, model() if model is not None else None,
            backend=self.config.backend, device=self.config.device)
        session.runner = runner
        return runner

    def stream_open(self, doc: Dict[str, Any]
                    ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        """``POST /stream``: open a session, with ``submit``'s admission
        shape: 503 while draining, 400 for an unknown model, 429 with
        ``Retry-After`` past ``stream_max`` open streams."""
        from jepsen_tpu_torch import stream as stream_ns
        if self.draining:
            return 503, {"error": "draining"}, {"Retry-After": "30"}
        tenant = str(doc.get("tenant") or "default")
        model_name = str(doc.get("model") or "cas-register")
        if model_name not in models():
            return 400, {"error": "bad-request",
                         "detail": f"unknown model {model_name!r}"}, {}
        # the quota check and the slot's reservation are one critical
        # section, so two opens racing at stream_max - 1 cannot both pass;
        # the slot holds None until the session is built
        with self._lock:
            live = sum(1 for s in self._streams.values()
                       if s is None or s.state != "done")
            over = live >= self.config.stream_max
            if not over:
                self._stream_seq += 1
                sid = f"s{self._stream_seq:06d}-{os.getpid()}"
                self._streams[sid] = None
        if over:
            retry = self._retry_after()
            return 429, {"error": "stream-quota", "open": live,
                         "retry-after-s": round(retry, 3)}, \
                {"Retry-After": str(max(1, int(round(retry))))}
        try:
            session = stream_ns.StreamSession(
                sid, tenant, model_name, self.config.root,
                reorder_max=self.config.stream_reorder)
            runner = self._make_runner(session)
        except BaseException:
            with self._lock:
                self._streams.pop(sid, None)
            raise
        with self._lock:
            self._streams[sid] = session
        runner.start()
        return 202, {"id": sid, "state": "open", "tenant": tenant,
                     "model": model_name}, {}

    def _stream_session(self, sid: str):
        with self._lock:
            return self._streams.get(sid)

    def stream_append(self, sid: str, doc: Dict[str, Any]
                      ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        """``POST /stream/<id>/ops``: one idempotent chunk. 429 with
        ``Retry-After`` while the ops not yet checked pass
        ``stream_buffer_ops`` (backpressure), or while the session's
        footprint on top of the committed bytes passes the byte budget."""
        session = self._stream_session(sid)
        if session is None:
            return 404, {"error": "no such stream", "id": sid}, {}
        if self.draining and session.state == "open":
            return 503, {"error": "draining"}, {"Retry-After": "30"}
        lag = session.lag()
        if session.state == "open" and lag > self.config.stream_buffer_ops:
            retry = self._retry_after()
            return 429, {"error": "backpressure", "id": sid,
                         "lag-ops": lag,
                         "buffer-ops": self.config.stream_buffer_ops,
                         "retry-after-s": round(retry, 3)}, \
                {"Retry-After": str(max(1, int(round(retry))))}
        budget = self._budget()
        if budget and session.footprint:
            with self._lock:
                committed = self._footprint_committed
            if committed + session.footprint > budget:
                retry = self._retry_after()
                return 429, {"error": "footprint", "id": sid,
                             "predicted-bytes": session.footprint,
                             "committed-bytes": committed,
                             "budget-bytes": budget,
                             "retry-after-s": round(retry, 3)}, \
                    {"Retry-After": str(max(1, int(round(retry))))}
        code, body = session.append(doc.get("seq"), doc.get("ops"),
                                    doc.get("crc"))
        return code, body, {}

    def stream_close(self, sid: str, doc: Dict[str, Any]
                     ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        """``POST /stream/<id>/close``: seal the stream."""
        session = self._stream_session(sid)
        if session is None:
            return 404, {"error": "no such stream", "id": sid}, {}
        code, body = session.close(doc.get("chunks"))
        return code, body, {}

    def stream_status(self, sid: str) -> Optional[Dict[str, Any]]:
        session = self._stream_session(sid)
        return session.status() if session is not None else None

    def _stream_replay(self) -> None:
        """Rebuild the sessions from their WALs after a restart: open and
        sealed streams without a verdict get a new runner (which resumes
        the session's checkpoint); finished ones are registered so that
        ``GET /stream/<id>`` still answers."""
        from jepsen_tpu_torch import stream as stream_ns
        base = os.path.join(self.config.root, "streams")
        if not os.path.isdir(base):
            return
        replayed = resumed = 0
        for name in sorted(os.listdir(base)):
            sdir = os.path.join(base, name)
            try:
                session = stream_ns.StreamSession.replay(
                    sdir, self.config.root,
                    reorder_max=self.config.stream_reorder)
            except Exception:  # noqa: BLE001 -- one bad directory
                log.exception("stream replay failed for %s", sdir)
                continue
            if session is None:
                continue
            replayed += 1
            with self._lock:
                self._streams[session.id] = session
            if session.state != "done":
                self._make_runner(session).start()
                resumed += 1
        if replayed:
            self.replay_stats["streams"] = replayed
            self.replay_stats["streams-resumed"] = resumed
            log.info("replayed %d stream session(s), %d resumed", replayed,
                     resumed)

    def _stream_summary(self) -> Dict[str, Any]:
        with self._lock:
            sessions = [s for s in self._streams.values() if s is not None]
        by_state = {"open": 0, "closed": 0, "done": 0, "failed": 0}
        ops = checked = lag = 0
        for s in sessions:
            by_state[s.state] = by_state.get(s.state, 0) + 1
            with s.lock:
                ops += len(s.ops)
                checked += s.checked_events
                lag += max(0, len(s.ops) - s.checked_events)
        return {"sessions": len(sessions), "ops": ops, "checked": checked,
                "lag": lag, **by_state}

    # -- status -------------------------------------------------------------

    def status(self, rid: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            req = self._by_id.get(rid)
            return req.public() if req else None

    def healthz(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            tenants = {t: len(q) for t, q in self._queues.items() if q}
            depth = self._depth
            inflight = len(self._inflight)
            oldest = max((now - (r.started_at or r.queued_at)
                          for r in self._inflight.values()), default=None)
            committed = self._footprint_committed
            stats = dict(self.stats)
            has_streams = bool(self._streams)
        doc = {
            "ok": True,
            "state": "draining" if self.draining else "serving",
            "uptime-s": round(time.time() - self._started, 3),
            "device": None if self.device is None else str(self.device),
            "queue-depth": depth, "queue-max": self.config.queue_max,
            "inflight": inflight, "workers": len(self._threads),
            "oldest-inflight-s": (round(oldest, 3)
                                  if oldest is not None else None),
            "tenants": tenants, "tenant-max": self.config.tenant_max,
            "committed-bytes": committed, "budget-bytes": self._budget(),
            "stats": stats, "replay": dict(self.replay_stats),
            "breakers": self.breaker.snapshot(),
            "engine": {
                "warm-buckets": ["/".join(str(x) for x in b)
                                 for b in self.engine.warm_buckets()],
                "max-warm-buckets": self.engine.max_warm_buckets,
                "evictions": self.engine.evictions,
            },
        }
        if has_streams:
            doc["streams"] = self._stream_summary()
        return doc


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------


def make_handler(daemon: CheckDaemon):
    """A request handler class serving ``daemon``'s routes."""

    class ServeHandler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: D401 -- quiet server
            log.debug("%s " + fmt, self.address_string(), *args)

        def _json(self, code: int, doc: Dict[str, Any],
                  headers: Optional[Dict[str, str]] = None) -> None:
            body = json.dumps(doc, default=repr).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _authorized(self) -> bool:
            token = daemon.config.auth_token
            if not token:
                return True
            got = self.headers.get("Authorization") or ""
            # constant-time: the token cannot be guessed byte by byte
            return hmac.compare_digest(got, f"Bearer {token}")

        def _body(self) -> Optional[dict]:
            """The request's JSON object; None after answering 400."""
            try:
                n = int(self.headers.get("Content-Length") or 0)
                doc = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(doc, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, TypeError) as e:
                self._json(400, {"error": "bad-request", "detail": str(e)})
                return None
            return doc

        def do_POST(self):  # noqa: N802 -- http.server's naming
            path = self.path.split("?", 1)[0]
            streams = (path.startswith("/stream")
                       and daemon._streams is not None)
            try:
                if (path in ("/check", "/drain") or streams) \
                        and not self._authorized():
                    return self._json(401, {"error": "unauthorized"},
                                      {"WWW-Authenticate": "Bearer"})
                if path == "/check":
                    doc = self._body()
                    if doc is None:
                        return None
                    tp = self.headers.get("traceparent")
                    if tp and not doc.get("traceparent"):
                        doc["traceparent"] = tp
                    code, body, hdrs = daemon.submit(doc)
                    return self._json(code, body, hdrs)
                if path == "/drain":
                    return self._json(200, daemon.drain())
                if streams:
                    parts = path.strip("/").split("/")
                    if path == "/stream":
                        route = daemon.stream_open
                    elif len(parts) == 3 and parts[2] == "ops":
                        route = (lambda d, sid=parts[1]:
                                 daemon.stream_append(sid, d))
                    elif len(parts) == 3 and parts[2] == "close":
                        route = (lambda d, sid=parts[1]:
                                 daemon.stream_close(sid, d))
                    else:
                        return self._json(404, {"error": "not-found"})
                    doc = self._body()
                    if doc is None:
                        return None
                    code, body, hdrs = route(doc)
                    return self._json(code, body, hdrs)
                return self._json(404, {"error": "not-found"})
            except BrokenPipeError:
                pass

        def do_GET(self):  # noqa: N802
            path = self.path.split("?", 1)[0]
            try:
                if path == "/healthz":
                    return self._json(200, daemon.healthz())
                if path == "/metrics":
                    body = obs_metrics.REGISTRY.to_prometheus().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", PROMETHEUS_CTYPE)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return None
                if path.startswith("/check/"):
                    rid = path[len("/check/"):].strip("/")
                    doc = daemon.status(rid)
                    if doc is None:
                        return self._json(404, {"error": "no such request",
                                                "id": rid})
                    # a gang's poison member failed: a server error, so a
                    # caller that retries on 5xx treats it as such
                    serve = (doc.get("result") or {}).get("serve") or {}
                    poison = (serve.get("gang") or {}).get("poison")
                    hdrs = ({"traceparent": obs_trace.format_traceparent(
                        doc["trace"])} if doc.get("trace") else None)
                    return self._json(500 if poison else 200, doc, hdrs)
                if path.startswith("/stream/") and \
                        daemon._streams is not None:
                    sid = path[len("/stream/"):].strip("/")
                    doc = daemon.stream_status(sid)
                    if doc is None:
                        return self._json(404, {"error": "no such stream",
                                                "id": sid})
                    return self._json(200, doc)
                return self._json(404, {"error": "not-found"})
            except BrokenPipeError:
                pass

    return ServeHandler


def run_daemon(config: Optional[ServeConfig] = None,
               host: str = "127.0.0.1", port: int = 8080
               ) -> Tuple[CheckDaemon, ThreadingHTTPServer]:
    """Start the daemon and its HTTP server (port 0: any free port, read
    back from ``server.server_port``); returns ``(daemon, server)``. The
    caller waits on ``daemon.drained`` (set by ``POST /drain``), then
    calls ``server.shutdown()``, ``server.server_close()`` and
    ``daemon.stop()``."""
    daemon = CheckDaemon(config)
    daemon.start()
    server = ThreadingHTTPServer((host, port), make_handler(daemon))
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="jtpu-serve-http").start()
    log.info("check daemon on http://%s:%s/ (POST /check, GET "
             "/check/<id>, /healthz, /drain%s)", host, server.server_port,
             ", /stream" if daemon._streams is not None else "")
    return daemon, server
