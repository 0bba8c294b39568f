"""Streaming intake with a crash-safe online check.

Counterpart of ``jepsen_tpu/stream.py``. A client opens a *stream session*
on the check daemon, appends CRC'd chunks of ops under sequence numbers,
and seals it with a close. Two halves serve those routes:

* :class:`StreamSession`, the intake. Chunks are idempotent (a re-POST of
  an accepted sequence number is a 202 and is not journaled again),
  chunks that arrive early within a bounded reorder window are buffered,
  and a gap answers 409 with the sequence number the daemon needs next.
  Every accepted chunk is appended to the session's own WAL
  (``streams/<sid>/wal.jsonl``, :mod:`jepsen_tpu_torch.journal` records)
  before the ack, so a killed daemon replays its open sessions.

* :class:`StreamRunner`, the online check. It feeds the arriving ops
  through :class:`jepsen_tpu_torch.ops.encode.StreamPacker` and runs the
  device search over the growing *stable prefix* in segments; after each
  segment it saves the carry, with the prefix's watermark and required-op
  count, to ``streams/<sid>/checkpoint.npz``. A longer stable prefix
  extends the shorter one's columns, so the carry carries over
  (:func:`jepsen_tpu_torch.checker.gpu._reopen_carry`), and a daemon
  killed mid-stream resumes from the checkpoint's level. An invalid
  stable prefix ends the stream at once (fail-fast): pool death with
  nothing truncated refutes the whole history, since every crashed op
  invokes at or past the watermark.

A segment is the supervisor's (:mod:`jepsen_tpu_torch.resilience`): one
launch of the shape's segment graph on the card, run on the engine's
shared buffers under :attr:`Engine.lock`. The runner takes the lock for
one segment at a time, never while it waits for ops: each time it uploads
its columns and its carry into the engine's buffers for the shape, runs
the segment and copies the carry back before it lets the lock go, so a
check of the same shape between two of its segments changes nothing of
it. Within one required-op bucket the buffers stay the same, and the
segment graph captured for them is launched again over the new columns;
a new bucket, or the crashed section that close adds, is a new shape.

A runner given a ``deadline_s`` runs each segment under the supervisor's
watchdog (:class:`jepsen_tpu_torch.resilience.SegmentWatchdog`). A segment
past it is a wedge: recorded for the process, its buffers left to the
abandoned worker and the engine's lock released, and the verdict is
UNKNOWN, ``"stream segment wedged: ..."``. The stream's checkpoint of its
last segment end stays on disk: a runner on ``device="cpu"`` over the
same session resumes it. A search that fails otherwise raises, and the
stream's verdict is UNKNOWN with the error.

Each session has a trace id (an inbound ``traceparent``'s or one made at
open; none with ``JTPU_TRACE=0``): journaled in the ``open`` record, kept
on replay, set on the runner's thread while it searches (so the
``stream.segment`` spans carry it) and ended by a ``stream.verdict``
event. The runner's ``on_done`` tells the daemon a verdict landed (its
progress heartbeat has the stream keys).

The daemon imports this module only when streaming is on
(``JTPU_SERVE_STREAM``).
"""

from __future__ import annotations

import functools
import json
import logging
import os
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import accel, interop, obs
from jepsen_tpu_torch import journal as journal_ns
from jepsen_tpu_torch import resilience as R
from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.checker.engine import default_engine
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.models.core import kernel_spec_for
from jepsen_tpu_torch.obs import metrics as obs_metrics
from jepsen_tpu_torch.obs import searchstats as obs_searchstats
from jepsen_tpu_torch.obs import trace as obs_trace
from jepsen_tpu_torch.ops.encode import StreamPacker, _Interner

log = logging.getLogger("jepsen_tpu_torch.stream")

WAL_NAME = "wal.jsonl"
CHECKPOINT_NAME = "checkpoint.npz"
HISTORY_NAME = "history.json"
RESULT_NAME = "result.json"

# the reference's stream counters (jepsen_tpu/stream.py:76-96)
_CHUNKS = obs_metrics.counter(
    "jtpu_stream_chunks_total", "Stream chunks accepted")
_DUPS = obs_metrics.counter(
    "jtpu_stream_dup_chunks_total", "Duplicate stream chunks absorbed")
_REORDERED = obs_metrics.counter(
    "jtpu_stream_reordered_chunks_total",
    "Out-of-order stream chunks buffered")
_GAPS = obs_metrics.counter(
    "jtpu_stream_gap_rejects_total", "Stream appends rejected on a gap")
_OPS = obs_metrics.counter(
    "jtpu_stream_ops_total", "Stream ops accepted")
_RESUMES = obs_metrics.counter(
    "jtpu_stream_resumes_total",
    "Stream sessions resumed from a partial-verdict checkpoint")
_FAILFAST = obs_metrics.counter(
    "jtpu_stream_failfast_total",
    "Streams short-circuited by an invalid prefix")
_LAG = obs_metrics.gauge(
    "jtpu_stream_lag_ops",
    "Buffered ops not yet covered by a checked stable prefix")


def chunk_crc(ops: list) -> str:
    """CRC of a chunk body, over the canonical compact JSON of the ops
    (sorted keys, no whitespace): client and daemon agree byte for byte,
    whichever package each is."""
    blob = json.dumps(ops, separators=(",", ":"), sort_keys=True,
                      default=repr).encode()
    return "%08x" % (zlib.crc32(blob) & 0xFFFFFFFF)


def _atomic_json(path: str, doc: Any) -> None:
    """Write ``doc`` through a temporary file and ``os.replace``, with
    deterministic bytes (the history artifact is compared byte for byte
    across delivery orders and replays)."""
    d, base = os.path.split(path)
    # dot-prefixed, so that directory scans skip a torn temporary file
    tmp = os.path.join(d, f".{base}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(doc, f, separators=(",", ":"), sort_keys=True,
                  default=repr)
    os.replace(tmp, path)


class StreamSession:
    """One stream: sequencing, reorder buffering and the WAL.

    Intake changes happen under :attr:`lock`; :attr:`cond` wakes the
    runner when ops arrive or the stream is sealed. States: ``open``, then
    ``closed`` (sealed, the runner finishing), then ``done`` (the result
    saved); a fail-fast refutation goes from ``open`` to ``done``.
    """

    def __init__(self, sid: str, tenant: str, model: str, root: str,
                 reorder_max: int = 64, trace: Optional[str] = None,
                 trace_parent: Optional[str] = None,
                 journal_open: bool = True):
        self.id = sid               # guarded-by: none -- immutable after init
        self.tenant = tenant
        self.model = model
        self.trace = trace
        self.trace_parent = trace_parent
        self.dir = os.path.join(root, "streams", sid)
        os.makedirs(self.dir, exist_ok=True)
        self.reorder_max = int(reorder_max)
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.state = "open"
        self.next_seq = 0                     # the next sequence wanted
        self.ops: List[dict] = []             # accepted ops, in order
        self.reorder: Dict[int, list] = {}    # journaled, not yet in order
        self.dups = 0
        self.reordered = 0
        self.created = time.time()
        self.closed_at: Optional[float] = None
        self.result: Optional[Dict[str, Any]] = None
        # the runner's progress, for status and the lag
        self.checked_events = 0
        self.checked_level = 0
        self.footprint = 0
        self.runner: Optional["StreamRunner"] = None
        self._wal = open(os.path.join(self.dir, WAL_NAME), "ab")
        if journal_open:
            self._journal({"event": "open", "id": sid, "tenant": tenant,
                           "model": model, "trace": trace,
                           "trace-parent": trace_parent,
                           "ts": round(self.created, 6)})

    def _journal(self, rec: dict) -> None:
        """Append one record, synced to the disk before the ack."""
        self._wal.write(journal_ns.encode_json_record(rec))
        self._wal.flush()
        os.fsync(self._wal.fileno())

    # -- intake -------------------------------------------------------------

    def append(self, seq: Any, ops: Any,
               crc: Optional[str] = None) -> Tuple[int, Dict[str, Any]]:
        """One chunk: ``(http_status, body)``. A duplicate is a 202 and is
        not journaled again; a chunk up to ``reorder_max`` ahead is
        buffered; past that it is a 409 ``gap`` with the ``need``ed
        sequence number."""
        try:
            seq = int(seq)
        except (TypeError, ValueError):
            return 400, {"error": "seq must be an integer"}
        if seq < 0 or not isinstance(ops, list):
            return 400, {"error": "need seq >= 0 and ops list"}
        if crc is not None and chunk_crc(ops) != crc:
            return 400, {"error": "crc-mismatch", "seq": seq}
        with self.cond:
            if self.state != "open":
                if seq < self.next_seq:
                    # a late duplicate: still 202, so the client's retries
                    # converge after the close
                    self.dups += 1
                    _DUPS.inc()
                    return 202, {"id": self.id, "seq": seq,
                                 "duplicate": True, "state": self.state,
                                 "need": self.next_seq}
                if (self.state == "done" and self.result is not None
                        and self.result.get("stream", {}).get(
                            "failed-fast")):
                    return 409, {"error": "stream-failed", "id": self.id,
                                 "state": self.state}
                return 409, {"error": "stream-closed", "id": self.id,
                             "state": self.state}
            if seq < self.next_seq or seq in self.reorder:
                self.dups += 1
                _DUPS.inc()
                return 202, {"id": self.id, "seq": seq, "duplicate": True,
                             "need": self.next_seq}
            if seq > self.next_seq:
                if seq - self.next_seq > self.reorder_max:
                    _GAPS.inc()
                    return 409, {"error": "gap", "id": self.id,
                                 "seq": seq, "need": self.next_seq,
                                 "reorder-max": self.reorder_max}
                # journaled when accepted: a replay buffers it again
                self._journal({"event": "chunk", "seq": seq, "ops": ops})
                self.reorder[seq] = ops
                self.reordered += 1
                _REORDERED.inc()
                _CHUNKS.inc()
                return 202, {"id": self.id, "seq": seq, "buffered": True,
                             "need": self.next_seq}
            self._journal({"event": "chunk", "seq": seq, "ops": ops})
            self._admit(seq, ops)
            while self.next_seq in self.reorder:
                self._admit(self.next_seq, self.reorder.pop(self.next_seq))
            _CHUNKS.inc()
            self.cond.notify_all()
            return 202, {"id": self.id, "seq": seq, "ops": len(self.ops),
                         "need": self.next_seq}

    def _admit(self, seq: int, ops: list) -> None:
        self.ops.extend(ops)
        self.next_seq = seq + 1
        _OPS.inc(len(ops))

    def close(self, chunks: Optional[Any] = None
              ) -> Tuple[int, Dict[str, Any]]:
        """Seal the stream. ``chunks``, the client's chunk count, catches a
        chunk still in flight: the close then answers 409 with the missing
        sequence number instead of sealing short."""
        with self.cond:
            if self.state != "open":
                return 200, {"id": self.id, "state": self.state,
                             "ops": len(self.ops)}
            if self.reorder or (chunks is not None
                                and int(chunks) != self.next_seq):
                _GAPS.inc()
                return 409, {"error": "gap", "id": self.id,
                             "need": self.next_seq,
                             "buffered": sorted(self.reorder)}
            self._journal({"event": "close", "chunks": self.next_seq,
                           "ops": len(self.ops)})
            self.state = "closed"
            self.closed_at = time.time()
            # the history artifact: the ops in sequence order, the same
            # bytes however the chunks came and however often the daemon
            # was killed
            _atomic_json(os.path.join(self.dir, HISTORY_NAME), self.ops)
            self.cond.notify_all()
            return 200, {"id": self.id, "state": "closed",
                         "chunks": self.next_seq, "ops": len(self.ops)}

    # -- the runner's side --------------------------------------------------

    def lag(self) -> int:
        with self.lock:
            return max(0, len(self.ops) - self.checked_events)

    def note_progress(self, events: int, level: int,
                      footprint: int = 0) -> None:
        with self.lock:
            self.checked_events = events
            self.checked_level = level
            if footprint:
                self.footprint = footprint

    def finish(self, result: Dict[str, Any], secs: float,
               on_done: Optional[Callable[["StreamSession"], None]] = None
               ) -> None:
        """Save the verdict: the result file first, then the ``verdict``
        record, so a crash between them checks the stream again and never
        loses it; then the trace's ``stream.verdict`` event and
        ``on_done``."""
        _atomic_json(os.path.join(self.dir, RESULT_NAME), result)
        with self.cond:
            self._journal({"event": "verdict",
                           "valid": repr(result.get("valid")),
                           "seconds": round(secs, 6)})
            self.result = result
            self.state = "done"
            self.cond.notify_all()
        if self.trace and obs_trace.enabled():
            with obs_trace.context(self.trace, self.trace_parent):
                obs_trace.event("stream.verdict", id=self.id,
                                valid=repr(result.get("valid")),
                                seconds=round(secs, 6))
        if on_done is not None:
            on_done(self)

    def status(self) -> Dict[str, Any]:
        with self.lock:
            doc = {"id": self.id, "state": self.state,
                   "tenant": self.tenant, "model": self.model,
                   "ops": len(self.ops), "chunks": self.next_seq,
                   "need": self.next_seq,
                   "buffered-chunks": len(self.reorder),
                   "dup-chunks": self.dups, "reordered": self.reordered,
                   "checked-events": self.checked_events,
                   "checked-level": self.checked_level,
                   "lag": max(0, len(self.ops) - self.checked_events)}
            if self.trace:
                doc["trace"] = self.trace
            if self.result is not None:
                doc["result"] = self.result
            return doc

    def stop_wal(self) -> None:
        # under the lock: closing the file mid-append would turn that
        # append into an error on a closed file
        with self.lock:
            try:
                self._wal.close()
            except OSError:
                pass

    @classmethod
    def replay(cls, sdir: str, root: str,
               reorder_max: int = 64) -> Optional["StreamSession"]:
        """Rebuild a session from its WAL (written by either package)
        after a crash. Chunks are admitted again in sequence order,
        whatever order they came in, so the ops, and the history
        artifact, are the ones before the crash. The journal reader drops
        a torn tail; the client's retries send it again."""
        path = os.path.join(sdir, WAL_NAME)
        if not os.path.exists(path):
            return None
        records, stats = journal_ns.read_json_records(path)
        opened = next((r for r in records if r.get("event") == "open"),
                      None)
        if opened is None:
            return None
        sid = opened.get("id") or os.path.basename(sdir)
        s = cls(sid, opened.get("tenant", "anon"), opened.get("model", ""),
                root, reorder_max=reorder_max, trace=opened.get("trace"),
                trace_parent=opened.get("trace-parent"), journal_open=False)
        chunks: Dict[int, list] = {}
        closed = verdict = False
        for r in records:
            ev = r.get("event")
            if ev == "chunk":
                chunks[int(r["seq"])] = r.get("ops") or []
            elif ev == "close":
                closed = True
            elif ev == "verdict":
                verdict = True
        for seq in sorted(chunks):
            if seq == s.next_seq:
                s._admit(seq, chunks[seq])
            elif seq > s.next_seq:
                s.reorder[seq] = chunks[seq]
        if closed:
            s.state = "closed"
            s.closed_at = time.time()
            hist = os.path.join(s.dir, HISTORY_NAME)
            if not os.path.exists(hist):
                _atomic_json(hist, s.ops)
        if verdict:
            s.state = "done"
            try:
                with open(os.path.join(s.dir, RESULT_NAME)) as f:
                    s.result = json.load(f)
            except (OSError, ValueError):
                # a verdict record without a readable result: check again
                s.state = "closed" if closed else "open"
                s.result = None
        if stats.get("torn") or stats.get("corrupt"):
            log.warning("stream %s WAL replay dropped %s torn / %s corrupt "
                        "records", sid, stats.get("torn"),
                        stats.get("corrupt"))
        return s


class _Verdict(Exception):
    """The online loop reached its result."""

    def __init__(self, result: Dict[str, Any]):
        super().__init__(repr(result.get("valid")))
        self.result = result


class StreamRunner(threading.Thread):
    """The online check of one session, in its own thread.

    The segment loop of :func:`jepsen_tpu_torch.resilience.
    supervised_check_packed` as a state machine, so that the columns can
    change under the live carry at stable-prefix barriers. Three
    transitions touch the carry:

    * **extend**: the stable prefix grew (or close added no crashed-mask
      word): the columns are rebuilt for the longer prefix and the same
      carry reopened (:func:`jepsen_tpu_torch.checker.gpu._reopen_carry`);
      level and counters go on.
    * **rebase**: the needed window outgrew the rung, the pool went lossy,
      the window overflowed, or close added crashed-mask words the carry
      lacks: a new search at level 0 on the next or a wider rung, as the
      offline ladder escalates.
    * **resume**: a replayed daemon finds the session's checkpoint: the
      carry goes on at its saved level over the prefix the WAL replay
      rebuilt (never shorter than the checkpoint's, since checkpoints
      follow journaled chunks).

    ``device`` (None: CUDA) is where the search runs; ``ops`` the level
    steps, :data:`gpu.KERNELS` or their plain versions :data:`gpu.PLAIN`.
    ``deadline_s`` is each segment's watchdog (None: none), as in
    :func:`jepsen_tpu_torch.resilience.supervised_check_packed`; a runner
    on CUDA started after a wedge in the process ends UNKNOWN at its
    first segment.
    The result's ``stream`` dict has the reference's keys (ops, chunks,
    dup-chunks, reordered, watermark, barriers, rebases, failed-fast,
    resume-level) and three of the port's: ``segments``, the segment
    graphs the stream ``captures`` and the carry's level at close
    (``close-level``).

    A barrier at which the search is done, followed by a forced op, costs
    the stream a level against the offline search, here as in the
    reference: offline, a forced run crosses the barrier within a level;
    online, the run stops at the old required count, where ``done`` is
    set, and goes on a level later.
    """

    def __init__(self, session: StreamSession, model: Any,
                 backend: str = "gpu", device=None,
                 segment_iters: Optional[int] = None,
                 ops: G.Ops = G.KERNELS,
                 deadline_s: Optional[float] = None,
                 on_done: Optional[Callable[[StreamSession], None]] = None):
        super().__init__(name=f"jtpu-stream-{session.id}", daemon=True)
        self.session = session
        self.model = model
        self.backend = backend
        self.device = device
        self.ops = ops
        self.on_done = on_done
        self.checkpoint_path = os.path.join(session.dir, CHECKPOINT_NAME)
        self._halt = threading.Event()
        self._seg = (G._segment_config(segment_iters)
                     or G.DEFAULT_SEGMENT_ITERS)
        self._policy = R.RetryPolicy()
        self._deadline_s = deadline_s
        self._watchdog: Optional[R.SegmentWatchdog] = None
        self._resume_cp: Optional[R.Checkpoint] = None
        if os.path.exists(self.checkpoint_path):
            try:
                self._resume_cp = R.Checkpoint.load(self.checkpoint_path)
            except Exception as e:  # noqa: BLE001 -- corrupt: start afresh
                log.warning("stream %s: unreadable checkpoint (%s); "
                            "starting from level 0", session.id, e)
        # the packer, with pack_with_init's initial state
        kernel = kernel_spec_for(model) if model is not None else None
        self.kernel = kernel
        self._packer: Optional[StreamPacker] = None
        if kernel is not None and kernel.remap is None:
            intern = _Interner()
            init = (kernel.pack_init(model, intern.id)
                    if kernel.pack_init is not None else kernel.init_state)
            self._packer = StreamPacker(kernel, init_state=init,
                                        intern=intern)
        # the search
        self._dev: Optional[torch.device] = None
        self._fed = 0
        self._p = None
        self._cols = None
        self._carry = None
        self._ladder: Optional[tuple] = None
        self._rung_i = 0
        self._rung = None                 # (cap, win, exp) requested
        self._cap_eff = self._exp_eff = None
        self._seg_idx = 0
        self._crw = 0
        self._lmax = 0
        self._checked_nr = 0
        self._checked_wm = 0
        self._final = False
        self._suspended = False           # ladder spent mid-stream
        self._transients = 0
        self._ooms = 0
        self._barriers = 0
        self._rebases: List[str] = []
        self._resume_level: Optional[int] = None
        self._failed_fast = False
        self._captures = 0
        self._close_level: Optional[int] = None
        # the stats lane rides with tracing, as in the offline search
        self._stats = obs.enabled()

    def stop(self) -> None:
        self._halt.set()
        with self.session.cond:
            self.session.cond.notify_all()

    # -- main loop ----------------------------------------------------------

    def run(self) -> None:
        s = self.session
        try:
            # the session's trace on this thread: its segments' spans
            with obs_trace.context(s.trace if obs_trace.enabled() else None,
                                   s.trace_parent):
                self._run()
        except _Verdict as v:
            self._deliver(v.result)
        except Exception as e:  # noqa: BLE001 -- never die silently
            if self._halt.is_set():
                return      # stopped meanwhile: the checkpoint holds it
            log.exception("stream %s online check crashed", self.session.id)
            self._deliver({"valid": UNKNOWN, "backend": self.backend,
                           "error": f"stream checker crashed: {e}"})
        finally:
            if self._watchdog is not None:
                self._watchdog.close()

    def _deliver(self, result: Dict[str, Any]) -> None:
        result.setdefault("stream", {}).update(self._telemetry())
        secs = (time.time() - self.session.closed_at
                if self.session.closed_at else 0.0)
        self.session.finish(result, secs, on_done=self.on_done)

    def _telemetry(self) -> Dict[str, Any]:
        s = self.session
        out = {"ops": len(s.ops), "chunks": s.next_seq,
               "dup-chunks": s.dups, "reordered": s.reordered,
               "watermark": self._checked_wm, "barriers": self._barriers,
               "rebases": list(self._rebases),
               "failed-fast": self._failed_fast,
               "segments": self._seg_idx, "captures": self._captures,
               "close-level": self._close_level}
        if self._resume_level is not None:
            out["resume-level"] = self._resume_level
        return out

    def _run(self) -> None:
        if self._packer is None:
            self._run_offline()
            return
        self._dev = G.resolve_device(self.device)
        while True:
            new, closed = self._poll()
            if self._halt.is_set():
                return
            if new:
                try:
                    self._packer.feed_ops(new)
                except ValueError as e:
                    raise _Verdict({"valid": UNKNOWN,
                                    "backend": self.backend,
                                    "error": str(e)})
            if closed and not self._final:
                self._rebuild(self._packer.close(), final=True)
            elif (not self._final and not self._suspended
                  and self._packer.stable_required > self._checked_nr):
                self._rebuild(self._packer.stable_packed(), final=False)
            if self._suspended and not self._final:
                continue
            if self._carry is None and self._cols is not None:
                self._seed_carry()
            if self._carry is None:
                continue
            if R._carry_active(self._carry, self._lmax):
                self._segment()
                continue
            done, lossy, wovf, best, levels, pool = \
                G._summarize_carry(self._carry)
            if done:
                if self._final:
                    raise _Verdict(self._result(True, False, False, best,
                                                levels, pool))
                continue            # caught up: wait for more ops
            if lossy or wovf:
                self._escalate(lossy, wovf, best, levels)
                continue
            # the pool died with nothing truncated: the checked prefix is
            # refuted, and with it the whole history (every crashed op
            # invokes at or past the watermark, so a witness for the
            # history would give one for the prefix)
            if not self._final:
                self._failed_fast = True
                _FAILFAST.inc()
            raise _Verdict(self._result(False, False, False, best, levels,
                                        pool))

    def _poll(self) -> Tuple[list, bool]:
        s = self.session
        with s.cond:
            if (len(s.ops) == self._fed and s.state == "open"
                    and not self._work_pending()):
                s.cond.wait(0.25)
            new = list(s.ops[self._fed:])
            self._fed += len(new)
            closed = s.state != "open"
        return new, closed

    def _work_pending(self) -> bool:
        return (self._carry is not None
                and R._carry_active(self._carry, self._lmax))

    # -- barrier transitions ------------------------------------------------

    def _rebuild(self, p, final: bool) -> None:
        """A stable-prefix barrier: new columns under the carry (extend),
        or a fresh rung (rebase)."""
        self._barriers += 1
        if final and self._carry is not None:
            self._close_level = int(self._carry[8])
        nr = p.n_required
        if final and nr == 0:
            raise _Verdict({"valid": True, "levels": 0, "backend": "gpu"})
        n_cr = p.n - nr
        crw = (G._crash_width(n_cr) or 0) if final else 0
        if final and G._crash_width(n_cr) is None:
            raise _Verdict({
                "valid": UNKNOWN, "backend": "gpu",
                "error": f"{n_cr} crashed ops exceed the crashed-set "
                         f"width {G.CRASH_MAX}"})
        breq = G._bucket(nr)
        cols = G._split_packed(p, breq, crw, self.kernel)
        wneed = G._window_needed(p)
        lmax = G._level_budget(breq, crw)
        transfer = self._carry is not None
        if transfer and wneed > self._rung[1]:
            self._rebases.append(f"window-{wneed}")
            transfer = False
        if transfer and crw != self._crw and (
                max((crw + 31) // 32, 1) != max((self._crw + 31) // 32, 1)):
            # close added crashed-mask words the carry lacks; a widening
            # within one word (0 to 32 crashed ops) keeps the carry, whose
            # crashed bits are all zero at width 0
            self._rebases.append(f"crash-width-{crw}")
            transfer = False
        self._p, self._cols, self._crw, self._lmax = p, cols, crw, lmax
        self._final = final or self._final
        if transfer:
            # reopen only when the barrier added required ops: a done
            # carry at the same nr stays done (close appending crashed
            # ops only adds optional ones), and clearing it anyway would
            # find done again a level later than the offline search
            if nr > self._checked_nr:
                self._carry = G._reopen_carry(self._carry, nr)
            if self._stats:
                self._carry = R._grow_carry_stats(self._carry, lmax)
        else:
            self._carry = None
            self._ladder = G._ladder_for(wneed, self._dev)
            self._rung_i = 0
            self._suspended = False
        self._checked_nr = nr
        self._checked_wm = (self._packer.n_events if final
                            else self._packer.watermark)

    def _seed_carry(self) -> None:
        """Start, or resume, a rung over the current columns."""
        cp = self._resume_cp
        self._resume_cp = None
        if cp is not None and 0 <= cp.n_required <= self._checked_nr \
                and cp.window >= G._window_needed(self._p) \
                and cp.crash_width == self._crw:
            carry = tuple(cp.carry)
            self._rung = tuple(cp.rung)
            idx = next((i for i, r in enumerate(self._ladder)
                        if tuple(r) == self._rung), None)
            if idx is None:
                self._ladder = (self._rung,) + tuple(self._ladder)
                idx = 0
            self._rung_i = idx
            self._cap_eff = cp.capacity_eff
            self._exp_eff = cp.expand_eff
            self._seg_idx = cp.segment
            carry = R._fit_carry_stats(carry, self._stats, self._lmax)
            if self._stats:
                carry = R._grow_carry_stats(carry, self._lmax)
            if self._checked_nr > cp.n_required:
                # the WAL replay rebuilt a longer stable prefix than the
                # checkpoint saw: the same reopen rule as _rebuild's
                carry = G._reopen_carry(carry, self._checked_nr)
            self._carry = carry
            self._resume_level = int(self._carry[8])
            _RESUMES.inc()
            log.info("stream %s: resumed from its checkpoint at level %s "
                     "(watermark %s, %s required ops)", self.session.id,
                     self._resume_level, cp.watermark, cp.n_required)
            return
        if cp is not None:
            self._rebases.append("checkpoint-stale")
        cap, win, exp = self._ladder[min(self._rung_i,
                                         len(self._ladder) - 1)]
        G._check_window(win)
        self._rung = (cap, win, exp)
        self._cap_eff, self._exp_eff = cap, exp
        self._seg_idx = 0
        self._carry = G._carry0_host(
            cap, win, self._cols["cf"].shape[0], self._cols["ini"],
            int(self._cols["nr"]),
            stats_rows=(self._lmax + 1) if self._stats else 0)

    def _escalate(self, lossy: bool, wovf: bool, best: int,
                  levels: int) -> None:
        """A lossy or overflowed rung end: a new search at level 0 on the
        next rung (a rebase, unlike a resume)."""
        if self._rung_i + 1 >= len(self._ladder):
            if self._final:
                raise _Verdict(self._result(False, lossy, wovf, best,
                                            levels, None))
            # UNKNOWN mid-stream refutes nothing: wait for the close,
            # then climb the ladder again over the whole history, as the
            # offline check does
            self._suspended = True
            self._carry = None
            self._rebases.append("suspended")
            return
        self._rung_i += 1
        self._rebases.append("wovf" if wovf else "lossy")
        self._carry = None
        self._seed_carry()

    # -- one device segment -------------------------------------------------

    def _segment(self) -> None:
        """One segment of the search under the engine's lock, on its shared
        buffers: the columns and the carry go up, the carry comes back
        (in the watchdog's thread, where there is a deadline). An OOM
        halves the pool and a transient failure is retried after the
        policy's backoff, both from the carry before the segment; a wedge
        ends the stream; anything else raises."""
        eng = default_engine()
        dev = self._dev
        cap_eff, exp_eff, win = self._cap_eff, self._exp_eff, self._rung[1]
        lvl0 = int(self._carry[8])
        ctx = {"rung": self._rung, "effective": (cap_eff, win, exp_eff),
               "segment": self._seg_idx, "level": lvl0,
               "backend": "stream"}
        if accel.runtime_wedged(dev):
            raise _Verdict({"valid": UNKNOWN, "backend": "gpu",
                            "levels": lvl0,
                            "error": "stream segment wedged: a device "
                                     "segment wedged earlier in this "
                                     "process"})
        try:
            if R._inject_fault is not None:
                R._inject_fault(dict(ctx))
            shape = K.LevelShape(C=cap_eff, W=win,
                                 E=min(exp_eff or cap_eff, cap_eff),
                                 n=self._cols["f"].shape[0],
                                 CR=self._cols["cf"].shape[0],
                                 model=self.kernel.name)
            stacked = interop.stack_cols([self._cols])
            shape_key = ("segment", self.kernel.name, cap_eff, win,
                         exp_eff, shape.n, shape.CR, self._stats)
            phase = G.call_phase(shape_key)
            with eng.lock, obs.span(
                    "stream.segment", phase=phase, segment=self._seg_idx,
                    level=lvl0, rung=[cap_eff, win, exp_eff],
                    watermark=self._checked_wm) as sp:
                captures = K.segments["captures"]
                t0 = time.perf_counter()
                cols = eng.batch_cols(stacked, dev, copy=False)
                carry, scratch = eng.state(shape, dev, self._stats)
                if self._watchdog is None:
                    self._watchdog = R.SegmentWatchdog(dev, self._deadline_s)
                try:
                    seg_end = self._watchdog.call(functools.partial(
                        R._device_segment, cols=cols, cols_np=stacked,
                        carry=carry, scratch=scratch, host=self._carry,
                        shape=shape, seg_len=self._seg, ops=self.ops,
                        keep=True))
                    seg_s = time.perf_counter() - t0
                    host = seg_end.host
                    sp.set(level_end=int(host[8]))
                except R.WedgeError as e:
                    accel.note_runtime_wedge(
                        "stream", self._deadline_s or 0.0, device=dev,
                        worker=getattr(e, "worker", None), level=lvl0)
                    eng.abandon(shape, dev, cols)
                    e.noted = True
                    raise
                self._captures += K.segments["captures"] - captures
        except R.WedgeError as e:
            if not getattr(e, "noted", False):
                # a wedge that came through the fault seam
                accel.note_runtime_wedge("stream", self._deadline_s or 0.0,
                                         device=dev, level=lvl0)
            raise _Verdict({"valid": UNKNOWN, "backend": "gpu",
                            "levels": lvl0,
                            "error": f"stream segment wedged: {e}"})
        except Exception as e:  # noqa: BLE001 -- classified below
            cls = R.classify_failure(e)
            if cls == R.OOM:
                self._ooms += 1
                new_cap = cap_eff // 2
                if new_cap < self._policy.min_capacity:
                    raise _Verdict({"valid": UNKNOWN, "backend": "gpu",
                                    "levels": lvl0,
                                    "error": f"OOM at the pool floor: {e}"})
                self._carry, _ = R._shrink_carry(self._carry, new_cap)
                self._cap_eff = new_cap
                if isinstance(self._exp_eff, int):
                    self._exp_eff = max(1, min(self._exp_eff // 2, new_cap))
                log.warning("stream %s: device OOM at level %s; halving the "
                            "pool to %s rows", self.session.id, lvl0,
                            new_cap)
                time.sleep(self._policy.delay(self._ooms))
                return
            if cls in (R.TRANSIENT, R.DCN):
                self._transients += 1
                if self._transients > self._policy.max_retries:
                    raise
                time.sleep(self._policy.delay(self._transients))
                return
            raise
        self._carry = host
        self._seg_idx += 1
        self._transients = 0
        G.mark_executed(shape_key)
        G.note_call_phase("segment", phase, seg_s)
        lvl1 = int(host[8])
        G._LEVELS_TOTAL.inc(lvl1 - lvl0)
        G._SEGMENTS_TOTAL.inc()
        if self._stats and len(host) > 13:
            obs_searchstats.record(np.asarray(host[13])[:lvl1],
                                   rung=(cap_eff, win, exp_eff))
        self.session.note_progress(self._checked_wm, lvl1,
                                   footprint=self._footprint())
        _LAG.set(self.session.lag())
        R.Checkpoint(carry=host, rung=self._rung, window=win,
                     expand_eff=self._exp_eff, crash_width=self._crw,
                     segment=self._seg_idx, watermark=self._checked_wm,
                     n_required=self._checked_nr).save(self.checkpoint_path)

    def _footprint(self) -> int:
        if self._p is None:
            return 0
        try:
            from jepsen_tpu_torch.checker import plan
            return int(plan.request_footprint(
                plan.PlanDims.from_packed(self._p), self._dev) or 0)
        except Exception:  # noqa: BLE001 -- pricing is advisory
            return 0

    def _result(self, done: bool, lossy: bool, wovf: bool, best: int,
                levels: int, pool) -> Dict[str, Any]:
        out = G._result(done, lossy, wovf, best, levels, self._p, pool=pool)
        out["rung"] = (self._cap_eff, self._rung[1], self._exp_eff)
        out["crash-width"] = self._crw
        out["segments"] = self._seg_idx
        out["segment-iters"] = self._seg
        return out

    # -- models with no online kernel ---------------------------------------

    def _run_offline(self) -> None:
        """Object models, and kernels with a global remap (the set and the
        queues), whose columns change at close: buffer until the stream is
        sealed, then run the offline check, ``linearizable`` under
        ``check_safe`` as the daemon's requests do."""
        s = self.session
        while True:
            with s.cond:
                if s.state == "open" and not self._halt.is_set():
                    s.cond.wait(0.25)
                ops = list(s.ops) if s.state != "open" else None
            if self._halt.is_set():
                return
            if ops is not None:
                break
        from jepsen_tpu_torch.checker import check_safe
        from jepsen_tpu_torch.checker.wgl import linearizable
        checker = linearizable(self.model, backend=self.backend,
                               device=self.device)
        raise _Verdict(check_safe(checker, {"name": f"stream-{s.id}"},
                                  History.of(ops)))
