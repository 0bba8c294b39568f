"""CRC'd JSON-record journals: the op write-ahead log of a test run and
the serve daemon's request WAL.

The port's copy of ``jepsen_tpu/journal.py``. One record per line::

    <crc32 as 8 lowercase hex chars> <compact JSON document>\\n

The CRC covers exactly the JSON payload bytes, so a reader tells a torn
final record (a write cut by a crash) from a corrupted earlier one. Each
record is one unbuffered write; with ``fsync`` each append is also synced
to the disk, which is what makes an acknowledged request survive a power
loss.

The op WAL (:class:`Journal`, ``history.wal`` in a run's store
directory): ``core.conj_op`` tees every op into it as the op is recorded,
so a run killed mid-flight leaves a checkable prefix of its history, which
``store.recover_run`` (the ``recover`` command) rebuilds. Its records are
byte for byte the reference's. The fsync cadence comes from the
environment:

* ``JTPU_WAL_SYNC=op``    -- fsync after every append;
* ``JTPU_WAL_SYNC=batch`` -- (default) fsync at most once per
  ``JTPU_WAL_BATCH_MS`` (default 50) window, and on close;
* ``JTPU_WAL_SYNC=off``   -- never fsync (still one write per append).

``JTPU_WAL=0`` turns the op WAL off. A clean run's ``history.jsonl`` is
the same with it on or off.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from typing import Optional, Tuple

from jepsen_tpu_torch.history import History, INFO, Op
from jepsen_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger("jepsen_tpu_torch.journal")

_FSYNC_SECONDS = obs_metrics.histogram(
    "jtpu_wal_fsync_seconds",
    "WAL fsync latency per sync (labeled by the sync policy)")
_BATCH_RECORDS = obs_metrics.histogram(
    "jtpu_wal_batch_records",
    "records accumulated between WAL fsyncs (batch sizes)",
    buckets=(1, 2, 5, 10, 25, 50, 100, 250, 500, 1000))
_WAL_RECORDS = obs_metrics.counter(
    "jtpu_wal_records_total", "ops teed into the write-ahead journal")

#: The op journal's filename inside a run's store directory.
WAL_NAME = "history.wal"

SYNC_OP = "op"
SYNC_BATCH = "batch"
SYNC_OFF = "off"
SYNC_POLICIES = (SYNC_OP, SYNC_BATCH, SYNC_OFF)

DEFAULT_BATCH_MS = 50.0


def _json_default(x):
    if isinstance(x, (set, frozenset)):
        return sorted(x, key=repr)
    if isinstance(x, bytes):
        return x.decode("utf-8", "replace")
    return repr(x)


def encode_json_record(doc: dict) -> bytes:
    """One CRC'd journal line for a JSON document."""
    payload = json.dumps(doc, separators=(",", ":"),
                         default=_json_default).encode("utf-8")
    return b"%08x " % (zlib.crc32(payload) & 0xFFFFFFFF) + payload + b"\n"


def decode_json_record(line: bytes) -> Optional[dict]:
    """One CRC'd journal line back to its document; None when the line is
    torn or corrupt (CRC mismatch, malformed JSON, not an object)."""
    if len(line) < 10 or line[8:9] != b" ":
        return None
    crc, payload = line[:8], line[9:]
    try:
        if int(crc, 16) != (zlib.crc32(payload) & 0xFFFFFFFF):
            return None
        d = json.loads(payload)
    except (ValueError, TypeError):
        return None
    return d if isinstance(d, dict) else None


def _decode_lines(path: str, decode, what: str) -> Tuple[list, dict]:
    """Decode every line of a journal: an undecodable unterminated last
    line is the crash's torn tail (``torn``), any other undecodable line
    is ``corrupt``, skipped and warned about."""
    stats = {"records": 0, "torn": 0, "corrupt": 0}
    with open(path, "rb") as f:
        data = f.read()
    lines = data.split(b"\n")
    terminated = data.endswith(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    out = []
    for i, line in enumerate(lines):
        d = decode(line)
        if d is not None:
            out.append(d)
            stats["records"] += 1
        elif i == len(lines) - 1 and not terminated:
            stats["torn"] += 1
        else:
            stats["corrupt"] += 1
            log.warning("%s %s: dropping corrupt record at line %d",
                        what, path, i + 1)
    return out, stats


def read_json_records(path: str) -> Tuple[list, dict]:
    """``(records, stats)`` of a journal of JSON documents."""
    return _decode_lines(path, decode_json_record, "journal")


class JsonRecordWriter:
    """Append-only writer of CRC'd records: one unbuffered write per
    record (a crash loses at most the torn tail); ``fsync=True`` syncs
    each append. A failed write disables the writer (:attr:`failed`)."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self.records = 0
        self.failed: Optional[str] = None
        self._lock = threading.Lock()
        self._f = open(path, "ab", buffering=0)

    def append(self, doc: dict) -> None:
        line = encode_json_record(doc)
        with self._lock:
            if self._f is None or self.failed is not None:
                return
            try:
                self._f.write(line)
                self.records += 1
                if self.fsync:
                    os.fsync(self._f.fileno())
            except OSError as e:
                self.failed = f"{type(e).__name__}: {e}"
                log.warning("journal append to %s failed (%s); the "
                            "writer is disabled", self.path, self.failed)

    def close(self) -> None:
        with self._lock:
            if self._f is None:
                return
            try:
                self._f.close()
            finally:
                self._f = None


def enabled() -> bool:
    """Whether the op WAL is on at all (``JTPU_WAL``, default on)."""
    return os.environ.get("JTPU_WAL", "1").lower() not in (
        "0", "false", "no", "off")


def sync_policy() -> str:
    """The fsync cadence from ``JTPU_WAL_SYNC`` (op|batch|off)."""
    v = os.environ.get("JTPU_WAL_SYNC", SYNC_BATCH).strip().lower()
    if v not in SYNC_POLICIES:
        log.warning("JTPU_WAL_SYNC=%r is not one of %s; using %r",
                    v, "|".join(SYNC_POLICIES), SYNC_BATCH)
        return SYNC_BATCH
    return v


def batch_window_s() -> float:
    """The batch-mode fsync window from ``JTPU_WAL_BATCH_MS``, in
    seconds."""
    v = os.environ.get("JTPU_WAL_BATCH_MS")
    if not v:
        return DEFAULT_BATCH_MS / 1000.0
    try:
        return max(0.0, float(v)) / 1000.0
    except ValueError:
        log.warning("JTPU_WAL_BATCH_MS=%r is not a number; using %s",
                    v, DEFAULT_BATCH_MS)
        return DEFAULT_BATCH_MS / 1000.0


def encode_record(op: Op) -> bytes:
    """One WAL line for an op: CRC-prefixed compact JSON."""
    return encode_json_record(op.to_dict())


def decode_record(line: bytes) -> Optional[Op]:
    """One WAL line back to an Op; None if the line is torn or corrupt."""
    d = decode_json_record(line)
    if d is None or "type" not in d:
        return None
    try:
        return Op.from_dict(d)
    except (ValueError, TypeError, KeyError):
        return None


class Journal:
    """Append-only, fsync-batched op journal. ``core.conj_op`` serializes
    appends under the history lock already; the journal keeps a lock of
    its own for direct users. A failed write disables the journal
    (:attr:`failed`, and a log line): the run never dies of its
    crash-insurance file."""

    def __init__(self, path: str, sync: Optional[str] = None,
                 batch_s: Optional[float] = None):
        self.path = path
        self.sync = sync if sync in SYNC_POLICIES else sync_policy()
        self.batch_s = batch_window_s() if batch_s is None else batch_s
        self.records = 0
        self.syncs = 0
        self.failed: Optional[str] = None
        self._lock = threading.Lock()
        self._dirty = False
        self._pending = 0  # records since the last fsync (batch size)
        self._last_sync = time.monotonic()
        self._f = open(path, "ab", buffering=0)

    def __repr__(self):
        with self._lock:
            failed, closed = self.failed, self._f is None
        state = f"failed: {failed}" if failed else \
            ("closed" if closed else "open")
        return (f"<Journal {self.path!r} sync={self.sync} "
                f"records={self.records} syncs={self.syncs} {state}>")

    def _fsync(self) -> None:
        t0 = time.monotonic()
        os.fsync(self._f.fileno())
        _FSYNC_SECONDS.observe(time.monotonic() - t0, sync=self.sync)
        if self._pending:
            _BATCH_RECORDS.observe(self._pending)
        self.syncs += 1
        self._dirty = False
        self._pending = 0
        self._last_sync = time.monotonic()

    def append(self, op: Op) -> None:
        """Tee one op: one unbuffered write (the kernel has the whole
        record once it returns), then an fsync as the policy says."""
        line = encode_record(op)
        with self._lock:
            if self._f is None or self.failed is not None:
                return
            try:
                self._f.write(line)
                self.records += 1
                self._pending += 1
                _WAL_RECORDS.inc()
                self._dirty = True
                if self.sync == SYNC_OP:
                    self._fsync()
                elif (self.sync == SYNC_BATCH and
                        time.monotonic() - self._last_sync >= self.batch_s):
                    self._fsync()
            except OSError as e:
                self.failed = f"{type(e).__name__}: {e}"
                log.warning("WAL append to %s failed (%s); the journal "
                            "is disabled for the rest of the run",
                            self.path, self.failed)

    def flush(self) -> None:
        """fsync now (unless the policy is off)."""
        with self._lock:
            if self._f is None or self.failed is not None:
                return
            try:
                if self.sync != SYNC_OFF and self._dirty:
                    self._fsync()
            except OSError as e:
                self.failed = f"{type(e).__name__}: {e}"

    def close(self) -> None:
        with self._lock:
            if self._f is None:
                return
            try:
                if self.sync != SYNC_OFF and self._dirty:
                    self._fsync()
            except OSError:
                pass
            try:
                self._f.close()
            finally:
                self._f = None


def open_journal(store_dir: Optional[str]) -> Optional[Journal]:
    """A Journal in a run's store directory, or None when the WAL is off
    or there is no directory."""
    if not store_dir or not enabled():
        return None
    try:
        return Journal(os.path.join(store_dir, WAL_NAME))
    except OSError as e:
        log.warning("couldn't open the WAL in %s: %s", store_dir, e)
        return None


def read_wal(path: str) -> Tuple[History, dict]:
    """``(history, stats)`` of an op WAL: at most the torn last record is
    lost; a corrupt earlier record is skipped and counted."""
    ops, stats = _decode_lines(path, decode_record, "WAL")
    return History(ops), stats


def reconcile(history: History) -> Tuple[History, int]:
    """Resolve dangling invokes to ``info`` completions. A run killed
    mid-flight leaves invocations whose completions were never recorded:
    like a crashed worker's op, each may or may not have taken effect, so
    each gets a synthesized ``info`` completion at the history's last
    time, in the order of the invokes' times (then process). Returns a new
    (history, n_reconciled); does not mutate the input."""
    open_by_proc: dict = {}
    for o in history:
        if o.is_invoke:
            open_by_proc[o.process] = o
        else:
            open_by_proc.pop(o.process, None)
    out = History(history)
    t_end = max((o.time for o in history), default=0)
    dangling = sorted(open_by_proc.values(),
                      key=lambda o: (o.time, str(o.process)))
    for inv in dangling:
        out.append(inv.replace(
            type=INFO, time=t_end, index=-1,
            error="wal-recovery: the run died before this op completed"))
    return out, len(dangling)
