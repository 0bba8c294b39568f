"""Auto-reconnecting connection wrappers.

Rebuild of jepsen.reconnect (jepsen/src/jepsen/reconnect.clj): a Wrapper
holds a connection behind a readers-writer discipline — many threads may
use the current connection concurrently (with_conn), while open/close/
reopen take the write side. An error inside with_conn closes and reopens
the connection, then rethrows, so the *next* operation gets a fresh conn
(reconnect.clj:92-129).

Reopen-on-error is paced: consecutive failures back off with capped
exponential delay plus jitter (a dead endpoint must not be hammered with
back-to-back reopens, and synchronized workers must not stampede it the
instant it returns). The per-wrapper consecutive-failure counter is
surfaced in the wrapper's repr and reconnect log lines. Base/cap are
env-tunable: JEPSEN_RECONNECT_BASE / JEPSEN_RECONNECT_CAP (seconds). The
port's copy of ``jepsen_tpu.reconnect``."""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Optional

log = logging.getLogger("jepsen.reconnect")


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        return default


#: Defaults for the reopen backoff (seconds); see Wrapper.__init__.
BACKOFF_BASE_S = 0.02
BACKOFF_CAP_S = 5.0


class _RWLock:
    """Readers-writer lock (writer-preferring enough for our use)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False

    @contextmanager
    def read(self):
        with self._cond:
            while self._writer:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                self._cond.notify_all()

    @contextmanager
    def write(self):
        with self._cond:
            while self._writer or self._readers:
                self._cond.wait()
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


class Wrapper:
    """Stateful reconnecting wrapper (reconnect.clj:16-31)."""

    def __init__(self, open: Callable[[], Any],
                 close: Callable[[Any], None],
                 name: Optional[str] = None, log_reconnects: bool = False,
                 backoff_base_s: Optional[float] = None,
                 backoff_cap_s: Optional[float] = None):
        assert callable(open) and callable(close)
        self._open = open
        self._close = close
        self.name = name
        self.log_reconnects = log_reconnects
        self._lock = _RWLock()
        self._conn: Optional[Any] = None
        #: Consecutive failed uses of this wrapper's connection (reset by
        #: a with_conn body completing). Drives the reopen backoff and is
        #: surfaced in __repr__ / log lines for operators.
        self.failures = 0
        self._fail_lock = threading.Lock()
        self._backoff_base = (backoff_base_s
                              if backoff_base_s is not None else
                              _env_float("JEPSEN_RECONNECT_BASE",
                                         BACKOFF_BASE_S))
        self._backoff_cap = (backoff_cap_s
                             if backoff_cap_s is not None else
                             _env_float("JEPSEN_RECONNECT_CAP",
                                        BACKOFF_CAP_S))
        self._rng = random.Random()

    def __repr__(self):
        state = "open" if self._conn is not None else "closed"
        return (f"<reconnect.Wrapper {self.name!r} {state} "
                f"failures={self.failures}>")

    def backoff_s(self) -> float:
        """Current reopen delay: capped exponential in the consecutive-
        failure count, jittered to [50%, 100%] so a fleet of workers
        whose conns died together doesn't stampede the endpoint."""
        n = self.failures
        if n <= 0:
            return 0.0
        d = min(self._backoff_cap, self._backoff_base * (2 ** (n - 1)))
        return d * (0.5 + self._rng.random() / 2)

    def _note_failure(self) -> int:
        with self._fail_lock:
            self.failures += 1
            return self.failures

    def _note_success(self) -> None:
        with self._fail_lock:
            self.failures = 0

    @property
    def conn(self):
        return self._conn

    def open(self) -> "Wrapper":
        """Open a connection; no-op if one exists (reconnect.clj:54-66)."""
        with self._lock.write():
            if self._conn is None:
                c = self._open()
                if c is None:
                    raise RuntimeError(
                        f"Error opening connection for {self.name!r}: "
                        f"open returned None")
                self._conn = c
        return self

    def close(self) -> "Wrapper":
        """Close the current connection, if any (reconnect.clj:68-75)."""
        with self._lock.write():
            if self._conn is not None:
                try:
                    self._close(self._conn)
                finally:
                    self._conn = None
        return self

    def reopen(self) -> "Wrapper":
        """Close (best-effort) and open a fresh connection
        (reconnect.clj:77-90). Applies the failure backoff BEFORE taking
        the write lock, so waiting out a dead endpoint never blocks
        readers of a still-working connection."""
        delay = self.backoff_s()
        if delay > 0:
            time.sleep(delay)
        with self._lock.write():
            if self._conn is not None:
                try:
                    self._close(self._conn)
                except Exception:  # noqa: BLE001
                    pass
                self._conn = None
            self._conn = self._open()
        return self

    @contextmanager
    def with_conn(self):
        """Yield the current connection; on error, back off, reopen and
        rethrow (reconnect.clj:92-129)."""
        with self._lock.read():
            if self._conn is None:
                need_open = True
            else:
                need_open = False
        if need_open:
            self.open()
        with self._lock.read():
            c = self._conn
        try:
            yield c
        except Exception:
            n = self._note_failure()
            delay = self.backoff_s()
            if self.log_reconnects:
                log.warning(
                    "Encountered error with conn %r; reopening after "
                    "%.3fs backoff (%r)", self.name, delay, self)
            # only reopen if nobody else already swapped the conn; the
            # backoff sleep happens OUTSIDE the locks (and only in the
            # thread that will actually reopen) so concurrent users of a
            # replaced conn aren't serialized behind it
            if self._conn is c:
                if delay > 0:
                    time.sleep(delay)
                with self._lock.write():
                    if self._conn is c:
                        try:
                            self._close(c)
                        except Exception:  # noqa: BLE001
                            pass
                        self._conn = self._open()
            raise
        else:
            self._note_success()


def wrapper(open: Callable[[], Any], close: Callable[[Any], None],
            name: Optional[str] = None,
            log_reconnects: bool = False,
            backoff_base_s: Optional[float] = None,
            backoff_cap_s: Optional[float] = None) -> Wrapper:
    return Wrapper(open, close, name, log_reconnects,
                   backoff_base_s=backoff_base_s,
                   backoff_cap_s=backoff_cap_s)
