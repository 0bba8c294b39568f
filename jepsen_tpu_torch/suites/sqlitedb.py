"""sqlite suite: a second real-database tier, on localhost.

The system under test is a real production storage engine: SQLite, the
C library that the stdlib ``sqlite3`` module links, arbitrating
concurrency across real connections to a WAL database on the local disk.
The suite follows the reference's postgres-rds pattern: one real managed
instance, the workers' clients connect to it in-process, and the faults
are client-visible ones (there is no node to kill).

Three tests:

- ``sqlite_register_test``: a CAS register over ``BEGIN IMMEDIATE``
  transactions, under a lock-hammer nemesis (a rogue connection holding
  the write lock for 1.5 s: real contention, busy timeouts, latency
  spikes). Linearizable by construction: the check should validate.
- ``sqlite_bank_test``: the bank-transfer invariant under concurrent
  transfers and snapshot reads: the total never moves.
- ``sqlite_register_toctou_test``: the register client with cas written
  as the classic application bug: SELECT, think, UPDATE in separate
  transactions. A deterministic two-thread schedule makes both cas's of
  the same old value succeed, a real lost update in a real engine, which
  the linearizability check must refute.

The port's copy of ``jepsen_tpu.suites.sqlitedb``, with two differences:
the linearizability check runs on the card (``backend`` "gpu", the
default) unless the options name the CPU (``backend: "cpu"`` for the host
search, ``device: "cpu"`` for the kernels' plain versions), and the
databases lie under the temporary directory (``TMPDIR``).
"""

from __future__ import annotations

import os
import sqlite3
import tempfile
import threading
import time

from jepsen_tpu_torch import client as client_ns
from jepsen_tpu_torch import db as db_ns
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import nemesis
from jepsen_tpu_torch.checker import compose, perf
from jepsen_tpu_torch.checker.wgl import linearizable
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.suites import workloads as wl
from jepsen_tpu_torch.testing import noop_test

RUN_DIR = os.path.join(tempfile.gettempdir(), "jepsen-sqlite")

#: In-process allocation cursor: successive test constructors never share
#: a database file, even when built up front and run in parallel.
_db_seq = iter(range(1 << 30))
_db_seq_lock = threading.Lock()

#: ms a connection waits for the write lock before it gives up. Short on
#: purpose: the lock hammer should produce visible busy failures, not
#: silent stalls.
BUSY_TIMEOUT_MS = 500


def _next_db_id() -> int:
    with _db_seq_lock:
        return next(_db_seq)


def db_path(test) -> str:
    return test["sqlite-path"]


def _connect(path: str) -> sqlite3.Connection:
    # check_same_thread=False: the lock hammer's release runs on a timer
    # thread; each connection is still used by one thread at a time
    conn = sqlite3.connect(path, timeout=BUSY_TIMEOUT_MS / 1000.0,
                           isolation_level=None,  # explicit BEGINs only
                           check_same_thread=False)
    conn.execute(f"PRAGMA busy_timeout={BUSY_TIMEOUT_MS}")
    return conn


class SqliteDB(db_ns.DB):
    """Creates and removes the database file and its schema. One instance,
    like the reference's RDS endpoint: every node name maps to the same
    file."""

    def __init__(self, schema: str):
        self.schema = schema
        self._done = threading.Lock()
        self._nodes_setup: set = set()

    def setup(self, test, node):
        # one shared instance: the first node in creates it
        with self._done:
            if self._nodes_setup:
                self._nodes_setup.add(node)
                return
            self._nodes_setup.add(node)
            os.makedirs(os.path.dirname(db_path(test)), exist_ok=True)
            for suffix in ("", "-wal", "-shm"):
                try:
                    os.remove(db_path(test) + suffix)
                except FileNotFoundError:
                    pass
            conn = _connect(db_path(test))
            try:
                conn.execute("PRAGMA journal_mode=WAL")
                conn.executescript(self.schema)
            finally:
                conn.close()

    def teardown(self, test, node):
        with self._done:
            self._nodes_setup.discard(node)
            if self._nodes_setup:
                return
        # the last node out checkpoints; the file stays
        try:
            conn = _connect(db_path(test))
            conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
            conn.close()
        except sqlite3.Error:
            pass


REGISTER_SCHEMA = """
CREATE TABLE IF NOT EXISTS register (
  id  INTEGER PRIMARY KEY,
  val INTEGER
);
INSERT OR REPLACE INTO register (id, val) VALUES (0, NULL);
"""


class _SqliteClient(client_ns.Client):
    """The connection plumbing both workloads share: one lazy connection a
    worker, and the rollback-or-drop recovery.

    sqlite is a local engine, so whether a failed op applied is known: a
    failed ``BEGIN IMMEDIATE`` (lock not taken) or a failed ``COMMIT``
    both mean the transaction did not apply, so busy errors are clean
    ``fail``s, not ``info``s (unlike a network client, where a lost
    acknowledgement must crash the op to ``info``)."""

    def __init__(self):
        self.conn = None
        self.path = None

    def open(self, test, node):
        c = type(self)()
        c.path = db_path(test)
        return c

    def close(self, test):
        if self.conn is not None:
            try:
                self.conn.close()
            except sqlite3.Error:
                pass
            self.conn = None

    def _c(self) -> sqlite3.Connection:
        if self.conn is None:
            self.conn = _connect(self.path)
        return self.conn

    def _rollback(self):
        try:
            if self.conn is not None:
                self.conn.execute("ROLLBACK")
        except sqlite3.Error:
            # no transaction open, or the connection is gone: either way
            # the op did not apply
            self.close(None)


class SqliteRegisterClient(_SqliteClient):
    """A CAS register over real transactions, one connection a worker."""

    def invoke(self, test, op: Op) -> Op:
        try:
            conn = self._c()
            if op.f == "read":
                row = conn.execute(
                    "SELECT val FROM register WHERE id=0").fetchone()
                return op.replace(type="ok",
                                  value=row[0] if row else None)
            if op.f == "write":
                conn.execute("BEGIN IMMEDIATE")
                conn.execute("UPDATE register SET val=? WHERE id=0",
                             (op.value,))
                conn.execute("COMMIT")
                return op.replace(type="ok")
            if op.f == "cas":
                old, new = op.value
                conn.execute("BEGIN IMMEDIATE")
                cur = conn.execute(
                    "UPDATE register SET val=? WHERE id=0 AND val=?",
                    (new, old))
                hit = cur.rowcount == 1
                conn.execute("COMMIT")
                return op.replace(type="ok" if hit else "fail",
                                  error=None if hit else "cas mismatch")
            raise ValueError(f"unknown op {op.f!r}")
        except sqlite3.Error as e:
            self._rollback()
            return op.replace(type="fail", error=str(e))


class SqliteToctouClient(SqliteRegisterClient):
    """The register client with the classic application bug: cas as
    SELECT, think, UPDATE in separate transactions. The engine is
    innocent; the application threw atomicity away. ``think_s`` widens
    the race so that a deterministic schedule can force the lost
    update."""

    #: wide by default: the schedule is only as deterministic as both
    #: workers reaching their SELECT inside this window, and a loaded
    #: host can deschedule a thread for seconds
    def __init__(self, think_s: float = 5.0):
        super().__init__()
        self.think_s = think_s

    def open(self, test, node):
        c = SqliteToctouClient(self.think_s)
        c.path = db_path(test)
        return c

    def invoke(self, test, op: Op) -> Op:
        if op.f != "cas":
            return super().invoke(test, op)
        old, new = op.value
        try:
            conn = self._c()
            row = conn.execute(
                "SELECT val FROM register WHERE id=0").fetchone()
            if row is None or row[0] != old:
                return op.replace(type="fail", error="cas mismatch")
            time.sleep(self.think_s)          # the check-then-act window
            conn.execute("BEGIN IMMEDIATE")
            conn.execute("UPDATE register SET val=? WHERE id=0", (new,))
            conn.execute("COMMIT")
            return op.replace(type="ok")
        except sqlite3.Error as e:
            self._rollback()
            return op.replace(type="fail", error=str(e))


def lock_hammer(hold_s: float = 1.5):
    """A rogue connection takes the write lock and sits on it: writers
    pile into busy timeouts while reads keep flowing (WAL). ``f=start``
    takes the lock, ``f=stop`` releases it; a timer releases it after
    ``hold_s`` seconds in any case."""
    state: dict = {}

    class LockHammer(nemesis.Nemesis):
        def setup(self, test):
            return self

        def invoke(self, test, op: Op) -> Op:
            if op.f == "start":
                conn = _connect(db_path(test))
                try:
                    conn.execute("BEGIN IMMEDIATE")
                except sqlite3.Error as e:
                    conn.close()
                    return op.replace(type="info", value=f"no lock: {e}")
                state["conn"] = conn
                t = threading.Timer(hold_s, _release)
                t.daemon = True
                state["timer"] = t
                t.start()
                return op.replace(type="info",
                                  value=f"write lock held {hold_s}s")
            if op.f == "stop":
                _release()
                return op.replace(type="info", value="released")
            return op.replace(type="info")

        def teardown(self, test):
            _release()

    def _release():
        conn = state.pop("conn", None)
        timer = state.pop("timer", None)
        if timer is not None:
            timer.cancel()
        if conn is not None:
            try:
                conn.execute("COMMIT")
            except sqlite3.Error:
                pass
            conn.close()

    return LockHammer()


def _nemesis_cycle(period: float):
    while True:
        yield gen.sleep(period)
        yield gen.once({"type": "info", "f": "start"})
        yield gen.sleep(period)
        yield gen.once({"type": "info", "f": "stop"})


def _base(opts: dict, name: str) -> dict:
    opts = dict(opts)
    test = noop_test()
    test.update({
        "name": name,
        # one real instance; the node names are the clients' homes, not
        # servers
        "nodes": ["db1"],
        "ssh": {"mode": "local"},
        "sqlite-path": os.path.join(
            RUN_DIR, f"{name}-{os.getpid()}-{_next_db_id()}.db"),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("concurrency", "time-limit", "store-dir",
                          "store-root", "sqlite-path")})
    return test


def _linear(opts: dict):
    """The register's linearizability check: on the card unless the
    options name the CPU."""
    return linearizable(CASRegister(), backend=opts.get("backend", "gpu"),
                        device=opts.get("device"))


def sqlite_register_test(opts: dict) -> dict:
    """A linearizable CAS register on the real engine, under the lock
    hammer."""
    test = _base(opts, "sqlite-register")
    test.update({
        "db": SqliteDB(REGISTER_SCHEMA),
        "client": SqliteRegisterClient(),
        "nemesis": lock_hammer(),
        "model": CASRegister(),
        "checker": compose({
            "perf": perf(),
            "linear": _linear(opts),
        }),
        "generator": gen.time_limit(
            opts.get("time-limit", 10),
            gen.clients(
                gen.stagger(1 / 30, gen.mix([wl.r, wl.w, wl.cas])),
                gen.seq(_nemesis_cycle(opts.get("nemesis-period", 3))))),
    })
    return test


N_ACCOUNTS = 5
TOTAL = 50

BANK_SCHEMA = ("CREATE TABLE IF NOT EXISTS accounts "
               "(id INTEGER PRIMARY KEY, balance INTEGER NOT NULL);\n"
               + "\n".join(
                   f"INSERT OR REPLACE INTO accounts VALUES "
                   f"({i}, {TOTAL // N_ACCOUNTS});"
                   for i in range(N_ACCOUNTS)))


class SqliteBankClient(_SqliteClient):
    """Transfers inside one write transaction; reads are one-statement
    snapshots (one SELECT is atomic in sqlite)."""

    def invoke(self, test, op: Op) -> Op:
        try:
            conn = self._c()
            if op.f == "read":
                rows = conn.execute(
                    "SELECT balance FROM accounts ORDER BY id"
                ).fetchall()
                return op.replace(type="ok",
                                  value=[r[0] for r in rows])
            if op.f == "transfer":
                v = op.value
                conn.execute("BEGIN IMMEDIATE")
                row = conn.execute(
                    "SELECT balance FROM accounts WHERE id=?",
                    (v["from"],)).fetchone()
                if row is None or row[0] < v["amount"]:
                    conn.execute("COMMIT")
                    return op.replace(type="fail",
                                      error="insufficient funds")
                conn.execute("UPDATE accounts SET balance=balance-? "
                             "WHERE id=?", (v["amount"], v["from"]))
                conn.execute("UPDATE accounts SET balance=balance+? "
                             "WHERE id=?", (v["amount"], v["to"]))
                conn.execute("COMMIT")
                return op.replace(type="ok")
            raise ValueError(f"unknown op {op.f!r}")
        except sqlite3.Error as e:
            self._rollback()
            return op.replace(type="fail", error=str(e))


def sqlite_bank_test(opts: dict) -> dict:
    """The bank invariant under concurrent transfers and the lock
    hammer."""
    test = _base(opts, "sqlite-bank")
    test.update({
        "db": SqliteDB(BANK_SCHEMA),
        "client": SqliteBankClient(),
        "nemesis": lock_hammer(),
        "checker": compose({
            "perf": perf(),
            "bank": wl.bank_checker(N_ACCOUNTS, TOTAL),
        }),
        "generator": gen.time_limit(
            opts.get("time-limit", 10),
            gen.clients(
                gen.stagger(1 / 30, gen.mix(
                    [wl.bank_read, wl.bank_diff_transfer(N_ACCOUNTS)])),
                gen.seq(_nemesis_cycle(opts.get("nemesis-period", 3))))),
    })
    return test


def sqlite_register_toctou_test(opts: dict) -> dict:
    """The lost-update schedule: write 0, then two workers cas 0->1 and
    0->2 concurrently through the non-atomic client. Both SELECT 0 in the
    think window, both UPDATE, both report ok: two successful cas's of the
    same old value with no write between them, which no linearization
    explains. The check must refute and render ``linear.svg``."""
    test = _base(opts, "sqlite-register-toctou")

    def racing_cas(test, process):
        t = gen.process_to_thread(process, test)
        return {"type": "invoke", "f": "cas", "value": (0, 1 + t)}

    def schedule():
        return gen.phases(
            gen.on_threads(lambda t: t == 0, gen.once(
                {"type": "invoke", "f": "write", "value": 0})),
            # one cas a thread, pulled concurrently: Each gives every
            # thread in scope its own once()
            gen.on_threads(lambda t: t in (0, 1),
                           gen.Each(lambda: gen.once(racing_cas))),
            gen.on_threads(lambda t: t == 2, gen.once(
                {"type": "invoke", "f": "read", "value": None})))

    test.update({
        "db": SqliteDB(REGISTER_SCHEMA),
        "client": SqliteToctouClient(),
        "model": CASRegister(),
        "checker": compose({
            "perf": perf(),
            "linear": _linear(opts),
        }),
        "generator": gen.time_limit(
            opts.get("time-limit", 20), gen.clients(schedule())),
    })
    if int(test.get("concurrency") or 0) < 3:
        test["concurrency"] = 3
    return test


def main(argv=None):
    """The reference's command line: ``test`` runs
    :func:`sqlite_register_test`, ``serve`` the results browser (``python -m
    jepsen_tpu_torch.suites.sqlitedb test|serve ...``)."""
    from jepsen_tpu_torch import cli
    cli.main(cli.merge_commands(cli.single_test_cmd(sqlite_register_test),
                                cli.serve_cmd()), argv)


if __name__ == "__main__":
    main()
