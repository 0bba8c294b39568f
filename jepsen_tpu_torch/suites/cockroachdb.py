"""CockroachDB suite — the richest workload/nemesis family.

Rebuild of cockroachdb/src/jepsen/cockroach*: the basic-test phase template
(during -> nemesis stop -> quiesce -> final reads, cockroach.clj:153-163),
a SQL data plane, the parameterized nemesis library (named maps with
{name, during, final, client, clocks}, cockroach/nemesis.clj:28-200) with
composition via [name, f]-tagged ops, cartesian nemesis products
(runner.clj:94-110), slowing/restarting wrappers, and the workload family:
independent register, bank, sets, monotonic, sequential, g2.

The SQL client drives ``cockroach sql`` on the nodes over the control
plane (the reference uses jdbc; the wire protocol differs, the SQL and the
error taxonomy — txn retries, indeterminate commits — are the same).

The port's copy of ``jepsen_tpu.suites.cockroachdb``, with one
difference: the register's linearizability check runs on the card
(``backend`` "gpu", the default) unless the options name the CPU
(``backend: "cpu"`` for the host search, ``device: "cpu"`` for the
kernels' plain versions)."""

from __future__ import annotations

import random
import re
from typing import Any, Callable, Dict, List, Optional, Sequence

from jepsen_tpu_torch import client as client_ns
from jepsen_tpu_torch import control, core
from jepsen_tpu_torch import db as db_ns
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import independent
from jepsen_tpu_torch import nemesis as nem
from jepsen_tpu_torch.checker import Checker, compose, perf, set_checker
from jepsen_tpu_torch.checker.wgl import linearizable
from jepsen_tpu_torch.control import util as cu
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.nemesis import time as nt
from jepsen_tpu_torch.suites import workloads as wl
from jepsen_tpu_torch.testing import noop_test

COCKROACH = "/opt/cockroach/cockroach"
DIR = "/opt/cockroach"
STORE = "/var/lib/cockroach"
LOGFILE = f"{DIR}/cockroach.log"
PIDFILE = f"{DIR}/cockroach.pid"

NEMESIS_DELAY = 5
NEMESIS_DURATION = 15

# ---------------------------------------------------------------------------
# SQL data plane
# ---------------------------------------------------------------------------


class SQLError(RuntimeError):
    def __init__(self, msg, retryable=False, indeterminate=False):
        super().__init__(msg)
        self.retryable = retryable
        self.indeterminate = indeterminate


def classify_error(e: control.RemoteError) -> SQLError:
    """The reference's exception taxonomy (cockroach/client.clj:128-236):
    retryable txn conflicts vs definite failures vs indeterminate
    commits."""
    msg = f"{e.err or ''} {e.out or ''}"
    retry = bool(re.search(r"retry transaction|restart transaction|"
                           r"TransactionRetryError", msg))
    indet = bool(re.search(r"connection (reset|refused)|timed? ?out|"
                           r"broken pipe|EOF", msg, re.I))
    return SQLError(msg.strip()[:200], retryable=retry, indeterminate=indet)


def sql(test: dict, node, statement: str, attempts: int = 3) -> List[List[str]]:
    """Run SQL on a node via the cockroach CLI; returns rows of columns
    (TSV, header dropped). Retries retryable txn errors."""
    for attempt in range(attempts):
        try:
            out = control.execute(
                test, node,
                f"{COCKROACH} sql --insecure --host {control.escape(str(node))} "
                f"--format tsv -e {control.escape(statement)}")
            rows = [line.split("\t") for line in out.splitlines()
                    if line.strip()]
            return rows[1:] if rows else []
        except control.RemoteError as e:
            err = classify_error(e)
            if err.retryable and attempt < attempts - 1:
                continue
            raise err from e
    return []


class SQLClient(client_ns.Client):
    """Base client: subclasses implement _invoke; SQL errors map to
    fail/info per the taxonomy (reads always fail-safe)."""

    def __init__(self, node=None):
        self.node = node

    def open(self, test, node):
        c = type(self)()
        c.node = node
        return c

    def invoke(self, test, op: Op) -> Op:
        crash = "fail" if op.f == "read" else "info"
        try:
            return self._invoke(test, op)
        except SQLError as e:
            if e.indeterminate and op.f != "read":
                return op.replace(type="info", error=str(e)[:80])
            return op.replace(type="fail" if not e.indeterminate else crash,
                              error=str(e)[:80])
        except control.RemoteError as e:
            return op.replace(type=crash, error=str(e)[:80])


# ---------------------------------------------------------------------------
# DB lifecycle (cockroach.clj db + auto.clj)
# ---------------------------------------------------------------------------


#: On-node pcap written by the packet capture (auto.clj pcaplog).
PCAPLOG = f"{DIR}/trace.pcap"
DB_PORT = 26257


def control_addr(test, node) -> str:
    """The control node's address as seen from a DB node: the SSH_CLIENT
    env var of our own session (auto.clj:58-66). The sudo wrapper is
    dropped so we read the session's env, not a subshell's."""
    import re as _re
    line = control.execute(test, node, "env | grep SSH_CLIENT")
    m = _re.search(r"SSH_CLIENT=(.+?)\s", line)
    if not m:
        raise control.RemoteError(node, "env | grep SSH_CLIENT", 1,
                                  line, "no SSH_CLIENT")
    return m.group(1)


def packet_capture(test, node) -> None:
    """Start tcpdump on the node, filtered to control-node traffic on the
    SQL port, as a background daemon (auto.clj packet-capture!,
    :67-76)."""
    addr = control_addr(test, node)
    with control.sudo():
        control.exec(test, node, "start-stop-daemon",
                     "--start", "--background",
                     "--exec", "/usr/sbin/tcpdump",
                     "--",
                     "-w", PCAPLOG, "host", addr,
                     "and", "port", DB_PORT)


def stop_packet_capture(test, node) -> None:
    with control.sudo():
        try:
            control.exec(test, node, "killall", "-9", "-w", "tcpdump")
        except control.RemoteError:
            pass


class CockroachDB(db_ns.DB, db_ns.LogFiles):
    def __init__(self, version: str = "v1.0", tcpdump: bool = False):
        self.version = version
        self.tcpdump = tcpdump

    def tarball_url(self):
        return (f"https://binaries.cockroachdb.com/"
                f"cockroach-{self.version}.linux-amd64.tgz")

    def setup(self, test, node):
        cu.install_archive(test, node,
                           test.get("tarball", self.tarball_url()), DIR)
        if self.tcpdump or test.get("tcpdump"):
            packet_capture(test, node)
        joins = ",".join(str(n) for n in test["nodes"])
        cu.start_daemon(
            test, node, COCKROACH,
            "start", "--insecure", "--store", STORE,
            "--host", str(node), "--join", joins,
            "--cache", "25%",
            logfile=LOGFILE, pidfile=PIDFILE, chdir=DIR)

    def teardown(self, test, node):
        if self.tcpdump or test.get("tcpdump"):
            stop_packet_capture(test, node)
        cu.grepkill(test, node, "cockroach")
        control.exec(test, node, "rm", "-rf", STORE, LOGFILE)

    def log_files(self, test, node):
        out = [LOGFILE]
        if self.tcpdump or test.get("tcpdump"):
            out.append(PCAPLOG)
        return out


def kill(test, node):
    """auto.clj kill!: SIGKILL the server."""
    cu.grepkill(test, node, "cockroach")
    return "killed"


def start(test, node):
    """auto.clj start!: restart the daemon."""
    joins = ",".join(str(n) for n in test["nodes"])
    cu.start_daemon(test, node, COCKROACH,
                    "start", "--insecure", "--store", STORE,
                    "--host", str(node), "--join", joins,
                    logfile=LOGFILE, pidfile=PIDFILE, chdir=DIR)
    return "started"


# ---------------------------------------------------------------------------
# Nemesis library (cockroach/nemesis.clj)
# ---------------------------------------------------------------------------


def nemesis_no_gen() -> dict:
    return {"during": None, "final": None}


def nemesis_single_gen() -> dict:
    """sleep / start / sleep / stop cycle (nemesis.clj:33-39)."""
    def cycle():
        while True:
            yield gen.sleep(NEMESIS_DELAY)
            yield gen.once({"type": "info", "f": "start"})
            yield gen.sleep(NEMESIS_DURATION)
            yield gen.once({"type": "info", "f": "stop"})
    return {"during": gen.seq(cycle()),
            "final": gen.once({"type": "info", "f": "stop"})}


def none() -> dict:
    """The blank nemesis (nemesis.clj none)."""
    return {**nemesis_no_gen(), "name": "blank", "client": nem.noop(),
            "clocks": False}


def parts() -> dict:
    return {**nemesis_single_gen(), "name": "parts",
            "client": nem.partition_random_halves(), "clocks": False}


def majring() -> dict:
    return {**nemesis_single_gen(), "name": "majring",
            "client": nem.partition_majorities_ring(), "clocks": False}


def _take_n(n):
    def targeter(nodes):
        nodes = list(nodes)
        random.shuffle(nodes)
        return nodes[:n]
    return targeter


def startstop(n: int = 1) -> dict:
    """SIGSTOP/SIGCONT n random nodes (nemesis.clj startstop)."""
    return {**nemesis_single_gen(),
            "name": f"startstop{n if n > 1 else ''}",
            "client": nem.hammer_time("cockroach", targeter=_take_n(n)),
            "clocks": False}


def startkill(n: int = 1) -> dict:
    """Kill + restart n random nodes (nemesis.clj startkill)."""
    return {**nemesis_single_gen(),
            "name": f"startkill{n if n > 1 else ''}",
            "client": nem.node_start_stopper(_take_n(n), kill, start),
            "clocks": False}


class _SkewNemesis(nem.Nemesis):
    """Bump clocks on a random node subset by +/- delta ms on start, reset
    on stop (nemesis.clj:223-272 skews)."""

    def __init__(self, delta_ms: float):
        self.delta_ms = delta_ms

    def setup(self, test):
        nt.install(test)
        return self

    def invoke(self, test, op):
        if op.f == "start":
            targets = nt.random_nonempty_subset(test.get("nodes") or [])
            plan = {n: random.choice([-1, 1]) * self.delta_ms
                    for n in targets}
            control.on_nodes(test,
                             lambda t, n: nt.bump_time(t, n, plan[n]),
                             nodes=list(plan))
            return op.replace(value=plan)
        if op.f == "stop":
            control.on_nodes(test, nt.reset_time)
            return op.replace(value="clocks reset")
        raise ValueError(f"skew nemesis got f={op.f!r}")

    def teardown(self, test):
        control.on_nodes(test, nt.reset_time)


def skew(name: str, delta_ms: float) -> dict:
    return {**nemesis_single_gen(), "name": f"{name}-skews",
            "client": _SkewNemesis(delta_ms), "clocks": True}


def small_skews() -> dict:
    return skew("small", 100)


def subcritical_skews() -> dict:
    return skew("subcritical", 200)


def critical_skews() -> dict:
    return skew("critical", 250)


def big_skews() -> dict:
    return skew("big", 2_000)


def huge_skews() -> dict:
    return skew("huge", 7_500)


class _SlewNemesis(nem.Nemesis):
    """Gradually slew clocks on a random node subset via adjtime(2) —
    smooth drift, the fault NTP-disciplined clocks actually exhibit
    (reference cockroachdb/resources/adjtime.c, compiled by
    auto.clj:122-140)."""

    def __init__(self, delta_ms: float):
        self.delta_ms = delta_ms

    def setup(self, test):
        nt.install(test)
        return self

    def invoke(self, test, op):
        if op.f == "start":
            targets = nt.random_nonempty_subset(test.get("nodes") or [])
            plan = {n: random.choice([-1, 1]) * self.delta_ms
                    for n in targets}
            control.on_nodes(test,
                             lambda t, n: nt.slew_time(t, n, plan[n]),
                             nodes=list(plan))
            return op.replace(value=plan)
        if op.f == "stop":
            control.on_nodes(test, nt.reset_time)
            return op.replace(value="clocks reset")
        raise ValueError(f"slew nemesis got f={op.f!r}")

    def teardown(self, test):
        control.on_nodes(test, nt.reset_time)


def gradual_skews() -> dict:
    return {**nemesis_single_gen(), "name": "gradual-skews",
            "client": _SlewNemesis(250), "clocks": True}


class _StrobeNemesis(nem.Nemesis):
    def setup(self, test):
        nt.install(test)
        return self

    def invoke(self, test, op):
        if op.f == "start":
            targets = nt.random_nonempty_subset(test.get("nodes") or [])
            control.on_nodes(
                test, lambda t, n: nt.strobe_time(t, n, 200, 10, 10),
                nodes=targets)
            return op.replace(value=list(targets))
        if op.f == "stop":
            control.on_nodes(test, nt.reset_time)
            return op.replace(value="clocks reset")
        raise ValueError(f"strobe nemesis got f={op.f!r}")


def strobe_skews() -> dict:
    return {**nemesis_single_gen(), "name": "strobe-skews",
            "client": _StrobeNemesis(), "clocks": True}


class _Slowing(nem.Nemesis):
    """Slow the network around the inner nemesis's start/stop
    (nemesis.clj:153-176)."""

    def __init__(self, inner: nem.Nemesis, dt_s: float):
        self.inner = inner
        self.dt_s = dt_s

    def setup(self, test):
        n = test.get("net")
        if n:
            n.fast(test)
        self.inner = self.inner.setup(test) or self.inner
        return self

    def invoke(self, test, op):
        n = test.get("net")
        if op.f == "start":
            if n:
                n.slow(test, {"mean": self.dt_s * 1000, "variance": 1})
            return self.inner.invoke(test, op)
        if op.f == "stop":
            try:
                return self.inner.invoke(test, op)
            finally:
                if n:
                    n.fast(test)
        return self.inner.invoke(test, op)

    def teardown(self, test):
        n = test.get("net")
        if n:
            n.fast(test)
        self.inner.teardown(test)


def slowing(nemesis_map: dict, dt_s: float = 0.2) -> dict:
    return {**nemesis_map, "name": f"slow-{nemesis_map['name']}",
            "client": _Slowing(nemesis_map["client"], dt_s)}


class _Restarting(nem.Nemesis):
    """Restart all nodes after the inner nemesis's stop
    (nemesis.clj:178-200)."""

    def __init__(self, inner: nem.Nemesis):
        self.inner = inner

    def setup(self, test):
        self.inner = self.inner.setup(test) or self.inner
        return self

    def invoke(self, test, op):
        out = self.inner.invoke(test, op)
        if op.f == "stop":
            stat = control.on_nodes(
                test, lambda t, n: _try_start(t, n))
            return out.replace(value=[out.value, stat])
        return out

    def teardown(self, test):
        self.inner.teardown(test)


def _try_start(test, node):
    try:
        return start(test, node)
    except Exception as e:  # noqa: BLE001
        return str(e)[:80]


def restarting(nemesis_map: dict) -> dict:
    return {**nemesis_map, "name": f"restart-{nemesis_map['name']}",
            "client": _Restarting(nemesis_map["client"])}


class _TaggedGen(gen.Generator):
    """Wrap a nemesis map's generator, tagging op f as (name, f)."""

    def __init__(self, name, g):
        self.name = name
        self.g = gen.gen(g)

    def op(self, test, process):
        o = self.g.op(test, process)
        if o is None:
            return None
        return o.replace(f=(self.name, o.f))


def compose_nemeses(maps: Sequence[Optional[dict]]) -> dict:
    """Merge nemesis maps: ops tagged (name, f) route to the right client
    (cockroach/nemesis.clj:62-106)."""
    maps = [m for m in maps if m]
    names = [m["name"] for m in maps]
    assert len(set(names)) == len(names), f"duplicate nemeses: {names}"

    def selector(my_name):
        def route(f):
            if isinstance(f, tuple) and len(f) == 2 and f[0] == my_name:
                return f[1]
            return None
        return route

    client = nem.compose([(selector(m["name"]), m["client"]) for m in maps])
    during = gen.mix([_TaggedGen(m["name"], m["during"])
                      for m in maps if m["during"] is not None] or [None])
    finals = [_TaggedGen(m["name"], m["final"])
              for m in maps if m["final"] is not None]
    final = gen.seq(finals) if finals else None
    return {"name": "+".join(names) or "blank",
            "clocks": any(m.get("clocks") for m in maps),
            "client": client, "during": during, "final": final}


def nemesis_product(c1: Sequence[str], c2: Sequence[str],
                    registry: Optional[Dict[str, Callable[[], dict]]] = None,
                    ) -> List[tuple]:
    """Cartesian product of named nemeses minus duplicates, same-pair
    reorders, and double-clock pairs (runner.clj:94-110). ``registry``
    defaults to this module's NEMESES; other suites (tidb) pass their
    own."""
    reg = NEMESES if registry is None else registry
    pairs, seen = [], set()
    for n1 in c1:
        for n2 in c2:
            key = frozenset((n1, n2))
            if (n1 == n2
                    or (reg[n1]().get("clocks")
                        and reg[n2]().get("clocks"))
                    or key in seen):
                continue
            seen.add(key)
            pairs.append((n1, n2))
    return pairs


#: Named nemesis registry (runner.clj opt-spec nemeses).
NEMESES: Dict[str, Callable[[], dict]] = {
    "none": none,
    "parts": parts,
    "majring": majring,
    "startstop": startstop,
    "startstop2": lambda: startstop(2),
    "startkill": startkill,
    "startkill2": lambda: startkill(2),
    "small-skews": small_skews,
    "subcritical-skews": subcritical_skews,
    "critical-skews": critical_skews,
    "big-skews": big_skews,
    "huge-skews": huge_skews,
    "strobe-skews": strobe_skews,
    "gradual-skews": gradual_skews,
}


# ---------------------------------------------------------------------------
# basic-test template (cockroach.clj:135-163)
# ---------------------------------------------------------------------------


def basic_test(opts: dict) -> dict:
    """Common phase structure: workload+nemesis during the time limit, stop
    the nemesis, quiesce, then final reads."""
    nemesis_map = opts.get("nemesis") or none()
    client_spec = opts["client"]  # {client, during, final}
    test = noop_test()
    test.update({
        "name": f"cockroachdb-{opts.get('name', 'test')}"
                + (f":{nemesis_map['name']}" if nemesis_map.get("name")
                   else ""),
        "db": CockroachDB(opts.get("version", "v1.0")),
        "client": client_spec["client"],
        "nemesis": nemesis_map.get("client") or nem.noop(),
        "keyrange": {},
        "generator": gen.phases(*filter(None, [
            gen.time_limit(
                opts.get("time-limit", 60),
                gen.clients(client_spec["during"],
                            nemesis_map.get("during"))),
            (gen.nemesis(nemesis_map["final"])
             if nemesis_map.get("final") is not None else None),
            gen.sleep(opts.get("recovery-time", 5)),
            (gen.clients(client_spec["final"])
             if client_spec.get("final") is not None else None),
        ])),
    })
    for k in ("nodes", "concurrency", "ssh", "checker", "model",
              "store-dir", "store-root", "net", "key-count",
              "linearizable", "time-limit"):
        if k in opts:
            test[k] = opts[k]
    return test


# ---------------------------------------------------------------------------
# Workload clients (SQL)
# ---------------------------------------------------------------------------


class RegisterClient(SQLClient):
    """Independent CAS registers in one table (register.clj)."""

    TABLE = "registers"

    def setup(self, test):
        node = test["nodes"][0]
        sql(test, node, f"CREATE TABLE IF NOT EXISTS {self.TABLE} "
                        f"(id INT PRIMARY KEY, val INT)")

    def _invoke(self, test, op):
        k, v = op.value
        if op.f == "read":
            rows = sql(test, self.node,
                       f"SELECT val FROM {self.TABLE} WHERE id = {int(k)}")
            val = int(rows[0][0]) if rows else None
            return op.replace(type="ok", value=independent.tuple_(k, val))
        if op.f == "write":
            sql(test, self.node,
                f"UPSERT INTO {self.TABLE} (id, val) VALUES "
                f"({int(k)}, {int(v)})")
            return op.replace(type="ok")
        if op.f == "cas":
            old, new = v
            rows = sql(test, self.node,
                       f"UPDATE {self.TABLE} SET val = {int(new)} "
                       f"WHERE id = {int(k)} AND val = {int(old)} "
                       f"RETURNING val")
            return op.replace(type="ok" if rows else "fail")
        raise ValueError(f"unknown op {op.f!r}")


class BankSQLClient(SQLClient):
    """Bank accounts in one table; transfers in one txn (bank.clj)."""

    def __init__(self, n: int = 5, starting: int = 10):
        super().__init__()
        self.n = n
        self.starting = starting

    def open(self, test, node):
        c = BankSQLClient(self.n, self.starting)
        c.node = node
        return c

    def setup(self, test):
        node = test["nodes"][0]
        sql(test, node, "CREATE TABLE IF NOT EXISTS accounts "
                        "(id INT PRIMARY KEY, balance BIGINT)")
        for i in range(self.n):
            sql(test, node, f"UPSERT INTO accounts VALUES "
                            f"({i}, {self.starting})")

    def _invoke(self, test, op):
        if op.f == "read":
            rows = sql(test, self.node,
                       "SELECT balance FROM accounts ORDER BY id")
            return op.replace(type="ok", value=[int(r[0]) for r in rows])
        if op.f == "transfer":
            v = op.value
            frm, to, amt = int(v["from"]), int(v["to"]), int(v["amount"])
            # One atomic statement: debit + credit guarded by the source
            # balance. RETURNING exposes the affected row count, so an
            # overdraw (guard matches nothing -> 0 rows) maps to a
            # determinate fail instead of silently minting the credit
            # (bank.clj:55-79 reads balances and aborts on overdraw).
            if frm == to:
                # Net-zero self-transfer: the two-row CASE would apply only
                # the debit branch to the single matched row. Keep it a
                # pure guarded touch so the balance is unchanged.
                rows = sql(
                    test, self.node,
                    f"UPDATE accounts SET balance = balance "
                    f"WHERE id = {frm} AND balance >= {amt} RETURNING id")
            else:
                rows = sql(
                    test, self.node,
                    f"UPDATE accounts SET balance = balance + "
                    f"CASE WHEN id = {frm} THEN {-amt} ELSE {amt} END "
                    f"WHERE id IN ({frm}, {to}) AND {amt} <= "
                    f"(SELECT balance FROM accounts WHERE id = {frm}) "
                    f"RETURNING id")
            return op.replace(type="ok" if rows else "fail")
        raise ValueError(f"unknown op {op.f!r}")


class SetsClient(SQLClient):
    """Unique-int inserts + final read (sets.clj)."""

    def setup(self, test):
        sql(test, test["nodes"][0],
            "CREATE TABLE IF NOT EXISTS sets (val INT PRIMARY KEY)")

    def _invoke(self, test, op):
        if op.f == "add":
            sql(test, self.node,
                f"INSERT INTO sets VALUES ({int(op.value)})")
            return op.replace(type="ok")
        if op.f == "read":
            rows = sql(test, self.node, "SELECT val FROM sets")
            return op.replace(type="ok",
                              value=sorted(int(r[0]) for r in rows))
        raise ValueError(f"unknown op {op.f!r}")


class CommentsClient(SQLClient):
    """Strict-serializability probe (comments.clj): concurrent blind
    inserts spread over TABLE_COUNT tables (so keys land in different
    shard ranges), plus transactional reads across every table."""

    TABLE_COUNT = 10

    def setup(self, test):
        node = test["nodes"][0]
        for t in self._tables():
            sql(test, node, f"CREATE TABLE IF NOT EXISTS {t} "
                            f"(id INT PRIMARY KEY, key INT)")

    def _tables(self):
        return [f"comment_{i}" for i in range(self.TABLE_COUNT)]

    def _table_for(self, op_id: int) -> str:
        return f"comment_{hash(op_id) % self.TABLE_COUNT}"

    def _invoke(self, test, op):
        k, v = op.value
        if op.f == "write":
            sql(test, self.node,
                f"INSERT INTO {self._table_for(int(v))} (id, key) "
                f"VALUES ({int(v)}, {int(k)})")
            return op.replace(type="ok")
        if op.f == "read":
            selects = " UNION ALL ".join(
                f"SELECT id FROM {t} WHERE key = {int(k)}"
                for t in self._tables())
            rows = sql(test, self.node,
                       f"BEGIN; SET TRANSACTION ISOLATION LEVEL "
                       f"SERIALIZABLE; {selects}; COMMIT")
            ids = sorted(int(r[0]) for r in rows if r and r[0] != "id")
            return op.replace(type="ok",
                              value=independent.tuple_(k, ids))
        raise ValueError(f"unknown op {op.f!r}")


class CommentsChecker(Checker):
    """T1 < T2 but T2 visible without T1 — the strict-serializability
    anomaly (comments.clj checker, :92-140). Replaying the (per-key)
    history: ``expected[w]`` is the set of writes known complete before
    w's invocation; an ok read seeing w but missing some member of
    expected[w] is a violation."""

    def check(self, test, history, opts=None):
        completed: set = set()
        expected: Dict[int, frozenset] = {}
        errors = []
        for op in history:
            if op.f == "write":
                if op.is_invoke:
                    expected[op.value] = frozenset(completed)
                elif op.is_ok:
                    completed.add(op.value)
            elif op.f == "read" and op.is_ok and op.value is not None:
                seen = set(op.value)
                our_expected: set = set()
                for w in seen:
                    our_expected |= expected.get(w, frozenset())
                missing = our_expected - seen
                if missing:
                    errors.append({"op": op.to_dict(),
                                   "missing": sorted(missing),
                                   "expected-count": len(our_expected)})
        return {"valid": not errors, "errors": errors}


def comments_checker() -> CommentsChecker:
    return CommentsChecker()


# ---------------------------------------------------------------------------
# Tests (register/bank/sets + reuse of monotonic/sequential/g2 checkers)
# ---------------------------------------------------------------------------


def register_test(opts: dict) -> dict:
    keys = __import__("itertools").count()
    return basic_test({
        **opts,
        "name": "register",
        "client": {
            "client": RegisterClient(),
            "during": independent.concurrent_generator(
                opts.get("threads-per-key", 5), keys,
                lambda k: gen.limit(opts.get("ops-per-key", 100),
                                    gen.stagger(1 / 10,
                                                wl.register_gen()))),
            "final": None,
        },
        "model": CASRegister(),
        "checker": compose({
            "perf": perf(),
            "indep": independent.checker(
                linearizable(CASRegister(),
                             backend=opts.get("backend", "gpu"),
                             device=opts.get("device"))),
        }),
    })


def bank_test(opts: dict) -> dict:
    n = opts.get("accounts", 5)
    starting = opts.get("starting-balance", 10)
    return basic_test({
        **opts,
        "name": "bank",
        "client": {
            "client": BankSQLClient(n, starting),
            "during": gen.stagger(
                1 / 10, gen.mix([wl.bank_read, wl.bank_diff_transfer(n)])),
            "final": gen.once({"f": "read", "value": None}),
        },
        "checker": compose({
            "perf": perf(),
            "bank": wl.bank_checker(n, n * starting),
        }),
    })


def sets_test(opts: dict) -> dict:
    counter = __import__("itertools").count()

    def add(test, process):
        return {"type": "invoke", "f": "add", "value": next(counter)}

    return basic_test({
        **opts,
        "name": "sets",
        "client": {
            "client": SetsClient(),
            "during": gen.stagger(1 / 10, add),
            "final": gen.once({"f": "read", "value": None}),
        },
        "checker": compose({
            "perf": perf(),
            "set": set_checker(),
        }),
    })


class MonotonicSQLClient(SQLClient):
    """Monotonic timestamped inserts (monotonic.clj): each add reads the
    current max val and inserts val+1 with the cluster's logical
    timestamp, atomically in one statement; the checker demands value
    order and timestamp order agree with no lost/duplicate/revived
    rows."""

    def setup(self, test):
        sql(test, test["nodes"][0],
            "CREATE TABLE IF NOT EXISTS mono (val INT, sts DECIMAL, "
            "node INT, process INT, tb INT)")

    def _invoke(self, test, op):
        if op.f == "add":
            node_i = test["nodes"].index(self.node) \
                if self.node in test.get("nodes", []) else 0
            rows = sql(
                test, self.node,
                f"INSERT INTO mono (val, sts, node, process, tb) "
                f"SELECT COALESCE(MAX(val), -1) + 1, "
                f"cluster_logical_timestamp(), {node_i}, "
                f"{int(op.process) if op.process != 'nemesis' else -1}, 0 "
                f"FROM mono RETURNING val")
            return op.replace(type="ok",
                              value=int(rows[0][0]) if rows else None)
        if op.f == "read":
            rows = sql(test, self.node,
                       "SELECT val, sts, node, process, tb FROM mono "
                       "ORDER BY sts")
            out = [{"val": int(r[0]), "sts": r[1], "node": r[2],
                    "proc": r[3], "tb": int(r[4])} for r in rows]
            return op.replace(type="ok", value=out)
        raise ValueError(f"unknown op {op.f!r}")


class SequentialSQLClient(SQLClient):
    """Sequential-consistency probe (sequential.clj:52-95): writes insert
    a key's subkeys IN ORDER, each in its own transaction; reads probe
    them in REVERSE, so any reader seeing subkey i without i-1 (a
    trailing nil after a value) witnesses a sequential violation."""

    def setup(self, test):
        sql(test, test["nodes"][0],
            "CREATE TABLE IF NOT EXISTS seq (tkey STRING PRIMARY KEY)")

    def _invoke(self, test, op):
        key_count = test.get("key-count", 5)
        ks = wl.subkeys(key_count, op.value if op.f == "write"
                        else op.value[0] if isinstance(op.value, tuple)
                        else op.value)
        if op.f == "write":
            for k in ks:       # separate txns, in order
                sql(test, self.node,
                    f"INSERT INTO seq (tkey) VALUES ('{k}') "
                    f"ON CONFLICT (tkey) DO NOTHING")
            return op.replace(type="ok")
        if op.f == "read":
            vals = []
            for k in reversed(ks):
                rows = sql(test, self.node,
                           f"SELECT tkey FROM seq WHERE tkey = '{k}'")
                vals.append(k if rows else None)
            return op.replace(type="ok", value=(op.value, vals))
        raise ValueError(f"unknown op {op.f!r}")


class G2SQLClient(SQLClient):
    """Anti-dependency-cycle probe (adya.clj:31-43 / cockroach g2): the
    predicate read + guarded insert run as ONE atomic statement, so
    under SERIALIZABLE at most one of a key's paired inserts can
    succeed; two successes for one key is the G2 phenomenon."""

    def setup(self, test):
        node = test["nodes"][0]
        for t in ("a", "b"):
            sql(test, node,
                f"CREATE TABLE IF NOT EXISTS {t} "
                f"(id INT PRIMARY KEY, key INT, value INT)")

    def _invoke(self, test, op):
        if op.f != "insert":
            raise ValueError(f"unknown op {op.f!r}")
        k = op.value.key
        a_id, b_id = op.value.value
        table = "a" if a_id is not None else "b"
        row_id = a_id if a_id is not None else b_id
        rows = sql(
            test, self.node,
            f"INSERT INTO {table} (id, key, value) "
            f"SELECT {int(row_id)}, {int(k)}, 30 "
            f"WHERE NOT EXISTS (SELECT 1 FROM a WHERE key = {int(k)} "
            f"AND value % 3 = 0) "
            f"AND NOT EXISTS (SELECT 1 FROM b WHERE key = {int(k)} "
            f"AND value % 3 = 0) RETURNING id")
        return op.replace(type="ok" if rows else "fail")


class BankMultitableClient(SQLClient):
    """Bank with each account in its OWN table (bank-multitable:
    cross-table transactions stress distributed txn paths the
    single-table bank never touches)."""

    def __init__(self, n: int = 5, starting: int = 10):
        super().__init__()
        self.n = n
        self.starting = starting

    def open(self, test, node):
        c = BankMultitableClient(self.n, self.starting)
        c.node = node
        return c

    def setup(self, test):
        node = test["nodes"][0]
        for i in range(self.n):
            sql(test, node,
                f"CREATE TABLE IF NOT EXISTS accounts_{i} "
                f"(id INT PRIMARY KEY, balance BIGINT)")
            sql(test, node,
                f"UPSERT INTO accounts_{i} VALUES (0, {self.starting})")

    def _invoke(self, test, op):
        if op.f == "read":
            selects = " UNION ALL ".join(
                f"SELECT {i} AS acct, balance FROM accounts_{i}"
                for i in range(self.n))
            rows = sql(test, self.node,
                       f"SELECT balance FROM ({selects}) ORDER BY acct")
            return op.replace(type="ok", value=[int(r[0]) for r in rows])
        if op.f == "transfer":
            v = op.value
            frm, to, amt = int(v["from"]), int(v["to"]), int(v["amount"])
            if frm == to:
                rows = sql(test, self.node,
                           f"UPDATE accounts_{frm} SET balance = balance "
                           f"WHERE balance >= {amt} RETURNING id")
            else:
                # debit CTE gates the credit: overdraw debits nothing, so
                # the credit's EXISTS guard fails -> 0 rows -> determinate
                # fail, atomically in one statement
                rows = sql(
                    test, self.node,
                    f"WITH d AS (UPDATE accounts_{frm} SET balance = "
                    f"balance - {amt} WHERE balance >= {amt} "
                    f"RETURNING 1) "
                    f"UPDATE accounts_{to} SET balance = balance + {amt} "
                    f"WHERE EXISTS (SELECT 1 FROM d) RETURNING id")
            return op.replace(type="ok" if rows else "fail")
        raise ValueError(f"unknown op {op.f!r}")


def comments_test(opts: dict) -> dict:
    """comments.clj test: per-key mix of blind writes (globally unique
    ids) and transactional cross-table reads, checked per key."""
    keys = __import__("itertools").count()
    ids = __import__("itertools").count()

    def writes(test, process):
        return {"type": "invoke", "f": "write", "value": next(ids)}

    reads = {"type": "invoke", "f": "read", "value": None}
    return basic_test({
        **opts,
        "name": "comments",
        "client": {
            "client": CommentsClient(),
            "during": independent.concurrent_generator(
                len(opts.get("nodes", [1] * 5)), keys,
                lambda k: gen.limit(
                    opts.get("ops-per-key", 500),
                    gen.stagger(1 / 100, gen.mix([reads, writes])))),
            "final": None,
        },
        "checker": compose({
            "perf": perf(),
            "comments": independent.checker(comments_checker()),
        }),
    })


def monotonic_test(opts: dict) -> dict:
    return basic_test({
        **opts,
        "name": "monotonic",
        "client": {
            "client": MonotonicSQLClient(),
            "during": gen.stagger(
                1 / 10, lambda t, p: {"type": "invoke", "f": "add",
                                      "value": None}),
            "final": gen.once({"f": "read", "value": None}),
        },
        "checker": compose({
            "perf": perf(),
            "monotonic": wl.monotonic_checker(),
        }),
    })


def sequential_test(opts: dict) -> dict:
    key_count = opts.get("key-count", 5)
    return basic_test({
        **opts,
        "name": "sequential",
        "key-count": key_count,
        "client": {
            "client": SequentialSQLClient(),
            "during": gen.stagger(1 / 10,
                                  wl.sequential_gen(opts.get("writers", 2))),
            "final": None,
        },
        "checker": compose({
            "perf": perf(),
            "sequential": wl.SequentialChecker(),
        }),
    })


def g2_test(opts: dict) -> dict:
    return basic_test({
        **opts,
        "name": "g2",
        "client": {
            "client": G2SQLClient(),
            "during": wl.g2_gen(),
            "final": None,
        },
        "checker": compose({
            "perf": perf(),
            "g2": wl.g2_checker(),
        }),
    })


def bank_multitable_test(opts: dict) -> dict:
    n = opts.get("accounts", 5)
    starting = opts.get("starting-balance", 10)
    return basic_test({
        **opts,
        "name": "bank-multitable",
        "client": {
            "client": BankMultitableClient(n, starting),
            "during": gen.stagger(
                1 / 10, gen.mix([wl.bank_read, wl.bank_diff_transfer(n)])),
            "final": gen.once({"f": "read", "value": None}),
        },
        "checker": compose({
            "perf": perf(),
            "bank": wl.bank_checker(n, n * starting),
        }),
    })


TESTS: Dict[str, Callable[[dict], dict]] = {
    "register": register_test,
    "bank": bank_test,
    "bank-multitable": bank_multitable_test,
    "sets": sets_test,
    "comments": comments_test,
    "monotonic": monotonic_test,
    "sequential": sequential_test,
    "g2": g2_test,
}


#: the workloads ``run --workload`` selects (the reference's ``main``)
WORKLOADS = TESTS


def named_nemesis(n1s: Optional[Sequence[str]],
                  n2s: Optional[Sequence[str]]) -> dict:
    """The nemesis map the reference's ``main`` composes from its
    ``--nemesis`` and ``--nemesis2`` name lists (runner.clj): the first
    pair of their product, composed."""
    n1s = n1s or ["none"]
    n2s = n2s or ["none"]
    pairs = nemesis_product(n1s, n2s) or [(n1s[0], n2s[0])]
    n1, n2 = pairs[0]
    return compose_nemeses([NEMESES[n1](), NEMESES[n2]()
                            if n2 != n1 else None])


def main(argv=None):
    """The reference's command line: ``test`` runs the ``--workload``
    test (default: register) under the nemesis :func:`named_nemesis`
    composes from ``--nemesis`` and ``--nemesis2``; ``serve`` the results
    browser."""
    from jepsen_tpu_torch import cli

    def opt_spec(p):
        p.add_argument("--workload", default="register",
                       choices=sorted(TESTS))
        p.add_argument("--nemesis", action="append", default=None,
                       choices=sorted(NEMESES))
        p.add_argument("--nemesis2", action="append", default=None,
                       choices=sorted(NEMESES))

    def test_fn(opts):
        composed = named_nemesis(opts.get("nemesis"), opts.get("nemesis2"))
        return TESTS[opts.get("workload", "register")](
            {**opts, "nemesis": composed})

    cli.main(cli.merge_commands(
        cli.single_test_cmd(test_fn, opt_spec=opt_spec),
        cli.serve_cmd()), argv)


if __name__ == "__main__":
    main()
