"""Galera / Percona suite — dirty reads, sets, bank over MySQL wsrep.

Rebuild of galera/src/jepsen/galera*.clj and percona/ (the suites share
their shape, galera.clj / percona.clj): SQL over the mysql CLI, the
dirty-reads workload (galera/dirty_reads.clj:40-106 — writers update
every row to their value inside one serializable txn, readers scan; a
FAILED write's value visible to any read is a dirty read; mixed-value
reads are inconsistent), plus set and bank via the shared workload
library.

The port's copy of ``jepsen_tpu.suites.galera``. Its checks (dirty reads,
set, bank) run on the host, as in the reference."""

from __future__ import annotations

import itertools
from typing import Any, Dict, List

from jepsen_tpu_torch import client as client_ns
from jepsen_tpu_torch import control
from jepsen_tpu_torch import db as db_ns
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import nemesis
from jepsen_tpu_torch.checker import Checker, compose, set_checker
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.os import debian
from jepsen_tpu_torch.suites import workloads as wl
from jepsen_tpu_torch.testing import noop_test

MYSQL = "mysql"


def sql(test: dict, node, statement: str, db: str = "jepsen") -> List[List[str]]:
    """Run SQL via the mysql CLI; TSV rows without header."""
    out = control.execute(
        test, node,
        f"{MYSQL} -u root --batch --skip-column-names "
        f"-D {db} -e {control.escape(statement)}")
    return [line.split("\t") for line in out.splitlines() if line.strip()]


class GaleraDB(db_ns.DB, db_ns.LogFiles):
    """galera.clj db: apt install, wsrep cluster address, bootstrap on the
    first node."""

    def setup(self, test, node):
        debian.install(test, node, ["galera-3", "mysql-wsrep-5.6"])
        cluster = ",".join(str(n) for n in test["nodes"])
        cnf = (f"[mysqld]\n"
               f"wsrep_provider=/usr/lib/galera/libgalera_smm.so\n"
               f"wsrep_cluster_address=gcomm://{cluster}\n"
               f"wsrep_node_address={node}\n"
               f"binlog_format=ROW\n"
               f"innodb_autoinc_lock_mode=2\n")
        with control.sudo():
            control.execute(
                test, node,
                f"echo {control.escape(cnf)} > /etc/mysql/conf.d/galera.cnf")
            if node == test["nodes"][0]:
                control.execute(test, node,
                                "service mysql bootstrap || "
                                "service mysql start --wsrep-new-cluster")
            else:
                control.exec(test, node, "service", "mysql", "start")
        sql(test, node, "CREATE DATABASE IF NOT EXISTS jepsen", db="mysql")

    def teardown(self, test, node):
        with control.sudo():
            control.execute(test, node, "service mysql stop || true")

    def log_files(self, test, node):
        return ["/var/log/mysql/error.log"]


class DirtyReadsClient(client_ns.Client):
    """galera/dirty_reads.clj:28-67: n rows seeded; a write sets every row
    (in random order, inside one serializable txn) to its value; a read
    scans all rows."""

    def __init__(self, n: int = 2):
        self.n = n
        self.node = None

    def open(self, test, node):
        c = DirtyReadsClient(self.n)
        c.node = node
        return c

    def setup(self, test):
        node = test["nodes"][0]
        sql(test, node, "CREATE TABLE IF NOT EXISTS dirty "
                        "(id INT PRIMARY KEY, x BIGINT)")
        for i in range(self.n):
            sql(test, node,
                f"INSERT IGNORE INTO dirty VALUES ({i}, -1)")

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "read":
                rows = sql(test, self.node,
                           "SET SESSION TRANSACTION ISOLATION LEVEL "
                           "SERIALIZABLE; SELECT x FROM dirty")
                return op.replace(type="ok",
                                  value=[int(r[0]) for r in rows])
            if op.f == "write":
                import random as _r
                order = list(range(self.n))
                _r.shuffle(order)
                stmts = ["SET SESSION TRANSACTION ISOLATION LEVEL "
                         "SERIALIZABLE", "BEGIN"]
                stmts += [f"SELECT x FROM dirty WHERE id = {i}"
                          for i in order]
                stmts += [f"UPDATE dirty SET x = {int(op.value)} "
                          f"WHERE id = {i}" for i in order]
                stmts.append("COMMIT")
                sql(test, self.node, "; ".join(stmts))
                return op.replace(type="ok")
            raise ValueError(f"unknown op {op.f!r}")
        except control.RemoteError as e:
            msg = f"{e.err or ''} {e.out or ''}"
            if "Deadlock" in msg or "lock" in msg.lower():
                return op.replace(type="fail", error="txn-abort")
            return op.replace(type="fail" if op.f == "read" else "info",
                              error=msg.strip()[:80])


class DirtyReadsChecker(Checker):
    """A failed write's value visible to any ok read is a dirty read;
    mixed-value reads are inconsistent (dirty_reads.clj:73-97)."""

    def check(self, test, history, opts=None):
        failed_writes = {op.value for op in history
                         if op.is_fail and op.f == "write"}
        reads = [op.value for op in history
                 if op.is_ok and op.f == "read" and op.value is not None]
        inconsistent = [v for v in reads if len(set(v)) > 1]
        dirty = [v for v in reads if any(x in failed_writes for x in v)]
        return {"valid": not dirty,
                "inconsistent-reads": inconsistent,
                "dirty-reads": dirty}


def dirty_reads_test(opts: dict) -> dict:
    """dirty_reads.clj test-: sequential integer writes, concurrent
    scans."""
    counter = itertools.count()

    def write(test, process):
        return {"type": "invoke", "f": "write", "value": next(counter)}

    n = opts.get("rows", 2)
    test = noop_test()
    test.update({
        "name": "galera-dirty-reads",
        "os": debian.os(),
        "db": GaleraDB(),
        "client": DirtyReadsClient(n),
        "nemesis": nemesis.partition_random_halves(),
        "checker": compose({"dirty-reads": DirtyReadsChecker()}),
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(
                gen.mix([write, lambda t, p: {"type": "invoke", "f": "read",
                                              "value": None}]),
                gen.seq(_nemesis_cycle()))),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


class SetClient(client_ns.Client):
    """galera.clj set-client (:199-236): unique-int inserts + a final
    scan, the lost-insert probe."""

    def __init__(self, node=None):
        self.node = node

    def open(self, test, node):
        return SetClient(node)

    def setup(self, test):
        sql(test, test["nodes"][0],
            "CREATE TABLE IF NOT EXISTS sets "
            "(id INT NOT NULL AUTO_INCREMENT PRIMARY KEY, "
            "value BIGINT NOT NULL)")

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "add":
                sql(test, self.node,
                    f"INSERT INTO sets (value) VALUES ({int(op.value)})")
                return op.replace(type="ok")
            if op.f == "read":
                rows = sql(test, self.node, "SELECT value FROM sets")
                return op.replace(type="ok",
                                  value=sorted(int(r[0]) for r in rows))
            raise ValueError(f"unknown op {op.f!r}")
        except control.RemoteError as e:
            return op.replace(type="fail" if op.f == "read" else "info",
                              error=str(e)[:80])


def sets_test(opts: dict) -> dict:
    """galera.clj sets-test (:238-258): staggered unique adds under the
    nemesis, then one final read checked with set algebra."""
    from jepsen_tpu_torch.checker import set_checker
    counter = itertools.count()

    def add(test, process):
        return {"type": "invoke", "f": "add", "value": next(counter)}

    test = noop_test()
    test.update({
        "name": "galera-set",
        "os": debian.os(),
        "db": GaleraDB(),
        "client": SetClient(),
        "nemesis": nemesis.partition_random_halves(),
        "checker": compose({"set": set_checker()}),
        "generator": gen.phases(
            gen.time_limit(
                opts.get("time-limit", 60),
                gen.clients(gen.delay(1 / 10, add),
                            gen.seq(_nemesis_cycle()))),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.clients(gen.once({"f": "read", "value": None}))),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


class BankClient(client_ns.Client):
    """galera.clj BankClient (:300-363): read both balances in a txn,
    abort on overdraw/negative, else write both back."""

    def __init__(self, n: int = 5, starting: int = 10, node=None):
        self.n = n
        self.starting = starting
        self.node = node

    def open(self, test, node):
        return BankClient(self.n, self.starting, node)

    def setup(self, test):
        node = test["nodes"][0]
        sql(test, node,
            "CREATE TABLE IF NOT EXISTS accounts "
            "(id INT NOT NULL PRIMARY KEY, balance BIGINT NOT NULL)")
        for i in range(self.n):
            sql(test, node,
                f"INSERT IGNORE INTO accounts VALUES "
                f"({i}, {self.starting})")

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "read":
                rows = sql(test, self.node,
                           "SELECT balance FROM accounts ORDER BY id")
                return op.replace(type="ok",
                                  value=[int(r[0]) for r in rows])
            if op.f == "transfer":
                v = op.value
                frm, to = int(v["from"]), int(v["to"])
                amt = int(v["amount"])
                # one serializable txn: row-locked guarded debit, credit
                # gated on the debit's row count — an overdraw debits 0
                # rows, credits 0 rows, and commits a no-op
                stmts = [
                    "SET SESSION TRANSACTION ISOLATION LEVEL SERIALIZABLE",
                    "BEGIN",
                    f"UPDATE accounts SET balance = balance - {amt} "
                    f"WHERE id = {frm} AND balance >= {amt}",
                    f"UPDATE accounts SET balance = balance + {amt} "
                    f"WHERE id = {to} AND ROW_COUNT() > 0",
                    "SELECT ROW_COUNT()",
                    "COMMIT"]
                rows = sql(test, self.node, "; ".join(stmts))
                applied = rows and rows[-1] and rows[-1][0] == "1"
                return op.replace(type="ok" if applied else "fail")
            raise ValueError(f"unknown op {op.f!r}")
        except control.RemoteError as e:
            msg = f"{e.err or ''} {e.out or ''}"
            if "Deadlock" in msg or "abort" in msg.lower():
                return op.replace(type="fail", error="txn-abort")
            return op.replace(type="fail" if op.f == "read" else "info",
                              error=msg.strip()[:80])


def bank_test(opts: dict) -> dict:
    """galera.clj bank-test (:364-383)."""
    from jepsen_tpu_torch.suites import workloads as wl
    n = opts.get("accounts", 5)
    starting = opts.get("starting-balance", 10)
    test = noop_test()
    test.update({
        "name": "galera-bank",
        "os": debian.os(),
        "db": GaleraDB(),
        "client": BankClient(n, starting),
        "nemesis": nemesis.partition_random_halves(),
        "checker": compose({"bank": wl.bank_checker(n, n * starting)}),
        "generator": gen.phases(
            gen.time_limit(
                opts.get("time-limit", 60),
                gen.clients(
                    gen.stagger(1 / 10,
                                gen.mix([wl.bank_read,
                                         wl.bank_diff_transfer(n)])),
                    gen.seq(_nemesis_cycle()))),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.clients(gen.once({"f": "read", "value": None}))),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


def _nemesis_cycle():
    while True:
        yield gen.sleep(10)
        yield gen.once({"type": "info", "f": "start"})
        yield gen.sleep(10)
        yield gen.once({"type": "info", "f": "stop"})


def main(argv=None):
    """The reference's command line: ``test`` runs :func:`dirty_reads_test`,
    ``serve`` the results browser (``python -m
    jepsen_tpu_torch.suites.galera test|serve ...``)."""
    from jepsen_tpu_torch import cli
    cli.main(cli.merge_commands(cli.single_test_cmd(dirty_reads_test),
                                cli.serve_cmd()), argv)


if __name__ == "__main__":
    main()
