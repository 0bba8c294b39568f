"""SQL-family suites sharing the mysql/psql CLI data plane: TiDB, Percona,
MySQL Cluster (NDB), Postgres RDS, and CrateDB's HTTP SQL endpoint.

Reference counterparts:
- tidb/: cockroach-style bank/register/sets over the MySQL protocol
  (tidb/src/tidb/*.clj — pd/tikv/tidb triple daemon, sql.clj retry client)
- percona/: dirty-reads + set + bank (percona.clj:319-361,
  percona/dirty_reads.clj:77) — identical shape to galera
- mysql-cluster/: NDB bank/set (mysql_cluster.clj)
- postgres-rds/: bank against a managed endpoint, no node setup
  (postgres_rds.clj:238-293)
- crate/: SQL over HTTP /_sql with version-divergence checking
  (crate/version_divergence.clj:93-122)

The port's copy of ``jepsen_tpu.suites.sql_family``, with one difference:
tidb-register's keyed linearizability check runs on the card (``backend``
"gpu", the default) unless the options name the CPU (``backend: "cpu"``
for the host search, ``device: "cpu"`` for the kernels' plain versions).
The bank, set, dirty-read and version-divergence checks run on the host,
as in the reference. The TiDB clients keep the reference's data plane:
``TiDBRegisterClient._sql`` and ``TiSets._sql`` are never called, so the
register and set clients run cockroachdb's ``cockroach sql`` and its
dialect (``UPSERT``, ``RETURNING``) on the TiDB nodes, and the bank
client is cockroachdb's own, as the reference's are.
"""

from __future__ import annotations

import itertools
import json
import urllib.request
from typing import Any, List, Optional

from jepsen_tpu_torch import client as client_ns
from jepsen_tpu_torch import control
from jepsen_tpu_torch import db as db_ns
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import nemesis
from jepsen_tpu_torch.checker import Checker, compose, perf, set_checker
from jepsen_tpu_torch.control import util as cu
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.os import debian
from jepsen_tpu_torch.suites import galera
from jepsen_tpu_torch.suites import workloads as wl
from jepsen_tpu_torch.suites.cockroachdb import BankSQLClient, RegisterClient
from jepsen_tpu_torch.testing import noop_test

# ---------------------------------------------------------------------------
# TiDB (pd + tikv + tidb triple daemon; MySQL wire protocol)
# ---------------------------------------------------------------------------

TIDB_DIR = "/opt/tidb"


class TiDB(db_ns.DB, db_ns.LogFiles):
    """tidb/db.clj: three daemons per node — pd, tikv, tidb."""

    def setup(self, test, node):
        cu.install_archive(test, node,
                           test.get("tarball",
                                    "https://download.pingcap.org/"
                                    "tidb-latest-linux-amd64.tar.gz"),
                           TIDB_DIR)
        tidb_quickstart(test, node)

    def teardown(self, test, node):
        tidb_stop(test, node)
        control.exec(test, node, "rm", "-rf", f"{TIDB_DIR}/tikv")

    def log_files(self, test, node):
        return [f"{TIDB_DIR}/{d}.log" for d in ("pd", "tikv", "tidb")]


def tidb_quickstart(test, node):
    """Start the pd/tikv/tidb daemon triple without reinstalling
    (tidb/db.clj:78-121 quickstart!) — the startkill nemesis's restart
    half must not pay the tarball install."""
    initial = ",".join(f"pd{i}=http://{n}:2380"
                       for i, n in enumerate(test["nodes"]))
    pds = ",".join(f"{n}:2379" for n in test["nodes"])
    i = test["nodes"].index(node)
    cu.start_daemon(test, node, f"{TIDB_DIR}/bin/pd-server",
                    "--name", f"pd{i}",
                    "--client-urls", f"http://{node}:2379",
                    "--peer-urls", f"http://{node}:2380",
                    "--initial-cluster", initial,
                    logfile=f"{TIDB_DIR}/pd.log",
                    pidfile=f"{TIDB_DIR}/pd.pid", chdir=TIDB_DIR)
    cu.start_daemon(test, node, f"{TIDB_DIR}/bin/tikv-server",
                    "--pd", pds, "--addr", f"{node}:20160",
                    "--data-dir", f"{TIDB_DIR}/tikv",
                    logfile=f"{TIDB_DIR}/tikv.log",
                    pidfile=f"{TIDB_DIR}/tikv.pid", chdir=TIDB_DIR)
    cu.start_daemon(test, node, f"{TIDB_DIR}/bin/tidb-server",
                    "--store", "tikv", "--path", pds,
                    logfile=f"{TIDB_DIR}/tidb.log",
                    pidfile=f"{TIDB_DIR}/tidb.pid", chdir=TIDB_DIR)


def tidb_stop(test, node):
    """Stop all three daemons, tidb first (tidb/db.clj:123-128)."""
    for d in ("tidb", "tikv", "pd"):
        cu.stop_daemon(test, node, f"{TIDB_DIR}/{d}.pid",
                       cmd=f"{d}-server")


class TiDBRegisterClient(RegisterClient):
    """Registers over the mysql CLI instead of the cockroach CLI."""

    def _sql(self, test, statement):
        return galera.sql(test, self.node, statement)


# ---------------------------------------------------------------------------
# TiDB nemesis packages (tidb/nemesis.clj) — the cockroach named-map
# scheme ({name, during, final, client, clocks}) with TiDB targets
# ---------------------------------------------------------------------------

#: The three daemon binaries startstop picks between (nemesis.clj:126-132).
TIDB_BINS = ("pd-server", "tikv-server", "tidb-server")


def tidb_nemesis_double_gen() -> dict:
    """Interleaved schedule for a composed nemesis pair
    (tidb/nemesis.clj:39-59): overlap the two faults half a duration at
    a time — fault 1 starts, fault 2 joins mid-way, fault 1 lifts while
    fault 2 persists, then the roles swap. Ops carry plain start/stop
    fs; compose_nemeses's tagging wraps them per package."""
    from jepsen_tpu_torch.suites.cockroachdb import (
        NEMESIS_DELAY, NEMESIS_DURATION)

    half = NEMESIS_DURATION / 2

    def cycle():
        while True:
            for first, second in (("start1", "start2"), ("start2",
                                                         "start1")):
                yield gen.sleep(NEMESIS_DELAY)
                yield gen.once({"type": "info", "f": first})
                yield gen.sleep(half)
                yield gen.once({"type": "info", "f": second})
                yield gen.sleep(half)
                yield gen.once({"type": "info",
                                "f": first.replace("start", "stop")})
                yield gen.sleep(half)
                yield gen.once({"type": "info",
                                "f": second.replace("start", "stop")})
    return {"during": gen.seq(cycle()),
            "final": gen.seq([gen.once({"type": "info", "f": "stop1"}),
                              gen.once({"type": "info", "f": "stop2"})])}


def tidb_none() -> dict:
    from jepsen_tpu_torch.suites import cockroachdb as cr
    return cr.none()


def tidb_parts() -> dict:
    from jepsen_tpu_torch.suites import cockroachdb as cr
    return cr.parts()


def tidb_majring() -> dict:
    from jepsen_tpu_torch.suites import cockroachdb as cr
    return cr.majring()


def tidb_startstop(n: int = 1) -> dict:
    """SIGSTOP/SIGCONT one of the three TiDB daemons on n random nodes
    (tidb/nemesis.clj:126-132 picks the binary at package-construction
    time)."""
    import random as _r

    from jepsen_tpu_torch.suites import cockroachdb as cr
    binary = _r.choice(TIDB_BINS)
    return {**cr.nemesis_single_gen(),
            "name": f"startstop{n if n > 1 else ''}",
            "client": nemesis.hammer_time(binary,
                                          targeter=cr._take_n(n)),
            "clocks": False}


def tidb_startkill(n: int = 1) -> dict:
    """Kill + quickstart the whole daemon triple on n random nodes
    (tidb/nemesis.clj:134-142: node-start-stopper over db/stop! +
    db/quickstart!)."""
    from jepsen_tpu_torch.suites import cockroachdb as cr
    return {**cr.nemesis_single_gen(),
            "name": f"startkill{n if n > 1 else ''}",
            "client": nemesis.node_start_stopper(
                cr._take_n(n), tidb_stop, tidb_quickstart),
            "clocks": False}


#: Named registry (tidb/nemesis.clj:110-144 + runner opt-spec).
TIDB_NEMESES = {
    "none": tidb_none,
    "parts": tidb_parts,
    "majring": tidb_majring,
    "startstop": tidb_startstop,
    "startstop2": lambda: tidb_startstop(2),
    "startkill": tidb_startkill,
    "startkill2": lambda: tidb_startkill(2),
}

#: Workload constructors the matrix multiplies against (core.clj:108-110).
TIDB_WORKLOADS = ("tidb", "tidb-register", "tidb-sets")


def _tidb_nemesis_parts(opts: dict):
    """(client, during-gen, final-gen) for a tidb test: the composed
    package from opts['nemesis-map'] when the matrix supplies one, else
    the legacy partition + 5s start/stop cycle."""
    nm = opts.get("nemesis-map")
    if nm:
        return (nm.get("client") or nemesis.noop(), nm.get("during"),
                nm.get("final"))
    return (nemesis.partition_random_halves(), gen.seq(_cycle()),
            gen.once({"type": "info", "f": "stop"}))


def tidb_tests(opts: dict) -> List[dict]:
    """Expand the TiDB test matrix: every requested workload x every
    (nemesis1, nemesis2) product pair, composed per test
    (tidb/core.clj:95-126: doseq over test-fns x nemesis-product,
    nemesis/compose per run)."""
    from jepsen_tpu_torch.suites import cockroachdb as cr

    names1 = opts.get("nemeses", ["none"])
    names2 = opts.get("nemeses2", ["none"])
    workloads = opts.get("workloads", TIDB_WORKLOADS)
    ctors = {
        "tidb": tidb_bank_test,
        "tidb-register": tidb_register_test,
        "tidb-sets": tidb_sets_test,
    }
    tests = []
    pairs = cr.nemesis_product(names1, names2, registry=TIDB_NEMESES) \
        or [(names1[0], names2[0])]  # e.g. none x none: one blank run
    for w in workloads:
        for n1, n2 in pairs:
            pair = [TIDB_NEMESES[n1](), TIDB_NEMESES[n2]()]
            merged = cr.compose_nemeses([m for m in pair
                                         if m["name"] != "blank"]
                                        or [pair[0]])
            t = ctors[w]({**opts, "nemesis-map": merged})
            t["name"] = f"{t['name']}-{merged['name']}"
            tests.append(t)
    return tests


def tidb_bank_test(opts: dict) -> dict:
    n = opts.get("accounts", 5)
    starting = opts.get("starting-balance", 10)

    class TiBank(BankSQLClient):
        pass

    nem_client, nem_during, nem_final = _tidb_nemesis_parts(opts)
    test = noop_test()
    test.update({
        "name": "tidb-bank",
        "db": TiDB(),
        "client": TiBank(n, starting),
        "nemesis": nem_client,
        "checker": compose({
            "perf": perf(),
            "bank": wl.bank_checker(n, n * starting)}),
        "generator": gen.phases(*filter(None, [
            gen.time_limit(
                opts.get("time-limit", 60),
                gen.clients(
                    gen.stagger(1 / 10, gen.mix(
                        [wl.bank_read, wl.bank_diff_transfer(n)])),
                    nem_during)),
            gen.nemesis(nem_final) if nem_final is not None else None,
            gen.sleep(5),
            gen.clients(gen.once({"f": "read", "value": None}))])),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


# ---------------------------------------------------------------------------
# Percona (galera-shaped: dirty reads + bank)
# ---------------------------------------------------------------------------


class PerconaDB(galera.GaleraDB):
    """percona.clj: XtraDB cluster — wsrep like galera."""

    def setup(self, test, node):
        debian.install(test, node, ["percona-xtradb-cluster-56"])
        super_cfg_node = galera.GaleraDB.setup
        # same wsrep bootstrap as galera with percona package names
        cluster = ",".join(str(n) for n in test["nodes"])
        cnf = (f"[mysqld]\n"
               f"wsrep_provider=/usr/lib/libgalera_smm.so\n"
               f"wsrep_cluster_address=gcomm://{cluster}\n"
               f"wsrep_node_address={node}\n")
        with control.sudo():
            control.execute(
                test, node,
                f"echo {control.escape(cnf)} > "
                f"/etc/mysql/conf.d/percona.cnf")
            if node == test["nodes"][0]:
                control.execute(test, node,
                                "service mysql bootstrap-pxc || "
                                "service mysql start")
            else:
                control.exec(test, node, "service", "mysql", "start")


def percona_dirty_reads_test(opts: dict) -> dict:
    test = galera.dirty_reads_test(opts)
    test["name"] = "percona-dirty-reads"
    test["db"] = PerconaDB()
    return test


# ---------------------------------------------------------------------------
# MySQL Cluster (NDB)
# ---------------------------------------------------------------------------


#: Node-id offsets per role (mysql_cluster.clj:14-20): one cluster-wide
#: id space, partitioned so every (role, node) pair gets a stable id.
NDB_MGMD_ID_OFFSET = 1
NDBD_ID_OFFSET = 11
MYSQLD_ID_OFFSET = 21
NDB_MGMD_DIR = "/var/lib/mysql-cluster"
NDBD_DIR = "/var/lib/mysql-cluster-ndbd"


def mysql_cluster_nodes_conf(test: dict) -> str:
    """config.ini role sections for every node (mysql_cluster.clj:75-112):
    every node runs a management and a mysqld section; the first four
    are storage (ndbd) nodes."""
    nodes = test["nodes"]
    parts = []
    for i, n in enumerate(nodes):
        parts.append(f"[ndb_mgmd]\nNodeId={NDB_MGMD_ID_OFFSET + i}\n"
                     f"hostname={n}\ndatadir={NDB_MGMD_DIR}\n")
    for i, n in enumerate(sorted(nodes)[:4]):
        parts.append(f"[ndbd]\nNodeId={NDBD_ID_OFFSET + i}\n"
                     f"hostname={n}\ndatadir={NDBD_DIR}\n")
    for i, n in enumerate(nodes):
        parts.append(f"[mysqld]\nNodeId={MYSQLD_ID_OFFSET + i}\n"
                     f"hostname={n}\n")
    return "\n".join(parts)


class MySQLClusterDB(db_ns.DB, db_ns.LogFiles):
    """mysql_cluster.clj:41-200: NDB management + storage + SQL daemons
    with the role-partitioned node-id scheme, generated config.ini /
    my.cnf, and the connect string spanning every management node."""

    def setup(self, test, node):
        debian.install(test, node, ["mysql-cluster-community-server"])
        i = test["nodes"].index(node)
        connect = ",".join(str(n) for n in test["nodes"])
        my_cnf = (f"[mysqld]\nndbcluster\n"
                  f"ndb-connectstring={connect}\n"
                  f"server-id={MYSQLD_ID_OFFSET + i}\n")
        with control.sudo():
            control.execute(
                test, node,
                f"echo {control.escape(my_cnf)} > /etc/my.cnf")
            control.execute(test, node, f"mkdir -p {NDB_MGMD_DIR} "
                                        f"{NDBD_DIR}")
            control.execute(
                test, node,
                f"echo {control.escape(mysql_cluster_nodes_conf(test))} "
                f"> /etc/my.config.ini")
            control.exec(test, node, "ndb_mgmd",
                         f"--ndb-nodeid={NDB_MGMD_ID_OFFSET + i}",
                         "-f", "/etc/my.config.ini")
            if node in sorted(test["nodes"])[:4]:
                control.exec(
                    test, node, "ndbd",
                    f"--ndb-connectstring={connect}")
            control.execute(test, node, "service mysql start || true")

    def teardown(self, test, node):
        with control.sudo():
            control.execute(test, node, "service mysql stop || true")
            control.execute(test, node, "pkill -9 ndbd || true")
            control.execute(test, node, "pkill -9 ndb_mgmd || true")
            control.execute(test, node,
                            f"rm -rf {NDBD_DIR}/* || true")

    def log_files(self, test, node):
        nid = NDB_MGMD_ID_OFFSET + test["nodes"].index(node)
        return [f"{NDB_MGMD_DIR}/ndb_{nid}_cluster.log",
                "/var/log/mysql/error.log"]


def mysql_cluster_bank_test(opts: dict) -> dict:
    test = tidb_bank_test(opts)
    test["name"] = "mysql-cluster-bank"
    test["db"] = MySQLClusterDB()
    return test


# ---------------------------------------------------------------------------
# Postgres RDS (managed; no node setup)
# ---------------------------------------------------------------------------


class PsqlBankClient(client_ns.Client):
    """postgres_rds.clj:150-230: bank over psql against one managed
    endpoint."""

    def __init__(self, n: int = 5, starting: int = 10, node=None):
        self.n = n
        self.starting = starting
        self.node = node

    def open(self, test, node):
        c = PsqlBankClient(self.n, self.starting)
        c.node = node
        return c

    def _psql(self, test, statement) -> List[List[str]]:
        endpoint = test.get("rds-endpoint", str(self.node))
        out = control.execute(
            test, self.node,
            f"psql -h {control.escape(endpoint)} -U jepsen -d jepsen "
            f"-t -A -F $'\\t' -c {control.escape(statement)}")
        return [line.split("\t") for line in out.splitlines()
                if line.strip()]

    def setup(self, test):
        node = test["nodes"][0]
        c = self.open(test, node)
        c._psql(test, "CREATE TABLE IF NOT EXISTS accounts "
                      "(id INT PRIMARY KEY, balance BIGINT)")
        for i in range(self.n):
            c._psql(test, f"INSERT INTO accounts VALUES "
                          f"({i}, {self.starting}) ON CONFLICT DO NOTHING")

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "read":
                rows = self._psql(
                    test, "SELECT balance FROM accounts ORDER BY id")
                return op.replace(type="ok",
                                  value=[int(r[0]) for r in rows])
            if op.f == "transfer":
                v = op.value
                self._psql(
                    test,
                    "BEGIN ISOLATION LEVEL SERIALIZABLE; "
                    f"UPDATE accounts SET balance = balance - {v['amount']}"
                    f" WHERE id = {v['from']} AND balance >= {v['amount']};"
                    f" UPDATE accounts SET balance = balance + "
                    f"{v['amount']} WHERE id = {v['to']}; COMMIT;")
                return op.replace(type="ok")
            raise ValueError(f"unknown op {op.f!r}")
        except control.RemoteError as e:
            msg = f"{e.err or ''}"
            if "serialize" in msg.lower() or "deadlock" in msg.lower():
                return op.replace(type="fail", error="txn-abort")
            t = "fail" if op.f == "read" else "info"
            return op.replace(type=t, error=msg.strip()[:80])


def postgres_rds_bank_test(opts: dict) -> dict:
    """Bank against managed RDS: DB lifecycle is a noop
    (postgres_rds.clj has no node setup)."""
    n = opts.get("accounts", 5)
    starting = opts.get("starting-balance", 10)
    test = noop_test()
    test.update({
        "name": "postgres-rds-bank",
        "db": db_ns.noop(),
        "client": PsqlBankClient(n, starting),
        "nemesis": None,
        "checker": compose({
            "perf": perf(),
            "bank": wl.bank_checker(n, n * starting)}),
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(gen.stagger(1 / 10, gen.mix(
                [wl.bank_read, wl.bank_diff_transfer(n)])))),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net",
                          "rds-endpoint")})
    return test


# ---------------------------------------------------------------------------
# CrateDB (SQL over HTTP; version divergence)
# ---------------------------------------------------------------------------

CRATE_DIR = "/opt/crate"


def crate_majority(n: int) -> int:
    """n//2 + 1 (crate/core.clj:289-292)."""
    return n // 2 + 1


class CrateDB(db_ns.DB, db_ns.LogFiles):
    """Crate node lifecycle (crate/core.clj:278-377): jdk8 + tarball
    install under a dedicated user, crate.yml with unicast discovery and
    majority minimum_master_nodes (the split-brain dial the
    version-divergence workload turns), vm.max_map_count bump, daemon
    start, wait for the HTTP port."""

    def __init__(self, tarball: Optional[str] = None):
        self.tarball = tarball

    def setup(self, test, node):
        tarball = (self.tarball or test.get("tarball")
                   or "https://cdn.crate.io/downloads/releases/"
                      "crate-0.57.2.tar.gz")
        debian.install(test, node, ["apt-transport-https",
                                    "openjdk-8-jdk"])
        cu.ensure_user(test, node, "crate")
        cu.install_archive(test, node, tarball, CRATE_DIR)
        n = len(test["nodes"])
        hosts = ", ".join(f'"{h}:44300"' for h in test["nodes"])
        conf = (f"cluster.name: jepsen\n"
                f"node.name: {node}\n"
                f"network.host: 0.0.0.0\n"
                f"transport.tcp.port: 44300\n"
                f"discovery.zen.ping.unicast.hosts: [{hosts}]\n"
                f"discovery.zen.minimum_master_nodes: "
                f"{crate_majority(n)}\n"
                f"gateway.expected_nodes: {n}\n")
        with control.sudo():
            control.execute(
                test, node,
                f"echo {control.escape(conf)} > "
                f"{CRATE_DIR}/config/crate.yml")
            control.execute(test, node,
                            f"chown -R crate:crate {CRATE_DIR}")
            control.execute(test, node,
                            "sysctl -w vm.max_map_count=262144")
            control.execute(test, node, f"mkdir -p {CRATE_DIR}/logs")
        cu.start_daemon(test, node, f"{CRATE_DIR}/bin/crate",
                        logfile=f"{CRATE_DIR}/logs/stdout.log",
                        pidfile=f"{CRATE_DIR}/crate.pid",
                        chdir=CRATE_DIR)

    def teardown(self, test, node):
        cu.grepkill(test, node, "crate")
        control.execute(test, node,
                        f"rm -rf {CRATE_DIR}/logs/* {CRATE_DIR}/data/* "
                        f"|| true")

    def log_files(self, test, node):
        return [f"{CRATE_DIR}/logs/crate.log",
                f"{CRATE_DIR}/logs/stdout.log"]


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------


class CrateClient(client_ns.Client):
    """crate/core.clj over the HTTP /_sql endpoint: versioned updates.
    write carries (k, version-guess, value)."""

    def __init__(self, node=None, timeout: float = 5.0):
        self.node = node
        self.timeout = timeout

    def open(self, test, node):
        return CrateClient(node, self.timeout)

    def _sql(self, stmt: str, args=()):
        node = str(self.node)
        authority = node if ":" in node else f"{node}:4200"
        req = urllib.request.Request(
            f"http://{authority}/_sql",
            data=json.dumps({"stmt": stmt, "args": list(args)}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read().decode())

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "read":
                out = self._sql("SELECT v, _version FROM jepsen.r "
                                "WHERE id = ?", [0])
                rows = out.get("rows") or []
                val = rows[0] if rows else None
                return op.replace(type="ok", value=val)
            if op.f == "write":
                out = self._sql(
                    "INSERT INTO jepsen.r (id, v) VALUES (?, ?) "
                    "ON DUPLICATE KEY UPDATE v = VALUES(v)",
                    [0, int(op.value)])
                return op.replace(
                    type="ok" if out.get("rowcount") else "fail")
            raise ValueError(f"unknown op {op.f!r}")
        except urllib.error.HTTPError as e:
            t = "fail" if op.f == "read" else "info"
            return op.replace(type=t, error=f"http-{e.code}")
        except (TimeoutError, OSError) as e:
            t = "fail" if op.f == "read" else "info"
            return op.replace(type=t, error=type(e).__name__)


class VersionDivergenceChecker(Checker):
    """crate/version_divergence.clj:93-122: no two reads may observe the
    same _version with different values."""

    def check(self, test, history, opts=None):
        by_version = {}
        divergent = []
        for o in history:
            if not (o.is_ok and o.f == "read") or not o.value:
                continue
            val, version = o.value[0], o.value[1]
            if version in by_version and by_version[version] != val:
                divergent.append({"version": version,
                                  "values": sorted({by_version[version],
                                                    val})})
            else:
                by_version[version] = val
        return {"valid": not divergent,
                "versions-seen": len(by_version),
                "divergent": divergent}


def crate_version_divergence_test(opts: dict) -> dict:
    counter = itertools.count()

    def write(test, process):
        return {"type": "invoke", "f": "write", "value": next(counter)}

    test = noop_test()
    test.update({
        "name": "crate-version-divergence",
        "db": CrateDB(),
        "client": CrateClient(),
        "nemesis": nemesis.partition_random_halves(),
        "checker": compose({
            "version-divergence": VersionDivergenceChecker()}),
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(
                gen.mix([write,
                         lambda t, p: {"type": "invoke", "f": "read",
                                       "value": None}]),
                gen.seq(_cycle()))),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


class CrateLostUpdatesClient(CrateClient):
    """crate/lost_updates.clj: a set per key stored as an element list;
    add = read elements + _version, append, write back guarded by the
    version (a lost update silently drops acknowledged elements); read =
    refresh + full element list."""

    RETRIES = 5

    def open(self, test, node):
        return CrateLostUpdatesClient(node, self.timeout)

    def setup(self, test):
        c = CrateLostUpdatesClient(test["nodes"][0], self.timeout)
        c._sql("CREATE TABLE IF NOT EXISTS jepsen.sets "
               "(id INTEGER PRIMARY KEY, elements STRING)")
        c._sql("INSERT INTO jepsen.sets (id, elements) VALUES (?, ?) "
               "ON DUPLICATE KEY UPDATE id = id", [0, ""])

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "add":
                for _ in range(self.RETRIES):
                    out = self._sql("SELECT elements, _version FROM "
                                    "jepsen.sets WHERE id = ?", [0])
                    rows = out.get("rows") or []
                    if not rows:
                        return op.replace(type="fail", error="no-row")
                    elements, version = rows[0]
                    new = (f"{elements},{int(op.value)}" if elements
                           else str(int(op.value)))
                    upd = self._sql(
                        "UPDATE jepsen.sets SET elements = ? "
                        "WHERE id = ? AND _version = ?",
                        [new, 0, version])
                    if upd.get("rowcount"):
                        return op.replace(type="ok")
                return op.replace(type="fail", error="version-conflict")
            if op.f == "read":
                self._sql("REFRESH TABLE jepsen.sets")
                out = self._sql("SELECT elements FROM jepsen.sets "
                                "WHERE id = ?", [0])
                rows = out.get("rows") or []
                if not rows:
                    return op.replace(type="fail", error="no-row")
                elements = rows[0][0] or ""
                vals = sorted(int(x) for x in elements.split(",") if x)
                return op.replace(type="ok", value=vals)
            raise ValueError(f"unknown op {op.f!r}")
        except urllib.error.HTTPError as e:
            t = "fail" if op.f == "read" else "info"
            return op.replace(type=t, error=f"http-{e.code}")
        except (TimeoutError, OSError) as e:
            t = "fail" if op.f == "read" else "info"
            return op.replace(type=t, error=type(e).__name__)


def crate_lost_updates_test(opts: dict) -> dict:
    counter = itertools.count()

    def add(test, process):
        return {"type": "invoke", "f": "add", "value": next(counter)}

    test = noop_test()
    test.update({
        "name": "crate-lost-updates",
        "db": CrateDB(),
        "client": CrateLostUpdatesClient(),
        "nemesis": nemesis.partition_random_halves(),
        "checker": compose({"set": set_checker()}),
        "generator": gen.phases(
            gen.time_limit(
                opts.get("time-limit", 60),
                gen.clients(gen.stagger(1 / 10, add),
                            gen.seq(_cycle()))),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.sleep(5),
            gen.clients(gen.once({"f": "read", "value": None}))),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


class CrateDirtyReadClient(CrateClient):
    """crate/dirty_read.clj: write = insert row by id; read = select by
    id (may see unacknowledged data); strong-read = refresh + full scan.
    The elasticsearch dirty-read checker consumes exactly this op
    vocabulary."""

    def open(self, test, node):
        return CrateDirtyReadClient(node, self.timeout)

    def setup(self, test):
        c = CrateDirtyReadClient(test["nodes"][0], self.timeout)
        c._sql("CREATE TABLE IF NOT EXISTS jepsen.dirty "
               "(id INTEGER PRIMARY KEY)")

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "write":
                out = self._sql("INSERT INTO jepsen.dirty (id) "
                                "VALUES (?)", [int(op.value)])
                return op.replace(
                    type="ok" if out.get("rowcount") else "fail")
            if op.f == "read":
                out = self._sql("SELECT id FROM jepsen.dirty "
                                "WHERE id = ?", [int(op.value)])
                return op.replace(type="ok" if out.get("rows")
                                  else "fail")
            if op.f == "strong-read":
                self._sql("REFRESH TABLE jepsen.dirty")
                out = self._sql("SELECT id FROM jepsen.dirty LIMIT 10000")
                vals = {int(r[0]) for r in (out.get("rows") or [])}
                return op.replace(type="ok", value=vals)
            raise ValueError(f"unknown op {op.f!r}")
        except urllib.error.HTTPError as e:
            t = "fail" if op.f != "write" else "info"
            return op.replace(type=t, error=f"http-{e.code}")
        except (TimeoutError, OSError) as e:
            t = "fail" if op.f != "write" else "info"
            return op.replace(type=t, error=type(e).__name__)


def crate_dirty_read_test(opts: dict) -> dict:
    from jepsen_tpu_torch.suites.elasticsearch import dirty_read_checker
    # writes take sequential ids; reads probe a random id below the
    # write high-water mark (in-flight writes included — that is the
    # dirty-read window)
    hwm = {"n": 0}

    def write_hwm(test, process):
        hwm["n"] += 1
        return {"type": "invoke", "f": "write", "value": hwm["n"] - 1}

    def read_hwm(test, process):
        import random as _r
        return {"type": "invoke", "f": "read",
                "value": _r.randrange(max(1, hwm["n"]))}

    test = noop_test()
    test.update({
        "name": "crate-dirty-read",
        "db": CrateDB(),
        "client": CrateDirtyReadClient(),
        "nemesis": nemesis.partition_random_halves(),
        "checker": compose({"dirty-read": dirty_read_checker()}),
        "generator": gen.phases(
            gen.time_limit(
                opts.get("time-limit", 60),
                gen.clients(gen.mix([write_hwm, read_hwm]),
                            gen.seq(_cycle()))),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.sleep(5),
            gen.clients(gen.once({"f": "strong-read", "value": None}))),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


def tidb_register_test(opts: dict) -> dict:
    """tidb register over independent keys (tidb/register.clj shape)."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.models import CASRegister
    keys = itertools.count()
    nem_client, nem_during, _ = _tidb_nemesis_parts(opts)
    test = noop_test()
    test.update({
        "name": "tidb-register",
        "db": TiDB(),
        "client": TiDBRegisterClient(),
        "nemesis": nem_client,
        "model": CASRegister(),
        "checker": compose({
            "perf": perf(),
            "indep": independent.checker(
                linearizable(CASRegister(),
                             backend=opts.get("backend", "gpu"),
                             device=opts.get("device"))),
        }),
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(
                independent.concurrent_generator(
                    opts.get("threads-per-key", 5), keys,
                    lambda k: gen.limit(
                        opts.get("ops-per-key", 100),
                        gen.stagger(1 / 10, wl.register_gen()))),
                nem_during)),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


def tidb_sets_test(opts: dict) -> dict:
    """tidb sets (tidb/sets.clj shape): unique inserts + final read."""
    from jepsen_tpu_torch.suites.cockroachdb import SetsClient
    counter = itertools.count()

    class TiSets(SetsClient):
        def _sql(self, test, statement):
            return galera.sql(test, self.node, statement)

    def add(test, process):
        return {"type": "invoke", "f": "add", "value": next(counter)}

    nem_client, nem_during, nem_final = _tidb_nemesis_parts(opts)
    test = noop_test()
    test.update({
        "name": "tidb-sets",
        "db": TiDB(),
        "client": TiSets(),
        "nemesis": nem_client,
        "checker": compose({"perf": perf(), "set": set_checker()}),
        "generator": gen.phases(*filter(None, [
            gen.time_limit(
                opts.get("time-limit", 60),
                gen.clients(gen.stagger(1 / 10, add),
                            nem_during)),
            gen.nemesis(nem_final) if nem_final is not None else None,
            gen.sleep(5),
            gen.clients(gen.once({"f": "read", "value": None}))])),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


def percona_sets_test(opts: dict) -> dict:
    """percona set workload (percona.clj:319-340) — galera shape over
    the XtraDB cluster DB."""
    test = galera.sets_test(opts)
    test["name"] = "percona-set"
    test["db"] = PerconaDB()
    return test


def percona_bank_test(opts: dict) -> dict:
    """percona bank (percona.clj:341-361)."""
    test = galera.bank_test(opts)
    test["name"] = "percona-bank"
    test["db"] = PerconaDB()
    return test


def _cycle():
    while True:
        yield gen.sleep(5)
        yield gen.once({"type": "info", "f": "start"})
        yield gen.sleep(5)
        yield gen.once({"type": "info", "f": "stop"})


#: the workloads ``run --workload`` selects for a tidb row (the reference's
#: ``tidb_main``)
WORKLOADS = {"tidb": tidb_bank_test, "tidb-register": tidb_register_test,
             "tidb-sets": tidb_sets_test}


def named_test(workload: str, n1s: Optional[List[str]],
               n2s: Optional[List[str]], opts: dict) -> dict:
    """The test map the reference's ``tidb_main`` builds from its
    ``--workload`` and ``--nemesis``/``--nemesis2`` name lists: the first
    point of :func:`tidb_tests`' matrix."""
    return tidb_tests({**opts, "nemeses": n1s or ["none"],
                       "nemeses2": n2s or ["none"],
                       "workloads": [workload]})[0]


def tidb_main(argv=None):
    """The reference's TiDB command line: ``test`` runs the first point
    of the matrix of the ``--workload`` (default: tidb) and the
    ``--nemesis``/``--nemesis2`` names (:func:`named_test`); ``serve`` the
    results browser."""
    from jepsen_tpu_torch import cli

    def opt_spec(p):
        p.add_argument("--workload", default="tidb",
                       choices=sorted(TIDB_WORKLOADS))
        p.add_argument("--nemesis", action="append", default=None,
                       choices=sorted(TIDB_NEMESES))
        p.add_argument("--nemesis2", action="append", default=None,
                       choices=sorted(TIDB_NEMESES))

    def test_fn(opts):
        return named_test(opts.get("workload", "tidb"), opts.get("nemesis"),
                          opts.get("nemesis2"), opts)

    cli.main(cli.merge_commands(
        cli.single_test_cmd(test_fn, opt_spec=opt_spec),
        cli.serve_cmd()), argv)


if __name__ == "__main__":
    tidb_main()
