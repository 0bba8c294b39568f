"""Galera and the SQL family (tidb, percona, mysql-cluster, postgres-rds,
crate) in the port, held against the reference on the CPU.

Under the dummy control plane each database's lifecycle (galera's and
percona's wsrep bootstrap, mysql-cluster's role-partitioned node ids,
crate's install and majority config, tidb's three daemons) and the tidb
nemeses' ``start`` and ``stop`` log the reference's commands from the
same seed; the double schedule, ``tidb_tests``' matrix and the command
line's composition are the reference's. The TiDB clients keep the
reference's data plane, which runs ``cockroach sql`` on the TiDB nodes;
a test pins those commands. The clients of galera, percona and
postgres-rds give the reference's completions on the same scripted
replies, and crate's HTTP clients through a stub of
``urllib.request.urlopen`` shared by both packages, each case of the
taxonomy included; ``DirtyReadsChecker`` and ``VersionDivergenceChecker``
give the reference's results. The fourteen test maps are the reference's.
End to end, a tidb-register run with crashed ops gets the reference's
per-key verdicts and levels (``analyze`` and ``recover`` re-check it key
by key), and a galera bank run against ``CliFake``'s mysql gets the
reference bank checker's result on the host.
"""

import io
import json
import os
import random
import sys
import urllib.error
import urllib.request
from contextlib import redirect_stdout

import pytest
import torch

from jepsen_tpu import control as j_control
from jepsen_tpu import generator as jgen
from jepsen_tpu import net as j_net
from jepsen_tpu import suites as j_suites
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.suites import cockroachdb as j_cr
from jepsen_tpu.suites import galera as j_galera
from jepsen_tpu.suites import sql_family as j_sql
from jepsen_tpu.suites import workloads as j_wl

from jepsen_tpu_torch import control, core, net, store, suites
from jepsen_tpu_torch import generator as pgen
from jepsen_tpu_torch.__main__ import main
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.suites import cockroachdb as cr
from jepsen_tpu_torch.suites import galera, sql_family

from test_torch_generator import drain
from test_torch_suite_etcd import reference_verdicts, to_reference
from test_torch_suite_substrate import both_logs, dummy_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import torch_suite_fakes as fakes  # noqa: E402

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

NODES = ["n1", "n2", "n3", "n4", "n5"]
ROWS = ("galera", "galera-set", "galera-bank", "tidb", "tidb-register",
        "tidb-sets", "percona", "percona-set", "percona-bank",
        "mysql-cluster", "postgres-rds", "crate", "crate-lost-updates",
        "crate-dirty-read")
ARCHIVE = {"stat ": (1, "", "no such file"), "ls -A": "top",
           "dirname": "/opt"}


def op(op_cls, f, value=None, process=0, time=0):
    return op_cls(type="invoke", f=f, value=value, process=process,
                  time=time)


def _plain(v):
    return sorted(v) if isinstance(v, (set, frozenset)) else list(v)


def completion(r):
    return (r.type, r.f, json.dumps(r.value, default=_plain), r.error)


def mods(m):
    """(galera, sql_family) of the package ``m`` names."""
    return (j_galera, j_sql) if m == "ref" else (galera, sql_family)


# ---------------------------------------------------------------------------
# the databases' lifecycles
# ---------------------------------------------------------------------------

LIFECYCLES = {
    "galera setup": (lambda g, s, t: (g.GaleraDB().setup(t, "n1"),
                                      g.GaleraDB().setup(t, "n2")), {}),
    "galera teardown": (lambda g, s, t: g.GaleraDB().teardown(t, "n3"), {}),
    "percona setup": (lambda g, s, t: (s.PerconaDB().setup(t, "n1"),
                                       s.PerconaDB().setup(t, "n4")), {}),
    "mysql-cluster setup": (lambda g, s, t: (
        s.MySQLClusterDB().setup(t, "n1"),
        s.MySQLClusterDB().setup(t, "n5")), {}),
    "mysql-cluster teardown": (lambda g, s, t: s.MySQLClusterDB().teardown(
        t, "n2"), {}),
    "crate setup": (lambda g, s, t: s.CrateDB().setup(t, "n2"), ARCHIVE),
    "crate setup tarball": (lambda g, s, t: s.CrateDB(
        tarball="http://x/crate.tar.gz").setup(t, "n1"), ARCHIVE),
    "crate teardown": (lambda g, s, t: s.CrateDB().teardown(t, "n1"), {}),
    "tidb setup": (lambda g, s, t: s.TiDB().setup(t, "n3"), ARCHIVE),
    "tidb teardown": (lambda g, s, t: s.TiDB().teardown(t, "n3"), {}),
    "tidb quickstart and stop": (lambda g, s, t: (
        s.tidb_quickstart(t, "n2"), s.tidb_stop(t, "n2")), {}),
}


@pytest.mark.parametrize("name", sorted(LIFECYCLES))
def test_each_lifecycle_logs_the_reference_commands(name):
    call, responses = LIFECYCLES[name]
    both_logs(lambda t: call(*mods("ref"), t),
              lambda t: call(*mods("port"), t), responses)


def test_the_log_files_are_the_references():
    t = dummy_map()
    for m, ctor in ((galera, "GaleraDB"), (sql_family, "MySQLClusterDB"),
                    (sql_family, "CrateDB"), (sql_family, "TiDB"),
                    (sql_family, "PerconaDB")):
        ref = j_galera if m is galera else j_sql
        for node in NODES:
            assert getattr(m, ctor)().log_files(t, node) == \
                getattr(ref, ctor)().log_files(t, node)
    assert "ndb_3_cluster.log" in sql_family.MySQLClusterDB().log_files(
        {"nodes": ["n1", "n2", "n3"]}, "n3")[0]


def test_mysql_cluster_conf_partitions_the_id_space():
    t = {"nodes": NODES}
    conf = sql_family.mysql_cluster_nodes_conf(t)
    assert conf == j_sql.mysql_cluster_nodes_conf(t)
    assert (conf.count("[ndb_mgmd]"), conf.count("[ndbd]"),
            conf.count("[mysqld]")) == (5, 4, 5)
    assert sql_family.crate_majority(5) == j_sql.crate_majority(5) == 3


# ---------------------------------------------------------------------------
# the tidb nemeses
# ---------------------------------------------------------------------------

def nemesis_logs(ctl, s, net_ns, op_cls, name, seed):
    t = dummy_map(net=net_ns.iptables())
    random.seed(seed)
    outs = []
    with ctl.session_pool(t):
        m = s.TIDB_NEMESES[name]()
        n = m["client"]
        n = n.setup(t) or n
        for f in ("start", "stop"):
            r = n.invoke(t, op_cls(type="info", f=f, value=None,
                                   process="nemesis", time=0))
            outs.append((r.type, r.f, json.dumps(r.value, sort_keys=True,
                                                 default=repr)))
        n.teardown(t)
        return ({k: list(s.log) for k, s in t["_sessions"].items()}, outs,
                (m["name"], m["clocks"]))


@pytest.mark.parametrize("name", sorted(j_sql.TIDB_NEMESES))
@pytest.mark.parametrize("seed", [0, 4])
def test_each_tidb_nemesis_logs_the_reference_commands(name, seed):
    ref = nemesis_logs(j_control, j_sql, j_net, JOp, name, seed)
    got = nemesis_logs(control, sql_family, net, Op, name, seed)
    assert got == ref
    assert set(sql_family.TIDB_NEMESES) == set(j_sql.TIDB_NEMESES)
    assert sql_family.TIDB_BINS == j_sql.TIDB_BINS


def test_the_double_schedule_is_the_references(monkeypatch):
    for mod in (cr, j_cr):
        monkeypatch.setattr(mod, "NEMESIS_DELAY", 0)
        monkeypatch.setattr(mod, "NEMESIS_DURATION", 0)
    draws = []
    for s, g_ns in ((j_sql, jgen), (sql_family, pgen)):
        m = s.tidb_nemesis_double_gen()
        draws.append((drain(g_ns, m["during"], ["nemesis"], 10,
                            ("nemesis",)),
                      drain(g_ns, m["final"], ["nemesis"], 3,
                            ("nemesis",))))
    assert draws[0] == draws[1]
    fs = [o[1] for o in draws[1][0] if o]
    assert fs[:8] == ["start1", "start2", "stop1", "stop2", "start2",
                      "start1", "stop2", "stop1"]


@pytest.mark.parametrize("opts", [
    {"nemeses": ["none", "parts"], "nemeses2": ["none", "startkill"],
     "workloads": ["tidb", "tidb-sets"]},
    {"nemeses": ["none"], "nemeses2": ["none"], "workloads": ["tidb"]},
    {"nemeses": ["majring", "startstop2"], "nemeses2": ["startkill2"],
     "workloads": list(j_sql.TIDB_WORKLOADS)}])
def test_tidb_tests_matrix_is_the_references(opts):
    random.seed(1)
    ref = j_sql.tidb_tests(dict(opts))
    random.seed(1)
    got = sql_family.tidb_tests(dict(opts))
    assert [t["name"] for t in got] == [t["name"] for t in ref]
    assert [type(t["nemesis"]).__name__ for t in got] == \
        [type(t["nemesis"]).__name__ for t in ref]


def test_a_composed_package_drives_the_generator():
    merged = cr.compose_nemeses([sql_family.TIDB_NEMESES["parts"](),
                                 sql_family.TIDB_NEMESES["startkill"]()])
    sql_family.tidb_sets_test({"nemesis-map": merged, "time-limit": 1})
    fs = [o[1] for o in drain(pgen, merged["final"], ["nemesis"], 4,
                              ("nemesis",)) if o]
    assert ("parts", "stop") in fs and ("startkill", "stop") in fs


# ---------------------------------------------------------------------------
# the TiDB clients: the reference's data plane, cockroach sql
# ---------------------------------------------------------------------------

def tidb_client_logs(ctl, s, op_cls, kv):
    """The three TiDB workloads' clients on n1 under the dummy control
    plane: their completions and n1's commands."""
    t = dummy_map({"SELECT val": "val\n3\n", "RETURNING val": "val\n4\n",
                   "SELECT balance": "balance\n10\n10\n10\n10\n10\n",
                   "UPDATE accounts": "id\n1\n3\n"})
    clients = [(s.TiDBRegisterClient(),
                [("write", kv(0, 3)), ("read", kv(0, None)),
                 ("cas", kv(0, (3, 4)))]),
               (s.tidb_sets_test({})["client"], [("add", 1),
                                                ("read", None)]),
               (s.tidb_bank_test({})["client"], [
                   ("read", None),
                   ("transfer", {"from": 1, "to": 3, "amount": 2})])]
    out = []
    with ctl.session_pool(t):
        for c, ops in clients:
            c = c.open(t, "n1")
            c.setup(t)
            for f, v in ops:
                out.append(completion(c.invoke(t, op(op_cls, f, v))))
        return out, list(t["_sessions"]["n1"].log)


def test_the_tidb_clients_run_cockroach_sql_as_the_reference_does():
    """Pins the reference's behaviour: ``TiDBRegisterClient._sql`` and
    ``TiSets._sql`` are never called, so the TiDB workloads run
    cockroachdb's CLI and its dialect on the TiDB nodes (ROADMAP §C)."""
    from jepsen_tpu import independent as j_independent
    from jepsen_tpu_torch import independent
    ref = tidb_client_logs(j_control, j_sql, JOp, j_independent.tuple_)
    got = tidb_client_logs(control, sql_family, Op, independent.tuple_)
    assert got == ref
    cmds = got[1]
    for stmt in ("UPSERT INTO registers (id, val) VALUES (0, 3)",
                 "INSERT INTO sets VALUES (1)",
                 "SELECT balance FROM accounts ORDER BY id"):
        assert f"/opt/cockroach/cockroach sql --insecure --host n1 " \
               f"--format tsv -e '{stmt}'" in cmds, stmt
    assert any("RETURNING val" in c for c in cmds)
    assert not any(c.startswith("mysql") for c in cmds)
    assert [c[0] for c in got[0]] == ["ok"] * 7


# ---------------------------------------------------------------------------
# the mysql and psql clients
# ---------------------------------------------------------------------------

TRANSFER = {"from": 0, "to": 1, "amount": 3}
#: (name, client, ops (f, value), dummy replies)
CLIENTS = [
    ("dirty", lambda g, s: g.DirtyReadsClient(3),
     [("write", 7), ("read", None)], {"SELECT x FROM dirty": "3\n3\n3\n"}),
    ("dirty-deadlock", lambda g, s: g.DirtyReadsClient(2),
     [("write", 8), ("read", None)],
     {"dirty": (1, "", "ERROR 1213 (40001): Deadlock found")}),
    ("dirty-lock-wait", lambda g, s: g.DirtyReadsClient(2),
     [("write", 8)],
     {"UPDATE": (1, "", "ERROR 1205: Lock wait timeout exceeded")}),
    ("dirty-lost", lambda g, s: g.DirtyReadsClient(2),
     [("write", 9), ("read", None)],
     {"dirty": (1, "", fakes.TIMEOUTS["mysql"])}),
    ("set", lambda g, s: g.SetClient(), [("add", 9), ("read", None)],
     {"SELECT value": "3\n7\n"}),
    ("set-lost", lambda g, s: g.SetClient(), [("add", 9), ("read", None)],
     {"sets": (1, "", fakes.TIMEOUTS["mysql"])}),
    ("bank", lambda g, s: g.BankClient(2, 10),
     [("read", None), ("transfer", TRANSFER)],
     {"SELECT balance": "10\n10\n", "ROW_COUNT()": "1\n"}),
    ("bank-overdraw", lambda g, s: g.BankClient(2, 10),
     [("transfer", TRANSFER)], {"ROW_COUNT()": "0\n"}),
    ("bank-deadlock", lambda g, s: g.BankClient(2, 10),
     [("transfer", TRANSFER)],
     {"ROW_COUNT()": (1, "", "ERROR 1213: Deadlock found")}),
    ("bank-abort", lambda g, s: g.BankClient(2, 10),
     [("transfer", TRANSFER)],
     {"ROW_COUNT()": (1, "", "WSREP detected deadlock/conflict and "
                             "aborted the transaction")}),
    ("bank-lost", lambda g, s: g.BankClient(2, 10),
     [("transfer", TRANSFER), ("read", None)],
     {"accounts": (1, "", fakes.TIMEOUTS["mysql"])}),
    ("psql-bank", lambda g, s: s.PsqlBankClient(2, 10),
     [("read", None), ("transfer", TRANSFER)],
     {"SELECT balance": "10\n10\n"}),
    ("psql-serialize", lambda g, s: s.PsqlBankClient(2, 10),
     [("transfer", TRANSFER)],
     {"BEGIN": (1, "", "ERROR: could not serialize access")}),
    ("psql-lost", lambda g, s: s.PsqlBankClient(2, 10),
     [("transfer", TRANSFER), ("read", None)],
     {"accounts": (1, "", fakes.TIMEOUTS["psql"])}),
]


def client_completions(m, ctl, op_cls, make, ops, responses):
    t = dummy_map(responses, **{"rds-endpoint": "rds.example"})
    random.seed(3)      # the dirty write's row order
    out = []
    with ctl.session_pool(t):
        c = make(*mods(m)).open(t, "n2")
        try:
            c.setup(t)
        except ctl.RemoteError:
            pass        # a reply scripted for the data fails setup too
        for i, (f, v) in enumerate(ops):
            out.append(completion(c.invoke(t, op(op_cls, f, v, time=i))))
        return out, {n: list(s.log) for n, s in t["_sessions"].items()}


@pytest.mark.parametrize("name,make,ops,responses", CLIENTS,
                         ids=[c[0] for c in CLIENTS])
def test_each_sql_client_is_the_references(name, make, ops, responses):
    ref = client_completions("ref", j_control, JOp, make, ops, responses)
    got = client_completions("port", control, Op, make, ops, responses)
    assert got == ref
    types = [c[0] for c in got[0]]
    want = {"dirty": ["ok", "ok"], "dirty-deadlock": ["fail", "fail"],
            "dirty-lock-wait": ["fail"], "dirty-lost": ["info", "fail"],
            "set": ["ok", "ok"], "set-lost": ["info", "fail"],
            "bank": ["ok", "ok"], "bank-overdraw": ["fail"],
            "bank-deadlock": ["fail"], "bank-abort": ["fail"],
            "bank-lost": ["info", "fail"], "psql-bank": ["ok", "ok"],
            "psql-serialize": ["fail"], "psql-lost": ["info", "fail"]}
    assert types == want[name]
    if name == "dirty":
        stmt = next(c for c in got[1]["n2"] if "UPDATE" in c)
        assert "SERIALIZABLE" in stmt and "SET x = 7" in stmt
    if name == "psql-bank":
        assert "rds.example" in next(c for c in got[1]["n2"]
                                     if "BEGIN" in c)


# ---------------------------------------------------------------------------
# crate's HTTP clients, through a stub of urlopen
# ---------------------------------------------------------------------------

class SqlStub:
    """``urllib.request.urlopen`` for both packages' crate clients: the
    first rule whose pattern is in the statement answers (a dict is the
    JSON body, an int an HTTP error, an exception is raised); a list of
    answers is taken in turn."""

    def __init__(self, rules):
        self.rules = [[p, list(a) if isinstance(a, list) else a]
                      for p, a in rules]
        self.calls = []

    def __call__(self, req, timeout=None):
        doc = json.loads(req.data.decode())
        self.calls.append((req.full_url, doc["stmt"], doc["args"]))
        for pat, ans in self.rules:
            if pat in doc["stmt"]:
                if isinstance(ans, list):
                    ans = ans.pop(0) if len(ans) > 1 else ans[0]
                if isinstance(ans, int):
                    raise urllib.error.HTTPError(req.full_url, ans, "err",
                                                 {}, None)
                if isinstance(ans, BaseException):
                    raise ans
                return io.BytesIO(json.dumps(ans).encode())
        return io.BytesIO(b"{}")


CRATE = [
    ("crate", "CrateClient",
     [("read", None), ("write", 3), ("write", 4), ("write", 5),
      ("read", None), ("write", 6), ("read", None)],
     [("SELECT v", [{"rows": [[3, 2]]}, 503, OSError("reset")]),
      ("INSERT", [{"rowcount": 1}, {"rowcount": 0}, 500,
                  TimeoutError("slow")])]),
    ("lost-updates", "CrateLostUpdatesClient",
     [("add", 3), ("add", 5), ("read", None), ("add", 6), ("read", None)],
     [("SELECT elements, _version", [{"rows": [["1,2", 7]]},
                                     {"rows": [["", 1]]}]),
      ("UPDATE jepsen.sets", [{"rowcount": 1}] + [{"rowcount": 0}] * 5
       + [500]),
      ("SELECT elements FROM", [{"rows": [["4,1,9"]]}, 503])]),
    ("dirty-read", "CrateDirtyReadClient",
     [("write", 1), ("read", 1), ("read", 2), ("strong-read", None),
      ("write", 2), ("read", 3), ("strong-read", None)],
     [("INSERT", [{"rowcount": 1}, 500]),
      ("WHERE id", [{"rows": [[1]]}, {"rows": []}, TimeoutError("slow")]),
      ("LIMIT", [{"rows": [[1], [0]]}, 503])]),
]


def crate_completions(s, op_cls, ctor, ops, rules, monkeypatch):
    stub = SqlStub(rules)
    monkeypatch.setattr(urllib.request, "urlopen", stub)
    c = getattr(s, ctor)().open({}, "n3")
    c.setup({"nodes": ["n1"]})
    out = [completion(c.invoke({}, op(op_cls, f, v, time=i)))
           for i, (f, v) in enumerate(ops)]
    return out, stub.calls


@pytest.mark.parametrize("name,ctor,ops,rules", CRATE,
                         ids=[c[0] for c in CRATE])
def test_each_crate_client_is_the_references(name, ctor, ops, rules,
                                             monkeypatch):
    ref = crate_completions(j_sql, JOp, ctor, ops, rules, monkeypatch)
    got = crate_completions(sql_family, Op, ctor, ops, rules, monkeypatch)
    assert got == ref
    types = [c[0] for c in got[0]]
    want = {"crate": ["ok", "ok", "fail", "info", "fail", "info", "fail"],
            "lost-updates": ["ok", "fail", "ok", "info", "fail"],
            "dirty-read": ["ok", "ok", "fail", "ok", "info", "fail",
                           "fail"]}
    assert types == want[name]
    if name == "lost-updates":
        assert got[0][1][3] == "version-conflict"
        assert json.loads(got[0][2][2]) == [1, 4, 9]
        upd = next(c for c in got[1] if c[1].startswith("UPDATE"))
        assert upd[2] == ["1,2,3", 0, 7]
    if name == "crate":
        assert got[0][3][3] == "http-500" and got[0][5][3] == "TimeoutError"
        assert all(u.startswith("http://n3:4200/_sql") for u, _, _ in got[1])


# ---------------------------------------------------------------------------
# the checkers
# ---------------------------------------------------------------------------

def history(h_cls, op_cls, rows):
    return h_cls(op_cls(type=ty, f=f, value=v, process=i % 3, time=i)
                 for i, (ty, f, v) in enumerate(rows))


DIRTY = [
    [("fail", "write", 1), ("ok", "read", [1, 1]), ("ok", "read", [2, 3])],
    [("ok", "write", 1), ("ok", "read", [1, 1])],
    [("info", "write", 4), ("fail", "write", 5), ("ok", "read", [4, 4]),
     ("ok", "read", None), ("fail", "read", [5, 5])]]


@pytest.mark.parametrize("rows", DIRTY)
def test_dirty_reads_checker_is_the_references(rows):
    a = j_galera.DirtyReadsChecker().check({}, history(JHistory, JOp, rows))
    b = galera.DirtyReadsChecker().check({}, history(History, Op, rows))
    assert a == b


VERSIONS = [
    [("ok", "read", [1, 5]), ("ok", "read", [2, 5])],
    [("ok", "read", [1, 5]), ("ok", "read", [1, 5]), ("ok", "read", [2, 6])],
    [("ok", "read", None), ("fail", "read", [3, 1]), ("ok", "read", [4, 1]),
     ("ok", "read", [5, 1]), ("ok", "read", [4, 1])]]


@pytest.mark.parametrize("rows", VERSIONS)
def test_version_divergence_checker_is_the_references(rows):
    a = j_sql.VersionDivergenceChecker().check({}, history(JHistory, JOp,
                                                            rows))
    b = sql_family.VersionDivergenceChecker().check({}, history(History, Op,
                                                                rows))
    assert a == b
    assert b["valid"] is (rows is VERSIONS[1])


# ---------------------------------------------------------------------------
# the test maps and the command line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ROWS)
def test_each_test_map_is_the_references(name):
    opts = {"time-limit": 7, "nodes": NODES, "concurrency": 10,
            "ssh": {"mode": "dummy"}, "store-root": "s",
            "rds-endpoint": "rds.example"}
    t = suites.registry()[name](dict(opts))
    r = j_suites.registry()[name](dict(opts))
    assert set(t) == set(r)
    for k in ("name", "nodes", "concurrency", "ssh", "time-limit",
              "store-root"):
        assert t.get(k) == r.get(k), k
    assert set(t["checker"].checkers) == set(r["checker"].checkers)
    for k in ("client", "db", "nemesis"):
        assert type(t[k]).__name__ == type(r[k]).__name__, k
    if name == "tidb-register":
        lin = t["checker"].checkers["indep"].inner
        assert (lin.backend, lin.device) == ("gpu", None)
        lin = sql_family.tidb_register_test({"backend": "cpu",
                                             "device": "cpu"})[
            "checker"].checkers["indep"].inner
        assert (lin.backend, lin.device) == ("cpu", "cpu")


@pytest.fixture
def seen(monkeypatch):
    out = []
    monkeypatch.setattr(core, "run", lambda t: out.append(t) or dict(
        t, results={"valid": True}))
    return out


@pytest.mark.parametrize("suite,workload,n1s,n2s", [
    ("tidb", None, ["parts"], None),
    ("tidb", "tidb-register", ["parts", "majring"], ["startkill"]),
    ("tidb-sets", None, None, ["startstop2"]),
    ("tidb-register", "tidb", ["none"], ["none"])])
def test_the_tidb_command_line_is_the_references_tidb_main(
        suite, workload, n1s, n2s, seen):
    random.seed(0)
    want = j_sql.tidb_tests({"nemeses": n1s or ["none"],
                             "nemeses2": n2s or ["none"],
                             "workloads": [workload or suite]})[0]
    argv = ["run", "--suite", suite, "--device", "cpu"]
    if workload:
        argv += ["--workload", workload]
    for flag, names in (("--nemesis", n1s), ("--nemesis2", n2s)):
        for n in names or ():
            argv += [flag, n]
    random.seed(0)
    assert main(argv) == 0
    assert seen[0]["name"] == want["name"]
    assert set(want) <= set(seen[0])
    assert type(seen[0]["nemesis"]).__name__ == \
        type(want["nemesis"]).__name__


def test_a_tidb_row_without_a_nemesis_keeps_its_partition_cycle(seen):
    for suite in ("tidb", "tidb-register", "tidb-sets"):
        assert main(["run", "--suite", suite, "--device", "cpu"]) == 0
        want = j_suites.registry()[suite]({})
        assert seen[-1]["name"] == want["name"]
        assert type(seen[-1]["nemesis"]).__name__ == \
            type(want["nemesis"]).__name__
    assert main(["run", "--suite", "tidb", "--workload", "tidb-sets",
                 "--device", "cpu"]) == 0
    assert seen[-1]["name"] == "tidb-sets"


def test_the_run_options_of_other_suites_exit_254(tmp_path):
    base = ["run", "--device", "cpu", "--store-root", str(tmp_path)]
    for suite, flags in (("tidb", ["--nemesis", "small-skews"]),
                         ("tidb-sets", ["--nemesis2", "strobe-skews"]),
                         ("tidb", ["--workload", "register"]),
                         ("percona", ["--workload", "tidb"]),
                         ("galera", ["--nemesis", "parts"]),
                         ("crate", ["--nemesis2", "none"]),
                         ("postgres-rds", ["--write-concern", "majority"]),
                         ("cockroachdb", ["--workload", "tidb-sets"]),
                         ("tidb-register", ["--read-concern", "local"])):
        assert main(base + ["--suite", suite, *flags]) == 254, (suite, flags)
    assert not os.listdir(tmp_path)


def test_each_main_is_run_suite(seen):
    assert exit_code(galera.main, ["test", "--device", "cpu"]) == 0
    assert seen[-1]["name"] == "galera-dirty-reads"
    assert exit_code(sql_family.tidb_main,
                     ["test", "--device", "cpu", "--workload", "tidb-sets",
                      "--nemesis", "parts"]) == 0
    assert seen[-1]["name"] == "tidb-sets-parts"


def exit_code(main, argv):
    """The code a suite module's ``main`` exits with."""
    with pytest.raises(SystemExit) as e:
        main(argv)
    return e.value.code


# ---------------------------------------------------------------------------
# end to end against the fakes
# ---------------------------------------------------------------------------

@pytest.fixture
def short_cycles(monkeypatch):
    """The partition cycles at half a second a sleep."""
    from jepsen_tpu_torch import generator as gen

    def cycle():
        while True:
            yield gen.sleep(0.5)
            yield gen.once({"type": "info", "f": "start"})
            yield gen.sleep(0.5)
            yield gen.once({"type": "info", "f": "stop"})
    monkeypatch.setattr(sql_family, "_cycle", cycle)
    monkeypatch.setattr(galera, "_nemesis_cycle", cycle)


def test_a_tidb_register_run_with_crashed_ops_gives_the_references_verdicts(
        tmp_path, short_cycles):
    fake = fakes.CliFake(NODES, fakes.DUMMY_RESPONSES["tidb"],
                         timeout_p=0.05, seed=4)
    test = sql_family.tidb_register_test({
        "nodes": NODES, "concurrency": 10, "time-limit": 3, "device": "cpu",
        "store-root": str(tmp_path), "ops-per-key": 40,
        "ssh": {"mode": "dummy"}})
    test["_sessions"] = fake.sessions()
    out = core.run(test)
    assert out["results"]["valid"] is True
    crashed = [o for o in out["history"]
               if o.type == "info" and o.process != "nemesis"]
    assert crashed and fake.stats["timeouts"] == len(crashed)
    res = reference_verdicts(out)
    assert len(res["results"]) >= 2
    d = out["store-dir"]
    want = {str(k): (r["valid"], r["levels"])
            for k, r in res["results"].items()}
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(["analyze", "--store", d, "--device", "cpu"]) == 0
    text = buf.getvalue()
    again = json.loads(text[text.index("\n{") + 1:])
    assert {k: (r["valid"], r["levels"])
            for k, r in again["results"].items()} == want
    store.write_state(d, "running")
    state = os.path.join(d, store.RUN_STATE)
    with open(state) as f:
        doc = json.load(f)
    doc["pid"] = 2 ** 22 + 1        # past the kernel's pid range: dead
    with open(state, "w") as f:
        json.dump(doc, f)
    os.remove(os.path.join(d, "history.jsonl"))
    with redirect_stdout(io.StringIO()):
        assert main(["recover", "--store", d, "--device", "cpu"]) == 0
    rec = store.load(d)
    assert {k: (r["valid"], r["levels"]) for k, r in
            rec["results"]["results"].items()} == want


def test_a_galera_bank_run_is_checked_on_the_host_as_the_reference(
        tmp_path, short_cycles):
    fake = fakes.CliFake(NODES, fakes.DUMMY_RESPONSES["galera"],
                         timeout_p=0.05, seed=2)
    test = galera.bank_test({"nodes": NODES, "concurrency": 5,
                             "time-limit": 2, "store-root": str(tmp_path),
                             "ssh": {"mode": "dummy"}})
    test["_sessions"] = fake.sessions()
    out = core.run(test)
    bank = out["results"]["bank"]
    assert out["results"]["valid"] is True and bank["valid"] is True
    assert sum(fake.sql_accounts.values()) == 50
    ops = [o for o in out["history"] if o.process != "nemesis"]
    assert any(o.f == "transfer" and o.type == "ok" for o in ops)
    assert any(o.f == "transfer" and o.type == "fail" for o in ops)
    ref = j_wl.bank_checker(5, 50).check({}, to_reference(out["history"]))
    assert json.loads(json.dumps(ref, default=repr)) == \
        json.loads(json.dumps(bank, default=repr))
