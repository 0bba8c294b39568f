"""The small suites of the port (logcabin, robustirc, rethinkdb, ravendb
and mongodb-rocks), held against the reference on the CPU.

Under the dummy control plane each database's lifecycle (logcabin's
source build and membership, robustirc's shared certificate and joins,
ravendb's install and links, rethinkdb with and without its ``faketime``
wrapper, mongodb-rocks' engine line) and the reconfigure nemeses log the
reference's commands and give its completions from the same seed. The
clients speak to ``tools/torch_suite_fakes.py`` (logcabin's CLI and
rethinkdb's ReQL through ``CliFake`` sessions, ravendb's HTTP listeners,
the IRC server) and give the reference's completions on the same op
sequence, each case of the taxonomy that decides ``info`` against
``fail`` included; the cases of the reference's registry tests are held
one for one. The six test maps are the reference's. A short logcabin run
with crashed ops and a rethinkdb run with outdated reads are checked on
the kernels' plain versions, and the reference's facade and device
search find the same verdicts and levels on the stored histories, as
does ``analyze``; past 128 crashed ops the device answers UNKNOWN and
the host the reference facade's verdict. Last, the smoke's
``small-suites`` phase runs on the CPU at a small size.
"""

import io
import json
import os
import re
import sys
from contextlib import redirect_stdout

import pytest
import torch

from jepsen_tpu import control as j_control
from jepsen_tpu import net as j_net
from jepsen_tpu import store as js
from jepsen_tpu import suites as j_suites
from jepsen_tpu.checker.tpu import check_history_tpu
from jepsen_tpu.checker.wgl import linearizable as j_linearizable
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.models import CASRegister as JCASRegister
from jepsen_tpu.suites import small as j_small

from jepsen_tpu_torch import control, core, net, suites
from jepsen_tpu_torch.__main__ import main
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.suites import small

from test_torch_suite_substrate import both_logs, dummy_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import torch_suite_fakes as fakes  # noqa: E402

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

NODES = ["n1", "n2", "n3", "n4", "n5"]
#: the fields a single register's verdict is held to across packages
KEYS = ("valid", "levels", "max-linearized-prefix")
ROWS = ("logcabin", "robustirc", "rethinkdb", "rethinkdb-aggressive",
        "ravendb", "mongodb-rocks")


def op(op_cls, f, value=None, process=0, time=0):
    return op_cls(type="invoke", f=f, value=value, process=process,
                  time=time)


def completion(r):
    return (r.type, r.f, json.dumps(r.value, default=repr), r.error)


@pytest.fixture
def short_cycle(monkeypatch):
    """The partition cycle at half a second a sleep, so that a short run
    is not held to its 5 s sleeps."""
    from jepsen_tpu_torch import generator as gen

    def cycle():
        while True:
            yield gen.sleep(0.5)
            yield gen.once({"type": "info", "f": "start"})
            yield gen.sleep(0.5)
            yield gen.once({"type": "info", "f": "stop"})
    monkeypatch.setattr(small, "_cycle", cycle)


# ---------------------------------------------------------------------------
# the databases' lifecycles
# ---------------------------------------------------------------------------

RAVEN_RESPONSES = {k: tuple(v) if isinstance(v, list) else v
                   for k, v in fakes.DUMMY_RESPONSES["ravendb"].items()}

LIFECYCLES = {
    "logcabin setup": (lambda m, t: (m.LogCabinDB().setup(t, "n1"),
                                     m.LogCabinDB().setup(t, "n2")), {}),
    "logcabin primary": (lambda m, t: m.LogCabinDB().setup_primary(t, "n1"),
                         {}),
    "logcabin teardown": (lambda m, t: m.LogCabinDB().teardown(t, "n3"),
                          {}),
    "ravendb setup": (lambda m, t: m.RavenDB().setup(t, "n2"),
                      RAVEN_RESPONSES),
    "ravendb primary": (lambda m, t: m.RavenDB().setup_primary(t, "n1"),
                        {}),
    "ravendb teardown": (lambda m, t: m.RavenDB().teardown(t, "n4"), {}),
    "rethinkdb setup": (lambda m, t: m.RethinkDB().setup(t, "n1"), {}),
    "rethinkdb faketime": (lambda m, t: m.RethinkDB(faketime=True).setup(
        t, "n3"), {"test -e": (1, "", "nope")}),
    "rethinkdb teardown": (lambda m, t: m.RethinkDB().teardown(t, "n2"),
                           {}),
    "robustirc teardown": (lambda m, t: m.RobustIRCDB().teardown(t, "n2"),
                           {}),
    "mongodb-rocks setup": (lambda m, t: m.mongodb_rocks_test({})[
        "db"].setup(t, "n5"), {}),
}


@pytest.mark.parametrize("name", sorted(LIFECYCLES))
def test_each_lifecycle_logs_the_reference_commands(name):
    call, responses = LIFECYCLES[name]
    both_logs(lambda t: call(j_small, t), lambda t: call(small, t),
              responses)


def test_the_log_files_are_the_references():
    t = dummy_map()
    for ctor in ("LogCabinDB", "RavenDB", "RethinkDB"):
        assert getattr(small, ctor)().log_files(t, "n1") == \
            getattr(j_small, ctor)().log_files(t, "n1")


def _normalized_certs(logs):
    """A node's log with the certificate pair's local directory (a fresh
    temporary directory a process) read as one name."""
    pat = re.compile(r"\S*/jepsen-robustirc-[^/\s]+")
    return {n: [pat.sub("<certs>", c) for c in cmds]
            for n, cmds in logs.items()}


def test_robustirc_setup_is_the_references_with_one_shared_cert():
    from test_torch_suite_substrate import logs_of
    logs = {}
    for key, ctl, mod in (("ref", j_control, j_small), ("port", control,
                                                          small)):
        db = mod.RobustIRCDB()
        logs[key] = logs_of(ctl, lambda t: (db.setup(t, "n1"),
                                            db.setup(t, "n2")))
    assert _normalized_certs(logs["port"]) == _normalized_certs(logs["ref"])
    port = logs["port"]
    assert any("-singlenode" in c for c in port["n1"])
    assert any("-join=n1:13001" in c for c in port["n2"])
    ups = [next(c for c in port[n] if c.startswith("UPLOAD")
                and c.endswith("/tmp/cert.pem")) for n in ("n1", "n2")]
    assert ups[0] == ups[1]


# ---------------------------------------------------------------------------
# the reconfigure nemeses
# ---------------------------------------------------------------------------

def nemesis_run(ctl, mod, net_ns, op_cls, make, seed):
    import random
    t = dummy_map(net=net_ns.iptables())
    random.seed(seed)
    outs = []
    with ctl.session_pool(t):
        n = make(mod)
        n = n.setup(t) or n
        for f in ("start", "stop", "start"):
            r = n.invoke(t, op_cls(type="info", f=f, value=None,
                                   process="nemesis", time=0))
            outs.append((r.type, r.f, json.dumps(r.value, sort_keys=True,
                                                 default=sorted)))
        n.teardown(t)
        return {k: list(s.log) for k, s in t["_sessions"].items()}, outs


@pytest.mark.parametrize("make", [
    lambda m: m.reconfigure_nemesis(),
    lambda m: m.aggressive_reconfigure_nemesis(),
    lambda m: m.aggressive_reconfigure_nemesis("db2", "t2")],
    ids=["reconfigure", "aggressive", "aggressive-named"])
@pytest.mark.parametrize("seed", [0, 7])
def test_each_nemesis_logs_the_reference_commands(make, seed):
    ref = nemesis_run(j_control, j_small, j_net, JOp, make, seed)
    got = nemesis_run(control, small, net, Op, make, seed)
    assert got == ref
    # each reconfiguration ran on the node it names
    for node, cmds in got[0].items():
        for c in cmds:
            if "rethinkdb admin" in c:
                assert f"--join {node}:29015" in c


@pytest.mark.parametrize("seed", range(6))
def test_reconfigure_grudge_is_the_references(seed):
    import random
    out = []
    for mod in (j_small, small):
        random.seed(seed)
        out.append([mod.reconfigure_grudge(NODES, "n3") for _ in range(5)])
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the clients against the fakes, taxonomy included
# ---------------------------------------------------------------------------

LC_MISMATCH = ("Exiting due to LogCabin::Client::Exception: Path "
               "'/jepsen' has value '8', not '7' as required")
#: (f, value, script before it): a read of the missing key, writes, a
#: CAS that holds and one that does not, LogCabin's mismatch message, a
#: transport error on a CAS and on a write (indeterminate), a read that
#: fails (determinate)
LOGCABIN_OPS = [
    ("read", None, None), ("write", 3, None), ("read", None, None),
    ("cas", (3, 4), None), ("cas", (3, 9), None),
    ("cas", (7, 9), ("--condition", (1, "", LC_MISMATCH), 1)),
    ("cas", (4, 5), ("--condition", (1, "", "connection timed out"), 1)),
    ("write", 6, ("write", (1, "", fakes.TIMEOUTS["logcabin"]), 1)),
    ("read", None, ("read", (1, "", "Exiting due to LogCabin::Client::"
                                    "Exception: session expired"), 1)),
    ("read", None, None)]


def cli_completions(mod, ctl, op_cls, make, ops, setup=False, node="n2"):
    fake = fakes.CliFake(NODES)
    t = dummy_map()
    t["_sessions"] = fake.sessions()
    out = []
    with ctl.session_pool(t):
        c = make(mod).open(t, node)
        if setup:
            c.setup(t)
        for i, (f, v, script) in enumerate(ops):
            if script:
                fake.script(*script)
            out.append(completion(c.invoke(t, op(op_cls, f, v, time=i))))
    return out, {n: list(s.log) for n, s in t["_sessions"].items()}, fake


def test_logcabin_completions_are_the_references():
    make = lambda m: m.LogCabinClient()   # noqa: E731
    ref = cli_completions(j_small, j_control, JOp, make, LOGCABIN_OPS)
    got = cli_completions(small, control, Op, make, LOGCABIN_OPS)
    assert got[:2] == ref[:2]
    assert [c[0] for c in got[0]] == ["ok", "ok", "ok", "ok", "fail",
                                      "fail", "info", "info", "fail", "ok"]
    assert json.loads(got[0][2][2]) == 3 and json.loads(got[0][9][2]) == 4
    assert got[2].tree == {"/jepsen": "4"}


REQL_FAIL = "rethinkdb.errors.ReqlUserError: abort in:\nr.error('abort')"
#: the ReQL client's ops: the acks matrix applied in setup, a read of the
#: missing document, a CAS on it, a write, CAS's that hold and do not (the
#: update's errors, first_error abort), the driver's ReqlUserError, a
#: 'connection abort' transport error, an update error other than abort,
#: a write that times out, a read that fails
RETHINK_OPS = [
    ("read", None, None), ("cas", (1, 2), None), ("write", 3, None),
    ("read", None, None), ("cas", (3, 4), None), ("cas", (3, 9), None),
    ("cas", (4, 5), (".update(lambda", (1, "", REQL_FAIL), 1)),
    ("cas", (4, 5), (".update(lambda", (1, "", "rethinkdb.errors."
                                               "ReqlDriverError: connection "
                                               "abort"), 1)),
    ("cas", (4, 6), (".update(lambda", (0, '{"errors": 1, "first_error": '
                                          '"Primary replica timed out"}',
                                        ""), 1)),
    ("write", 7, ("insert(", (1, "", fakes.TIMEOUTS["rethinkdb"]), 1)),
    ("read", None, ("get(0).run", (1, "", "rethinkdb.errors."
                                          "ReqlDriverError: closed"), 1)),
    ("read", None, None)]


@pytest.mark.parametrize("acks,mode", [("majority", "majority"),
                                       ("single", "outdated")])
def test_rethink_completions_are_the_references(acks, mode):
    make = lambda m: m.RethinkClient(write_acks=acks,    # noqa: E731
                                     read_mode=mode)
    ref = cli_completions(j_small, j_control, JOp, make, RETHINK_OPS, True)
    got = cli_completions(small, control, Op, make, RETHINK_OPS, True)
    assert got[:2] == ref[:2]
    assert [c[0] for c in got[0]] == ["ok", "fail", "ok", "ok", "ok",
                                      "fail", "fail", "info", "info",
                                      "info", "fail", "ok"]
    assert json.loads(got[0][3][2]) == 3 and json.loads(got[0][11][2]) == 4
    assert got[0][8][3] == "Primary replica timed out"
    assert got[2].write_acks == acks


def test_the_outdated_read_is_served_by_a_lagging_replica():
    """In stale-reads mode an outdated read on another node than the
    primary sees a write only DELAY_S after it; a majority read and a
    read on the primary see it at once."""
    fake = fakes.CliFake(NODES, stale_reads=True, delay_s=30)
    t = dummy_map()
    t["_sessions"] = fake.sessions()
    with control.session_pool(t):
        w = small.RethinkClient().open(t, "n2")
        assert w.invoke(t, op(Op, "write", 5)).type == "ok"
        for node, mode, want in (("n2", "outdated", None),
                                 ("n1", "outdated", 5),
                                 ("n2", "majority", 5)):
            c = small.RethinkClient(read_mode=mode).open(t, node)
            assert c.invoke(t, op(Op, "read")).value == want, (node, mode)
    assert fake.stats["stale"] == 1


def raven_completions(mod, op_cls, scripts):
    fake = fakes.RavenFake(1)
    nodes = fake.start()
    out = []
    try:
        c = mod.RavenClient().open({}, nodes[0])
        for i, (f, v, script) in enumerate(scripts):
            if script:
                fake.script(*script)
            out.append(completion(c.invoke({}, op(op_cls, f, v, time=i))))
        down = mod.RavenClient(timeout=0.5).open({}, "127.0.0.1:1")
        for f, v in (("write", 1), ("read", None)):
            out.append(completion(down.invoke({}, op(op_cls, f, v))))
    finally:
        fake.stop()
    return out


#: a read of the missing document (404: ok nil), writes and reads, a 503
#: on a write (indeterminate) and on a read (a failed read)
RAVEN_OPS = [("read", None, None), ("write", 3, None), ("read", None, None),
             ("write", 4, ("PUT", 503)), ("read", None, ("GET", 500)),
             ("read", None, None)]


def test_raven_completions_are_the_references():
    ref = raven_completions(j_small, JOp, RAVEN_OPS)
    got = raven_completions(small, Op, RAVEN_OPS)
    assert got == ref
    assert [c[0] for c in got] == ["ok", "ok", "ok", "info", "fail", "ok",
                                   "info", "fail"]
    assert json.loads(got[0][2]) is None and json.loads(got[5][2]) == 3
    assert got[3][3] == "HTTPError" and got[6][3] == "URLError"


def irc_completions(mod, op_cls):
    fake = fakes.IrcFake(2)
    nodes = fake.start()
    out = []
    try:
        a = mod.IRCClient(timeout=0.3).open({}, nodes[0])
        b = mod.IRCClient(timeout=0.3).open({}, nodes[1])
        for c, f, v in ((a, "add", 1), (b, "add", 2), (a, "add", 3),
                        (b, "read", None), (a, "read", None)):
            out.append(completion(c.invoke({}, op(op_cls, f, v))))
        late = mod.IRCClient(timeout=0.3).open({}, nodes[1])
        out.append(completion(late.invoke({}, op(op_cls, "read"))))
        for c in (a, b, late):
            c.close({})
        down = mod.IRCClient(timeout=0.3).open({}, "127.0.0.1:1")
        for f, v in (("add", 4), ("read", None)):
            out.append(completion(down.invoke({}, op(op_cls, f, v))))
    finally:
        fake.stop()
    return out


def test_irc_completions_are_the_references():
    ref = irc_completions(j_small, JOp)
    got = irc_completions(small, Op)
    assert got == ref
    assert [c[0] for c in got] == ["ok"] * 6 + ["info", "fail"]
    assert json.loads(got[5][2]) == [1, 2, 3]


# ---------------------------------------------------------------------------
# the reference's registry cases, one for one (tests/test_suite_registry.py)
# ---------------------------------------------------------------------------

def both(fn, over):
    """``fn(mod, ctl, op_cls, t)`` under each package's dummy control plane
    on ``dummy_map(**over)``: its return values and the nodes' logs."""
    import random
    out = []
    for mod, ctl, op_cls in ((j_small, j_control, JOp),
                             (small, control, Op)):
        t = dummy_map(**over)
        random.seed(0)      # the temporary directories' names
        with ctl.session_pool(t):
            r = fn(mod, ctl, op_cls, t)
            out.append((r, {n: list(s.log)
                            for n, s in t["_sessions"].items()}))
    assert out[0] == out[1]
    return out[1]


def test_logcabin_cas():
    def fn(mod, ctl, op_cls, t):
        c = mod.LogCabinClient().open(t, "n1")
        return [completion(c.invoke(t, op(op_cls, "read"))),
                completion(c.invoke(t, op(op_cls, "cas", (7, 9))))]
    res, logs = both(fn, {"ssh": {"mode": "dummy", "dummy-responses": {
        "logcabin --cluster": "7"}}})
    assert [r[0] for r in res] == ["ok", "ok"] and json.loads(res[0][2]) == 7
    assert any("--condition /jepsen:7" in c for c in logs["n1"])


@pytest.mark.parametrize("err,want", [(LC_MISMATCH, "fail"),
                                      ("connection timed out", "info")])
def test_logcabin_cas_error_taxonomy(err, want):
    def fn(mod, ctl, op_cls, t):
        c = mod.LogCabinClient().open(t, "n1")
        return completion(c.invoke(t, op(op_cls, "cas", (7, 9))))
    res, _ = both(fn, {"ssh": {"mode": "dummy", "dummy-responses": {
        "--condition": (1, "", err)}}})
    assert res[0] == want


@pytest.mark.parametrize("err,want", [
    ("rethinkdb.errors.ReqlUserError: abort", "fail"),
    ("connection refused", "info")])
def test_rethink_cas_abort_is_fail(err, want):
    def fn(mod, ctl, op_cls, t):
        c = mod.RethinkClient().open(t, "n1")
        return completion(c.invoke(t, op(op_cls, "cas", (1, 2))))
    res, _ = both(fn, {"ssh": {"mode": "dummy", "dummy-responses": {
        "python3 -c": (1, "", err)}}})
    assert res[0] == want


def test_rethink_cas_via_node_driver():
    def fn(mod, ctl, op_cls, t):
        c = mod.RethinkClient().open(t, "n1")
        return [completion(c.invoke(t, op(op_cls, "read"))),
                completion(c.invoke(t, op(op_cls, "cas", (3, 4))))]
    res, _ = both(fn, {"ssh": {"mode": "dummy", "dummy-responses": {
        "get(0).update": '{"replaced": 1}',
        "get(0).run": '{"id": 0, "v": 3}'}}})
    assert [r[0] for r in res] == ["ok", "ok"] and json.loads(res[0][2]) == 3


def test_rethink_matrix_applies_to_cluster_and_reads():
    def fn(mod, ctl, op_cls, t):
        c = mod.RethinkClient("n1", write_acks="single",
                              read_mode="outdated")
        c.setup(t)
        try:
            c.open(t, "n1").invoke(t, op(op_cls, "read"))
        except Exception:   # noqa: BLE001 - the reference test's own
            pass
    _, logs = both(fn, {"nodes": ["n1"], "ssh": {
        "mode": "dummy", "dummy-responses": {"table_config": "{}"}}})
    cfg = next(c for c in logs["n1"] if "table_config" in c)
    assert "write_acks" in cfg and "single" in cfg
    rd = next(c for c in logs["n1"] if "read_mode" in c and "get(0)" in c)
    assert "outdated" in rd


def test_rethink_test_name_carries_matrix_point():
    opts = {"time-limit": 1, "write-acks": "single", "read-mode": "outdated"}
    assert small.rethinkdb_test(dict(opts))["name"] == \
        j_small.rethinkdb_test(dict(opts))["name"] == \
        "rethinkdb-write-single-read-outdated"
    assert small.rethinkdb_aggressive_test({})["name"] == \
        j_small.rethinkdb_aggressive_test({})["name"]


def test_aggressive_nemesis_reconfigures_heals_and_partitions():
    healed = []

    def fn(mod, ctl, op_cls, t):
        import random
        net_ns = j_net if mod is j_small else net

        class SpyNet(net_ns.NoopNet):
            def heal(self, test):
                healed.append(mod.__name__)
        t["net"] = SpyNet()
        random.seed(2)
        out = mod.aggressive_reconfigure_nemesis().invoke(
            t, op(op_cls, "reconfigure"))
        return out.type, json.dumps(out.value, sort_keys=True,
                                    default=sorted)
    res, logs = both(fn, {"nodes": ["n1", "n2", "n3"], "ssh": {
        "mode": "dummy", "dummy-responses": {"reconfigure": ""}}})
    assert res[0] == "info" and healed == ["jepsen_tpu.suites.small",
                                           "jepsen_tpu_torch.suites.small"]
    value = json.loads(res[1])
    assert value["primary"] in ("n1", "n2", "n3")
    cmd = next(c for cmds in logs.values() for c in cmds
               if "reconfigure" in c)
    assert "jepsen.cas" in cmd


def test_rethink_faketime_wrapper_only_when_asked():
    for faketime in (True, False):
        def fn(mod, ctl, op_cls, t):
            import random
            random.seed(1)
            mod.RethinkDB(faketime=faketime).setup(t, "n1")
        _, logs = both(fn, {"nodes": ["n1"], "ssh": {
            "mode": "dummy", "dummy-responses": {"test -e": (1, "",
                                                             "nope")}}})
        assert any("faketime" in c for c in logs["n1"]) is faketime
        if faketime:
            assert any("mv" in c and "/usr/bin/rethinkdb" in c
                       for c in logs["n1"])


def test_logcabin_db_builds_configures_and_reconfigures():
    def fn(mod, ctl, op_cls, t):
        db = mod.LogCabinDB()
        db.setup(t, "n1")
        db.setup(t, "n2")
        db.setup_primary(t, "n1")
        db.teardown(t, "n1")
    _, logs = both(fn, {"nodes": ["n1", "n2", "n3"]})
    cmds = logs["n1"]
    assert any("git clone" in c for c in cmds)
    assert any("serverId = 1" in c for c in cmds)
    assert any("--bootstrap" in c for c in cmds)
    assert not any("--bootstrap" in c for c in logs["n2"])
    assert any("Reconfigure" in c and "n3:5254" in c for c in cmds)
    assert any("LogCabin" in c and "kill" in c for c in cmds)


def test_logcabin_server_id_is_index_based():
    def fn(mod, ctl, op_cls, t):
        mod.LogCabinDB().setup(t, "10.0.0.2")
    _, logs = both(fn, {"nodes": ["10.0.0.1", "10.0.0.2"]})
    assert any("serverId = 2" in c for c in logs["10.0.0.2"])


def test_ravendb_leader_links_followers():
    def fn(mod, ctl, op_cls, t):
        db = mod.RavenDB()
        db.setup(t, "n1")
        db.setup_primary(t, "n1")
    _, logs = both(fn, {"nodes": ["n1", "n2", "n3"], "ssh": {
        "mode": "dummy", "dummy-responses": RAVEN_RESPONSES}})
    assert any("Raven.Server" in c and "start-stop-daemon" in c
               for c in logs["n1"])
    assert len([c for c in logs["n1"] if "admin/cluster/node" in c]) == 2


def test_robustirc_teardown_keeps_the_shared_cert():
    db = small.RobustIRCDB()
    t = dummy_map(nodes=["n1", "n2"])
    with control.session_pool(t):
        db.setup(t, "n1")
        up = next(c for c in t["_sessions"]["n1"].log
                  if c.startswith("UPLOAD") and c.endswith("/tmp/cert.pem"))
        db.teardown(t, "n1")
    cert = up.split()[1]
    assert os.path.exists(cert)
    import subprocess
    sans = subprocess.run(["openssl", "x509", "-in", cert, "-noout", "-ext",
                           "subjectAltName"], capture_output=True,
                          text=True).stdout
    assert "DNS:n1" in sans and "DNS:n2" in sans, sans


# ---------------------------------------------------------------------------
# the test maps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ROWS)
def test_each_test_map_is_the_references(name):
    opts = {"time-limit": 7, "nodes": NODES, "concurrency": 10,
            "ssh": {"mode": "dummy"}, "store-root": "s"}
    t = suites.registry()[name](dict(opts))
    r = j_suites.registry()[name](dict(opts))
    assert set(t) == set(r)
    for k in ("name", "nodes", "concurrency", "ssh", "time-limit",
              "store-root"):
        assert t[k] == r[k], k
    assert set(t["checker"].checkers) == set(r["checker"].checkers)
    assert type(t["client"]).__name__ == type(r["client"]).__name__
    assert type(t["db"]).__name__ == type(r["db"]).__name__
    assert type(t["nemesis"]).__name__ == type(r["nemesis"]).__name__
    checkers = t["checker"].checkers
    lin = (checkers["indep"].inner if "indep" in checkers
           else checkers.get("linear"))
    if name == "robustirc":
        assert lin is None
        return
    assert (lin.backend, lin.device) == ("gpu", None)
    asked = suites.registry()[name]({"backend": "cpu", "device": "cpu"})
    checkers = asked["checker"].checkers
    lin = (checkers["indep"].inner if "indep" in checkers
           else checkers["linear"])
    assert (lin.backend, lin.device) == ("cpu", "cpu")


def test_small_has_no_main_and_run_takes_no_rethink_option(tmp_path):
    assert not hasattr(small, "main") and not hasattr(j_small, "main")
    for flags in (["--write-acks", "single"], ["--read-mode", "outdated"]):
        assert main(["run", "--suite", "rethinkdb", "--device", "cpu",
                     "--store-root", str(tmp_path), *flags]) == 254
    for flags in (["--workload", "register"], ["--nemesis", "parts"],
                  ["--write-concern", "majority"]):
        assert main(["run", "--suite", "logcabin", "--device", "cpu",
                     "--store-root", str(tmp_path), *flags]) == 254
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# end to end against the fakes
# ---------------------------------------------------------------------------

def reference_single(out, lin):
    """The reference's facade and its device search on the stored
    history give the port's verdict, levels and prefix."""
    jh = js.load(out["store-dir"])["history"]
    ref = j_linearizable(JCASRegister()).check({}, jh)
    assert ref["valid"] == lin["valid"], (ref, lin)
    dev = check_history_tpu(jh, JCASRegister())
    assert {k: dev.get(k) for k in KEYS} == {k: lin.get(k) for k in KEYS}


def analyzed(d):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(["analyze", "--store", d, "--device", "cpu"])
    text = buf.getvalue()
    return rc, json.loads(text[text.index("\n{") + 1:])


def run_small(tmp_path, suite, fake, **opts):
    """A 2 s run of ``suite`` on the fake's sessions: the run and the
    sessions."""
    test = suites.registry()[suite]({
        "nodes": NODES, "concurrency": 5, "time-limit": 2, "device": "cpu",
        "store-root": str(tmp_path), "ssh": {"mode": "dummy"}, **opts})
    sessions = test["_sessions"] = fake.sessions()
    return core.run(test), sessions


def test_a_logcabin_run_with_crashed_ops_gives_the_references_verdict(
        tmp_path, short_cycle):
    fake = fakes.CliFake(NODES, timeout_p=0.08, seed=5)
    out, _ = run_small(tmp_path, "logcabin", fake)
    lin = out["results"]["linear"]
    assert out["results"]["valid"] is True and lin["valid"] is True
    assert lin["backend"] == "gpu" and "fallback-from" not in lin
    crashed = [o for o in out["history"]
               if o.type == "info" and o.process != "nemesis"]
    assert crashed and len(crashed) == fake.stats["timeouts"]
    assert all(o.error.startswith("command failed on") for o in crashed)
    assert lin["crash-width"] >= 8
    reference_single(out, lin)
    rc, again = analyzed(out["store-dir"])
    assert rc == 0 and (again["valid"], again["levels"]) == \
        (lin["valid"], lin["levels"])


def test_a_rethinkdb_run_with_outdated_reads_is_refuted_as_the_reference(
        tmp_path, short_cycle):
    fake = fakes.CliFake(NODES, stale_reads=True, delay_s=0.5)
    out, sessions = run_small(tmp_path, "rethinkdb", fake,
                              **{"read-mode": "outdated"})
    lin = out["results"]["linear"]
    assert out["results"]["valid"] is False and lin["valid"] is False
    assert fake.stats["stale"] > 0
    reference_single(out, lin)
    rc, again = analyzed(out["store-dir"])
    assert rc == 1 and again["valid"] is False
    # the reconfigure nemesis ran on the nodes it chose, once an op
    recon = [(n, c) for n, s in sessions.items() for c in s.log
             if "rethinkdb admin" in c]
    done = [o for o in out["history"] if o.process == "nemesis"
            and o.type == "info" and isinstance(o.value, dict)]
    assert recon and len(recon) == len(done)
    assert all(f"--join {n}:29015" in c for n, c in recon)


def test_past_128_crashed_ops_the_device_answers_unknown_as_the_reference(
        tmp_path, short_cycle):
    """A logcabin history with more crashed ops than the device's widest
    crashed mask: the device search answers UNKNOWN, as the reference's
    does (checker/tpu.py:1249, :1413), and the facade's host engine gives
    the reference facade's verdict."""
    from jepsen_tpu_torch.checker.gpu import check_history_gpu
    from jepsen_tpu_torch.models import CASRegister
    fake = fakes.CliFake(NODES, timeout_p=0.95, seed=3)
    out, _ = run_small(tmp_path, "logcabin", fake, **{"time-limit": 4})
    crashed = [o for o in out["history"]
               if o.type == "info" and o.process != "nemesis"]
    assert len(crashed) > 128
    lin = out["results"]["linear"]
    assert lin["valid"] is True and lin["fallback-from"] == "gpu"
    dev = check_history_gpu(out["history"], CASRegister(), device="cpu")
    jh = js.load(out["store-dir"])["history"]
    ref = check_history_tpu(jh, JCASRegister())
    assert dev["valid"] == ref["valid"] == "unknown"
    assert dev["error"] == ref["error"] == \
        f"{len(crashed)} crashed ops exceed the crashed-set width 128"
    facade = j_linearizable(JCASRegister(), backend="tpu").check({}, jh)
    assert (facade["valid"], facade["fallback-from"]) == (True, "tpu")


# ---------------------------------------------------------------------------
# the smoke's phase
# ---------------------------------------------------------------------------

def test_the_smoke_small_suites_phase_runs_on_the_cpu(short_cycle):
    sys.path.insert(0, ROOT)
    import chip_smoke
    seconds = {}
    line, launches, grid, segs = chip_smoke.small_suites_phase(
        torch.device("cpu"), seconds, "cpu", dict(
            chip_smoke.SMALL_RUN, logcabin_seconds=2, raven_seconds=1,
            rethink_seconds=2, rocks_seconds=2, rocks_workers=10,
            min_crash_width=0))
    assert set(line) == {"card", "logcabin", "ravendb", "rethinkdb majority",
                         "rethinkdb outdated", "mongodb-rocks"}
    assert line["logcabin"]["valid"] is True
    assert any(ln.startswith("# plan:") for ln in line["logcabin"]["analyze"])
    assert line["ravendb"]["valid"] is True
    assert line["rethinkdb majority"]["valid"] is True
    assert line["rethinkdb outdated"]["valid"] is False
    assert line["rethinkdb outdated"]["reconfigurations"] > 0
    assert line["mongodb-rocks"]["valid"] is True
    # the plain versions launch no kernel
    assert set(launches.values()) == {0} and segs["launches"] == 0
    assert seconds["small-suites"] > 0
