"""The aerospike and mongodb suites of the port and the registry's new
rows, held against the reference on the CPU.

Under the dummy control plane each database's lifecycle (aerospike's
roster dance, mongodb's replica-set initiation) and aerospike's kill
nemesis log the reference's commands; the info, roster and replica-set
helpers parse and wait as the reference's do. ``with_errors`` and the
mongodb client's ``not master`` mapping give the reference's completion
for each message, and the clients (the generation-predicated CAS, the
counter, the document CAS under each concern, the transfer) give the
reference's completions through the command-line fake of
``tools/torch_suite_fakes.py``: a generation mismatch, a missing record,
a timeout and a secondary's ``not master`` among them. ``AccountsModel``
steps as the reference's, and the suite's clustering specification is
the reference's copy, byte for byte. All twelve new ``SUITES`` rows are the
reference's and build its test maps; ``--workload``, ``--write-concern``
and ``--read-concern`` pick the reference's tests, and exit 254 for
another suite. A small aerospike run with seeded timeouts (crashed ops)
and a small mongodb run against lagging secondaries (refuted) give the
reference's per-key verdicts, and ``analyze`` re-checks them key by key;
the transfer's host-checked verdict is the reference's.
"""

import importlib
import io
import json
import os
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from jepsen_tpu import control as j_control
from jepsen_tpu import independent as j_independent
from jepsen_tpu import suites as j_suites
from jepsen_tpu.checker.wgl import linearizable as j_linearizable
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.models.core import is_inconsistent as j_is_inconsistent
from jepsen_tpu.suites import aerospike as j_as
from jepsen_tpu.suites import mongodb as j_mongo

from jepsen_tpu_torch import control, core, independent, suites
from jepsen_tpu_torch.__main__ import main
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.models.core import is_inconsistent
from jepsen_tpu_torch.suites import aerospike
from jepsen_tpu_torch.suites import mongodb

from test_torch_cli_lib import SUITE_MAINS, suite_map
from test_torch_suite_etcd import reference_verdicts, to_reference
from test_torch_suite_smoke import built_tests
from test_torch_suite_substrate import both_logs, dummy_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import torch_suite_fakes as fakes  # noqa: E402

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

NODES = ["n1", "n2", "n3", "n4", "n5"]
NEW_ROWS = ("cockroachdb", "cockroachdb-bank", "cockroachdb-sets",
            "cockroachdb-comments", "cockroachdb-monotonic",
            "cockroachdb-sequential", "cockroachdb-g2",
            "cockroachdb-bank-multitable", "aerospike", "aerospike-counter",
            "mongodb", "mongodb-transfer")


def responses(suite):
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in fakes.DUMMY_RESPONSES[suite].items()}


def kv(mod, k, v):
    return (j_independent if mod in (j_as, j_mongo)
            else independent).tuple_(k, v)


# ---------------------------------------------------------------------------
# the registry and the command line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NEW_ROWS)
def test_the_new_rows_are_the_references(name):
    assert suites.SUITES[name] == j_suites.SUITES[name]
    mod, attr = suites.SUITES[name]
    opts = {"nodes": NODES, "concurrency": 10, "time-limit": 5}
    t = suites.registry()[name](dict(opts))
    ref = getattr(importlib.import_module(f"jepsen_tpu.suites.{mod}"),
                  attr)(dict(opts))
    assert set(t) == set(ref) and t["name"] == ref["name"]
    assert set(t["checker"].checkers) == set(ref["checker"].checkers)
    assert type(t["client"]).__name__ == type(ref["client"]).__name__


@pytest.mark.parametrize("suite,workload,name", [
    ("aerospike", "counter", "aerospike-counter"),
    ("aerospike-counter", "cas-register", "aerospike-cas-register"),
    ("mongodb", "transfer", "mongodb-transfer"),
    ("mongodb", "document-cas",
     "mongodb-document-cas-wmajority-rlinearizable")])
def test_workload_picks_the_references_test(suite, workload, name,
                                            monkeypatch):
    seen = []
    monkeypatch.setattr(core, "run", lambda t: seen.append(t) or dict(
        t, results={"valid": True}))
    assert main(["run", "--suite", suite, "--device", "cpu",
                 "--workload", workload]) == 0
    assert seen[0]["name"] == name


@pytest.mark.parametrize("wc", mongodb.WRITE_CONCERNS)
@pytest.mark.parametrize("rc", mongodb.READ_CONCERNS)
def test_the_concern_options_reach_the_client(wc, rc, monkeypatch):
    seen = []
    monkeypatch.setattr(core, "run", lambda t: seen.append(t) or dict(
        t, results={"valid": True}))
    assert main(["run", "--suite", "mongodb", "--device", "cpu",
                 "--write-concern", wc, "--read-concern", rc]) == 0
    ref = j_mongo.document_cas_test({"write-concern": wc,
                                     "read-concern": rc})
    assert seen[0]["name"] == ref["name"]
    c = seen[0]["client"]
    assert (c.write_concern, c.read_concern, c._wc()) == \
        (ref["client"].write_concern, ref["client"].read_concern,
         ref["client"]._wc())


def test_the_new_options_exit_254_for_other_suites(tmp_path):
    base = ["run", "--device", "cpu", "--store-root", str(tmp_path)]
    for suite, flags in (("etcd", ["--write-concern", "majority"]),
                         ("aerospike", ["--read-concern", "local"]),
                         ("local-kv", ["--workload", "counter"]),
                         ("aerospike", ["--workload", "transfer"]),
                         ("mongodb", ["--workload", "lock"]),
                         ("hazelcast", ["--workload", "register"]),
                         ("mongodb", ["--nemesis", "parts"]),
                         ("mongodb", ["--read-concern", "snapshot"])):
        assert main(base + ["--suite", suite, *flags]) == 254, (suite, flags)
    assert not os.listdir(tmp_path)


def _suite_options(mod, monkeypatch):
    """(option, choice) of each choice of the reference's own options of
    ``mod``'s ``test`` (beyond the standard test options)."""
    from jepsen_tpu import cli as j_cli
    parser = suite_map("jepsen_tpu", mod, monkeypatch)["test"]["parser"]()
    bare = j_cli.Parser(prog="t")
    j_cli.add_test_opts(bare)
    out = []
    for opt, action in sorted(parser._option_string_actions.items()):
        if opt not in bare._option_string_actions and action.choices:
            out += [(opt, c) for c in sorted(action.choices)]
    return out


@pytest.mark.parametrize("mod", sorted(SUITE_MAINS))
def test_each_new_main_is_the_run_command(mod, monkeypatch):
    """Each suite module's main exits as the reference's does (``test
    --help`` and ``serve --help`` 0, an unknown option or no command 254),
    and each choice of the reference's own options builds the
    reference's test."""
    mains = [getattr(importlib.import_module(f"{pkg}.suites.{mod}"),
                     SUITE_MAINS[mod])
             for pkg in ("jepsen_tpu_torch", "jepsen_tpu")]
    for argv, rc in ((["test", "--help"], 0), (["serve", "--help"], 0),
                     (["test", "--no-such-option"], 254), ([], 254)):
        for m in mains:
            with pytest.raises(SystemExit) as e, \
                    redirect_stdout(io.StringIO()), \
                    redirect_stderr(io.StringIO()):
                m(argv)
            assert e.value.code == rc, (m.__module__, argv)
    variants = _suite_options(mod, monkeypatch)
    assert bool(variants) == (mod in ("aerospike", "cockroachdb",
                                      "hazelcast", "mongodb", "sql_family"))
    got = built_tests(mod, monkeypatch, [["test", opt, choice]
                                         for opt, choice in variants])
    (rcs, ours), (jrcs, theirs) = got["jepsen_tpu_torch"], got["jepsen_tpu"]
    assert rcs == jrcs == [0] * len(variants)
    assert [t["name"] for t in ours] == [t["name"] for t in theirs]


# ---------------------------------------------------------------------------
# aerospike
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["aerospike_clustering.tla",
                                  "aerospike_clustering.cfg"])
def test_the_specification_is_the_references_copy(name):
    with open(os.path.join(ROOT, "jepsen_tpu_torch", "suites", "resources",
                           name), "rb") as a, \
            open(os.path.join(ROOT, "jepsen_tpu", "suites", "resources",
                              name), "rb") as b:
        assert a.read() == b.read()


def test_aerospike_lifecycle_logs_the_reference_commands():
    resp = responses("aerospike")
    for call in (lambda m, t: m.AerospikeDB().setup(t, "n2"),
                 lambda m, t: m.AerospikeDB().setup_primary(t, "n1"),
                 lambda m, t: m.AerospikeDB().teardown(t, "n3"),
                 lambda m, t: m.roster_set(t, "n1", "A1,A2"),
                 lambda m, t: m.recluster(t, "n1")):
        both_logs(lambda t: call(j_as, t), lambda t: call(aerospike, t),
                  resp)
    assert aerospike.AerospikeDB().log_files({}, "n1") == \
        j_as.AerospikeDB().log_files({}, "n1")


def test_aerospike_info_helpers_are_the_references():
    resp = {"roster:namespace": "roster=null:pending_roster=A1,B2:"
                                "observed_nodes=A1,B2,C3",
            "statistics": "cluster_size=3;migrate_allowed=true;"
                          "migrate_partitions_remaining=0;uptime=12.5"}
    outs = []
    for ctl, mod in ((j_control, j_as), (control, aerospike)):
        t = dummy_map(resp)
        with ctl.session_pool(t):
            outs.append((mod.observed_nodes(t, "n1"), mod.roster(t, "n1"),
                         mod.server_info(t, "n1"),
                         mod.wait_for_migrations(t, "n1")))
    assert outs[0] == outs[1]
    assert outs[1][1]["roster"] == [] and outs[1][2]["uptime"] == 12.5


def test_aerospike_polls_time_out_as_the_references(monkeypatch):
    monkeypatch.setattr("time.sleep", lambda s: None)
    for mod in (j_as, aerospike):
        calls = []
        with pytest.raises(TimeoutError, match="3 tries"):
            mod._poll(lambda: calls.append(1), lambda r: False, tries=3)
        assert len(calls) == 3
        t = dummy_map({"roster:namespace": "observed_nodes=A1"})
        ctl = j_control if mod is j_as else control
        with ctl.session_pool(t):
            with pytest.raises(TimeoutError):
                mod.wait_for_all_nodes_observed(t, "n1")


def test_the_kill_nemesis_logs_the_reference_commands():
    def run(mod, op_cls):
        def fn(t):
            n = mod.kill_nemesis().setup(t)
            for f in ("start", "stop"):
                n.invoke(t, op_cls(type="info", f=f, value=None,
                                   process="nemesis", time=0))
        return fn
    both_logs(run(j_as, JOp), run(aerospike, Op))


#: with_errors' messages, each against a read, a write and a cas
AEROSPIKE_ERRORS = ["Error: (3) AEROSPIKE_ERR_RECORD_GENERATION "
                    "FAIL_GENERATION", "generation mismatch",
                    "record not found", "Error: NotFound", "forbidden op",
                    "Error: (9) AEROSPIKE_ERR_TIMEOUT: timeout",
                    "client timed out", "socket closed", ""]


@pytest.mark.parametrize("msg", AEROSPIKE_ERRORS)
def test_with_errors_is_the_references(msg):
    for f in ("read", "write", "cas"):
        a = aerospike.with_errors(Op(type="invoke", f=f, value=None,
                                     process=0, time=0), RuntimeError(msg))
        b = j_as.with_errors(JOp(type="invoke", f=f, value=None, process=0,
                                 time=0), RuntimeError(msg))
        assert (a.type, a.error) == (b.type, b.error), (f, msg)


#: register ops (f, key, value) and the fake's scripted reply before each
AEROSPIKE_OPS = [
    ("read", 0, None, None), ("cas", 0, (1, 2), None),
    ("write", 0, 3, None), ("read", 0, None, None),
    ("cas", 0, (3, 4), None), ("cas", 0, (3, 9), None),
    ("cas", 0, (4, 5), ("gen_equal", (1, "", "Error: (3) "
                                      "AEROSPIKE_ERR_RECORD_GENERATION "
                                      "FAIL_GENERATION"), 1)),
    ("write", 1, 7, ("INSERT", (1, "", fakes.TIMEOUTS["aerospike"]), 1)),
    ("read", 1, None, ("SELECT", (1, "", fakes.TIMEOUTS["aerospike"]), 1)),
    ("cas", 0, (4, 6), ("SELECT", (1, "", "Error: record not found"), 1)),
    ("write", 2, 1, ("INSERT", (1, "", "Error: forbidden"), 1)),
    ("read", 0, None, None), ("read", 2, None, None)]


def completions(mod, ctl, op_cls, client, ops, fake):
    t = dummy_map()
    t["_sessions"] = fake.sessions()
    c = client.open(t, "n2")
    out = []
    with ctl.session_pool(t):
        for i, (f, k, v, script) in enumerate(ops):
            if script:
                fake.script(*script)
            value = kv(mod, k, v) if k is not None else v
            r = c.invoke(t, op_cls(type="invoke", f=f, value=value,
                                   process=0, time=i))
            val = r.value
            if val is not None and not isinstance(val, (int, list, dict)):
                val = tuple(val)
            out.append((r.type, r.f, val, r.error))
    return out


def test_aerospike_cas_completions_are_the_references():
    ref = completions(j_as, j_control, JOp, j_as.CasRegisterClient(),
                      AEROSPIKE_OPS, fakes.CliFake(NODES))
    got = completions(aerospike, control, Op,
                      aerospike.CasRegisterClient(), AEROSPIKE_OPS,
                      fakes.CliFake(NODES))
    assert got == ref
    assert [(c[0], c[3]) for c in got] == [
        ("ok", None), ("fail", "not-found"), ("ok", None), ("ok", None),
        ("ok", None), ("fail", "value-mismatch"),
        ("fail", "generation-mismatch"), ("info", "timeout"),
        ("fail", "timeout"), ("fail", "not-found"), ("fail", "forbidden"),
        ("ok", None), ("ok", None)]
    assert got[3][2] == (0, 3) and got[11][2] == (0, 4)


def test_aerospike_counter_completions_are_the_references():
    ops = [("read", None, None, None), ("add", None, 1, None),
           ("add", None, 2, None),
           ("add", None, 5, ("EXECUTE", (1, "", "timeout"), 1)),
           ("read", None, None, None)]
    ref = completions(j_as, j_control, JOp, j_as.CounterClient(), ops,
                      fakes.CliFake(NODES))
    got = completions(aerospike, control, Op, aerospike.CounterClient(),
                      ops, fakes.CliFake(NODES))
    assert got == ref
    assert [c[2] for c in got] == [0, 1, 2, 5, 3]
    assert got[3][0] == "info"


# ---------------------------------------------------------------------------
# mongodb
# ---------------------------------------------------------------------------

def test_mongodb_lifecycle_logs_the_reference_commands():
    resp = responses("mongodb")
    for call in (lambda m, t: m.MongoDB().setup(t, "n2"),
                 lambda m, t: m.MongoDB().setup_primary(t, "n1"),
                 lambda m, t: m.MongoDB().teardown(t, "n3"),
                 lambda m, t: m.replica_set_reconfigure(
                     t, "n1", {"version": 3, "members": []}),
                 lambda m, t: m.TransferClient(3, 7).setup(t)):
        both_logs(lambda t: call(j_mongo, t), lambda t: call(mongodb, t),
                  resp)
    assert mongodb.MongoDB().log_files({}, "n1") == \
        j_mongo.MongoDB().log_files({}, "n1")


def test_mongodb_replica_set_helpers_are_the_references(monkeypatch):
    fake = fakes.CliFake(NODES, stale_reads=True)
    outs = []
    for ctl, mod in ((j_control, j_mongo), (control, mongodb)):
        t = dummy_map()
        t["_sessions"] = fake.sessions()
        with ctl.session_pool(t):
            outs.append((mod.replica_set_status(t, "n3"),
                         mod.replica_set_config(t, "n1"),
                         mod.primaries(t, NODES), mod.primary(t, "n4")))
            mod.await_join(t, "n2", NODES, timeout=5)
            mod.await_primary(t, "n2", timeout=5)
    assert outs[0] == outs[1]
    assert outs[1][2] == ["n1"] and outs[1][3] == "n1"
    monkeypatch.setattr("time.sleep", lambda s: None)
    for mod in (j_mongo, mongodb):
        monkeypatch.setattr(mod, "mongo_eval", lambda t, n, js: "{}")
        with pytest.raises(TimeoutError):
            mod.await_primary({}, "n1", timeout=0.05)
        with pytest.raises(TimeoutError):
            mod.await_join({}, "n1", NODES, timeout=0.05)


#: document-CAS ops (node, f, key, value) and the scripted reply before
#: each, against a primary (n1) and lagging secondaries
MONGO_OPS = [
    ("n1", "read", 0, None, None), ("n1", "cas", 0, (1, 2), None),
    ("n1", "write", 0, 3, None), ("n1", "read", 0, None, None),
    ("n1", "cas", 0, (3, 4), None), ("n1", "cas", 0, (3, 9), None),
    ("n2", "write", 0, 7, None), ("n2", "cas", 0, (4, 5), None),
    ("n2", "read", 0, None, None),
    ("n1", "write", 1, 2, ("update(", (1, "", fakes.TIMEOUTS["mongodb"]),
                           1)),
    ("n1", "read", 1, None, ("find(", (1, "", "socket closed"), 1)),
    ("n1", "cas", 0, (4, 8), ("findAndModify", (0, "not json", ""), 1)),
    ("n1", "read", 0, None, None)]


def mongo_completions(mod, ctl, op_cls, concern):
    fake = fakes.CliFake(NODES, stale_reads=True, delay_s=60)
    t = dummy_map()
    t["_sessions"] = fake.sessions()
    out = []
    with ctl.session_pool(t):
        clients = {n: mod.DocumentCASClient("majority", concern).open(t, n)
                   for n in ("n1", "n2")}
        for i, (node, f, k, v, script) in enumerate(MONGO_OPS):
            if script:
                fake.script(*script)
            r = clients[node].invoke(t, op_cls(
                type="invoke", f=f, value=kv(mod, k, v), process=0, time=i))
            val = tuple(r.value) if r.value is not None else None
            out.append((r.type, r.f, val, r.error))
    return out


@pytest.mark.parametrize("concern", mongodb.READ_CONCERNS)
def test_mongodb_cas_completions_are_the_references(concern):
    ref = mongo_completions(j_mongo, j_control, JOp, concern)
    got = mongo_completions(mongodb, control, Op, concern)
    assert got == ref
    # a secondary refuses writes and cas's with not master: a definite
    # failure
    assert got[6][:1] == got[7][:1] == ("fail",)
    assert got[6][3] == got[7][3] == "not-primary"
    if concern == "linearizable":
        assert got[8][3] == "not-primary"
    else:
        # the secondary's replica lags a minute: the key is missing there
        assert got[8][:3] == ("ok", "read", (0, None))
    assert got[9][0] == "info" and got[10][0] == "fail"
    assert got[11][0] == "info" and got[12][2] == (0, 4)


def test_mongodb_transfer_completions_are_the_references():
    ops = [(None, "read", None, None), (None, "transfer",
                                        {"from": 0, "to": 1, "amount": 4},
                                        None),
           (None, "transfer", {"from": 0, "to": 1, "amount": 9}, None),
           (None, "read", None, None),
           (None, "transfer", {"from": 1, "to": 0, "amount": 1},
            ("insertOne", (1, "", "timed out"), 1)),
           (None, "read", None, ("find()", (1, "", "timed out"), 1))]
    outs = []
    for mod, ctl, op_cls in ((j_mongo, j_control, JOp),
                             (mongodb, control, Op)):
        fake = fakes.CliFake(NODES)
        t = dummy_map()
        t["_sessions"] = fake.sessions()
        c = mod.TransferClient(2, 10).open(t, "n1")
        with ctl.session_pool(t):
            c.setup(t)
            out = []
            for i, (_, f, v, script) in enumerate(ops):
                if script:
                    fake.script(*script)
                r = c.invoke(t, op_cls(type="invoke", f=f, value=v,
                                       process=0, time=i))
                out.append((r.type, r.f, r.value, r.error))
            outs.append(out)
    assert outs[0] == outs[1]
    assert [o[0] for o in outs[1]] == ["ok", "ok", "fail", "ok", "info",
                                       "fail"]
    assert outs[1][3][2] == [6, 14]


ACCOUNT_STEPS = [("transfer", {"from": 0, "to": 1, "amount": 4}),
                 ("read", [6, 14]), ("read", None), ("read", (6, 14)),
                 ("transfer", {"from": 0, "to": 1, "amount": 100}),
                 ("read", [10, 10]), ("deposit", 3)]


def test_accounts_model_steps_as_the_references():
    m, jm = mongodb.AccountsModel((10, 10)), j_mongo.AccountsModel((10, 10))
    for f, v in ACCOUNT_STEPS:
        a = m.step(Op(type="ok", f=f, value=v, process=0, time=0))
        b = jm.step(JOp(type="ok", f=f, value=v, process=0, time=0))
        assert is_inconsistent(a) == j_is_inconsistent(b), (f, v)
        if is_inconsistent(a):
            assert a.msg == b.msg
        else:
            assert repr(a) == repr(b) and a == mongodb.AccountsModel(
                b.balances)
            assert hash(a) == hash(mongodb.AccountsModel(a.balances))
            m, jm = a, b


# ---------------------------------------------------------------------------
# end to end against the fake
# ---------------------------------------------------------------------------

def run_suite(tmp_path, suite, fake, **opts):
    test = suites.registry()[suite](dict(
        {"nodes": NODES, "concurrency": 10, "time-limit": 3,
         "device": "cpu", "store-root": str(tmp_path),
         "threads-per-key": 5, "ops-per-key": 40}, **opts))
    test["_sessions"] = fake.sessions()
    return core.run(test)


def analyze_verdicts(d):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(["analyze", "--store", d, "--device", "cpu"])
    text = buf.getvalue()
    again = json.loads(text[text.index("\n{") + 1:])
    return rc, {k: (r["valid"], r["levels"])
                for k, r in again["results"].items()}


def test_an_aerospike_run_with_crashed_ops_gives_the_references_verdicts(
        tmp_path):
    fake = fakes.CliFake(NODES, fakes.DUMMY_RESPONSES["aerospike"],
                         timeout_p=0.05, seed=2)
    out = run_suite(tmp_path, "aerospike", fake)
    assert out["results"]["valid"] is True
    crashed = [o for o in out["history"]
               if o.type == "info" and o.process != "nemesis"]
    assert crashed and all(o.error == "timeout" for o in crashed)
    res = reference_verdicts(out)
    assert all(r["backend"] == "gpu" and "fallback-from" not in r
               for r in res["results"].values())
    assert analyze_verdicts(out["store-dir"]) == (0, {
        str(k): (r["valid"], r["levels"])
        for k, r in res["results"].items()})


def test_mongodb_local_reads_from_lagging_secondaries_are_refuted(tmp_path):
    fake = fakes.CliFake(NODES, fakes.DUMMY_RESPONSES["mongodb"],
                         stale_reads=True, delay_s=0.2)
    out = run_suite(tmp_path, "mongodb", fake, **{"read-concern": "local"})
    res = reference_verdicts(out)
    assert out["results"]["valid"] is False and res["failures"]
    assert fake.stats["stale"] > 0
    rc, got = analyze_verdicts(out["store-dir"])
    assert rc == 1 and got == {str(k): (r["valid"], r["levels"])
                               for k, r in res["results"].items()}


def test_the_transfer_is_checked_on_the_host_as_the_reference(tmp_path):
    fake = fakes.CliFake(NODES, fakes.DUMMY_RESPONSES["mongodb"])
    out = run_suite(tmp_path, "mongodb-transfer", fake)
    lin = out["results"]["linear"]
    ref = j_linearizable(j_mongo.AccountsModel((10, 10)),
                         backend="cpu").check({}, to_reference(
                             out["history"]))
    assert lin["valid"] is ref["valid"] is True
    # no word kernel for AccountsModel: the host answers, labelled
    assert lin["fallback-from"] == "gpu" and lin["backend"] == "cpu"
    assert fake.stats["writes"] > 0
