"""The cockroachdb suite of the port, held against the reference on the CPU.

Under the dummy control plane the database's lifecycle (with and without
the packet capture), ``kill`` and ``start``, and each of the fourteen
named nemeses' setup, ``start``, ``stop`` and teardown (with the slowing
and restarting wrappers) log the reference's commands and give its
completions from the same seed; ``compose_nemeses``' generators draw the
reference's tagged ops, and ``nemesis_product`` and the command line's
composition pick the reference's pairs. The SQL taxonomy
(``classify_error``) and the register client's completions through the
command-line fake of ``tools/torch_suite_fakes.py`` (a transaction retry
that succeeds and one that does not, a reset connection, a timeout) are
the reference's, as are the other seven clients' command logs and
completions, the eight test maps, and ``CommentsChecker``. A small run of
the register under the small-skews nemesis, with seeded timeouts, records
crashed ops; the reference's independent checker and its keyed device
search on JAX's CPU find the port's per-key verdicts and levels on that
history, and ``analyze`` and ``recover`` re-check it key by key. Last,
the smoke's ``cas-suites`` phase (aerospike, this register under skews,
and mongodb against lagging secondaries) runs on the CPU at a small size.
"""

import io
import json
import os
import sys
from contextlib import redirect_stdout

import pytest
import torch

from jepsen_tpu import control as j_control
from jepsen_tpu import generator as jgen
from jepsen_tpu import independent as j_independent
from jepsen_tpu import net as j_net
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.suites import cockroachdb as j_cr

from jepsen_tpu_torch import control, core, independent, net, store
from jepsen_tpu_torch import generator as pgen
from jepsen_tpu_torch.__main__ import main
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.suites import cockroachdb as cr

from test_torch_clock import both_logs
from test_torch_generator import drain
from test_torch_suite_etcd import reference_verdicts
from test_torch_suite_substrate import dummy_map

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import torch_suite_fakes as fakes  # noqa: E402

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES = ["n1", "n2", "n3", "n4", "n5"]
RESPONSES = {k: tuple(v) if isinstance(v, list) else v
             for k, v in fakes.DUMMY_RESPONSES["cockroachdb"].items()}


# ---------------------------------------------------------------------------
# the database's lifecycle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tcpdump", [False, True])
def test_db_lifecycle_logs_the_reference_commands(tcpdump):
    responses = dict(RESPONSES, **{"SSH_CLIENT": "SSH_CLIENT=10.1.2.3 5 22"})
    for call in (lambda m, t: m.CockroachDB("v1.0", tcpdump).setup(t, "n2"),
                 lambda m, t: m.CockroachDB("v1.0", tcpdump).teardown(t,
                                                                     "n2"),
                 lambda m, t: m.kill(t, "n3"),
                 lambda m, t: m.start(t, "n4")):
        both_logs(lambda t: call(j_cr, t), lambda t: call(cr, t), responses)
    for version in ("v1.0", "v2.1.0"):
        db, ref = cr.CockroachDB(version, tcpdump), \
            j_cr.CockroachDB(version, tcpdump)
        assert db.tarball_url() == ref.tarball_url()
        assert db.log_files({}, "n1") == ref.log_files({}, "n1")


def test_control_addr_needs_ssh_client():
    for ctl, mod in ((j_control, j_cr), (control, cr)):
        t = dummy_map()
        with ctl.session_pool(t):
            with pytest.raises(ctl.RemoteError, match="no SSH_CLIENT"):
                mod.control_addr(t, "n1")


# ---------------------------------------------------------------------------
# the nemesis library
# ---------------------------------------------------------------------------

def nop(op_cls, f, value=None):
    return op_cls(type="info", f=f, value=value, process="nemesis", time=0)


def nemesis_logs(ctl, mod, net_ns, op_cls, make, seed):
    """A named nemesis's setup, start, stop and teardown under ``ctl``'s
    dummy control plane with an iptables ``net``: each node's log and the
    two completions."""
    import random
    t = dummy_map(RESPONSES, net=net_ns.iptables())
    random.seed(seed)
    outs = []
    with ctl.session_pool(t):
        n = make(mod)["client"]
        n = n.setup(t) or n
        for f in ("start", "stop"):
            r = n.invoke(t, nop(op_cls, f))
            outs.append((r.type, r.f, json.dumps(r.value, sort_keys=True,
                                                 default=repr)))
        n.teardown(t)
        return {k: list(s.log) for k, s in t["_sessions"].items()}, outs


def normalized(logs, res):
    return {n: [c.replace(res, "<resources>") for c in cmds]
            for n, cmds in logs.items()}


MAKERS = {name: (lambda m, name=name: m.NEMESES[name]())
          for name in sorted(j_cr.NEMESES)}
MAKERS["slow-parts"] = lambda m: m.slowing(m.parts(), 0.5)
MAKERS["restart-startkill"] = lambda m: m.restarting(m.startkill())


@pytest.mark.parametrize("name", sorted(MAKERS))
@pytest.mark.parametrize("seed", [0, 5])
def test_each_nemesis_logs_the_reference_commands(name, seed):
    from jepsen_tpu.nemesis import time as j_nt
    from jepsen_tpu_torch.nemesis import time as nt
    ref_logs, ref_outs = nemesis_logs(j_control, j_cr, j_net, JOp,
                                      MAKERS[name], seed)
    logs, outs = nemesis_logs(control, cr, net, Op, MAKERS[name], seed)
    assert normalized(logs, nt.RESOURCE_DIR) == \
        normalized(ref_logs, j_nt.RESOURCE_DIR)
    assert outs == ref_outs
    made, ref = MAKERS[name](cr), MAKERS[name](j_cr)
    assert (made["name"], made["clocks"]) == (ref["name"], ref["clocks"])
    if name.endswith("-skews") and name != "strobe-skews":
        verb = "adj-time" if name.startswith("gradual") else "bump-time"
        plan = json.loads(outs[0][2])
        for node in NODES:
            bumped = any(f"/opt/jepsen/{verb} " in c for c in logs[node])
            assert bumped is (node in plan), (node, plan)


def test_nemesis_product_is_the_references():
    names = sorted(j_cr.NEMESES)
    assert cr.nemesis_product(names, names) == \
        j_cr.nemesis_product(names, names)
    for c1, c2 in ((["small-skews"], ["none"]),
                   (["big-skews", "parts"], ["huge-skews", "majring"]),
                   (["none"], ["none"])):
        assert cr.nemesis_product(c1, c2) == j_cr.nemesis_product(c1, c2)


@pytest.mark.parametrize("n1s,n2s", [(["small-skews"], None),
                                     (["parts", "majring"],
                                      ["big-skews"]),
                                     (None, None),
                                     (["strobe-skews"], ["huge-skews"])])
def test_the_command_lines_composition_is_the_references(n1s, n2s,
                                                         monkeypatch):
    """``run --suite cockroachdb --nemesis ... --nemesis2 ...`` builds the
    test map the reference's ``main`` builds (its name and its keys)."""
    a, b = n1s or ["none"], n2s or ["none"]
    p1, p2 = (j_cr.nemesis_product(a, b) or [(a[0], b[0])])[0]
    want = j_cr.register_test({"nemesis": j_cr.compose_nemeses(
        [j_cr.NEMESES[p1](), j_cr.NEMESES[p2]() if p2 != p1 else None])})
    seen = []
    monkeypatch.setattr(core, "run", lambda t: seen.append(t) or dict(
        t, results={"valid": True}))
    argv = ["run", "--suite", "cockroachdb", "--device", "cpu"]
    for flag, names in (("--nemesis", n1s), ("--nemesis2", n2s)):
        for n in names or ():
            argv += [flag, n]
    assert main(argv) == 0
    assert seen[0]["name"] == want["name"]
    assert set(want) <= set(seen[0])


def test_compose_nemeses_draws_the_references_tagged_ops(monkeypatch):
    import random
    for mod in (cr, j_cr):
        monkeypatch.setattr(mod, "NEMESIS_DELAY", 0)
        monkeypatch.setattr(mod, "NEMESIS_DURATION", 0)
    draws = {}
    for key, mod, g_ns in (("ref", j_cr, jgen), ("port", cr, pgen)):
        random.seed(3)
        m = mod.compose_nemeses([mod.parts(), mod.small_skews(), None])
        assert m["name"] == "parts+small-skews" and m["clocks"] is True
        draws[key] = (drain(g_ns, m["during"], ["nemesis"], 12,
                            ("nemesis",)),
                      drain(g_ns, m["final"], ["nemesis"], 4,
                            ("nemesis",)))
    assert draws["port"] == draws["ref"]
    during, final = draws["port"]
    assert {o[1] for o in during if o} == {("parts", "start"),
                                           ("parts", "stop"),
                                           ("small-skews", "start"),
                                           ("small-skews", "stop")}
    assert [o[1] for o in final if o] == [("parts", "stop"),
                                          ("small-skews", "stop")]
    with pytest.raises(AssertionError, match="duplicate"):
        cr.compose_nemeses([cr.parts(), cr.parts()])


# ---------------------------------------------------------------------------
# the SQL data plane
# ---------------------------------------------------------------------------

MESSAGES = [("", "restart transaction: TransactionRetryError"),
            ("retry transaction", ""), ("", "connection reset by peer"),
            ("", "dial tcp: connection refused"), ("", "i/o timeout"),
            ("", "context deadline: timed out"), ("", "write: broken pipe"),
            ("unexpected EOF", ""), ("", "ERROR: duplicate key value"),
            ("", "")]


@pytest.mark.parametrize("out,err", MESSAGES)
def test_classify_error_is_the_references(out, err):
    a = cr.classify_error(control.RemoteError("n1", "c", 1, out, err))
    b = j_cr.classify_error(j_control.RemoteError("n1", "c", 1, out, err))
    assert (str(a), a.retryable, a.indeterminate) == \
        (str(b), b.retryable, b.indeterminate)


#: (f, key, value) ops on the register, and the fake's scripted replies
#: before each: a read of a missing key, writes, cas's that match and that
#: do not, a retry that succeeds, one that never does, a reset connection
#: on a write, a cas and a read, and a timeout
REGISTER_OPS = [
    ("read", 0, None, None), ("write", 0, 3, None), ("read", 0, None, None),
    ("cas", 0, (3, 4), None), ("cas", 0, (3, 9), None),
    ("cas", 0, (4, 5), ("UPDATE", (1, "", "restart transaction"), 2)),
    ("write", 1, 7, ("UPSERT", (1, "", "TransactionRetryError"), 3)),
    ("write", 1, 8, ("UPSERT", (1, "", "connection reset by peer"), 1)),
    ("cas", 0, (5, 6), ("UPDATE", (1, "", "connection reset by peer"), 1)),
    ("read", 0, None, ("SELECT", (1, "", "connection reset by peer"), 1)),
    ("write", 2, 1, ("UPSERT", (1, "", "i/o timeout"), 1)),
    ("read", 1, None, None), ("read", 0, None, None)]


def register_completions(mod, op_cls, ctl):
    fake = fakes.CliFake(NODES)
    t = dummy_map()
    t["_sessions"] = fake.sessions()
    c = mod.RegisterClient().open(t, "n2")
    out = []
    with ctl.session_pool(t):
        c.setup(t)
        for i, (f, k, v, script) in enumerate(REGISTER_OPS):
            if script:
                fake.script(*script)
            kv = (j_independent if mod is j_cr else independent).tuple_(k, v)
            r = c.invoke(t, op_cls(type="invoke", f=f, value=kv, process=0,
                                   time=i))
            val = tuple(r.value) if r.value is not None else None
            out.append((r.type, r.f, val, r.error))
    return out


def test_register_completions_are_the_references():
    ref = register_completions(j_cr, JOp, j_control)
    got = register_completions(cr, Op, control)
    assert got == ref
    assert [c[0] for c in got] == ["ok", "ok", "ok", "ok", "fail", "ok",
                                   "fail", "info", "info", "fail", "info",
                                   "ok", "ok"]
    assert got[0][2] == (0, None) and got[12][2] == (0, 5)
    assert "connection reset" in got[7][3]


#: the other clients: (name, constructor, ops (f, value), dummy replies)
OTHER_CLIENTS = [
    ("bank", lambda m: m.BankSQLClient(5, 10),
     [("read", None), ("transfer", {"from": 1, "to": 3, "amount": 4}),
      ("transfer", {"from": 2, "to": 2, "amount": 1})],
     {"SELECT balance": "balance\n10\n10\n10\n10\n10\n",
      "UPDATE accounts": "id\n1\n3\n"}),
    ("bank-overdraw", lambda m: m.BankSQLClient(5, 10),
     [("transfer", {"from": 1, "to": 3, "amount": 99})],
     {"UPDATE accounts": "id\n"}),
    ("sets", lambda m: m.SetsClient(), [("add", 4), ("read", None)],
     {"SELECT val": "val\n4\n1\n"}),
    ("comments", lambda m: m.CommentsClient(),
     [("write", ("kv", 0, 12)), ("read", ("kv", 0, None))],
     {"UNION ALL": "id\n12\n3\n"}),
    ("monotonic", lambda m: m.MonotonicSQLClient(),
     [("add", None), ("read", None)],
     {"RETURNING val": "val\n7\n",
      "ORDER BY sts": "val\tsts\tnode\tprocess\ttb\n0\t1.5\t1\t2\t0\n"}),
    ("sequential", lambda m: m.SequentialSQLClient(),
     [("write", 3), ("read", ("t", 3))], {"WHERE tkey": "tkey\n3_1\n"}),
    ("g2", lambda m: m.G2SQLClient(),
     [("insert", ("kv", 2, (5, None))), ("insert", ("kv", 2, (None, 6)))],
     {"INSERT INTO a": "id\n5\n"}),
    ("bank-multitable", lambda m: m.BankMultitableClient(3, 10),
     [("read", None), ("transfer", {"from": 0, "to": 2, "amount": 4}),
      ("transfer", {"from": 1, "to": 1, "amount": 2})],
     {"UNION ALL": "balance\n10\n10\n10\n", "WITH d AS": "id\n0\n"}),
]


def _value(mod, v):
    if isinstance(v, tuple) and v and v[0] == "kv":
        return (j_independent if mod is j_cr else independent).tuple_(*v[1:])
    if isinstance(v, tuple) and v and v[0] == "t":
        return tuple(v[1:])
    return v


def client_completions(mod, ctl, op_cls, make, ops, responses):
    t = dummy_map(responses)
    out = []
    with ctl.session_pool(t):
        c = make(mod).open(t, "n3")
        c.setup(t)
        for i, (f, v) in enumerate(ops):
            r = c.invoke(t, op_cls(type="invoke", f=f, value=_value(mod, v),
                                   process=1, time=i))
            out.append((r.type, r.f, json.dumps(r.value, default=list),
                        r.error))
        return out, {n: list(s.log) for n, s in t["_sessions"].items()}


@pytest.mark.parametrize("name,make,ops,responses", OTHER_CLIENTS,
                         ids=[c[0] for c in OTHER_CLIENTS])
def test_other_clients_are_the_references(name, make, ops, responses):
    ref = client_completions(j_cr, j_control, JOp, make, ops, responses)
    got = client_completions(cr, control, Op, make, ops, responses)
    assert got == ref
    assert any(got[1].values())
    if name == "bank-overdraw":
        assert got[0][0][0] == "fail"


@pytest.mark.parametrize("name", sorted(j_cr.TESTS))
def test_each_test_map_is_the_references(name):
    opts = {"time-limit": 7, "nodes": NODES, "concurrency": 10,
            "ssh": {"mode": "dummy"}, "store-root": "s", "key-count": 4}
    t, r = cr.TESTS[name](dict(opts)), j_cr.TESTS[name](dict(opts))
    assert set(t) == set(r)
    for k in ("name", "nodes", "concurrency", "ssh", "time-limit",
              "store-root"):
        assert t[k] == r[k], k
    assert set(t["checker"].checkers) == set(r["checker"].checkers)
    assert type(t["client"]).__name__ == type(r["client"]).__name__
    assert cr.WORKLOADS[name].__name__ == j_cr.TESTS[name].__name__
    if name == "register":
        lin = t["checker"].checkers["indep"].inner
        assert (lin.backend, lin.device) == ("gpu", None)
        lin = cr.register_test({"backend": "cpu", "device": "cpu"})[
            "checker"].checkers["indep"].inner
        assert (lin.backend, lin.device) == ("cpu", "cpu")


def test_the_comments_checker_is_the_references():
    import random
    rnd = random.Random(4)
    rows = []
    done = []
    for i in range(60):
        if rnd.random() < 0.5:
            rows.append(("invoke", "write", i))
            if rnd.random() < 0.8:
                rows.append(("ok", "write", i))
                done.append(i)
        else:
            seen = sorted(rnd.sample(done, min(len(done), rnd.randint(0, 4))))
            rows.append(("invoke", "read", None))
            rows.append(("ok", "read", seen))
    outs = []
    for mod, op_cls, h_cls in ((j_cr, JOp, JHistory), (cr, Op, History)):
        h = h_cls(op_cls(type=ty, f=f, value=v, process=i % 3, time=i)
                  for i, (ty, f, v) in enumerate(rows))
        outs.append(mod.comments_checker().check({}, h))
    assert outs[0] == outs[1]
    assert outs[1]["valid"] is False


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def test_the_run_options_of_other_suites_exit_254(tmp_path):
    base = ["run", "--device", "cpu", "--store-root", str(tmp_path)]
    for suite, flags in (("etcd", ["--nemesis", "parts"]),
                         ("aerospike", ["--nemesis2", "small-skews"]),
                         ("cockroachdb", ["--workload", "counter"]),
                         ("cockroachdb", ["--nemesis", "warp"]),
                         ("cockroachdb-bank", ["--read-concern", "local"])):
        assert main(base + ["--suite", suite, *flags]) == 254, (suite, flags)
    assert not tmp_path.exists() or not os.listdir(tmp_path)


def test_workload_picks_the_modules_test(monkeypatch):
    seen = []
    monkeypatch.setattr(core, "run", lambda t: seen.append(t) or dict(
        t, results={"valid": True}))
    for workload in sorted(j_cr.TESTS):
        assert main(["run", "--suite", "cockroachdb", "--device", "cpu",
                     "--workload", workload, "--nemesis",
                     "parts"]) == 0
        assert seen[-1]["name"] == f"cockroachdb-{workload}:parts+blank"


# ---------------------------------------------------------------------------
# end to end against the fake, with crashed ops and clock skews
# ---------------------------------------------------------------------------

def test_a_skewed_run_with_crashed_ops_gives_the_references_verdicts(
        tmp_path, monkeypatch):
    # the skew's sleep/start/sleep/stop cycle at a second apiece
    monkeypatch.setattr(cr, "NEMESIS_DELAY", 1)
    monkeypatch.setattr(cr, "NEMESIS_DURATION", 1)
    fake = fakes.CliFake(NODES, fakes.DUMMY_RESPONSES["cockroachdb"],
                         timeout_p=0.05, seed=3)
    test = cr.register_test({
        "nodes": NODES, "concurrency": 10, "time-limit": 3, "device": "cpu",
        "recovery-time": 0.5, "store-root": str(tmp_path),
        "threads-per-key": 5, "ops-per-key": 40,
        "nemesis": cr.named_nemesis(["small-skews"], None)})
    sessions = test["_sessions"] = fake.sessions()
    out = core.run(test)
    assert out["results"]["valid"] is True
    crashed = [o for o in out["history"]
               if o.type == "info" and o.process != "nemesis"]
    assert crashed and fake.stats["timeouts"] == len(crashed)
    assert all("connection reset" in o.error for o in crashed)
    res = reference_verdicts(out)
    assert len(res["results"]) >= 2
    # the skews: the helper built on every node, each start's plan bumped
    plans = [o.value for o in out["history"] if o.process == "nemesis"
             and o.f == ("small-skews", "start") and o.type == "info"
             and isinstance(o.value, dict)]
    assert plans
    for node, s in sessions.items():
        assert any("g++ -O2 -o bump-time" in c for c in s.log)
        for plan in plans:
            if node in plan:
                assert any(f"/opt/jepsen/bump-time {plan[node]}" in c
                           for c in s.log)
    # the store keeps the [k v] values; analyze and recover re-check them
    # key by key to the run's verdicts
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


# ---------------------------------------------------------------------------
# the smoke's phase
# ---------------------------------------------------------------------------

def test_the_smoke_cas_suites_phase_runs_on_the_cpu(monkeypatch):
    sys.path.insert(0, ROOT)
    import chip_smoke
    # the skew's sleep/start/sleep/stop cycle at a second apiece
    monkeypatch.setattr(cr, "NEMESIS_DELAY", 1)
    monkeypatch.setattr(cr, "NEMESIS_DURATION", 1)
    seconds = {}
    line, launches, grid, segs = chip_smoke.cas_suites_phase(
        torch.device("cpu"), seconds, "cpu", dict(
            chip_smoke.CAS_RUN, aerospike_workers=20, aerospike_seconds=3,
            cockroach_workers=10, cockroach_seconds=3, mongo_workers=10,
            mongo_seconds=3, delay_s=0.3,
            cockroach_opts={"recovery-time": 0.5}))
    assert set(line) == {"card", "aerospike", "cockroachdb",
                         "mongodb linearizable", "mongodb local"}
    for tag in ("aerospike", "cockroachdb"):
        assert line[tag]["valid"] is True and line[tag]["crashed"] > 0
        assert any(ln.startswith("# plan:") for ln in line[tag]["analyze"])
    assert line["cockroachdb"]["skews"]
    assert line["mongodb linearizable"]["valid"] is True
    assert line["mongodb local"]["failures"]
    # the plain versions launch no kernel
    assert set(launches.values()) == {0} and segs["launches"] == 0
    assert seconds["cas-suites"] > 0
