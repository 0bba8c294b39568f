"""The consul, zookeeper, raftis and disque suites of the port, held
against the reference on the CPU.

Each database's ``setup``, ``teardown`` and ``log_files`` log the
reference's commands under the dummy control plane. Each wire client
gives the reference's completions for the same op sequence against a
fresh fake (the reference tests' HTTP consul and RESP servers; zkCli's
replies scripted through ``dummy-responses``), a down node included; the
disque drain writes the reference's dequeue pairs into the live history.
Small runs of consul and raftis (``device="cpu"``) are valid, and the
reference's checker and its device search on JAX's CPU find the same
verdict and levels on the port's recorded history.
"""

import threading
from http.server import ThreadingHTTPServer

import pytest
import torch

from jepsen_tpu import control as j_control
from jepsen_tpu.checker.tpu import check_history_tpu
from jepsen_tpu.checker.wgl import linearizable as j_linearizable
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.models import CASRegister as JCASRegister
from jepsen_tpu.suites import consul as j_consul
from jepsen_tpu.suites import disque as j_disque
from jepsen_tpu.suites import raftis as j_raftis
from jepsen_tpu.suites import zookeeper as j_zookeeper

from jepsen_tpu_torch import control, core
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.suites import consul, disque, raftis, zookeeper

from test_suite_kv import FakeConsulHandler, FakeRespServer
from test_torch_suite_substrate import both_logs, dummy_map

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ARCHIVE = {"stat ": (1, "", "no such file"), "ls -A": "pkg-1.0",
           "dirname": "/opt"}

PAIRS = {"consul": (j_consul.ConsulDB, consul.ConsulDB),
         "zookeeper": (j_zookeeper.ZKDB, zookeeper.ZKDB),
         "raftis": (j_raftis.RaftisDB, raftis.RaftisDB),
         "disque": (j_disque.DisqueDB, disque.DisqueDB)}
#: the scripted replies each database's setup needs to run to its start
SETUP_RESPONSES = {"consul": ARCHIVE, "raftis": ARCHIVE, "disque": ARCHIVE,
                   "zookeeper": {"apt-cache policy": "Installed: 3.4.0\n"}}


@pytest.mark.parametrize("node", ["n1", "n3"])
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_db_setup_logs_the_reference_commands(name, node):
    ref, port = PAIRS[name]
    got = both_logs(lambda t: ref().setup(t, node),
                    lambda t: port().setup(t, node), SETUP_RESPONSES[name])
    assert got[node]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_db_teardown_and_log_files_are_the_reference_ones(name):
    ref, port = PAIRS[name]
    both_logs(lambda t: ref().teardown(t, "n2"),
              lambda t: port().teardown(t, "n2"))
    assert port().log_files({}, "n4") == ref().log_files({}, "n4")
    t = {"nodes": ["a", "b", "c"]}
    assert zookeeper.zoo_cfg_servers(t) == j_zookeeper.zoo_cfg_servers(t)
    assert raftis.initial_cluster(t) == j_raftis.initial_cluster(t)
    for n in ("a", "a:1"):
        assert consul.kv_url(n) == j_consul.kv_url(n)
        assert disque._addr(n) == j_disque._addr(n)


def test_disque_killer_logs_the_reference_commands():
    def drive(nem, o):
        def go(t):
            k = nem.killer()
            for f in ("start", "stop"):
                k.invoke(t, o(type="info", f=f, value=None,
                              process="nemesis", time=0))
        return go
    both_logs(drive(j_disque, JOp), drive(disque, Op))


# ---------------------------------------------------------------------------
# wire clients
# ---------------------------------------------------------------------------

def run_ops(client, op_cls, ops, test=None):
    out = []
    for i, (f, v) in enumerate(ops):
        r = client.invoke(test if test is not None else {},
                          op_cls(type="invoke", f=f, value=v, process=0,
                                 time=i))
        out.append((r.type, r.f, r.value, r.error))
    return out


def consul_fake():
    FakeConsulHandler.store = {}
    FakeConsulHandler.index = [1]
    s = ThreadingHTTPServer(("127.0.0.1", 0), FakeConsulHandler)
    threading.Thread(target=s.serve_forever, daemon=True).start()
    return f"127.0.0.1:{s.server_port}", s


def resp_fake():
    s = FakeRespServer()
    threading.Thread(target=s.serve_forever, daemon=True).start()
    return f"127.0.0.1:{s.server_address[1]}", s


REGISTER_OPS = [("read", None), ("write", 3), ("read", None),
                ("cas", (3, 5)), ("cas", (3, 9)), ("read", None),
                ("write", 0), ("cas", (0, 1))]


@pytest.mark.parametrize("setup", [False, True])
def test_consul_completions_equal_the_reference(setup):
    out = []
    for mod, o in ((j_consul, JOp), (consul, Op)):
        node, s = consul_fake()
        try:
            c = mod.ConsulClient().open({}, node)
            if setup:
                c.setup({"nodes": [node]})
            out.append(run_ops(c, o, REGISTER_OPS))
        finally:
            s.shutdown()
    assert out[0] == out[1]
    assert out[1][0][0] == ("ok" if setup else "fail")


def test_raftis_completions_equal_the_reference():
    out = []
    for mod, o in ((j_raftis, JOp), (raftis, Op)):
        node, s = resp_fake()
        try:
            c = mod.RaftisClient().open({}, node)
            out.append(run_ops(c, o, REGISTER_OPS))
            c.close({})
        finally:
            s.shutdown()
    assert out[0] == out[1]
    assert [t for t, *_ in out[1]] == ["ok", "ok", "ok", "ok", "fail",
                                       "ok", "ok", "ok"]


CLIENTS = {"consul": (j_consul, consul, "ConsulClient"),
           "raftis": (j_raftis, raftis, "RaftisClient"),
           "disque": (j_disque, disque, "DisqueClient")}


@pytest.mark.parametrize("name", sorted(CLIENTS))
def test_a_down_node_crashes_as_in_the_reference(name):
    ops = {"disque": [("enqueue", 1), ("dequeue", None)]}.get(
        name, [("read", None), ("write", 1), ("cas", (1, 2))])
    ref_mod, port_mod, cls = CLIENTS[name]
    out = []
    for mod, o in ((ref_mod, JOp), (port_mod, Op)):
        c = getattr(mod, cls)(timeout=0.3).open({}, "127.0.0.1:1")
        out.append(run_ops(c, o, ops))
    assert out[0] == out[1]
    assert all(t in ("fail", "info") for t, *_ in out[1])


def test_disque_completions_and_drain_equal_the_reference():
    out = []
    for mod, o, h in ((j_disque, JOp, JHistory), (disque, Op, History)):
        node, s = resp_fake()
        try:
            c = mod.DisqueClient().open({}, node)
            got = run_ops(c, o, [("enqueue", {"a": 1}), ("enqueue", 2),
                                 ("dequeue", None), ("enqueue", [3]),
                                 ("enqueue", "x")])
            hist = h()
            test = {"_history_lock": threading.Lock(),
                    "_active_histories": [hist], "start-time": 0}
            got += run_ops(c, o, [("drain", None), ("dequeue", None)], test)
            got.append([(x.type, x.f, x.value, x.process) for x in hist])
            out.append(got)
        finally:
            s.shutdown()
    assert out[0] == out[1]
    assert out[1][-1] == [("invoke", "dequeue", None, 0),
                          ("ok", "dequeue", 2, 0),
                          ("invoke", "dequeue", None, 0),
                          ("ok", "dequeue", [3], 0),
                          ("invoke", "dequeue", None, 0),
                          ("ok", "dequeue", "x", 0),
                          ("invoke", "dequeue", None, 0),
                          ("fail", "dequeue", None, 0)]


ZK_GET = """Connecting to n1:2181
WATCHER::
4
cZxid = 0x100
dataVersion = 7
numChildren = 0
"""
ZK_CASES = {
    "read write cas": ({"get /jepsen": ZK_GET},
                       [("read", None), ("write", 2), ("cas", (4, 9)),
                        ("cas", (5, 9))]),
    "no node": ({"get /jepsen": "Node does not exist: /jepsen"},
                [("read", None), ("cas", (4, 9))]),
    "refused set": ({"get /jepsen": ZK_GET, "set /jepsen": (1, "", "bad")},
                    [("write", 2), ("cas", (4, 9))]),
    "down": ({"zkCli": (1, "", "Connection refused")},
             [("read", None), ("write", 2)]),
}


@pytest.mark.parametrize("case", sorted(ZK_CASES))
def test_zookeeper_client_equals_the_reference(case):
    """zkCli runs over the control plane: the same scripted replies give
    the same completions and the same command log."""
    responses, ops = ZK_CASES[case]
    out = []
    for ctl, mod, o in ((j_control, j_zookeeper, JOp),
                        (control, zookeeper, Op)):
        t = dummy_map(responses)
        with ctl.session_pool(t):
            c = mod.ZKClient().open(t, "n1")
            c.setup(t)
            got = run_ops(c, o, ops, t)
            out.append((got, {n: list(s.log)
                              for n, s in t["_sessions"].items()}))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the test maps, and small runs
# ---------------------------------------------------------------------------

CTORS = {"consul": (j_consul.consul_test, consul.consul_test),
         "zookeeper": (j_zookeeper.zk_test, zookeeper.zk_test),
         "raftis": (j_raftis.raftis_test, raftis.raftis_test),
         "disque": (j_disque.disque_test, disque.disque_test)}


@pytest.mark.parametrize("name", sorted(CTORS))
def test_test_maps_match_the_reference(name):
    ref_ctor, port_ctor = CTORS[name]
    opts = {"time-limit": 9, "nodes": ["a", "b", "c"], "concurrency": 6,
            "store-root": "s"}
    t, r = port_ctor(dict(opts)), ref_ctor(dict(opts))
    assert set(t) == set(r)
    for k in ("name", "nodes", "concurrency", "time-limit", "store-root"):
        assert t[k] == r[k], k
    assert repr(t["model"]) == repr(r["model"])
    for k in ("db", "client", "nemesis", "os"):
        assert type(t[k]).__name__ == type(r[k]).__name__, k
    assert set(t["checker"].checkers) == set(r["checker"].checkers)
    lin = t["checker"].checkers.get("linear")
    if lin is not None:
        assert (lin.backend, lin.device) == ("gpu", None)
        lin = port_ctor({"backend": "cpu", "device": "cpu"})[
            "checker"].checkers["linear"]
        assert (lin.backend, lin.device) == ("cpu", "cpu")


def to_reference(history):
    return JHistory(JOp(o.type, o.f, o.value, o.process, o.time, o.index,
                        o.error) for o in history)


@pytest.mark.parametrize("name", ["consul", "raftis"])
def test_small_run_is_valid_and_the_reference_agrees(name, tmp_path):
    fake = consul_fake if name == "consul" else resp_fake
    node, s = fake()
    try:
        ctor = CTORS[name][1]
        test = ctor({"time-limit": 2, "device": "cpu", "nodes": [node] * 3,
                     "concurrency": 3, "store-root": str(tmp_path)})
        test.update(db=None, nemesis=None)
        if name == "raftis":
            from jepsen_tpu_torch import generator as gen
            test["generator"] = gen.time_limit(2, gen.clients(
                gen.stagger(1 / 50, raftis.r_w_gen())))
        out = core.run(test)
    finally:
        s.shutdown()
    lin = out["results"]["linear"]
    assert out["results"]["valid"] is True and lin["valid"] is True
    assert lin["backend"] == "gpu" and "fallback-from" not in lin
    jh = to_reference(out["history"])
    model = JCASRegister(None if name == "consul" else 0)
    assert j_linearizable(model, backend="cpu").check({}, jh)["valid"] \
        is True
    dev = check_history_tpu(jh, model)
    assert (dev["valid"], dev["levels"]) == (True, lin["levels"])
    assert sum(1 for o in out["history"] if o.is_ok) > 10
