"""The rabbitmq and hazelcast suites of the port, held against the
reference on the CPU.

Each database's ``setup``, ``teardown`` and ``log_files`` log the
reference's commands under the dummy control plane. The rabbitmq queue
and semaphore clients give the reference's completions against the
reference tests' management-API fake, and the drain writes the same
dequeue pairs; the hazelcast shim clients give the reference's
completions against the reference tests' shim fake and the shim fake of
``tools/torch_suite_fakes.py``, ``FAIL`` and a down shim included. Every
workload bundle builds as the reference's, and ``--workload`` selects
it. Small runs: the hazelcast lock is valid, and the reference's checker
and its device search find the same verdict and levels on the port's
recorded history; a rabbitmq queue drained at the end passes
``total_queue``, as the reference's checker finds too. The Java shim's
source lies inside the port.
"""

import os
import sys
import threading
from http.server import ThreadingHTTPServer

import pytest
import torch

from jepsen_tpu.checker import total_queue as j_total_queue
from jepsen_tpu.checker.tpu import check_history_tpu
from jepsen_tpu.checker.wgl import linearizable as j_linearizable
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.models import Mutex as JMutex
from jepsen_tpu.suites import hazelcast as j_hazelcast
from jepsen_tpu.suites import rabbitmq as j_rabbitmq

from jepsen_tpu_torch import core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.__main__ import main
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.suites import hazelcast, rabbitmq

from test_suite_mq import FakeRabbitHandler, FakeShim
from test_torch_suite_kv import run_ops, to_reference
from test_torch_suite_substrate import both_logs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import torch_suite_fakes as fakes  # noqa: E402

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

DB_CASES = {
    "rabbitmq": (j_rabbitmq.RabbitDB, rabbitmq.RabbitDB,
                 {"dpkg --get-selections": ""}, {}),
    "hazelcast": (j_hazelcast.HazelcastDB, hazelcast.HazelcastDB, {},
                  {"shim-jar": "/tmp/shim.jar"}),
}


@pytest.mark.parametrize("node", ["n1", "n4"])
@pytest.mark.parametrize("name", sorted(DB_CASES))
def test_db_lifecycle_logs_the_reference_commands(name, node):
    ref, port, responses, over = DB_CASES[name]
    both_logs(lambda t: ref().setup(t, node),
              lambda t: port().setup(t, node), responses, **over)
    both_logs(lambda t: ref().teardown(t, node),
              lambda t: port().teardown(t, node))
    assert port().log_files({}, node) == ref().log_files({}, node)


# ---------------------------------------------------------------------------
# rabbitmq
# ---------------------------------------------------------------------------

def rabbit_fake(drop=False):
    FakeRabbitHandler.queues = {}
    FakeRabbitHandler.drop_publishes = drop
    s = ThreadingHTTPServer(("127.0.0.1", 0), FakeRabbitHandler)
    threading.Thread(target=s.serve_forever, daemon=True).start()
    return f"127.0.0.1:{s.server_port}", s


@pytest.mark.parametrize("drop", [False, True])
def test_rabbitmq_queue_completions_equal_the_reference(drop):
    out = []
    for mod, o, h in ((j_rabbitmq, JOp, JHistory),
                      (rabbitmq, Op, History)):
        node, s = rabbit_fake(drop)
        try:
            c = mod.QueueClient().open({}, node)
            got = run_ops(c, o, [("enqueue", 41), ("enqueue", {"a": [1]}),
                                 ("dequeue", None), ("enqueue", "x")])
            hist = h()
            test = {"_history_lock": threading.Lock(),
                    "_active_histories": [hist], "start-time": 0}
            got += run_ops(c, o, [("drain", None), ("dequeue", None)], test)
            got.append([(x.type, x.f, x.value) for x in hist])
            out.append(got)
        finally:
            s.shutdown()
    assert out[0] == out[1]
    if not drop:
        assert out[1][2][:3] == ("ok", "dequeue", 41)


def test_rabbitmq_semaphore_completions_equal_the_reference():
    out = []
    for mod, o in ((j_rabbitmq, JOp), (rabbitmq, Op)):
        node, s = rabbit_fake()
        try:
            test = {"nodes": [node]}
            a = mod.SemaphoreClient().open(test, node)
            b = mod.SemaphoreClient().open(test, node)
            got = []
            for c, f in ((a, "acquire"), (b, "acquire"), (a, "acquire"),
                         (b, "release"), (a, "release"), (b, "acquire"),
                         (a, "release")):
                got += run_ops(c, o, [(f, None)])
            out.append(got)
        finally:
            s.shutdown()
    assert out[0] == out[1]
    assert [t for t, *_ in out[1]] == ["ok", "fail", "fail", "fail", "ok",
                                       "ok", "fail"]


def test_rabbitmq_down_broker_equals_the_reference():
    out = []
    for mod, o in ((j_rabbitmq, JOp), (rabbitmq, Op)):
        q = mod.QueueClient(timeout=0.3).open({}, "127.0.0.1:1")
        m = mod.SemaphoreClient(timeout=0.3).open({}, "127.0.0.1:1")
        out.append(run_ops(q, o, [("enqueue", 1), ("dequeue", None)])
                   + run_ops(m, o, [("acquire", None), ("release", None)]))
    assert out[0] == out[1]


def test_rabbitmq_test_maps_match_the_reference():
    for ref_ctor, ctor in ((j_rabbitmq.rabbitmq_test,
                            rabbitmq.rabbitmq_test),
                           (j_rabbitmq.mutex_test, rabbitmq.mutex_test)):
        opts = {"time-limit": 5, "nodes": ["a", "b"], "concurrency": 4}
        t, r = ctor(dict(opts)), ref_ctor(dict(opts))
        assert set(t) == set(r) and t["name"] == r["name"]
        assert repr(t["model"]) == repr(r["model"])
        assert set(t["checker"].checkers) == set(r["checker"].checkers)
        for k in ("db", "client", "nemesis", "os"):
            assert type(t[k]).__name__ == type(r[k]).__name__, k
    lin = rabbitmq.mutex_test({})["checker"].checkers["linear"]
    assert (lin.backend, lin.device) == ("gpu", None)


def test_rabbitmq_queue_run_drains_and_the_reference_agrees(tmp_path):
    node, s = rabbit_fake()
    try:
        out = core.run(rabbitmq.rabbitmq_test(
            {"time-limit": 1, "nodes": [node] * 2, "concurrency": 2,
             "store-root": str(tmp_path), "ssh": {"mode": "dummy"}}))
    finally:
        s.shutdown()
    res = out["results"]["queue"]
    assert out["results"]["valid"] is True and res["valid"] is True
    drains = [o for o in out["history"] if o.f == "drain" and o.is_ok]
    assert len(drains) == 2 and res["ok-count"] > 0
    ref = j_total_queue().check({}, to_reference(out["history"]))
    assert ref == res


# ---------------------------------------------------------------------------
# hazelcast
# ---------------------------------------------------------------------------

def ref_shim():
    s = FakeShim()
    threading.Thread(target=s.serve_forever, daemon=True).start()
    return f"127.0.0.1:{s.server_address[1]}", s.shutdown


def tools_shim():
    f = fakes.ShimFake(1)
    return f.start()[0], f.stop


SHIM_OPS = {
    "LockClient": [("acquire", None), ("release", None), ("release", None),
                   ("acquire", None)],
    "IdClient": [("generate", None)] * 3,
    "RefIdClient": [("generate", None)] * 2,
    "GenIdClient": [("generate", None)] * 2,
    "MapClient": [("read", None), ("add", 3), ("add", 1), ("add", 2),
                  ("read", None)],
    "HZQueueClient": [("enqueue", 5), ("enqueue", 6), ("dequeue", None),
                      ("drain", None), ("dequeue", None)],
}


@pytest.mark.parametrize("server", [ref_shim, tools_shim])
@pytest.mark.parametrize("cls", sorted(SHIM_OPS))
def test_shim_clients_equal_the_reference(cls, server):
    out = []
    for mod, o in ((j_hazelcast, JOp), (hazelcast, Op)):
        node, stop = server()
        try:
            c = getattr(mod, cls)().open({}, node)
            out.append(run_ops(c, o, SHIM_OPS[cls]))
            c.close({})
        finally:
            stop()
    assert out[0] == out[1]


def test_the_lock_is_held_by_one_connection():
    node, stop = tools_shim()
    try:
        a = hazelcast.LockClient().open({}, node)
        b = hazelcast.LockClient().open({}, node)
        got = [r[0] for c, f in ((a, "acquire"), (b, "acquire"),
                                 (b, "release"), (a, "release"),
                                 (b, "acquire"))
               for r in run_ops(c, Op, [(f, None)])]
    finally:
        stop()
    assert got == ["ok", "fail", "fail", "ok", "ok"]


def test_a_down_shim_crashes_as_in_the_reference():
    out = []
    for mod, o in ((j_hazelcast, JOp), (hazelcast, Op)):
        out.append([run_ops(getattr(mod, cls)(timeout=0.3).open(
            {}, "127.0.0.1:1"), o, SHIM_OPS[cls][:1]) for cls in SHIM_OPS])
    assert out[0] == out[1]


WORKLOADS = ("atomic-long-ids", "atomic-ref-ids", "crdt-map", "id-gen-ids",
             "lock", "map", "queue")


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_bundles_match_the_reference(name, capsys):
    port, ref = hazelcast.workloads(), j_hazelcast.workloads()
    assert sorted(port) == sorted(ref) == list(WORKLOADS)
    assert set(port[name]) == set(ref[name])
    assert type(port[name]["client"]).__name__ == \
        type(ref[name]["client"]).__name__
    assert type(port[name]["checker"]).__name__ == \
        type(ref[name]["checker"]).__name__
    t = hazelcast.hazelcast_test({"workload": name, "time-limit": 3})
    r = j_hazelcast.hazelcast_test({"workload": name, "time-limit": 3})
    assert set(t) == set(r) and t["name"] == r["name"] == \
        f"hazelcast-{name}"
    assert type(t["nemesis"]).__name__ == type(r["nemesis"]).__name__
    assert repr(t["model"]) == repr(r["model"])
    if name == "lock":
        lin = t["checker"].checkers["workload"]
        assert (lin.backend, lin.device) == ("gpu", None)
    # run --workload takes each bundle (a host without CUDA refuses the
    # card's check before any work: 255) and refuses an unknown one
    if not torch.cuda.is_available():
        assert main(["run", "--suite", "hazelcast", "--workload", name,
                     "--time-limit", "1"]) == 255
        assert "CUDA" in capsys.readouterr().err
    assert main(["run", "--suite", "hazelcast", "--workload",
                 "bogus"]) == 254


def test_the_shim_source_lies_inside_the_port():
    src = hazelcast.SHIM_SOURCE
    pkg = os.path.join(ROOT, "jepsen_tpu_torch") + os.sep
    assert os.path.realpath(src).startswith(pkg) and os.path.isfile(src)
    with open(src) as f:
        port_lines = f.read().splitlines()
    with open(os.path.join(ROOT, "jepsen_tpu", "suites", "resources",
                           "HazelcastShim.java")) as f:
        ref_lines = f.read().splitlines()
    # the same program; only the comment naming its Python client differs
    assert len(port_lines) == len(ref_lines)
    differ = [a for a, b in zip(port_lines, ref_lines) if a != b]
    assert differ == ["// framework's line protocol (see "
                      "jepsen_tpu_torch/suites/hazelcast.py docstring)."]


def test_the_lock_run_is_valid_and_the_reference_agrees(tmp_path):
    f = fakes.ShimFake(3)
    nodes = f.start()
    try:
        test = hazelcast.hazelcast_test(
            {"workload": "lock", "time-limit": 1, "nodes": nodes,
             "concurrency": 3, "device": "cpu",
             "store-root": str(tmp_path), "ssh": {"mode": "dummy"}})
        # the clients' schedule alone: the nemesis's first fault is 15 s in
        test["generator"] = gen.time_limit(1, gen.clients(
            hazelcast.workloads()["lock"]["generator"]))
        out = core.run(test)
    finally:
        f.stop()
    lin = out["results"]["workload"]
    assert out["results"]["valid"] is True and lin["valid"] is True
    assert lin["backend"] == "gpu" and "fallback-from" not in lin
    jh = to_reference(out["history"])
    assert j_linearizable(JMutex(), backend="cpu").check({}, jh)[
        "valid"] is True
    dev = check_history_tpu(jh, JMutex())
    assert (dev["valid"], dev["levels"]) == (True, lin["levels"])
    assert sum(1 for o in out["history"] if o.is_ok) > 10
