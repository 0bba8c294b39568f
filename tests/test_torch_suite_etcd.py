"""The etcd suite of the port, held against the reference on the CPU.

The database's lifecycle logs the reference's commands under the dummy
control plane; the v2-keys client gives the reference's completions
against a fresh fake (the reference tests' ``FakeEtcdHandler`` and the
five-member fake of ``tools/torch_suite_fakes.py``), refused connections,
404, 412 and 500 included. A small run of the suite (2 threads and 30 ops
a key, 3 s) against the five members is valid, and the reference's
independent checker and its keyed device search on JAX's CPU find the
same per-key verdicts (and levels) on the port's recorded history; a run
against the fake's lagging replicas is refuted on the same keys by both.
The store and the WAL keep the ``[k v]`` values, so ``analyze``, and
``recover`` of the run marked dead, re-check it key by key to the run's
verdicts. Below ten workers the suite fails as
the reference's does, and the nemesis cuts no link without a ``net``.
"""

import io
import json
import os
import sys
import threading
from contextlib import redirect_stdout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from jepsen_tpu import control as j_control
from jepsen_tpu import independent as j_independent
from jepsen_tpu import nemesis as j_nemesis
from jepsen_tpu.checker.tpu import check_keyed_tpu
from jepsen_tpu.checker.wgl import linearizable as j_linearizable
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.models import CASRegister as JCASRegister
from jepsen_tpu.suites import etcd as j_etcd

from jepsen_tpu_torch import control, core, independent, nemesis, store
from jepsen_tpu_torch.__main__ import main
from jepsen_tpu_torch.history import KV, History, Op
from jepsen_tpu_torch.suites import etcd

from test_suite_etcd import FakeEtcdHandler
from test_torch_suite_substrate import both_logs, dummy_map

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import torch_suite_fakes as fakes  # noqa: E402

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

RESPONSES = {k: tuple(v) if isinstance(v, list) else v
             for k, v in fakes.DUMMY_RESPONSES["etcd"].items()}
SMALL = {"time-limit": 3, "threads-per-key": 2, "ops-per-key": 30}


# ---------------------------------------------------------------------------
# the database's lifecycle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over", [{}, {"tarball": "file:///tmp/etcd.tgz"}],
                         ids=["download", "local tarball"])
def test_db_setup_logs_the_reference_commands(over):
    got = both_logs(lambda t: j_etcd.EtcdDB().setup(t, "n2"),
                    lambda t: etcd.EtcdDB().setup(t, "n2"), RESPONSES,
                    **over)
    start = next(c for c in got["n2"] if "start-stop-daemon" in c)
    assert "--initial-cluster n1=http://n1:2380,n2=http://n2:2380" in start


def test_db_teardown_and_log_files_are_the_reference_ones():
    both_logs(lambda t: j_etcd.EtcdDB("v3.0.0").teardown(t, "n1"),
              lambda t: etcd.EtcdDB("v3.0.0").teardown(t, "n1"))
    assert etcd.EtcdDB().log_files({}, "n1") == \
        j_etcd.EtcdDB().log_files({}, "n1") == ["/opt/etcd/etcd.log"]
    t = {"nodes": ["a", "b:1234"]}
    assert etcd.initial_cluster(t) == j_etcd.initial_cluster(t)
    for n in ("a", "b:1234"):
        assert etcd.client_url(n) == j_etcd.client_url(n)
        assert etcd.peer_url(n) == j_etcd.peer_url(n)
    assert etcd.EtcdDB().tarball_url() == j_etcd.EtcdDB().tarball_url()


# ---------------------------------------------------------------------------
# the v2-keys client
# ---------------------------------------------------------------------------

#: (f, key, value): a missing key's read, cas and write; writes, reads and
#: cas's that match and that do not, on two keys
OPS = [("read", 0, None), ("cas", 0, (1, 2)), ("write", 0, 3),
       ("read", 0, None), ("cas", 0, (3, 4)), ("cas", 0, (3, 9)),
       ("read", 0, None), ("write", "a b", 1), ("read", "a b", None),
       ("read", 1, None), ("cas", "a b", (1, 1))]


def ref_fake():
    FakeEtcdHandler.store = {}
    s = ThreadingHTTPServer(("127.0.0.1", 0), FakeEtcdHandler)
    threading.Thread(target=s.serve_forever, daemon=True).start()
    return f"127.0.0.1:{s.server_port}", s.shutdown


def tools_fake():
    f = fakes.EtcdFake(5)
    return f.start()[2], f.stop


class _Fails(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _fail(self):
        self.send_response(500)
        self.send_header("Content-Length", "0")
        self.end_headers()

    do_GET = do_PUT = _fail  # noqa: N815


def failing_server():
    s = ThreadingHTTPServer(("127.0.0.1", 0), _Fails)
    threading.Thread(target=s.serve_forever, daemon=True).start()
    return f"127.0.0.1:{s.server_port}", s.shutdown


def refused():
    return "127.0.0.1:1", lambda: None


def completions(mod, op_cls, kv, server):
    node, stop = server()
    try:
        c = mod.EtcdClient(timeout=0.5).open({}, node)
        out = []
        for i, (f, k, v) in enumerate(OPS):
            r = c.invoke({}, op_cls(type="invoke", f=f, value=kv(k, v),
                                    process=0, time=i))
            val = tuple(r.value) if r.value is not None else None
            out.append((r.type, r.f, val, r.error))
        return out
    finally:
        stop()


@pytest.mark.parametrize("server", [ref_fake, tools_fake, failing_server,
                                    refused])
def test_client_completions_equal_the_reference(server):
    ref = completions(j_etcd, JOp, j_independent.tuple_, server)
    got = completions(etcd, Op, independent.tuple_, server)
    assert got == ref
    types = [c[0] for c in got]
    if server in (ref_fake, tools_fake):
        assert types == ["fail", "fail", "ok", "ok", "ok", "fail", "ok",
                         "ok", "ok", "fail", "ok"]
        assert got[6][2] == (0, 4) and got[0][3] == "not-found"
    else:
        # reads crash as fail, writes and cas's as info
        assert types == ["fail" if f == "read" else "info"
                         for f, _, _ in OPS]


# ---------------------------------------------------------------------------
# the test map
# ---------------------------------------------------------------------------

def test_test_map_matches_the_reference():
    opts = {"time-limit": 7, "nodes": ["a", "b"], "concurrency": 20,
            "ssh": {"mode": "dummy"}, "store-root": "s", "other": 1}
    t, r = etcd.etcd_test(dict(opts)), j_etcd.etcd_test(dict(opts))
    assert set(t) == set(r)
    for k in ("name", "nodes", "concurrency", "ssh", "time-limit",
              "store-root"):
        assert t[k] == r[k], k
    assert type(t["nemesis"]).__name__ == type(r["nemesis"]).__name__
    assert set(t["checker"].checkers) == set(r["checker"].checkers) == \
        {"perf", "indep"}
    lin = t["checker"].checkers["indep"].inner
    assert (lin.backend, lin.device) == ("gpu", None)
    lin = etcd.etcd_test({"backend": "cpu", "device": "cpu"})[
        "checker"].checkers["indep"].inner
    assert (lin.backend, lin.device) == ("cpu", "cpu")
    assert type(etcd.etcd_test({"os": "debian"})["os"]).__name__ == \
        "DebianOS"


def test_the_nemesis_cuts_nothing_without_a_net():
    """No ``net`` in the test map (the reference's ``noop_test`` has
    none): ``start`` and ``stop`` are recorded and run no command."""
    outs = []
    for ctl, nem, o in ((j_control, j_nemesis, JOp),
                        (control, nemesis, Op)):
        t = dummy_map()
        with ctl.session_pool(t):
            n = nem.partition_random_halves().setup(t)
            for f in ("start", "stop"):
                r = n.invoke(t, o(type="info", f=f, value=None,
                                  process="nemesis", time=0))
                outs.append((r.type, r.f, type(r.value).__name__))
            assert all(s.log == [] for s in t["_sessions"].values())
    assert outs[:2] == outs[2:]


def test_ten_threads_a_key_need_ten_workers(tmp_path):
    """At five workers the suite fails as the reference's does, and
    ``run`` exits 255 with the reference's message."""
    f = fakes.EtcdFake(5)
    nodes = f.start()
    try:
        t = etcd.etcd_test({"time-limit": 2, "device": "cpu",
                            "nodes": nodes,
                            "store-root": str(tmp_path / "a")})
        t["db"] = None
        with pytest.raises(AssertionError,
                           match="raise concurrency to at least 10"):
            core.run(t)
        argv = ["run", "--suite", "etcd", "--ssh-mode", "dummy",
                "--time-limit", "2", "--device", "cpu", "--store-root",
                str(tmp_path / "b")]
        for n in nodes:
            argv += ["-n", n]
        assert main(argv + ["--concurrency", "1n"]) == 255
    finally:
        f.stop()
    assert main(argv + ["--workload", "lock"]) == 254
    assert main(["run", "--suite", "etcd", "--dummy-responses", "x.json",
                 "--device", "cpu"]) == 254


# ---------------------------------------------------------------------------
# end to end against the fake
# ---------------------------------------------------------------------------

def run_small(tmp_path, stale):
    # the followers lag 0.1 s: a key lives about a second at this size
    f = fakes.EtcdFake(5, stale_reads=stale, delay_s=0.1)
    nodes = f.start()
    try:
        test = etcd.etcd_test(dict(SMALL, device="cpu", nodes=nodes,
                                   concurrency=4,
                                   **{"store-root": str(tmp_path)}))
        test["ssh"] = {"mode": "dummy", "dummy-responses": RESPONSES}
        return core.run(test)
    finally:
        f.stop()


def to_reference(history):
    return JHistory(JOp(o.type, o.f,
                        j_independent.tuple_(*o.value)
                        if isinstance(o.value, KV) else o.value,
                        o.process, o.time, o.index, o.error)
                    for o in history)


def reference_verdicts(out):
    """The reference's independent checker, and its keyed device search,
    on the port's recorded history: the port's per-key verdicts (and
    levels)."""
    res = out["results"]["indep"]
    jh = to_reference(out["history"])
    ref = j_independent.checker(j_linearizable(
        JCASRegister(), backend="cpu")).check({}, jh)
    assert {k: r["valid"] for k, r in ref["results"].items()} == \
        {k: r["valid"] for k, r in res["results"].items()}
    assert sorted(ref["failures"]) == sorted(res["failures"])
    keys = {o.value.key for o in jh if j_independent.is_tuple(o.value)}
    dev = check_keyed_tpu({k: j_independent.subhistory(k, jh)
                           for k in keys}, JCASRegister())
    for k, r in res["results"].items():
        assert (dev["results"][k]["valid"], dev["results"][k]["levels"]) \
            == (r["valid"], r["levels"]), k
    return res


def test_small_run_is_valid_and_the_reference_agrees(tmp_path):
    out = run_small(tmp_path, stale=False)
    assert out["results"]["valid"] is True
    res = reference_verdicts(out)
    assert len(res["results"]) >= 2 and not res["failures"]
    assert all(r["backend"] == "gpu" and "fallback-from" not in r
               for r in res["results"].values())
    # the store keeps the [k v] values; analyze re-checks key by key
    d = out["store-dir"]
    loaded = store.load(d)["history"]
    assert [o.value for o in loaded] == [
        KV(o.value.key, list(o.value.value)
           if isinstance(o.value.value, tuple) else o.value.value)
        if isinstance(o.value, KV) else o.value for o in out["history"]]
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(["analyze", "--store", d, "--device", "cpu"]) == 0
    text = buf.getvalue()
    again = json.loads(text[text.index("\n{") + 1:])
    assert {k: (r["valid"], r["levels"]) for k, r in
            again["results"].items()} == \
        {str(k): (r["valid"], r["levels"])
         for k, r in res["results"].items()}
    assert "# plan:" in text and "batch" in text.split("# plan:")[1]
    assert "# contention: decomposable" in text
    # a run that died mid-flight: recover rebuilds the keyed history from
    # the WAL and re-checks it key by key
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
    assert [o.value for o in rec["history"]] == [o.value for o in loaded]
    assert {k: (r["valid"], r["levels"]) for k, r in
            rec["results"]["results"].items()} == \
        {str(k): (r["valid"], r["levels"])
         for k, r in res["results"].items()}


def test_stale_reads_are_refuted_on_the_same_keys(tmp_path):
    out = run_small(tmp_path, stale=True)
    res = out["results"]["indep"]
    assert out["results"]["valid"] is False and res["failures"]
    reference_verdicts(out)
    for k in res["failures"]:
        assert os.path.exists(os.path.join(
            out["store-dir"], "independent", str(k), "results.json"))


def test_kv_values_survive_the_store_and_the_wal(tmp_path):
    """A keyed op value is stored as ``{"independent/kv": [k, v]}`` in
    ``history.jsonl`` and in the WAL, and loads back as a KV."""
    from jepsen_tpu_torch import journal
    ops = [Op(type="invoke", f="cas", value=KV(3, (1, 2)), process=0,
              time=1),
           Op(type="ok", f="read", value=KV("k", None), process=1, time=2),
           Op(type="ok", f="enqueue", value={"independent/kv": 7},
              process=2, time=3)]
    text = History(ops).to_jsonl()
    assert json.loads(text.splitlines()[0])["value"] == \
        {"independent/kv": [3, [1, 2]]}
    back = History.from_jsonl(text)
    assert [o.value for o in back] == [KV(3, [1, 2]), KV("k", None),
                                      {"independent/kv": 7}]
    assert journal.decode_record(
        journal.encode_record(ops[0]).rstrip(b"\n")).value == KV(3, [1, 2])
