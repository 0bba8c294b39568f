"""The elasticsearch suite of the port, held against the reference on the
CPU.

Under the dummy control plane the database's lifecycle and the crash,
pause, isolate-primaries and bridge nemeses log the reference's commands
and give its completions from the same seed (the self-primaries read
from a fake ``/_cluster/state``, or fixed). The HTTP clients (the
document client, the set client over it, the MVCC set client) go
through a stub of ``urllib.request.urlopen`` shared by both packages and
give the reference's completions, each case of the taxonomy included:
a 404 against a 5xx, a version conflict, a timeout. ``DirtyReadChecker``
gives the reference's results on the same histories, and the seven test
maps and ``main`` are the reference's.
"""

import io
import json
import random
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from jepsen_tpu import control as j_control
from jepsen_tpu import net as j_net
from jepsen_tpu import suites as j_suites
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.suites import elasticsearch as j_es

from jepsen_tpu_torch import control, core, net, suites
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.suites import elasticsearch as es

from test_torch_suite_substrate import both_logs, dummy_map

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

NODES = ["n1", "n2", "n3", "n4", "n5"]
ROWS = ("elasticsearch", "elasticsearch-set", "elasticsearch-set-cas",
        "elasticsearch-set-isolate-primaries", "elasticsearch-set-pause",
        "elasticsearch-set-crash", "elasticsearch-set-bridge")


def op(op_cls, f, value=None, process=0, time=0):
    return op_cls(type="invoke", f=f, value=value, process=process,
                  time=time)


def completion(r):
    return (r.type, r.f, json.dumps(r.value, default=sorted), r.error)


# ---------------------------------------------------------------------------
# the lifecycle and the nemeses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda m, t: m.ESDB().setup(t, "n2"),
    lambda m, t: m.ESDB().teardown(t, "n4")], ids=["setup", "teardown"])
def test_the_lifecycle_logs_the_reference_commands(call):
    logs = both_logs(lambda t: call(j_es, t), lambda t: call(es, t))
    if "setup" in str(call):
        conf = next(c for c in logs["n2"] if "elasticsearch.yml" in c)
        assert '"n1", "n2", "n3", "n4", "n5"' in conf


def test_the_log_files_are_the_references():
    assert es.ESDB().log_files({}, "n1") == j_es.ESDB().log_files({}, "n1")


def nemesis_run(ctl, mod, net_ns, op_cls, make, seed, primaries):
    """A nemesis's setup, start, stop and teardown under the dummy
    control plane with ``self_primaries`` answering ``primaries``."""
    t = dummy_map(net=net_ns.iptables())
    old = mod.self_primaries
    mod.self_primaries = lambda nodes: list(primaries)
    random.seed(seed)
    outs = []
    try:
        with ctl.session_pool(t):
            n = make(mod)
            n = n.setup(t) or n
            for f in ("start", "stop"):
                r = n.invoke(t, op_cls(type="info", f=f, value=None,
                                       process="nemesis", time=0))
                outs.append((r.type, r.f, json.dumps(
                    r.value, sort_keys=True, default=sorted)))
            n.teardown(t)
            return {k: list(s.log) for k, s in t["_sessions"].items()}, outs
    finally:
        mod.self_primaries = old


NEMESES = {
    "crash": lambda m: m.crash_nemesis(),
    "crash-primary": lambda m: m.crash_primary_nemesis(),
    "isolate-primaries": lambda m: m.isolate_self_primaries_nemesis(),
    "pause": lambda m: m.set_pause_test({})["nemesis"],
    "bridge": lambda m: m.set_bridge_test({})["nemesis"],
}


@pytest.mark.parametrize("name", sorted(NEMESES))
@pytest.mark.parametrize("seed,primaries", [(0, ["n1", "n3"]), (5, ["n4"]),
                                            (2, [])])
def test_each_nemesis_logs_the_reference_commands(name, seed, primaries):
    ref = nemesis_run(j_control, j_es, j_net, JOp, NEMESES[name], seed,
                      primaries)
    got = nemesis_run(control, es, net, Op, NEMESES[name], seed, primaries)
    assert got == ref
    if name == "crash" or (name == "crash-primary" and primaries):
        assert any("killall -9 java" in c for cmds in got[0].values()
                   for c in cmds)


def test_isolate_self_primaries_grudge_is_the_references(monkeypatch):
    grudges = []
    for mod in (j_es, es):
        monkeypatch.setattr(mod, "self_primaries",
                            lambda nodes: ["n1", "n3"])
        grudges.append(mod.isolate_self_primaries_nemesis().grudge_fn(
            ["n1", "n2", "n3", "n4"]))
    assert grudges[0] == grudges[1]
    assert grudges[1]["n1"] == {"n2", "n3", "n4"}
    assert grudges[1]["n2"] == {"n1", "n3"}


@pytest.mark.parametrize("seed", range(4))
def test_mostly_small_nonempty_subset_is_the_references(seed):
    draws = []
    for mod in (j_es, es):
        random.seed(seed)
        draws.append([mod.mostly_small_nonempty_subset(NODES)
                      for _ in range(50)])
    assert draws[0] == draws[1]
    sizes = [len(x) for x in draws[1]]
    assert all(1 <= s <= 5 for s in sizes)
    assert es.mostly_small_nonempty_subset([]) == []


@pytest.fixture()
def cluster_state():
    """A fake ``/_cluster/state`` endpoint: its handler and address."""
    class Handler(BaseHTTPRequestHandler):
        states = {}

        def log_message(self, *a):
            pass

        def do_GET(self):  # noqa: N802
            body = json.dumps(self.states).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield Handler, f"127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()


def test_primaries_read_the_cluster_state_as_the_reference(cluster_state):
    handler, addr = cluster_state
    handler.states = {"master_node": "abc", "nodes": {"abc": {"name": addr}}}
    assert es.primaries([addr]) == j_es.primaries([addr]) == {addr: addr}
    assert es.self_primaries([addr]) == j_es.self_primaries([addr]) == [addr]
    handler.states = {"master_node": "abc", "nodes": {"abc": {"name": "x"}}}
    assert es.self_primaries([addr]) == j_es.self_primaries([addr]) == []
    down = "127.0.0.1:1"
    assert es.primaries([down], timeout=0.3) == \
        j_es.primaries([down], timeout=0.3) == {down: None}


# ---------------------------------------------------------------------------
# the HTTP clients, through a stub of urlopen
# ---------------------------------------------------------------------------

class HttpStub:
    """``urllib.request.urlopen`` for both packages' clients: the first
    rule whose method and path fragment match answers (a dict is the JSON
    body, an int an HTTP error, an exception is raised); a list of
    answers is taken in turn, its last one kept."""

    def __init__(self, rules):
        self.rules = [[m, p, list(a) if isinstance(a, list) else a]
                      for m, p, a in rules]
        self.calls = []

    def __call__(self, req, timeout=None):
        body = json.loads(req.data.decode()) if req.data else None
        method = req.get_method()
        self.calls.append((method, req.full_url, body))
        for m, pat, ans in self.rules:
            if m == method and pat in req.full_url:
                if isinstance(ans, list):
                    ans = ans.pop(0) if len(ans) > 1 else ans[0]
                if isinstance(ans, int):
                    raise urllib.error.HTTPError(req.full_url, ans, "err",
                                                 {}, None)
                if isinstance(ans, BaseException):
                    raise ans
                return io.BytesIO(json.dumps(ans).encode())
        raise urllib.error.HTTPError(req.full_url, 400, "no rule", {}, None)


HITS = {"hits": {"hits": [{"_id": "3"}, {"_id": "1"}]}}
CLIENTS = [
    ("doc", lambda m: m.ESClient(),
     [("write", 3), ("write", 4), ("write", 5), ("write", 6), ("write", 7),
      ("write", 8), ("read", 3), ("read", 4), ("read", 5), ("read", 6),
      ("read", 7), ("strong-read", None), ("strong-read", None)],
     [("PUT", "/jepsen/doc/", [{"created": True}, {"result": "created"},
                               {"_version": 2}, {"result": "updated"},
                               500, TimeoutError("slow")]),
      ("GET", "/jepsen/doc/", [{"found": True}, {"found": False}, 404, 503,
                               OSError("reset")]),
      ("POST", "/_refresh", {}),
      ("POST", "/_search", [HITS, 502])]),
    ("set", lambda m: m.sets_test({})["client"],
     [("add", 1), ("add", 2), ("read", None), ("read", None)],
     [("PUT", "/jepsen/doc/", [{"created": True}, 503]),
      ("POST", "/_refresh", {}),
      ("POST", "/_search", [HITS, TimeoutError("slow")])]),
    ("cas-set", lambda m: m.CASSetClient(),
     [("add", 3), ("add", 4), ("add", 5), ("add", 6), ("add", 7),
      ("add", 8), ("read", None)],
     [("PUT", "op_type=create", 409),
      ("GET", "?preference=_primary",
       [{"found": True, "_version": 4, "_source": {"values": [1, 2]}},
        {"found": True, "_version": 5, "_source": {"values": [1, 2, 3]}},
        404, {"found": False}, TimeoutError("slow"),
        {"found": True, "_version": 6, "_source": {"values": [9, 1]}}]),
      ("PUT", "?version=", [{}, 409, 500]),
      ("POST", "/_refresh", {})]),
]


def http_completions(mod, op_cls, make, ops, rules, monkeypatch):
    stub = HttpStub(rules)
    monkeypatch.setattr(urllib.request, "urlopen", stub)
    c = make(mod).open({}, "n2")
    c.setup({"nodes": NODES})
    out = [completion(c.invoke({}, op(op_cls, f, v, time=i)))
           for i, (f, v) in enumerate(ops)]
    return out, stub.calls


@pytest.mark.parametrize("name,make,ops,rules", CLIENTS,
                         ids=[c[0] for c in CLIENTS])
def test_each_client_is_the_references(name, make, ops, rules, monkeypatch):
    ref = http_completions(j_es, JOp, make, ops, rules, monkeypatch)
    got = http_completions(es, Op, make, ops, rules, monkeypatch)
    assert got == ref
    types = [c[0] for c in got[0]]
    want = {"doc": ["ok", "ok", "ok", "fail", "info", "info", "ok", "fail",
                    "fail", "fail", "fail", "ok", "fail"],
            "set": ["ok", "info", "ok", "fail"],
            "cas-set": ["ok", "fail", "fail", "fail", "info", "info", "ok"]}
    assert types == want[name]
    if name == "doc":
        assert got[0][4][3] == "http-500" and got[0][8][3] == "not-found"
        assert json.loads(got[0][11][2]) == [1, 3]
        assert all(u.startswith("http://n2:9200/jepsen/")
                   for _, u, _ in got[1])
    if name == "cas-set":
        put = [c for c in got[1] if c[0] == "PUT" and "version=4" in c[1]]
        assert put and put[0][2] == {"values": [1, 2, 3]}
        assert got[0][1][3] == "conflict"
        assert json.loads(got[0][6][2]) == [1, 9]


# ---------------------------------------------------------------------------
# the checker, the generators, the test maps
# ---------------------------------------------------------------------------

def history(h_cls, op_cls, rows):
    return h_cls(op_cls(type=ty, f=f, value=v, process=i % 3, time=i)
                 for i, (ty, f, v) in enumerate(rows))


DIRTY = [
    [("ok", "write", 1), ("ok", "write", 2), ("ok", "read", 3),
     ("ok", "strong-read", {1, 2}), ("ok", "strong-read", {1, 2})],
    [("ok", "write", 1), ("ok", "strong-read", {1}),
     ("ok", "strong-read", {1, 2})],
    [("ok", "write", 1), ("ok", "write", 2), ("ok", "read", 1),
     ("ok", "strong-read", {1, 2}), ("fail", "strong-read", {5})],
    [("ok", "write", 1), ("info", "write", 2), ("ok", "strong-read", {1})],
    [("ok", "write", 1), ("ok", "read", 1)],
    [("ok", "write", 4), ("ok", "strong-read", {2}),
     ("ok", "strong-read", None)]]


@pytest.mark.parametrize("rows", DIRTY)
def test_the_dirty_read_checker_is_the_references(rows):
    a = j_es.dirty_read_checker().check({}, history(JHistory, JOp, rows))
    b = es.dirty_read_checker().check({}, history(History, Op, rows))
    assert a == b


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
    for k in ("client", "db", "nemesis", "os"):
        assert type(t[k]).__name__ == type(r[k]).__name__, k


def test_main_is_run_suite_elasticsearch(monkeypatch):
    seen = []
    monkeypatch.setattr(core, "run", lambda t: seen.append(t) or dict(
        t, results={"valid": True}))
    assert exit_code(es.main, ["test", "--device", "cpu", "--time-limit",
                               "3"]) == 0
    assert seen[0]["name"] == "elasticsearch-dirty-read"
    assert seen[0]["time-limit"] == 3
    assert exit_code(es.main, ["test", "--device", "cpu", "--nemesis",
                               "parts"]) == 254


def exit_code(main, argv):
    """The code a suite module's ``main`` exits with."""
    with pytest.raises(SystemExit) as e:
        main(argv)
    return e.value.code
