"""The port's check daemon on the CPU (``ServeConfig(device="cpu")``).

* A burst coalesces into gangs whose verdicts equal the port's offline
  ``check_safe(linearizable(...))`` of the same histories, and equal the
  JAX package's offline verdicts.
* A poison member (``_GANG_FAULT``) fails alone and counts once toward
  its bucket's breaker.
* Admission: 429 on the queue, the tenant quota, the footprint and the
  rate; 503 while draining; 400 on malformed input.
* The WAL: replay after a daemon is dropped without finishing, a torn
  tail in the middle of a gang, finished requests not replayed.
* A request's deadline: the serial search stops at its barrier and frees
  the engine, so a second request finishes while the first is late.
* HTTP on port 0: ``POST /check``, ``GET /check/<id>``, ``/healthz``,
  ``/drain``, the bearer token; and ``python -m jepsen_tpu_torch serve``.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import torch

from jepsen_tpu.checker import check_safe as j_check_safe
from jepsen_tpu.checker.wgl import linearizable as j_linearizable
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.models import CASRegister as JCASRegister

from jepsen_tpu_torch import journal as journal_ns
from jepsen_tpu_torch import serve as S
from jepsen_tpu_torch.checker import UNKNOWN, check_safe
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.checker.engine import default_engine
from jepsen_tpu_torch.checker.wgl import linearizable
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.ops.encode import pack_with_init

from test_torch_gang import bad_read, conc_ops

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VERDICT = ("valid", "levels", "max-linearized-prefix", "final-states",
           "frontier-op")


def daemon(tmp_path, start=False, **cfg):
    cfg.setdefault("root", str(tmp_path / "serve"))
    cfg.setdefault("device", "cpu")
    d = S.CheckDaemon(S.ServeConfig(**cfg))
    return d.start() if start else d


def wait_done(d, rid, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        doc = d.status(rid)
        if doc and doc["state"] == "done":
            return doc
        time.sleep(0.02)
    raise AssertionError(f"request {rid} never finished: {d.status(rid)}")


def offline(ops):
    return check_safe(linearizable(CASRegister(), device="cpu"),
                      {"name": "offline"}, History.of(ops))


def submit_all(d, histories, tenants=2):
    """Submit each history (tenant i % tenants); returns {id: ops}."""
    out = {}
    for i, ops in enumerate(histories):
        code, body, _ = d.submit({"tenant": f"t{i % tenants}",
                                  "model": "cas-register", "history": ops})
        assert code == 202, body
        out[body["id"]] = ops
    return out


def restarted(tmp_path, histories, **cfg):
    """Journal the histories in a daemon that never runs them (dropped, as
    by a crash), then start a second one on the same directory: its
    worker's first dequeue leads a gang of every replayed request."""
    d1 = daemon(tmp_path)
    ids = submit_all(d1, histories)
    d1.journal.close()
    cfg.setdefault("batch_wait_ms", 200.0)
    return daemon(tmp_path, start=True, workers=1, **cfg), ids


def test_a_burst_coalesces_into_gangs_equal_to_offline(tmp_path):
    histories = [conc_ops(24, s, 100 * s) for s in range(50, 54)]
    histories.append(bad_read(conc_ops(24, 54)))
    d, ids = restarted(tmp_path, histories)
    assert d.batcher is not None and d.replay_stats["requeued"] == 5
    docs = {rid: wait_done(d, rid) for rid in ids}
    d.stop()
    assert d.stats["batches"] >= 1 and d.stats["max-batch"] == 5
    assert S.RequestJournal.replay(d.journal.path)[0] == []
    for rid, ops in ids.items():
        r = docs[rid]["result"]
        gang = r["serve"]["gang"]
        assert gang["size"] == 5 and gang["poison"] is False
        want = offline(ops)
        assert {k: r.get(k) for k in VERDICT} == {
            k: want.get(k) for k in VERDICT}, (rid, r, want)
        ref = j_check_safe(j_linearizable(JCASRegister(), backend="tpu"),
                           {}, JHistory.of(ops))
        assert r["valid"] == ref["valid"]
    assert sorted(r["result"]["valid"] is True for r in docs.values()) == [
        False, True, True, True, True]
    # the WAL holds the gang's membership, and each member's done record
    records, _ = journal_ns.read_json_records(d.journal.path)
    gangs = [r for r in records if r.get("event") == "gang"]
    assert len(gangs) == 1 and sorted(gangs[0]["ids"]) == sorted(ids)
    assert all(sorted(r["gang"]) == sorted(ids) for r in records
               if r.get("event") == "done")


def test_a_poison_member_fails_alone_and_counts_once(tmp_path,
                                                     monkeypatch):
    survivors = [conc_ops(24, s, 100 * s) for s in range(60, 63)]
    poison = conc_ops(22, 63)
    poison_n = pack_with_init(History.of(poison), CASRegister())[0].n
    assert all(pack_with_init(History.of(o), CASRegister())[0].n
               != poison_n for o in survivors)
    calls = []

    def fault(pks):
        calls.append(len(pks))
        if any(p.n == poison_n for p in pks):
            raise MemoryError("injected gang OOM")

    monkeypatch.setattr(G, "_GANG_FAULT", fault)
    d, ids = restarted(tmp_path, [poison] + survivors, breaker_fails=5)
    rid_p = next(iter(ids))
    docs = {rid: wait_done(d, rid) for rid in ids}
    d.stop()
    res = docs[rid_p]["result"]
    assert res["valid"] is UNKNOWN and res["error-class"] == "oom"
    assert res["serve"]["gang"] == {"size": 4, "index": 0,
                                    "bisections": 2, "poison": True}
    assert d.stats["poisoned"] == 1 and d.stats["bisections"] == 2
    assert calls[0] == 4
    for rid in list(ids)[1:]:
        r = docs[rid]["result"]
        assert r["serve"]["gang"]["poison"] is False
        want = offline(ids[rid])
        assert {k: r.get(k) for k in VERDICT} == {
            k: want.get(k) for k in VERDICT}
    assert [b["fails"] for b in d.breaker.snapshot().values()] == [1]


def test_a_gang_member_past_its_deadline_is_cancelled(tmp_path):
    late = conc_ops(300, 70)
    mates = [conc_ops(300, s, 1000 * s) for s in (71, 72)]
    d1 = daemon(tmp_path)
    code, body, _ = d1.submit({"model": "cas-register", "history": late,
                               "deadline-s": 0.001})
    rid_late = body["id"]
    ids = submit_all(d1, mates)
    d1.journal.close()
    d = daemon(tmp_path, start=True, workers=1, batch_wait_ms=200.0)
    r = wait_done(d, rid_late)["result"]
    docs = {rid: wait_done(d, rid)["result"] for rid in ids}
    d.stop()
    assert r["error"] == ":info/timeout" and r["gang-cancelled"] is True
    assert r["error-class"] == "wedge" and r["deadline-s"] == 0.001
    assert r["serve"]["timed-out"] is True
    assert r["serve"]["gang"]["size"] == 3
    for rid, res in docs.items():
        assert res["valid"] is True and res["serve"]["timed-out"] is False
        assert res["levels"] == offline(ids[rid])["levels"]
    assert d.stats["timeouts"] == 1


def test_a_late_request_frees_the_engine_for_the_next(tmp_path):
    """A lone request past its deadline answers :info/timeout; its search
    stops at the next segment barrier and releases the engine's lock, so
    the request queued behind it finishes long before the late one's
    whole search would (about 13 s here)."""
    d = daemon(tmp_path, start=True, workers=1, batch_enabled=False)
    from jepsen_tpu_torch.testing import simulate_register_history
    big = [o.to_dict() for o in simulate_register_history(
        2000, n_procs=5, n_vals=16, seed=9000, crash_p=0.002)]
    t0 = time.monotonic()
    code, a, _ = d.submit({"tenant": "a", "model": "cas-register",
                           "history": big, "deadline-s": 0.05})
    assert code == 202
    code, b, _ = d.submit({"tenant": "b", "model": "cas-register",
                           "history": conc_ops(24, 80)})
    rb = wait_done(d, b["id"], timeout=10.0)["result"]
    assert time.monotonic() - t0 < 10.0 and rb["valid"] is True
    ra = wait_done(d, a["id"])["result"]
    assert ra["valid"] == "unknown" and ra["error"] == ":info/timeout"
    assert ra["serve"]["timed-out"] is True
    for t in threading.enumerate():
        if t.name == f"jtpu-serve-check-{a['id']}":
            t.join(timeout=10.0)
            assert not t.is_alive()
    assert not default_engine().lock.locked()
    d.stop()


# ---------------------------------------------------------------------------
# Admission
# ---------------------------------------------------------------------------


def test_the_queue_and_the_tenant_quota_answer_429(tmp_path):
    d = daemon(tmp_path, queue_max=3, tenant_max=2)
    ops = conc_ops(24, 3)
    for tenant in ("a", "a", "b"):
        assert d.submit({"tenant": tenant, "history": ops})[0] == 202
    code, body, hdrs = d.submit({"tenant": "a", "history": ops})
    assert (code, body["error"]) == (429, "queue-full")
    assert int(hdrs["Retry-After"]) >= 1
    d2 = daemon(tmp_path / "2", queue_max=10, tenant_max=1)
    assert d2.submit({"tenant": "greedy", "history": ops})[0] == 202
    code, body, hdrs = d2.submit({"tenant": "greedy", "history": ops})
    assert (code, body["error"]) == (429, "tenant-quota")
    assert "Retry-After" in hdrs
    assert d2.submit({"tenant": "modest", "history": ops})[0] == 202
    d.stop()
    d2.stop()


def test_the_footprint_budget_and_the_rate_limit(tmp_path):
    d = daemon(tmp_path, bytes_budget=512)
    code, body, _ = d.submit({"history": conc_ops(24, 3)})
    assert (code, body["error"]) == (429, "footprint")
    assert body["predicted-bytes"] > 512 == body["budget-bytes"]
    d2 = daemon(tmp_path / "2", rate_limit=0.001, rate_burst=1)
    assert d2.submit({"tenant": "a", "history": conc_ops(24, 3)})[0] == 202
    code, body, _ = d2.submit({"tenant": "a", "history": conc_ops(24, 3)})
    assert (code, body["error"]) == (429, "rate-limited")
    assert d2.submit({"tenant": "b", "history": conc_ops(24, 3)})[0] == 202
    d.stop()
    d2.stop()


def test_draining_503_and_bad_input_400(tmp_path):
    d = daemon(tmp_path)
    assert d.submit({"model": "nope", "history": conc_ops(8, 1)})[0] == 400
    assert d.submit({"history": []})[0] == 400
    assert d.submit({"history": conc_ops(8, 1), "deadline-s": "x"})[0] == 400
    bad = [{"type": "invoke", "f": "write", "value": 1, "process": 0,
            "time": 0},
           {"type": "invoke", "f": "write", "value": 2, "process": 0,
            "time": 1}]
    code, body, _ = d.submit({"history": bad})
    assert (code, body["error"]) == (400, "malformed") and body["lint"]
    d.draining = True
    code, body, hdrs = d.submit({"history": conc_ops(8, 1)})
    assert (code, body["error"]) == (503, "draining")
    assert "Retry-After" in hdrs
    d.stop()


def test_an_open_breaker_answers_503(tmp_path):
    d = daemon(tmp_path, breaker_fails=1, breaker_cooldown_s=60.0)
    code, body, _ = d.submit({"history": conc_ops(24, 3)})
    bucket = tuple(body["bucket"])
    d.breaker.record(bucket, "oom", probe=False)
    code, body, hdrs = d.submit({"history": conc_ops(24, 4)})
    assert (code, body["error"]) == (503, "breaker-open")
    assert "Retry-After" in hdrs
    d.stop()


def test_a_gang_is_priced_whole_against_the_budget(tmp_path):
    """The scheduler caps a gang at the members whose stacked footprint
    fits the byte budget."""
    from jepsen_tpu_torch.checker import plan
    ops = conc_ops(24, 3)
    dims = plan.PlanDims.from_history(History.of(ops), CASRegister())
    fp = plan.request_footprint(dims, "cpu")
    d = daemon(tmp_path, bytes_budget=3 * fp, batch_max=8)
    code, body, _ = d.submit({"history": ops})
    assert code == 202 and d.status(body["id"])["predicted-bytes"] == fp
    assert d.batcher.max_fit(d._by_id[body["id"]]) == 3
    d.stop()


def test_the_host_backend_serves_without_gangs(tmp_path):
    """``backend="cpu"``: the exact host search, no bucket, no device."""
    d = daemon(tmp_path, start=True, backend="cpu")
    ops = bad_read(conc_ops(24, 96))
    code, body, _ = d.submit({"history": ops})
    assert code == 202 and "bucket" not in body and d.device is None
    r = wait_done(d, body["id"])["result"]
    d.stop()
    want = check_safe(linearizable(CASRegister(), backend="cpu"), {},
                      History.of(ops))
    assert r["valid"] is False and r["backend"] == "cpu"
    assert r["max-linearized-prefix"] == want["max-linearized-prefix"]


def test_the_daemon_bounds_the_engines_warm_buckets(tmp_path):
    eng = default_engine()
    before = eng.max_warm_buckets
    try:
        d = daemon(tmp_path, start=True, engine_max_buckets=1,
                   batch_enabled=False)
        assert eng.max_warm_buckets == 1
        ids = submit_all(d, [conc_ops(24, 97), conc_ops(300, 98)])
        for rid in ids:
            wait_done(d, rid)
        health = d.healthz()["engine"]
        d.stop()
        assert len(health["warm-buckets"]) == 1
        assert health["warm-buckets"][0].startswith("cas-register/256/")
        assert health["evictions"] >= 1
    finally:
        eng.set_max_warm_buckets(before)


# ---------------------------------------------------------------------------
# The WAL
# ---------------------------------------------------------------------------


def test_a_dropped_daemon_replays_and_matches_offline(tmp_path):
    histories = [conc_ops(24, 90), bad_read(conc_ops(24, 91))]
    d, ids = restarted(tmp_path, histories, batch_enabled=False)
    assert d.batcher is None and d.replay_stats["requeued"] == 2
    for rid, ops in ids.items():
        r = wait_done(d, rid)["result"]
        assert "gang" not in r["serve"]
        assert r["valid"] == offline(ops)["valid"]
    d.stop()
    assert S.RequestJournal.replay(d.journal.path)[0] == []


def test_a_torn_tail_mid_gang_replays_every_member(tmp_path):
    histories = [conc_ops(24, 92), conc_ops(24, 93, 100)]
    d1 = daemon(tmp_path)
    ids = submit_all(d1, histories)
    d1.journal.close()
    with open(d1.journal.path, "ab") as f:
        f.write(b'deadbeef {"event": "gang", "ids": [tor')
    pending, stats = S.RequestJournal.replay(d1.journal.path)
    assert [r["id"] for r in pending] == list(ids) and stats["torn"] == 1
    d2 = daemon(tmp_path, start=True, workers=1, batch_wait_ms=150.0)
    assert d2.replay_stats["requeued"] == 2
    for rid, ops in ids.items():
        r = wait_done(d2, rid)["result"]
        assert r["valid"] == offline(ops)["valid"]
    d2.stop()


def test_the_journal_format_round_trips():
    docs = [{"event": "accepted", "id": "a", "history": [1, {2}]},
            {"event": "done", "id": "a"}]
    lines = [journal_ns.encode_json_record(d) for d in docs]
    assert journal_ns.decode_json_record(lines[0][:-1]) == {
        "event": "accepted", "id": "a", "history": [1, [2]]}
    assert journal_ns.decode_json_record(b"00000000 {}") is None
    assert journal_ns.decode_json_record(b"short") is None


def test_the_journal_skips_a_corrupt_record(tmp_path):
    path = str(tmp_path / "j.wal")
    w = journal_ns.JsonRecordWriter(path, fsync=True)
    w.append({"id": "a"})
    w.close()
    with open(path, "ab") as f:
        f.write(b"0badc0de {\"id\": \"b\"}\n")
    w = journal_ns.JsonRecordWriter(path)
    w.append({"id": "c"})
    w.close()
    records, stats = journal_ns.read_json_records(path)
    assert [r["id"] for r in records] == ["a", "c"]
    assert stats == {"records": 2, "torn": 0, "corrupt": 1}


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------


def http(port, method, path, doc=None, token=None):
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def test_an_http_round_trip(tmp_path):
    d, server = S.run_daemon(S.ServeConfig(root=str(tmp_path / "serve"),
                                           device="cpu"), port=0)
    port = server.server_port
    try:
        ops = bad_read(conc_ops(24, 95))
        code, body, _ = http(port, "POST", "/check",
                             {"tenant": "t", "model": "cas-register",
                              "history": ops})
        assert code == 202 and body["state"] == "queued"
        deadline = time.monotonic() + 30
        while True:
            code, doc, _ = http(port, "GET", f"/check/{body['id']}")
            assert code == 200
            if doc["state"] == "done" or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert doc["result"]["valid"] is False
        assert doc["result"]["max-linearized-prefix"] == offline(ops)[
            "max-linearized-prefix"]
        code, health, _ = http(port, "GET", "/healthz")
        assert code == 200 and health["stats"]["completed"] == 1
        assert health["device"] == "cpu"
        assert http(port, "GET", "/check/nope")[0] == 404
        # the registry in Prometheus text
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as resp:
            assert resp.status == 200
            assert (b"# TYPE jtpu_serve_admitted_total counter"
                    in resp.read())
        code, drained, _ = http(port, "POST", "/drain")
        assert code == 200 and drained["drained"] is True
        assert d.drained.is_set()
        assert http(port, "POST", "/check",
                    {"history": ops})[0] == 503
    finally:
        server.shutdown()
        server.server_close()
        d.stop()


def test_the_bearer_token_guards_the_posts(tmp_path):
    d, server = S.run_daemon(S.ServeConfig(root=str(tmp_path / "serve"),
                                           device="cpu", auth_token="s3"),
                             port=0)
    port = server.server_port
    try:
        doc = {"history": conc_ops(8, 1)}
        code, body, hdrs = http(port, "POST", "/check", doc)
        assert code == 401 and hdrs["WWW-Authenticate"] == "Bearer"
        assert http(port, "POST", "/check", doc, token="bad")[0] == 401
        assert http(port, "POST", "/drain")[0] == 401
        assert http(port, "POST", "/check", doc, token="s3")[0] == 202
        assert http(port, "GET", "/healthz")[0] == 200
    finally:
        server.shutdown()
        server.server_close()
        d.stop()


def test_the_cli_serves_until_drained(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch", "serve",
         "--check-daemon", "--host", "127.0.0.1", "--port", "0",
         "--serve-dir", str(tmp_path / "serve"), "--device", "cpu",
         "--queue-max", "4"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("Listening on http://127.0.0.1:"), line
        port = int(line.split(":")[2].split("/")[0])
        code, body, _ = http(port, "POST", "/check",
                             {"history": conc_ops(24, 3)})
        assert code == 202
        code, health, _ = http(port, "GET", "/healthz")
        assert health["queue-max"] == 4 and health["device"] == "cpu"
        assert http(port, "POST", "/drain")[0] == 200
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    records, _ = journal_ns.read_json_records(
        str(tmp_path / "serve" / S.WAL_NAME))
    assert records[0]["event"] == "accepted"
