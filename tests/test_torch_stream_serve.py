"""The port's stream intake and the daemon's stream routes, on the CPU
(``ServeConfig(device="cpu")``).

* The session: duplicates absorbed without a second WAL record, early
  chunks buffered and drained in order, 409 on a gap and on a close with
  a chunk missing, 400 on a CRC mismatch; a replay after a kill gives the
  same ops and a byte-identical ``history.json``, also from a WAL the JAX
  package's session wrote.
* The daemon: open, feed, close and verdict (equal to the offline
  check); 400 on an unknown model, 404 on an unknown stream; 429 on the
  stream quota (with no window between the check and the reservation),
  on backpressure and on the footprint; a restart that replays an open
  stream and finishes it; a stream and ``POST /check`` requests of its
  bucket interleaved; the routes over HTTP behind the bearer token, and
  ``python -m jepsen_tpu_torch stream`` against a daemon on port 0.
* With ``JTPU_SERVE_STREAM=0``: no route, no ``streams/`` directory, no
  healthz key, and ``jepsen_tpu_torch.stream`` never imported.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from jepsen_tpu import stream as JS

from jepsen_tpu_torch import journal as journal_ns
from jepsen_tpu_torch import serve as SV
from jepsen_tpu_torch import stream as S
from jepsen_tpu_torch.checker import check_safe
from jepsen_tpu_torch.checker.wgl import linearizable
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import CASRegister

from test_stream import _chunks, _conc_ops

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VERDICT = ("valid", "max-linearized-prefix", "final-states", "frontier-op")


def offline(ops):
    return check_safe(linearizable(CASRegister(), device="cpu"),
                      {"name": "offline"}, History.of(ops))


def same_as_offline(result, ops):
    """The verdict fields of a stream equal the offline check's; its
    levels are the offline search's plus at most one a barrier (a barrier
    at which the search was done, followed by a forced op: see
    ``tests/test_torch_stream_runner.py`` ``agree``)."""
    want = offline(ops)
    for k in VERDICT:
        assert result.get(k) == want.get(k), (k, result, want)
    extra = result["levels"] - want["levels"]
    assert 0 <= extra <= result["stream"]["barriers"], (result, want)


def session(root, sid="s1", **kw):
    return S.StreamSession(sid, "t", "cas-register", str(root), **kw)


def wal_bytes(s):
    with open(os.path.join(s.dir, S.WAL_NAME), "rb") as f:
        return f.read()


def history_bytes(s):
    with open(os.path.join(s.dir, S.HISTORY_NAME), "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------


def test_a_duplicate_is_absorbed_without_a_second_record(tmp_path):
    s = session(tmp_path)
    chunk = _conc_ops(8, 1)
    code, body = s.append(0, chunk, S.chunk_crc(chunk))
    assert code == 202 and body["need"] == 1
    before = wal_bytes(s)
    code, body = s.append(0, chunk, S.chunk_crc(chunk))
    assert code == 202 and body["duplicate"] is True
    assert len(s.ops) == len(chunk) and s.dups == 1
    assert wal_bytes(s) == before
    s.stop_wal()


def test_early_chunks_buffer_and_drain_in_order(tmp_path):
    s = session(tmp_path)
    c = _chunks(_conc_ops(24, 2), 8)
    assert s.append(1, c[1])[1]["buffered"] is True
    assert s.append(2, c[2])[1]["buffered"] is True
    assert s.ops == []
    code, body = s.append(0, c[0])
    assert code == 202 and body["need"] == 3
    assert s.ops == c[0] + c[1] + c[2] and s.reordered == 2
    s.stop_wal()


def test_gaps_crc_and_holes_at_close(tmp_path):
    s = session(tmp_path, reorder_max=2)
    code, body = s.append(5, [])
    assert code == 409 and body["error"] == "gap" and body["need"] == 0
    code, body = s.append(0, _conc_ops(4, 3), "deadbeef")
    assert code == 400 and body["error"] == "crc-mismatch"
    assert s.append("x", [])[0] == 400 and s.append(0, {})[0] == 400
    c = _chunks(_conc_ops(24, 4), 8)
    s.append(0, c[0])
    s.append(2, c[2])
    code, body = s.close(3)
    assert code == 409 and body["need"] == 1 and body["buffered"] == [2]
    s.append(1, c[1])
    code, body = s.close(3)
    assert code == 200 and body["state"] == "closed"
    # late duplicates still 202; a new chunk after the close is refused
    code, body = s.append(0, c[0])
    assert code == 202 and body["duplicate"] is True
    assert s.append(3, c[0])[1]["error"] == "stream-closed"
    assert s.close(3)[0] == 200
    s.stop_wal()


def _killed(root, pkg, c):
    """A session of package ``pkg`` that took chunks 0, 1 and 3 and was
    killed (its WAL left as it stands)."""
    s = pkg.StreamSession("s1", "t", "cas-register", str(root))
    for i in (0, 1, 3):
        assert s.append(i, c[i])[0] == 202
    s.stop_wal()
    return s


@pytest.mark.parametrize("writer", [S, JS])
def test_a_replay_gives_the_same_ops_and_history_bytes(tmp_path, writer):
    """A kill between chunks, one chunk buffered early: the port's replay
    of the WAL (the port's own, or the JAX package's) rebuilds the ops and
    the buffer, and the sealed ``history.json`` is byte for byte the one a
    stream that was never killed writes, in either package."""
    c = _chunks(_conc_ops(60, 6), 10)
    clean = {}
    for pkg in (S, JS):
        ref = pkg.StreamSession("s1", "t", "cas-register",
                                str(tmp_path / f"clean-{pkg.__name__}"))
        for i, ch in enumerate(c):
            ref.append(i, ch)
        ref.close(len(c))
        ref.stop_wal()
        clean[pkg] = history_bytes(ref)
    assert clean[S] == clean[JS]
    s = _killed(tmp_path / "killed", writer, c)
    s2 = S.StreamSession.replay(s.dir, str(tmp_path / "killed"))
    assert s2.state == "open" and s2.ops == c[0] + c[1]
    assert list(s2.reorder) == [3] and s2.next_seq == 2
    assert s2.append(1, c[1])[1]["duplicate"] is True
    for i in range(2, len(c)):
        assert s2.append(i, c[i])[0] == 202
    assert s2.close(len(c))[0] == 200
    s2.stop_wal()
    assert history_bytes(s2) == clean[S]
    # a replay of the sealed session writes the artifact again
    os.unlink(os.path.join(s2.dir, S.HISTORY_NAME))
    s3 = S.StreamSession.replay(s2.dir, str(tmp_path / "killed"))
    s3.stop_wal()
    assert s3.state == "closed" and history_bytes(s3) == clean[S]


def test_a_replayed_verdict_and_a_torn_tail(tmp_path):
    s = session(tmp_path)
    ops = _conc_ops(20, 7)
    s.append(0, ops)
    s.close(1)
    s.finish({"valid": True, "levels": 3}, 0.5)
    s.stop_wal()
    records, _ = journal_ns.read_json_records(
        os.path.join(s.dir, S.WAL_NAME))
    assert [r["event"] for r in records] == ["open", "chunk", "close",
                                             "verdict"]
    s2 = S.StreamSession.replay(s.dir, str(tmp_path))
    s2.stop_wal()
    assert s2.state == "done" and s2.result == {"valid": True, "levels": 3}
    # without its result file the verdict is checked again
    os.unlink(os.path.join(s.dir, S.RESULT_NAME))
    with open(os.path.join(s.dir, S.WAL_NAME), "ab") as f:
        f.write(b"0123abcd {\"event\": \"chu")     # a torn record
    s3 = S.StreamSession.replay(s.dir, str(tmp_path))
    s3.stop_wal()
    assert s3.state == "closed" and s3.result is None and s3.ops == ops
    assert S.StreamSession.replay(str(tmp_path / "none"),
                                  str(tmp_path)) is None


# ---------------------------------------------------------------------------
# The daemon
# ---------------------------------------------------------------------------


def daemon(tmp_path, start=True, **cfg):
    cfg.setdefault("root", str(tmp_path / "serve"))
    cfg.setdefault("device", "cpu")
    d = SV.CheckDaemon(SV.ServeConfig(**cfg))
    return d.start() if start else d


def wait_stream(d, sid, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        doc = d.stream_status(sid)
        if doc["state"] == "done" and doc.get("result"):
            return doc
        time.sleep(0.02)
    raise AssertionError(f"stream {sid} never finished: "
                         f"{d.stream_status(sid)}")


def stream_all(d, ops, size, tenant="t1"):
    code, body, _ = d.stream_open({"tenant": tenant,
                                   "model": "cas-register"})
    assert code == 202 and body["state"] == "open", body
    sid = body["id"]
    c = _chunks(ops, size)
    for i, ch in enumerate(c):
        code, body, _ = d.stream_append(sid, {"seq": i, "ops": ch,
                                              "crc": S.chunk_crc(ch)})
        assert code == 202, body
    code, body, _ = d.stream_close(sid, {"chunks": len(c)})
    assert code == 200, body
    return sid


def test_open_feed_close_and_verdict(tmp_path):
    ops = _conc_ops(160, 31)
    d = daemon(tmp_path)
    try:
        sid = stream_all(d, ops, 20)
        doc = wait_stream(d, sid)
        same_as_offline(doc["result"], ops)
        assert doc["result"]["stream"]["watermark"] == len(ops)
        assert doc["checked-events"] == len(ops) and doc["lag"] == 0
        hz = d.healthz()
        assert hz["streams"]["sessions"] == 1 and hz["streams"]["done"] == 1
        assert hz["streams"]["ops"] == len(ops)
        with open(os.path.join(d.config.root, "streams", sid,
                               S.RESULT_NAME)) as f:
            assert json.load(f)["valid"] is True
    finally:
        d.stop()


def test_an_unknown_model_is_400_and_an_unknown_stream_404(tmp_path):
    d = daemon(tmp_path, start=False)
    try:
        assert d.stream_open({"model": "no-such-model"})[0] == 400
        assert d.stream_append("nope", {"seq": 0, "ops": []})[0] == 404
        assert d.stream_close("nope", {})[0] == 404
        assert d.stream_status("nope") is None
    finally:
        d.stop()


def test_the_stream_quota_answers_429(tmp_path):
    d = daemon(tmp_path, start=False, stream_max=1)
    try:
        assert d.stream_open({"model": "cas-register"})[0] == 202
        code, body, hdrs = d.stream_open({"model": "cas-register"})
        assert code == 429 and body["error"] == "stream-quota"
        assert int(hdrs["Retry-After"]) >= 1
    finally:
        d.stop()


def test_the_quota_check_and_the_reservation_are_one(tmp_path,
                                                     monkeypatch):
    """An open stalled inside the session's construction holds its slot:
    a second open at the quota answers 429."""
    entered, release = threading.Event(), threading.Event()
    real = S.StreamSession

    class Stalled(real):
        def __init__(self, *a, **kw):
            entered.set()
            assert release.wait(30)
            super().__init__(*a, **kw)

    monkeypatch.setattr(S, "StreamSession", Stalled)
    d = daemon(tmp_path, start=False, stream_max=1)
    first = {}
    t = threading.Thread(target=lambda: first.update(
        r=d.stream_open({"model": "cas-register"})), daemon=True)
    try:
        t.start()
        assert entered.wait(30)
        code, body, _ = d.stream_open({"model": "cas-register"})
        assert code == 429 and body["error"] == "stream-quota"
        assert d.healthz()["ok"] is True
    finally:
        release.set()
        t.join(30)
        d.stop()
    assert first["r"][0] == 202


def test_backpressure_and_the_footprint_answer_429(tmp_path):
    d = daemon(tmp_path, start=False, stream_buffer_ops=10)
    try:
        sid = d.stream_open({"model": "cas-register"})[1]["id"]
        sess = d._stream_session(sid)
        sess.runner.stop()
        sess.runner.join(10)
        ops = _conc_ops(40, 32)
        assert d.stream_append(sid, {"seq": 0, "ops": ops})[0] == 202
        code, body, hdrs = d.stream_append(sid, {"seq": 1, "ops": ops})
        assert code == 429 and body["error"] == "backpressure"
        assert body["lag-ops"] == len(ops) and int(hdrs["Retry-After"]) >= 1
    finally:
        d.stop()
    d = daemon(tmp_path / "fp", start=False, bytes_budget=1000)
    try:
        sid = d.stream_open({"model": "cas-register"})[1]["id"]
        assert d.stream_append(sid, {"seq": 0,
                                     "ops": _conc_ops(40, 33)})[0] == 202
        sess = d._stream_session(sid)
        deadline = time.monotonic() + 30
        while not sess.footprint and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sess.footprint > 1000
        code, body, _ = d.stream_append(sid, {"seq": 1, "ops": []})
        assert code == 429 and body["error"] == "footprint"
        assert body["predicted-bytes"] == sess.footprint
    finally:
        d.stop()


def test_a_restart_replays_an_open_stream_and_finishes_it(tmp_path):
    ops = _conc_ops(200, 33)
    c = _chunks(ops, 20)
    d1 = daemon(tmp_path)
    try:
        sid = d1.stream_open({"model": "cas-register"})[1]["id"]
        for i in range(5):
            assert d1.stream_append(sid, {"seq": i, "ops": c[i]})[0] == 202
    finally:
        d1.stop()
    d2 = daemon(tmp_path)
    try:
        assert d2.replay_stats["streams"] == 1
        assert d2.replay_stats["streams-resumed"] == 1
        doc = d2.stream_status(sid)
        assert doc["state"] == "open" and doc["ops"] == 100
        for i in range(5, len(c)):
            assert d2.stream_append(sid, {"seq": i, "ops": c[i]})[0] == 202
        assert d2.stream_close(sid, {"chunks": len(c)})[0] == 200
        same_as_offline(wait_stream(d2, sid)["result"], ops)
    finally:
        d2.stop()
    # a third incarnation registers the finished stream read-only
    d3 = daemon(tmp_path)
    try:
        assert d3.stream_status(sid)["state"] == "done"
        assert d3.replay_stats["streams-resumed"] == 0
    finally:
        d3.stop()


def test_a_stream_and_checks_of_its_bucket_interleave(tmp_path):
    """Between a stream's chunks, requests of the bucket its search runs
    in use the engine's buffers for the same shape: both the stream and
    the requests equal their offline checks."""
    ops = _conc_ops(240, 34)
    others = [_conc_ops(200, 340 + i) for i in range(4)]
    d = daemon(tmp_path, batch_enabled=False)
    try:
        sid = d.stream_open({"model": "cas-register"})[1]["id"]
        rids = []
        chunks = _chunks(ops, 24)
        for i, ch in enumerate(chunks):
            assert d.stream_append(sid, {"seq": i, "ops": ch})[0] == 202
            if i % 3 == 1:
                code, body, _ = d.submit({"model": "cas-register",
                                          "history": others[i // 3]})
                assert code == 202
                rids.append((body["id"], others[i // 3]))
        assert d.stream_close(sid, {"chunks": len(chunks)})[0] == 200
        same_as_offline(wait_stream(d, sid)["result"], ops)
        for rid, h in rids:
            deadline = time.monotonic() + 60
            while d.status(rid)["state"] != "done":
                assert time.monotonic() < deadline
                time.sleep(0.02)
            got, want = d.status(rid)["result"], offline(h)
            for k in VERDICT + ("levels",):
                assert got.get(k) == want.get(k), k
    finally:
        d.stop()


def test_drain_waits_for_sealed_streams_and_keeps_open_ones(tmp_path):
    d = daemon(tmp_path)
    try:
        open_sid = d.stream_open({"model": "cas-register"})[1]["id"]
        sealed = stream_all(d, _conc_ops(120, 35), 30)
        out = d.drain(timeout_s=60)
        assert out["drained"] is True
        assert d.stream_status(sealed)["state"] == "done"
        assert d.stream_status(open_sid)["state"] == "open"
        assert d.stream_open({"model": "cas-register"})[0] == 503
        assert d.stream_append(open_sid, {"seq": 0, "ops": []})[0] == 503
    finally:
        d.stop()


# ---------------------------------------------------------------------------
# HTTP and the client
# ---------------------------------------------------------------------------


def call(port, method, path, doc=None, token=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if doc is None else json.dumps(doc).encode())
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_the_routes_over_http_behind_the_token(tmp_path):
    ops = _conc_ops(120, 41)
    c = _chunks(ops, 30)
    cfg = SV.ServeConfig(root=str(tmp_path / "serve"), device="cpu",
                         auth_token="sekrit")
    d, server = SV.run_daemon(cfg, port=0)
    port = server.server_port
    try:
        assert call(port, "POST", "/stream", {})[0] == 401
        code, body = call(port, "POST", "/stream",
                          {"model": "cas-register"}, "sekrit")
        assert code == 202
        sid = body["id"]
        for i, ch in enumerate(c):
            code, body = call(port, "POST", f"/stream/{sid}/ops",
                              {"seq": i, "ops": ch,
                               "crc": S.chunk_crc(ch)}, "sekrit")
            assert code == 202, body
        code, body = call(port, "POST", f"/stream/{sid}/ops",
                          {"seq": 500, "ops": []}, "sekrit")
        assert code == 409 and body["need"] == len(c)
        assert call(port, "POST", f"/stream/{sid}/nope", {},
                    "sekrit")[0] == 404
        assert call(port, "POST", "/stream/nope/ops", {"seq": 0, "ops": []},
                    "sekrit")[0] == 404
        code, body = call(port, "POST", f"/stream/{sid}/close",
                          {"chunks": len(c)}, "sekrit")
        assert code == 200
        deadline = time.monotonic() + 60
        while True:
            code, doc = call(port, "GET", f"/stream/{sid}")
            if doc["state"] == "done" and doc.get("result"):
                break
            assert time.monotonic() < deadline
            time.sleep(0.02)
        same_as_offline(doc["result"], ops)
        assert call(port, "GET", "/stream/nope")[0] == 404
        assert call(port, "GET", "/healthz")[1]["streams"]["done"] == 1
    finally:
        server.shutdown()
        server.server_close()
        d.stop()


def test_the_stream_client_against_a_daemon_on_port_0(tmp_path):
    ops = _conc_ops(160, 42)
    bad = _conc_ops(160, 43, corrupt_at=2)
    d, server = SV.run_daemon(SV.ServeConfig(
        root=str(tmp_path / "serve"), device="cpu"), port=0)
    port = server.server_port
    try:
        runs = {}
        for name, h, fmt in (("good", ops, "array"), ("bad", bad, "lines")):
            path = tmp_path / f"{name}.json"
            path.write_text(json.dumps(h) if fmt == "array"
                            else "\n".join(json.dumps(o) for o in h))
            runs[name] = subprocess.run(
                [sys.executable, "-m", "jepsen_tpu_torch", "stream",
                 "--history", str(path), "--url",
                 f"http://127.0.0.1:{port}", "--chunk", "40", "--poll",
                 "0.05", "--timeout", "120"],
                cwd=ROOT, capture_output=True, text=True, timeout=180)
        good, badrun = runs["good"], runs["bad"]
        assert good.returncode == 0, good.stdout + good.stderr
        assert good.stdout.startswith("# stream: s")
        result = json.loads(good.stdout.split("\n", 1)[1])
        same_as_offline(result, ops)
        assert result["stream"]["chunks"] == len(_chunks(ops, 40))
        assert badrun.returncode == 1, badrun.stdout + badrun.stderr
        assert '"valid": false' in badrun.stdout
        empty = tmp_path / "empty.json"
        empty.write_text("[]")
        rc = subprocess.run(
            [sys.executable, "-m", "jepsen_tpu_torch", "stream",
             "--history", str(empty), "--url", f"http://127.0.0.1:{port}"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert rc.returncode == 254
    finally:
        server.shutdown()
        server.server_close()
        d.stop()


# ---------------------------------------------------------------------------
# The kill switch
# ---------------------------------------------------------------------------


def test_streaming_off_leaves_no_route_directory_or_key(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("JTPU_SERVE_STREAM", "0")
    cfg = SV.ServeConfig(root=str(tmp_path / "serve"), device="cpu",
                         stream_enabled=True)
    assert cfg.stream_on is False
    d, server = SV.run_daemon(cfg, port=0)
    try:
        assert d._streams is None
        assert "streams" not in d.healthz()
        port = server.server_port
        assert call(port, "POST", "/stream", {"model": "cas-register"})[0] \
            == 404
        assert call(port, "GET", "/stream/s1")[0] == 404
        assert not os.path.isdir(os.path.join(cfg.root, "streams"))
    finally:
        server.shutdown()
        server.server_close()
        d.stop()
    monkeypatch.setenv("JTPU_SERVE_STREAM", "1")
    assert SV.ServeConfig(stream_enabled=False).stream_on is False
    assert SV.ServeConfig().stream_on is True


def test_streaming_off_never_imports_the_stream_module(tmp_path):
    code = (
        "import sys\n"
        "from jepsen_tpu_torch import serve\n"
        "d = serve.CheckDaemon(serve.ServeConfig(root=%r, device='cpu'))\n"
        "d.start(); d.healthz(); d.stop()\n"
        "assert 'jepsen_tpu_torch.stream' not in sys.modules\n"
        "assert d._streams is None\n") % str(tmp_path / "serve")
    env = {**os.environ, "JTPU_SERVE_STREAM": "0"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert not os.path.isdir(tmp_path / "serve" / "streams")
