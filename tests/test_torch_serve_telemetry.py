"""The port's daemon telemetry, held against the JAX package's daemon.

Both daemons (the port's on ``device="cpu"``, the reference's on JAX's
CPU) take the same requests over HTTP: four histories from three
tenants, then a stream opened with a ``traceparent``. Their ``/usage``
totals (requests, ops and lane share; the device seconds are timings
and the bytes each package's own footprint model), the key sets of
``progress.json`` before and during the stream, ``/slo``'s objectives
and the usage fold of the WAL are equal, and each daemon's live totals
equal ``usage --json`` over its WAL, before and after a restart. Under
``JTPU_TSDB=0`` the port's routes, healthz keys and metric families are
the ones it had without the telemetry, and its ``done`` records carry
the reference's fields. A breaker trip and a drain write flight-recorder
dumps, ``serve``'s SIGTERM another; ``JTPU_SERVE_BATCH_VERIFY=1`` holds a
gang to its serial re-runs. The ``usage``, ``flightrec`` and ``top``
commands print what the reference's print on the same directory.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from jepsen_tpu import cli as ref_cli
from jepsen_tpu import serve as ref_serve
from jepsen_tpu.obs import usage as ref_usage
from jepsen_tpu_torch import journal as journal_ns
from jepsen_tpu_torch import serve as port_serve
from jepsen_tpu_torch import stream as S
from jepsen_tpu_torch.__main__ import main as port_main
from jepsen_tpu_torch.obs import flightrec as flightrec_ns
from jepsen_tpu_torch.obs import metrics as obs_metrics
from jepsen_tpu_torch.obs import trace as obs_trace
from jepsen_tpu_torch.obs import tsdb as tsdb_ns
from jepsen_tpu_torch.obs import usage as usage_ns

from test_torch_gang import bad_read, conc_ops
from test_torch_serve import daemon as port_daemon
from test_torch_serve import restarted, wait_done

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
TRACEPARENT = f"00-{TRACE}-00f067aa0ba902b7-01"
REQUESTS = [("a", conc_ops(24, 11)), ("b", conc_ops(30, 12)),
            ("a", bad_read(conc_ops(24, 13))), ("c", conc_ops(16, 14))]
STREAM = conc_ops(40, 15)


def http(port, method, path, doc=None, headers=None):
    """(status, body bytes, headers) of one call."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if doc is None else json.dumps(doc).encode(),
        headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def http_json(port, method, path, doc=None, headers=None):
    code, body, hdrs = http(port, method, path, doc, headers)
    return code, json.loads(body), hdrs


def _config(pkg, root, **kw):
    if pkg == "ref":
        return ref_serve.ServeConfig(root=root, backend="tpu", **kw)
    return port_serve.ServeConfig(root=root, device="cpu", **kw)


def _progress(root):
    with open(os.path.join(root, "progress.json")) as f:
        return json.load(f)


def _drive(pkg, root):
    """One daemon through the requests and the stream; what it said."""
    ns = ref_serve if pkg == "ref" else port_serve
    d, server = ns.run_daemon(_config(pkg, root, batch_enabled=False,
                                      tsdb_cadence_s=0.1),
                              host="127.0.0.1", port=0,
                              store_root=os.path.dirname(root))
    port = server.server_port
    out = {"root": root}
    try:
        ids = []
        for tenant, ops in REQUESTS:
            code, body, _ = http_json(port, "POST", "/check",
                                      {"tenant": tenant,
                                       "model": "cas-register",
                                       "history": ops})
            assert code == 202, body
            ids.append(body["id"])
        for rid in ids:
            wait_done(d, rid, timeout=120)
        d._publish(force=True)
        out["progress"] = _progress(root)
        out["usage"] = http_json(port, "GET", "/usage")[1]
        out["usage_a"] = http_json(port, "GET", "/usage?tenant=a")[1]
        out["slo"] = http_json(port, "GET", "/slo")[1]
        out["healthz"] = http_json(port, "GET", "/healthz")[1]
        code, body, hdrs = http_json(port, "POST", "/stream",
                                     {"tenant": "s",
                                      "model": "cas-register"},
                                     {"traceparent": TRACEPARENT})
        assert code == 202, body
        sid = out["sid"] = body["id"]
        out["open"] = (body, hdrs.get("traceparent"))
        code, _, _ = http_json(port, "POST", f"/stream/{sid}/ops",
                               {"seq": 0, "ops": STREAM})
        assert code == 202
        d._publish(force=True)
        out["progress_stream"] = _progress(root)
        assert http_json(port, "POST", f"/stream/{sid}/close",
                         {"chunks": 1})[0] == 200
        deadline = time.monotonic() + 120
        while True:
            code, doc, hdrs = http_json(port, "GET", f"/stream/{sid}")
            if doc["state"] == "done":
                break
            assert time.monotonic() < deadline, doc
            time.sleep(0.05)
        out["stream"] = (doc, hdrs.get("traceparent"))
        out["drain"] = http_json(port, "POST", "/drain")[1]
        out["flightrec"] = http_json(port, "GET",
                                     "/flightrec?format=json")[1]
        out["live_usage"] = d.usage.totals()
    finally:
        server.shutdown()
        server.server_close()
        d.stop()
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    out = {}
    for pkg in ("ref", "port"):
        root = str(tmp_path_factory.mktemp(pkg) / "serve")
        out[pkg] = _drive(pkg, root)
    return out


def _shares(doc):
    """The usage fields the two packages must share exactly."""
    keep = ("requests", "ops", "lane-share")
    return ({t: {k: u[k] for k in keep} for t, u in doc["tenants"].items()},
            {k: doc["total"][k] for k in keep})


def test_the_usage_totals_equal_the_reference(pair):
    for key in ("usage", "usage_a"):
        assert _shares(pair["port"][key]) == _shares(pair["ref"][key])
    doc = pair["port"]["usage"]
    assert doc["tenants"]["a"]["requests"] == 2
    assert doc["total"]["ops"] == sum(len(o) for _, o in REQUESTS)
    assert all(u["device-s"] > 0 for u in doc["tenants"].values())
    assert sorted(pair["port"]["usage_a"]["tenants"]) == ["a"]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_the_live_totals_equal_the_wal_fold(pair, pkg):
    wal = os.path.join(pair[pkg]["root"], port_serve.WAL_NAME)
    live = pair[pkg]["live_usage"]
    assert live == usage_ns.from_wal(wal) == ref_usage.from_wal(wal)
    assert live == pair[pkg]["usage"]


def test_a_restarted_daemon_replays_the_meter(pair):
    root = pair["port"]["root"]
    d = port_serve.CheckDaemon(_config("port", root))
    d.start()
    try:
        assert d.usage.totals() == pair["port"]["live_usage"]
        assert d.tsdb.resumed_records > 0
    finally:
        d.stop()


def test_the_heartbeat_has_the_references_keys(pair):
    for key in ("progress", "progress_stream"):
        doc, rdoc = pair["port"][key], pair["ref"][key]
        assert set(doc) == set(rdoc) == {"state", "ts", "serve"}
        assert list(doc["serve"]) == list(rdoc["serve"]), key
    before, during = (pair["port"]["progress"]["serve"],
                      pair["port"]["progress_stream"]["serve"])
    assert "streams" not in before and during["streams"] == 1
    assert during["stream-ops"] == len(STREAM)
    assert before["completed"] == len(REQUESTS)
    assert before["usage-top"][0] in ("a", "b", "c")
    assert set(before["slo"]) == {"breached", "max-burn"}


def test_the_slo_document_equals_the_reference(pair):
    doc, rdoc = pair["port"]["slo"], pair["ref"]["slo"]
    assert set(doc) == set(rdoc)
    assert doc["windows"] == rdoc["windows"]
    assert doc["burn-threshold"] == rdoc["burn-threshold"]
    shape = {n: {k: v for k, v in o.items()
                 if k not in ("windows", "answered", "breached")}
             for n, o in doc["objectives"].items()}
    rshape = {n: {k: v for k, v in o.items()
                  if k not in ("windows", "answered", "breached")}
              for n, o in rdoc["objectives"].items()}
    assert shape == rshape and set(shape) == {
        "verdict-latency-p99", "queue-wait-p95", "availability"}
    assert "slo" in pair["port"]["healthz"]


def test_the_stream_keeps_its_trace_id(pair):
    for pkg in ("ref", "port"):
        body, tp = pair[pkg]["open"]
        assert body["trace"] == TRACE and TRACE in tp
        doc, tp = pair[pkg]["stream"]
        assert doc["trace"] == TRACE and TRACE in tp
    assert pair["port"]["stream"][0]["result"]["valid"] is True
    sdir = os.path.join(pair["port"]["root"], "streams",
                        pair["port"]["sid"])
    records, _ = journal_ns.read_json_records(
        os.path.join(sdir, S.WAL_NAME))
    rrecords, _ = journal_ns.read_json_records(os.path.join(
        pair["ref"]["root"], "streams", pair["ref"]["sid"], S.WAL_NAME))
    assert set(records[0]) == set(rrecords[0])
    assert records[0]["trace"] == TRACE
    again = S.StreamSession.replay(sdir, pair["port"]["root"])
    assert again.trace == TRACE and again.trace_parent == "00f067aa0ba902b7"
    again.stop_wal()
    # the runner's segments and the verdict ran under the stream's trace
    with open(os.path.join(pair["port"]["root"], "trace.jsonl")) as f:
        text = f.read()
    assert TRACE in text and "stream.verdict" in text


def test_drain_dumps_the_flight_recorder(pair):
    for pkg in ("ref", "port"):
        dumps = pair[pkg]["flightrec"]["dumps"]
        assert [d["reason"] for d in dumps] == ["drain"]
    doc = flightrec_ns.load_dump(pair["port"]["root"],
                                 pair["port"]["flightrec"]["dumps"][0]
                                 ["name"])
    assert doc["extra"] == {"was-queued": 0, "inflight-remaining": 0}
    assert doc["tsdb"]["series"] and doc["spans"]
    assert os.path.exists(os.path.join(pair["port"]["root"],
                                       tsdb_ns.TSDB_NAME))


@pytest.mark.parametrize("argv", [
    ["usage", "--json"], ["usage"], ["usage", "--tenant", "a", "--json"],
    ["flightrec", "--json"], ["usage", "--serve-dir", "/nonexistent"],
    ["flightrec", "nope.json"], ["flightrec", "../serve.wal", "--json"]])
def test_the_commands_print_the_references_output(pair, argv, capsys):
    argv = list(argv)
    if "--serve-dir" not in argv:
        argv += ["--serve-dir", pair["port"]["root"]]
    rc = port_main(argv)
    out = capsys.readouterr().out
    rrc = ref_cli.run(ref_cli.default_commands(), argv)
    rout = capsys.readouterr().out
    assert (rc, out) == (rrc, rout)


def test_flightrec_shows_a_dump_as_the_reference(pair, capsys):
    name = pair["port"]["flightrec"]["dumps"][0]["name"]
    for extra in ([], ["--json"]):
        argv = ["flightrec", name, "--serve-dir", pair["port"]["root"],
                *extra]
        assert port_main(argv) == 0
        out = capsys.readouterr().out
        assert ref_cli.run(ref_cli.default_commands(), argv) == 0
        assert out == capsys.readouterr().out
    assert port_main(["flightrec", "--serve-dir", pair["port"]["root"]]) \
        == 0
    assert "reason=drain" in capsys.readouterr().out


@pytest.mark.parametrize("target", ["serve", "run", "missing"])
def test_top_prints_the_references_screen(pair, target, tmp_path,
                                          capsys):
    if target == "serve":
        d = pair["port"]["root"]
    elif target == "run":
        d = str(tmp_path)
        with open(os.path.join(d, "progress.json"), "w") as f:
            json.dump({"state": "searching", "level": 7,
                       "level-budget": 90, "frontier-rows": 12,
                       "segments": 2, "ts": 1.0}, f)
    else:
        d = str(tmp_path / "none")
    argv = ["top", "--once", "--store", d]
    rc = port_main(argv)
    out = capsys.readouterr().out
    rrc = ref_cli.run(ref_cli.default_commands(), argv)
    rout = capsys.readouterr().out

    def strip(text):
        # the first line carries the wall clock
        return [ln for ln in text.splitlines() if " at " not in ln]
    assert rc == rrc and strip(out) == strip(rout)
    if target == "serve":
        assert "# top: state stopped | queue 0" in out
        assert "slo OK" in out and "top tenant" in out


# ---------------------------------------------------------------------------
# The kill switch
# ---------------------------------------------------------------------------

#: healthz's keys without the telemetry (the daemon before it)
HEALTHZ_KEYS = {"ok", "state", "uptime-s", "device", "queue-depth",
                "queue-max", "inflight", "workers", "oldest-inflight-s",
                "tenants", "tenant-max", "committed-bytes", "budget-bytes",
                "stats", "replay", "breakers", "engine", "streams"}


def test_jtpu_tsdb_0_leaves_the_daemon_without_telemetry(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("JTPU_TSDB", "0")
    types = {ln for ln in obs_metrics.REGISTRY.to_prometheus().splitlines()
             if ln.startswith("# TYPE ")}
    done_keys = {}
    for pkg in ("ref", "port"):
        cfg = _config(pkg, str(tmp_path / pkg / "serve"), tsdb_enabled=True)
        assert cfg.tsdb_on is False
        ns = ref_serve if pkg == "ref" else port_serve
        d, server = ns.run_daemon(cfg, host="127.0.0.1", port=0,
                                  store_root=str(tmp_path / pkg))
        port = server.server_port
        try:
            assert (d.tsdb, d.slo, d.usage, d.flightrec) == (None,) * 4
            code, body, _ = http_json(port, "POST", "/check",
                                      {"history": conc_ops(24, 21)})
            wait_done(d, body["id"], timeout=120)
            if pkg == "port":
                assert set(d.healthz()) == HEALTHZ_KEYS - {"streams"}
                for path in ("/usage", "/usage?tenant=a", "/slo",
                             "/flightrec", "/flightrec/x.json"):
                    assert http_json(port, "GET", path)[:2] == (
                        404, {"error": "not-found"}), path
            assert http(port, "POST", "/drain")[0] == 200
        finally:
            server.shutdown()
            server.server_close()
            d.stop()
        assert not os.path.exists(os.path.join(cfg.root, "metrics.tsdb"))
        assert not os.path.exists(os.path.join(cfg.root, "flightrec"))
        records, _ = journal_ns.read_json_records(
            os.path.join(cfg.root, port_serve.WAL_NAME))
        done_keys[pkg] = [set(r) for r in records
                          if r.get("event") == "done"]
    assert done_keys["port"] == done_keys["ref"] == [
        {"event", "id", "valid", "seconds"}]
    assert {ln for ln in obs_metrics.REGISTRY.to_prometheus().splitlines()
            if ln.startswith("# TYPE ")} == types


# ---------------------------------------------------------------------------
# Breaker trips, batch verify, request traces, SIGTERM
# ---------------------------------------------------------------------------


def test_a_breaker_trip_dumps_the_flight_recorder(tmp_path, monkeypatch):
    monkeypatch.setattr(
        port_serve.CheckDaemon, "_check",
        lambda self, req, deadline=None: {
            "valid": "unknown", "error": "CUDA out of memory (fake)",
            "error-class": "oom"})
    d = port_daemon(tmp_path, start=True, breaker_fails=1,
                    batch_enabled=False)
    try:
        code, body, _ = d.submit({"tenant": "boom", "model": "cas-register",
                                  "history": conc_ops(24, 31)})
        assert code == 202
        wait_done(d, body["id"])
        deadline = time.monotonic() + 30
        while not flightrec_ns.list_dumps(d.config.root):
            assert time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        d.stop()
    (dump,) = flightrec_ns.list_dumps(d.config.root)
    assert dump["reason"] == "breaker-trip"
    doc = flightrec_ns.load_dump(d.config.root, dump["name"])
    assert doc["extra"]["class"] == "oom" and doc["extra"]["bucket"]
    assert flightrec_ns.load_dump(d.config.root, "../serve.wal") is None


def test_same_reason_dumps_are_rate_limited(tmp_path):
    fr = flightrec_ns.FlightRecorder(str(tmp_path), seconds=60.0)
    assert fr.dump("flappy") is not None
    assert fr.dump("flappy") is None
    assert fr.dump("other") is not None
    # newest first by name: the reason leads the name
    assert [d["reason"] for d in flightrec_ns.list_dumps(str(tmp_path))
            ] == ["other", "flappy"]
    for name in ("../x.json", "a/b.json", "nope.txt", "missing.json"):
        assert flightrec_ns.load_dump(str(tmp_path), name) is None


@pytest.mark.parametrize("serial", ["agrees", "disagrees"])
def test_batch_verify_holds_a_gang_to_its_serial_reruns(serial, tmp_path,
                                                        monkeypatch):
    histories = [conc_ops(24, s, 100 * s) for s in range(40, 43)]
    calls = []
    check = port_serve.CheckDaemon._check

    def counted(self, req, deadline=None):
        calls.append(req.id)
        r = check(self, req, deadline)
        if serial == "disagrees":
            r = dict(r, levels=r["levels"] + 1)
        return r

    monkeypatch.setattr(port_serve.CheckDaemon, "_check", counted)
    monkeypatch.setenv("JTPU_SERVE_BATCH_VERIFY", "1")
    d, ids = restarted(tmp_path, histories)
    assert d.config.batch_verify
    try:
        results = {rid: wait_done(d, rid)["result"] for rid in ids}
    finally:
        d.stop()
    assert sorted(calls) == sorted(ids)
    for rid, r in results.items():
        assert r["serve"]["gang"]["size"] == 3
        assert r["valid"] is True
        if serial == "agrees":
            assert "batch-mismatch" not in r
        else:
            assert r["batch-mismatch"] == ["levels"]


def test_the_heartbeat_is_current_once_the_daemon_is_idle(tmp_path):
    """A gang's members finish within the heartbeat's 0.1 s throttle; the
    completion that leaves the daemon idle is published all the same."""
    histories = [conc_ops(24, s, 100 * s) for s in range(47, 51)]
    d, ids = restarted(tmp_path, histories)
    try:
        for rid in ids:
            wait_done(d, rid)
        with open(os.path.join(d.config.root, "progress.json")) as f:
            beat = json.load(f)["serve"]
    finally:
        d.stop()
    assert (beat["completed"], beat["inflight"], beat["queue-depth"],
            beat["oldest-inflight-s"]) == (len(ids), 0, 0, None)
    assert beat["max-batch"] == len(ids)


def test_a_gang_members_request_trace_page(tmp_path):
    histories = [conc_ops(24, s, 100 * s) for s in range(44, 46)]
    d, ids = restarted(tmp_path, histories)
    server = None
    try:
        for rid in ids:
            wait_done(d, rid)
        member = list(ids)[1]
        tid = d.status(member)["trace"]
        assert d.resolve_trace(member) == tid
        assert d.resolve_trace(tid.upper()) == tid
        assert d.resolve_trace("nope") is None
        from jepsen_tpu_torch import web
        server = web.serve(host="127.0.0.1", port=0,
                           root=str(tmp_path),
                           handler_cls=port_serve.make_handler(
                               d, root=str(tmp_path)))
        import threading
        threading.Thread(target=server.serve_forever, daemon=True).start()
        port = server.server_port
        code, body, _ = http(port, "GET", f"/trace/request/{member}")
        assert code == 200 and b"serve.gang.join" in body
        assert tid.encode() in body
        assert http(port, "GET", "/trace/request/nope")[0] == 404
        assert http(port, "GET", "/")[0] == 200
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        d.stop()
    # a journaled id resolves after a restart
    d2 = port_daemon(tmp_path, start=True)
    try:
        assert d2.resolve_trace(member) == tid
    finally:
        d2.stop()


def _listening(proc):
    line = proc.stdout.readline()
    assert line.startswith("Listening on http://127.0.0.1:"), line
    return int(line.split(":")[2].split("/")[0].split()[0])


def test_serve_without_the_daemon_is_the_browser(tmp_path):
    run = tmp_path / "store" / "t" / "20260730T000000.000"
    run.mkdir(parents=True)
    (run / "results.json").write_text('{"valid": true}')
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch", "serve", "--host",
         "127.0.0.1", "--port", "0", "--store-root",
         str(tmp_path / "store")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        port = _listening(proc)
        code, body, _ = http(port, "GET", "/")
        assert code == 200 and b"20260730T000000.000" in body
        assert http(port, "POST", "/check", {"history": []})[0] == 501
        assert http(port, "GET", "/healthz")[0] == 404
    finally:
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0


def test_sigterm_dumps_the_flight_recorder_and_exits_0(tmp_path, capsys):
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch", "serve",
         "--check-daemon", "--host", "127.0.0.1", "--port", "0",
         "--store-root", str(tmp_path), "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT,
                           JTPU_TSDB_CADENCE="0.2"),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        port = _listening(proc)
        code, body, _ = http_json(port, "POST", "/check",
                                  {"history": conc_ops(24, 51)})
        assert code == 202
        deadline = time.monotonic() + 60
        while http_json(port, "GET", f"/check/{body['id']}")[1][
                "state"] != "done":
            assert time.monotonic() < deadline
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    serve_dir = os.path.join(str(tmp_path), "serve")
    assert [d["reason"] for d in flightrec_ns.list_dumps(serve_dir)] == [
        "sigterm"]
    assert port_main(["flightrec", "--store-root", str(tmp_path)]) == 0
    assert "reason=sigterm" in capsys.readouterr().out
    assert port_main(["usage", "--store-root", str(tmp_path),
                      "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["total"]["requests"] == 1
    with open(os.path.join(serve_dir, "progress.json")) as f:
        assert json.load(f)["state"] == "stopped"
    records, _ = journal_ns.read_json_records(
        os.path.join(serve_dir, "metrics.tsdb"))
    assert sum(r.get("k") == "tick" for r in records) >= 2
    assert obs_trace.enabled()

