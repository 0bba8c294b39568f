"""The check daemon's telemetry on the CPU (``ServeConfig(device="cpu")``).

* ``GET /metrics`` on a daemon on port 0 serves the registry in
  Prometheus text: the daemon's ``jtpu_serve_*`` families with a trace-id
  exemplar on the latency histograms, and the ``jtpu_device_*``,
  ``jtpu_search_*`` and ``jtpu_engine_*`` families once a check ran.
* A request's trace id comes from its ``traceparent`` header, is
  journaled with it, answered in the 202's ``traceparent`` and kept by a
  daemon that replays it after a restart; ``GET /check/<id>`` carries the
  phase breakdown; the daemon's ``trace.jsonl`` holds its spans.
* Admission answers 429 ``headroom`` under an injected headroom gauge
  below ``headroom_min``; ``engine_headroom_min`` evicts warm buckets.
* ``JTPU_TRACE=0``: no trace id, phases or trace file.
"""

import json
import os
import time
import urllib.request

import pytest
import torch

from jepsen_tpu_torch import serve as S
from jepsen_tpu_torch.obs import devices as obs_devices
from jepsen_tpu_torch.obs import trace as obs_trace

from test_torch_gang import conc_ops

torch.set_num_threads(1)

TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
TRACEPARENT = f"00-{TRACE}-00f067aa0ba902b7-01"


def http(port, method, path, doc=None, headers=None):
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method,
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def wait_done(port, rid, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        code, body, hdrs = http(port, "GET", f"/check/{rid}")
        doc = json.loads(body)
        if doc.get("state") == "done":
            return doc, hdrs
        time.sleep(0.05)
    raise AssertionError(f"request {rid} never finished")


def start(tmp_path, **cfg):
    cfg.setdefault("root", str(tmp_path / "serve"))
    cfg.setdefault("device", "cpu")
    return S.run_daemon(S.ServeConfig(**cfg), port=0)


def stop(d, server):
    server.shutdown()
    server.server_close()
    d.stop()


def test_metrics_and_a_traced_request(tmp_path):
    d, server = start(tmp_path)
    port = server.server_port
    try:
        code, body, hdrs = http(port, "POST", "/check",
                                {"tenant": "a", "model": "cas-register",
                                 "history": conc_ops(40, 1)},
                                headers={"traceparent": TRACEPARENT})
        assert code == 202, body
        doc = json.loads(body)
        assert doc["trace"] == TRACE
        assert hdrs["traceparent"].startswith(f"00-{TRACE}-")
        res, rh = wait_done(port, doc["id"])
        assert res["trace"] == TRACE and rh["traceparent"].startswith(
            f"00-{TRACE}-")
        serve = res["result"]["serve"]
        assert serve["trace"] == TRACE
        ph = serve["phases"]
        assert set(ph) == {"queue_s", "coalesce_s", "compile_s",
                           "device_s", "verdict_s"}
        assert ph["compile_s"] + ph["device_s"] > 0
        assert res["result"]["valid"] is True
        code, body, hdrs = http(port, "GET", "/metrics")
        assert code == 200
        assert hdrs["Content-Type"].startswith("text/plain; version=0.0.4")
        text = body.decode()
        for fam in ("jtpu_serve_admitted_total", "jtpu_serve_queue_wait",
                    "jtpu_serve_request_seconds", "jtpu_device_call_seconds",
                    "jtpu_device_headroom_ratio", "jtpu_search_levels_total",
                    "jtpu_search_segments_total", "jtpu_engine_builds_total",
                    "jtpu_compile_cold_total"):
            assert f"# TYPE {fam}" in text, fam
        assert f'trace_id="{TRACE}"' in text
    finally:
        stop(d, server)
    recs, _ = obs_trace.read_trace(os.path.join(str(tmp_path / "serve"),
                                                obs_trace.TRACE_NAME))
    names = {r["name"] for r in recs if r.get("trace") == TRACE}
    assert {"serve.request", "checker.segment", "serve.verdict"} <= names


def test_the_trace_id_survives_a_restart(tmp_path):
    d1 = S.CheckDaemon(S.ServeConfig(root=str(tmp_path / "serve"),
                                     device="cpu"))
    code, body, _ = d1.submit({"tenant": "a", "model": "cas-register",
                               "history": conc_ops(30, 2),
                               "traceparent": TRACEPARENT})
    assert code == 202 and body["trace"] == TRACE
    rid = body["id"]
    d1.journal.close()         # dropped before it ran, as by a crash
    with open(os.path.join(str(tmp_path / "serve"), S.WAL_NAME), "rb") as f:
        assert TRACE.encode() in f.read()
    d2, server = start(tmp_path)
    try:
        res, hdrs = wait_done(server.server_port, rid)
        assert res["trace"] == TRACE
        assert res["result"]["serve"]["trace"] == TRACE
        assert hdrs["traceparent"].startswith(f"00-{TRACE}-")
    finally:
        stop(d2, server)


def test_low_headroom_refuses_admission_and_evicts(tmp_path, monkeypatch):
    d, server = start(tmp_path, headroom_min=0.2, engine_headroom_min=0.2)
    port = server.server_port
    try:
        # a device to read: the daemon's CPU device reports no headroom
        monkeypatch.setattr(obs_devices, "headroom_ratio",
                            lambda rows=None, device=None: 0.1)
        code, body, hdrs = http(port, "POST", "/check",
                                {"tenant": "a", "model": "cas-register",
                                 "history": conc_ops(20, 3)})
        assert code == 429, body
        doc = json.loads(body)
        assert doc["error"] == "headroom" and doc["headroom"] == 0.1
        assert int(hdrs["Retry-After"]) >= 1
        code, body, _ = http(port, "GET", "/metrics")
        assert 'jtpu_serve_rejected_total{reason="headroom"}' in \
            body.decode()
        monkeypatch.setattr(obs_devices, "headroom_ratio",
                            lambda rows=None, device=None: 0.9)
        ids = []
        for s in (4, 5):
            code, body, _ = http(port, "POST", "/check",
                                 {"tenant": "a", "model": "cas-register",
                                  "history": conc_ops(20 + 20 * s, s)})
            assert code == 202
            ids.append(json.loads(body)["id"])
            wait_done(port, ids[-1])
        assert len(d.engine.warm_buckets()) >= 2
        # pressure after the next request: the stalest buckets go
        before = d.engine.evictions
        monkeypatch.setattr(obs_devices, "headroom_ratio",
                            lambda rows=None, device=None: 0.1)
        d.engine.evict_below_headroom(d.config.engine_headroom_min)
        assert d.engine.evictions > before
        assert len(d.engine.warm_buckets()) == 1
    finally:
        stop(d, server)


def test_tracing_off_has_no_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("JTPU_TRACE", "0")
    d, server = start(tmp_path)
    port = server.server_port
    try:
        code, body, hdrs = http(port, "POST", "/check",
                                {"tenant": "a", "model": "cas-register",
                                 "history": conc_ops(30, 6)},
                                headers={"traceparent": TRACEPARENT})
        assert code == 202 and "traceparent" not in hdrs
        doc = json.loads(body)
        assert "trace" not in doc
        res, _ = wait_done(port, doc["id"])
        assert "trace" not in res["result"]["serve"]
        assert "phases" not in res["result"]["serve"]
    finally:
        stop(d, server)
    assert not os.path.exists(os.path.join(str(tmp_path / "serve"),
                                           obs_trace.TRACE_NAME))
