"""Fleet-backed serving in the port (``serve --fleet``), on the CPU.

The check daemon's ``FleetPlacer`` splits each gang's lanes over fleet
hosts (in-process ``LocalHost``s on the CPU here, and in one case two
worker processes); a host killed mid-gang re-meshes the next round onto
the survivor and loses no verdict; with every host gone the lanes re-run
serially and the flight recorder dumps ``all-hosts-lost``. Every verdict
equals the offline check's, and ``check_packed_gang_fleet`` equals the
reference's on the same histories. ``JTPU_SERVE_FLEET=0`` leaves the
single-host daemon as it is. The federation plane (frame exporters, the
federator, the straggler detector, ``/trace/find``) against the
reference's.

Tolerance: none (integer state).
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from jepsen_tpu import fleet as jfleet
from jepsen_tpu.checker import tpu as T
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.models import CASRegister as JCASRegister
from jepsen_tpu.obs import straggler as jstraggler
from jepsen_tpu.ops.encode import pack_with_init as jpack

from jepsen_tpu_torch import fleet
from jepsen_tpu_torch import serve as S
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.obs import straggler
from jepsen_tpu_torch.ops.encode import pack_with_init

from test_torch_gang import conc_ops
from test_torch_serve import VERDICT, daemon, offline, wait_done

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)


def _fleet_daemon(tmp_path, hosts=2, **cfg):
    cfg.setdefault("fleet_hosts", hosts)
    cfg.setdefault("fleet_backend", "local")
    cfg.setdefault("batch_wait_ms", 150.0)
    cfg.setdefault("workers", 1)
    return daemon(tmp_path, **cfg)


def _burst(d, histories, tenants=("t0", "t1", "t2")):
    rids = []
    for i, ops in enumerate(histories):
        code, body, _ = d.submit({"model": "cas-register", "history": ops,
                                  "tenant": tenants[i % len(tenants)]})
        assert code == 202, body
        rids.append(body["id"])
    return rids


def _assert_offline(d, rids, histories):
    for ops, rid in zip(histories, rids):
        doc = wait_done(d, rid)
        want = offline(ops)
        for key in VERDICT:
            assert doc["result"].get(key) == want.get(key), (key, doc)


def _packs(histories):
    pks, jpks = [], []
    for ops in histories:
        p, kernel = pack_with_init(History.of(ops), CASRegister())
        jp, jk = jpack(JHistory.of(ops), JCASRegister())
        pks.append(p)
        jpks.append(jp)
    return pks, kernel, jpks, jk


def _histories(seed, n=3, ops=24):
    return [conc_ops(ops, seed + i, 60 * i) for i in range(n)]


# ---------------------------------------------------------------------------
# The placer
# ---------------------------------------------------------------------------


def test_gang_over_fleet_matches_offline(tmp_path):
    histories = _histories(3)
    d = _fleet_daemon(tmp_path).start()
    try:
        assert d.placer is not None and d.placer.live() == 2
        rids = _burst(d, histories)
        _assert_offline(d, rids, histories)
        assert d.placer.stats["gangs"] >= 1
        assert d.placer.stats["rounds"] >= 1
        hz = d.healthz()
        assert hz["fleet"]["hosts"] == 2 and hz["fleet"]["live"] == 2
        assert hz["fleet"]["backend"] == "local"
        for key in ("remeshes", "host-losses", "dcn-retries"):
            assert hz["fleet"][key] == 0
        from jepsen_tpu_torch.obs import metrics
        text = metrics.REGISTRY.to_prometheus()
        assert "jtpu_serve_fleet_live 2" in text
        assert "jtpu_serve_fleet_remesh_total" in text
    finally:
        d.stop()


def test_a_single_request_routes_through_the_fleet(tmp_path):
    d = _fleet_daemon(tmp_path).start()
    try:
        code, body, _ = d.submit({"model": "cas-register",
                                  "history": conc_ops(12, 5)})
        assert code == 202
        assert wait_done(d, body["id"])["result"]["valid"] is True
        assert d.placer.stats["gangs"] == 1
    finally:
        d.stop()


def test_host_kill_mid_gang_loses_no_verdict(tmp_path, monkeypatch):
    monkeypatch.setenv("JTPU_SEGMENT_ITERS", "2")
    histories = _histories(11)
    d = _fleet_daemon(tmp_path)
    killed = []

    def kill_second(round_idx, hosts):
        if not killed:
            hosts[-1].kill()
            killed.append(round_idx)

    d.placer.on_round = kill_second
    d.start()
    try:
        rids = _burst(d, histories)
        _assert_offline(d, rids, histories)
        assert killed and d.placer.live() == 1
        assert d.placer.stats["host-losses"] >= 1
        assert d.placer.stats["remeshes"] >= 1
        assert d.stats["poisoned"] == 0
        snap = d.breaker.snapshot()
        assert all(r["fails"] == 0 and r["state"] == "closed"
                   for r in snap.values()), snap
    finally:
        d.stop()


def test_all_hosts_lost_fails_over_to_serial(tmp_path, monkeypatch):
    monkeypatch.setenv("JTPU_SEGMENT_ITERS", "2")
    histories = _histories(21, n=2)
    d = _fleet_daemon(tmp_path)

    def kill_all(round_idx, hosts):
        for h in hosts:
            h.kill()

    d.placer.on_round = kill_all
    d.start()
    try:
        rids = _burst(d, histories)
        _assert_offline(d, rids, histories)
        assert d.placer.live() == 0 and d.stats["poisoned"] == 0
        assert all(r["fails"] == 0 for r in d.breaker.snapshot().values())
        dumps = os.listdir(os.path.join(d.config.root, "flightrec"))
        assert any("all-hosts-lost" in n for n in dumps), dumps
    finally:
        d.stop()


def test_dcn_blip_is_retried_without_breaker_impact(tmp_path):
    d = _fleet_daemon(tmp_path).start()
    try:
        blipped = []

        def blip_once(ctx):
            if not blipped:
                blipped.append(ctx)
                raise RuntimeError(
                    "connection reset by peer (injected DCN blip)")

        d.placer.hosts[0].chaos = blip_once
        ops = conc_ops(12, 6)
        code, body, _ = d.submit({"model": "cas-register", "history": ops})
        assert code == 202
        _assert_offline(d, [body["id"]], [ops])
        assert blipped and d.placer.stats["dcn-retries"] >= 1
        assert d.placer.stats["host-losses"] == 0
        assert all(r["fails"] == 0 for r in d.breaker.snapshot().values())
    finally:
        d.stop()


def test_drain_with_a_fleet_gang_in_flight(tmp_path, monkeypatch):
    monkeypatch.setenv("JTPU_SEGMENT_ITERS", "2")
    histories = _histories(51, n=2)
    d = _fleet_daemon(tmp_path, queue_max=8)
    gate = threading.Event()
    killed = []

    def slow_then_kill(round_idx, hosts):
        gate.set()
        if not killed:
            killed.append(round_idx)
            hosts[-1].kill()
        time.sleep(0.05)

    d.placer.on_round = slow_then_kill
    d.start()
    try:
        rids = _burst(d, histories)
        assert gate.wait(20.0)
        code, body, _ = d.submit({"model": "cas-register",
                                  "history": conc_ops(8, 9),
                                  "tenant": "late"})
        assert code == 202
        late = body["id"]
        out = d.drain(timeout_s=60.0)
        assert out["drained"] and out["inflight-remaining"] == 0
        _assert_offline(d, rids, histories)
        assert d.status(late)["state"] == "queued"
        pending, _ = S.RequestJournal.replay(d.journal.path)
        assert [p["id"] for p in pending] == [late]
    finally:
        d.stop()


def test_switch_off_is_the_single_host_daemon(tmp_path, monkeypatch):
    monkeypatch.setenv("JTPU_SERVE_FLEET", "0")
    d = _fleet_daemon(tmp_path / "off", hosts=2)
    assert d.config.fleet_enabled is False and d.placer is None
    d.stop()
    monkeypatch.delenv("JTPU_SERVE_FLEET")
    d = daemon(tmp_path, start=True, workers=1)
    try:
        assert d.placer is None and d._fleet_width() == 1
        ops = conc_ops(12, 7)
        code, body, _ = d.submit({"model": "cas-register", "history": ops})
        _assert_offline(d, [body["id"]], [ops])
        assert "fleet" not in d.healthz()
        d._publish(force=True)
        with open(os.path.join(d.config.root, S.PROGRESS_NAME)) as f:
            prog = json.load(f)
        for key in ("fleet-hosts", "fleet-live", "remeshes",
                    "straggler-hosts"):
            assert key not in prog["serve"]
        assert not [p for p in os.listdir(d.config.root)
                    if p.startswith("fleet-host-")]
    finally:
        d.stop()


def test_progress_and_watch_line_carry_the_fleet(tmp_path):
    from jepsen_tpu_torch.obs import observatory
    d = _fleet_daemon(tmp_path).start()
    try:
        d.placer.stats["remeshes"] = 3
        d._publish(force=True)
        p = observatory.read_progress(d.config.root)
        assert p["serve"]["fleet-hosts"] == 2
        assert p["serve"]["fleet-live"] == 2
        line = observatory.format_status(p)
        assert "fleet 2/2 host(s)" in line and "remesh 3" in line
    finally:
        d.stop()


# ---------------------------------------------------------------------------
# The gang ladder on fleet hosts against the reference's
# ---------------------------------------------------------------------------


def test_gang_fleet_matches_reference_and_the_local_gang():
    histories = _histories(31, n=3)
    pks, kernel, jpks, jk = _packs(histories)
    h0 = fleet.LocalHost("h0", device="cpu")
    h1 = fleet.LocalHost("h1", device="cpu")
    j0, j1 = jfleet.LocalHost("h0"), jfleet.LocalHost("h1")

    def lost(ctx):
        raise fleet.HostLostError("host h1 is gone")

    def jlost(ctx):
        raise jfleet.HostLostError("host h1 is gone")

    h1.chaos, j1.chaos = lost, jlost
    for h in (h0, h1, j0, j1):
        h.start(None, None)
    stats, trail, jstats, jtrail = {}, [], {}, []
    got = G.check_packed_gang_fleet(pks, kernel, [h0, h1], stats=stats,
                                    trail=trail, device="cpu")
    want = T.check_packed_gang_fleet(jpks, jk, [j0, j1], stats=jstats,
                                     trail=jtrail)
    local = G.check_packed_gang_gpu(pks, kernel, device="cpu")
    for g, w, loc in zip(got, want, local):
        for key in VERDICT + ("rung", "crash-width", "gang-size"):
            assert g.get(key) == w.get(key), (key, g, w)
            assert g.get(key) == loc.get(key), (key, g, loc)
        assert g["fleet"] is True
    assert stats == jstats and stats["host-losses"] >= 1
    assert [e["event"] for e in trail] == [e["event"] for e in jtrail]


def test_gang_fleet_all_hosts_lost_and_poison():
    histories = _histories(41, n=2)
    pks, kernel, _, _ = _packs(histories)
    h0 = fleet.LocalHost("h0", device="cpu")
    h0.start(None, None)
    h0.kill()
    out = G.check_packed_gang_fleet(pks, kernel, [h0], device="cpu")
    assert all(r["fleet-lost"] and r["error"] == "all fleet hosts lost"
               for r in out)
    assert out[0] == G._fleet_lost_result(0)
    h1 = fleet.LocalHost("h1", device="cpu")

    def oom(ctx):
        raise RuntimeError("CUDA out of memory: injected")

    h1.chaos = oom
    h1.start(None, None)
    with pytest.raises(RuntimeError, match="out of memory"):
        G.check_packed_gang_fleet(pks, kernel, [h1], device="cpu")


# ---------------------------------------------------------------------------
# Worker processes behind the daemon
# ---------------------------------------------------------------------------


def test_worker_killed_mid_gang_under_the_proc_backend(tmp_path,
                                                        monkeypatch):
    """Two worker processes; host-1 sleeps before each segment, and is
    SIGKILLed in its first: every verdict is the offline one, healthz
    shows one live host."""
    monkeypatch.setenv("JTPU_CHAOS_SLOW_HOST", "fleet-host-1:1.0")
    histories = _histories(61, n=4)
    d = _fleet_daemon(tmp_path, fleet_backend="proc", batch_wait_ms=500.0)
    d.start()
    try:
        rids = _burst(d, histories)
        hb_dir = os.path.join(d.config.root, "fleet-host-1")
        deadline = time.monotonic() + 60
        while True:
            hb = fleet.read_heartbeat(hb_dir) or {}
            if hb.get("state") == "segment":
                os.kill(int(hb["pid"]), signal.SIGKILL)
                break
            assert time.monotonic() < deadline, "no segment on host-1"
            time.sleep(0.02)
        _assert_offline(d, rids, histories)
        hz = d.healthz()["fleet"]
        assert hz["live"] == 1 and hz["host-losses"] >= 1
        assert hz["backend"] == "proc"
    finally:
        d.stop()


# ---------------------------------------------------------------------------
# The federation plane
# ---------------------------------------------------------------------------


def test_straggler_detector_matches_reference():
    got, want = straggler.StragglerDetector(), jstraggler.StragglerDetector()
    feed = [("a", 0.1), ("b", 0.11), ("c", 0.5)] * 6 + [("c", 0.6)]
    for host, secs in feed:
        got.observe_segment(host, secs)
        want.observe_segment(host, secs)
    got.observe_heartbeat("b", 3.0)
    want.observe_heartbeat("b", 3.0)
    assert got.scores() == want.scores()
    assert got.flagged() == want.flagged() and got.flagged()
    assert got.poll_new() == want.poll_new()


def test_federation_frames_reach_the_daemon(tmp_path, monkeypatch):
    """Local hosts' frame exporters write telemetry.frames, the
    federator folds them into the time series with host labels on the
    sampler's tick, and GET /trace/find answers from the files."""
    import urllib.request
    monkeypatch.setenv("JTPU_FED_CADENCE", "0.1")
    cfg = S.ServeConfig(root=str(tmp_path / "serve"), device="cpu",
                        fleet_hosts=2, fleet_backend="local", workers=1,
                        batch_wait_ms=150.0, tsdb_cadence_s=0.1,
                        federate_cadence_s=0.1)
    d, server = S.run_daemon(cfg, host="127.0.0.1", port=0,
                             store_root=str(tmp_path))
    try:
        assert d.federator is not None and d.straggler is not None
        ops = conc_ops(12, 8)
        code, body, _ = d.submit({"model": "cas-register", "history": ops,
                                  "tenant": "t9"})
        _assert_offline(d, [body["id"]], [ops])
        frames = os.path.join(d.config.root, "fleet-host-0",
                              "telemetry.frames")
        deadline = time.monotonic() + 20
        while not (os.path.exists(frames) and d.federator.hosts()):
            assert time.monotonic() < deadline, "no frame federated"
            time.sleep(0.05)
        assert "last_seen_age_s" in d.healthz()["fleet"]
        port = server.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/trace/find?tenant=t9"
                f"&format=json", timeout=30) as resp:
            rows = json.loads(resp.read())["requests"]
        assert [r["tenant"] for r in rows] == ["t9"]
    finally:
        server.shutdown()
        server.server_close()
        d.stop()
