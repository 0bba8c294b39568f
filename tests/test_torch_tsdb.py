"""The port's time series and SLO engine, held against the JAX package's.

Both packages' :class:`TSDB`\\ s are fed the same fake clock and the same
metric updates, each through its own package's ``Registry``; the rings,
the windowed queries, the SLO engine's burn rates and transitions, the
resumed series after a torn tail and the compacted file must be equal
(exact equality: all of it is host arithmetic). The cases follow the
reference's own (``tests/test_tsdb.py``). The two packages also read each
other's ``metrics.tsdb``, and the SLO webhook posts the same transition
document to a local listener.
"""

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from jepsen_tpu import journal as ref_journal
from jepsen_tpu.obs import metrics as ref_metrics
from jepsen_tpu.obs import slo as ref_slo
from jepsen_tpu.obs import tsdb as ref_tsdb
from jepsen_tpu_torch import journal as port_journal
from jepsen_tpu_torch.obs import metrics as port_metrics
from jepsen_tpu_torch.obs import slo as port_slo
from jepsen_tpu_torch.obs import tsdb as port_tsdb

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

PACKAGES = {
    "ref": (ref_metrics, ref_tsdb, ref_slo, ref_journal),
    "port": (port_metrics, port_tsdb, port_slo, port_journal),
}


def _clock(start=1000.0):
    now = [float(start)]

    def fn():
        return now[0]

    fn.set = lambda t: now.__setitem__(0, float(t))
    fn.advance = lambda d: now.__setitem__(0, now[0] + d)
    return fn


def _both(scenario, tmp_path):
    """``scenario(metrics, tsdb, slo, journal, root)`` run once per
    package; returns {package: its output}."""
    out = {}
    for name, mods in PACKAGES.items():
        root = tmp_path / name
        root.mkdir()
        out[name] = scenario(*mods, str(root))
    return out


def _db(tsdb, root, clock, registry, resolutions=(("1s", 1.0, 8),),
        persist=False):
    return tsdb.TSDB(os.path.join(root, "tsdb"), cadence=999.0,
                     now_fn=clock, registry=registry,
                     resolutions=resolutions, persist=persist)


# ---------------------------------------------------------------------------
# Rings and queries
# ---------------------------------------------------------------------------


def _counter_downsample(metrics, tsdb, slo, journal, root):
    reg = metrics.Registry()
    c = reg.counter("jobs_total")
    clock = _clock(100.0)
    db = _db(tsdb, root, clock, reg,
             resolutions=(("1s", 1.0, 32), ("4s", 4.0, 32)))
    for i in range(8):
        c.inc(2 + i % 3, tenant="t%d" % (i % 2))
        db.sample_once()
        clock.advance(1.0)
    return {"fine": db.series("jobs_total", "1s", tenant="t0"),
            "coarse": db.series("jobs_total", "4s", tenant="t1"),
            "keys": db.series_keys("jobs_total"),
            "kind": db.kind("jobs_total"), "ticks": db.ticks,
            "delta": [db.window_delta("jobs_total", w)
                      for w in (1.0, 3.0, 10.0)],
            "delta_t1": db.window_delta("jobs_total", 10.0, tenant="t1"),
            "resolution": [db.resolution_for(w) for w in (5, 40, 1e9)]}


def _wraparound(metrics, tsdb, slo, journal, root):
    reg = metrics.Registry()
    c = reg.counter("spins_total")
    clock = _clock(0.0)
    db = _db(tsdb, root, clock, reg, resolutions=(("1s", 1.0, 4),))
    for _ in range(10):
        c.inc()
        db.sample_once()
        clock.advance(1.0)
    return db.series("spins_total")


def _gauge(metrics, tsdb, slo, journal, root):
    reg = metrics.Registry()
    g = reg.gauge("depth")
    clock = _clock(50.0)
    db = _db(tsdb, root, clock, reg, resolutions=(("10s", 10.0, 8),))
    for v, t in ((3, 50.0), (9, 51.0), (1, 62.0), (4, 75.5)):
        g.set(v)
        clock.set(t)
        db.sample_once()
    return {"series": db.series("depth", "10s"),
            "latest": db.latest("depth", "10s"),
            "recent": db.recent(30.0)}


def _histogram(metrics, tsdb, slo, journal, root):
    reg = metrics.Registry()
    h = reg.histogram("lat_s", buckets=(0.1, 1.0, 5.0))
    clock = _clock(200.0)
    db = _db(tsdb, root, clock, reg, resolutions=(("1s", 1.0, 64),))
    for i in range(9):
        h.observe(0.05 * (i + 1), tenant="a")
    h.observe(0.5, tenant="b")
    db.sample_once()
    clock.advance(2.0)
    h.observe(7.0, tenant="b")
    db.sample_once()
    return {"hist": db.window_hist("lat_s", 10.0),
            "hist_b": db.window_hist("lat_s", 10.0, tenant="b"),
            "q": [db.quantile("lat_s", q, 10.0)
                  for q in (0.5, 0.9, 0.99, 1.0)],
            "q_b": db.quantile("lat_s", 0.5, 10.0, tenant="b"),
            "empty": db.quantile("lat_s", 0.5, 10.0,
                                 now=clock() + 100.0),
            "bounds": db.bounds("lat_s"),
            "series": db.series("lat_s", tenant="a")}


def _reset(metrics, tsdb, slo, journal, root):
    reg = metrics.Registry()
    c = reg.counter("boots_total")
    h = reg.histogram("boot_s", buckets=(1.0,))
    clock = _clock(0.0)
    db = _db(tsdb, root, clock, reg, resolutions=(("1s", 1.0, 64),))
    c.inc(10)
    h.observe(0.5)
    h.observe(0.7)
    db.sample_once()
    reg.reset()
    reg.counter("boots_total").inc(2)
    reg.histogram("boot_s", buckets=(1.0,)).observe(3.0)
    clock.advance(1.0)
    db.sample_once()
    return {"c": db.series("boots_total"), "h": db.series("boot_s")}


def _ingest_external(metrics, tsdb, slo, journal, root):
    """The federation's entry point and its durable cursor, through a
    restart."""
    reg = metrics.Registry()
    clock = _clock(300.0)
    db = _db(tsdb, root, clock, reg, resolutions=(("1s", 1.0, 16),),
             persist=True)
    db.start()
    try:
        db.ingest_external(300.0, c={"fed_total": {'{host="h1"}': 4.0}},
                           g={"fed_depth": {'{host="h1"}': 2.0}},
                           h={"fed_s": {'{host="h1"}': [3, 0.6, [2, 1]]}},
                           hb={"fed_s": [0.5]}, src=["h1", "boot0", 7])
    finally:
        db.stop()
    db2 = _db(tsdb, root, _clock(400.0), metrics.Registry(),
              resolutions=(("1s", 1.0, 16),), persist=True)
    db2.resume()
    return {"c": db2.series("fed_total", host="h1"),
            "g": db2.series("fed_depth", host="h1"),
            "h": db2.series("fed_s", host="h1"),
            "q": db2.quantile("fed_s", 0.5, 10.0, now=300.5, host="h1"),
            "meta": db2.meta_view("fed")}


SCENARIOS = {"counter-downsample": _counter_downsample,
             "wraparound": _wraparound, "gauge": _gauge,
             "histogram": _histogram, "registry-reset": _reset,
             "ingest-external": _ingest_external}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_the_rings_and_queries_equal_the_reference(name, tmp_path):
    out = _both(SCENARIOS[name], tmp_path)
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# The segment file: resume, torn tail, compaction, across packages
# ---------------------------------------------------------------------------


def _ticks(metrics, tsdb, root, n=8):
    reg = metrics.Registry()
    c = reg.counter("work_total")
    h = reg.histogram("work_s", buckets=(0.1, 1.0))
    g = reg.gauge("work_depth")
    clock = _clock(100.0)
    db = _db(tsdb, root, clock, reg, resolutions=(("1s", 1.0, 32),),
             persist=True)
    db.start()
    try:
        for i in range(n):
            c.inc(2, tenant="a")
            h.observe(0.05 * i)
            g.set(i)
            db.sample_once()
            clock.advance(1.0)
        return db.series("work_total", tenant="a"), db.path
    finally:
        db.stop()


def _resumed(metrics, tsdb, path):
    db = tsdb.TSDB(os.path.dirname(path), cadence=999.0,
                   now_fn=_clock(200.0), registry=metrics.Registry(),
                   resolutions=(("1s", 1.0, 32),), persist=True)
    db.resume()
    return {"c": db.series("work_total", tenant="a"),
            "h": db.series("work_s"), "g": db.series("work_depth"),
            "kind": db.kind("work_s"), "bounds": db.bounds("work_s"),
            "records": db.resumed_records}


@pytest.mark.parametrize("tear", [0, 5, 40])
def test_the_resumed_series_after_a_torn_tail_equal(tear, tmp_path):
    def scenario(metrics, tsdb, slo, journal, root):
        pre, path = _ticks(metrics, tsdb, root)
        with open(path, "rb") as f:
            blob = f.read()
        if tear:
            with open(path, "wb") as f:
                f.write(blob[:-tear])
        got = _resumed(metrics, tsdb, path)
        # the torn record is the final sample's (stop()), which moves
        # only the gauge: the counter's series is the pre-kill one
        assert got["c"] == pre
        with open(path, "rb") as f:
            return got, f.read()
    out = _both(scenario, tmp_path)
    assert out["port"][0] == out["ref"][0]
    # the same records, whichever package wrote them, but for the tick
    # times' wall-clock-free fields: the files are equal byte for byte
    assert out["port"][1] == out["ref"][1]


@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")])
def test_each_package_resumes_the_others_file(writer, reader, tmp_path):
    wm, wt = PACKAGES[writer][:2]
    rm, rt = PACKAGES[reader][:2]
    _, path = _ticks(wm, wt, str(tmp_path))
    assert _resumed(rm, rt, path) == _resumed(wm, wt, path)


def test_compaction_equals_the_reference(tmp_path):
    def scenario(metrics, tsdb, slo, journal, root):
        reg = metrics.Registry()
        c = reg.counter("churn_total")
        clock = _clock(0.0)
        db = _db(tsdb, root, clock, reg, resolutions=(("1s", 1.0, 8),),
                 persist=True)
        db.start()
        try:
            for _ in range(tsdb.COMPACT_RECORDS + 5):
                c.inc()
                db.sample_once()
                clock.advance(1.0)
        finally:
            db.stop()
        records, stats = journal.read_json_records(db.path)
        db2 = _db(tsdb, root, clock, metrics.Registry(),
                  resolutions=(("1s", 1.0, 8),), persist=True)
        db2.resume()
        return (records, {k: stats.get(k) for k in ("torn", "corrupt")},
                db2.series("churn_total"), db.series("churn_total"))
    out = _both(scenario, tmp_path)
    assert out["port"] == out["ref"]
    records, stats, resumed, live = out["port"]
    assert records[0]["k"] == "ckpt" and not any(stats.values())
    assert len(records) < port_tsdb.COMPACT_RECORDS and resumed == live


# ---------------------------------------------------------------------------
# SLO engine
# ---------------------------------------------------------------------------


def _slo_run(metrics, tsdb, slo, journal, root, steps):
    reg = metrics.Registry()
    h = reg.histogram("req_s", buckets=(0.1, 1.0))
    c = reg.counter("bad_total")
    ok = reg.counter("good_total")
    clock = _clock(1000.0)
    db = _db(tsdb, root, clock, reg, resolutions=(("1s", 1.0, 120),))
    events = []
    objs = [slo.Objective("lat-p90", "latency", target=0.9, metric="req_s",
                          threshold=0.1),
            slo.Objective("avail", "availability", target=0.99,
                          bad_of=[("bad_total", {})],
                          good_of=[("good_total", {})])]
    eng = slo.SLOEngine(db, objectives=objs,
                        windows=(("2s", 2.0), ("60s", 60.0)),
                        burn_threshold=1.0, on_transition=events.append)
    snaps = [eng.evaluate()]
    for dt, slow, fast, bad, good in steps:
        clock.advance(dt)
        for i in range(slow):
            h.observe(0.5, tenant="hot" if i % 2 else "cold")
        for _ in range(fast):
            h.observe(0.05, tenant="cold")
        c.inc(bad, tenant="hot")
        ok.inc(good, tenant="cold")
        db.sample_once()
        snaps.append(eng.snapshot())
    gauge = metrics.REGISTRY.gauge("jtpu_slo_burn_rate")
    return {"snaps": snaps, "events": events, "breached": eng.breached(),
            "max_burn": eng.max_burn(),
            "gauge": {t: gauge.value(slo="lat-p90", tenant=t)
                      for t in ("all", "hot", "cold")}}


SLO_STEPS = {
    "breach-then-recover": [(0.0, 5, 0, 0, 0), (10.0, 0, 20, 0, 0)],
    "no-traffic": [],
    "availability": [(1.0, 0, 3, 1, 9), (1.0, 0, 3, 0, 50),
                     (30.0, 0, 1, 0, 5)],
    "mixed-tenants": [(0.5, 6, 2, 0, 1), (0.5, 1, 30, 2, 2),
                      (5.0, 0, 0, 0, 0)],
}


@pytest.mark.parametrize("name", sorted(SLO_STEPS))
def test_the_slo_burn_and_transitions_equal(name, tmp_path):
    out = _both(lambda *m: _slo_run(*m, SLO_STEPS[name]), tmp_path)
    for side in out.values():
        for ev in side["events"]:
            ev.pop("ts")        # the fake clock's, equal anyway
    assert out["port"] == out["ref"]
    if name == "breach-then-recover":
        assert [e["event"] for e in out["port"]["events"]] == [
            "slo.breach", "slo.recovered"]


def test_the_default_objectives_equal(monkeypatch):
    monkeypatch.setenv("JTPU_SLO_LATENCY_P99_S", "2.5")
    monkeypatch.setenv("JTPU_SLO_AVAILABILITY", "0.995")

    def doc(slo):
        return [(o.name, o.describe(), o.bad_of, o.good_of)
                for o in slo.default_objectives()]
    assert doc(port_slo) == doc(ref_slo)
    assert {o.name for o in port_slo.default_objectives()} == {
        "verdict-latency-p99", "queue-wait-p95", "availability"}


def test_the_env_knobs_equal(monkeypatch):
    for v in ("", "0", "off", "1", "yes"):
        monkeypatch.setenv("JTPU_TSDB", v)
        assert port_tsdb.enabled() == ref_tsdb.enabled()
    for v in ("", "0.05", "3", "x"):
        monkeypatch.setenv("JTPU_TSDB_CADENCE", v)
        assert port_tsdb.cadence_from_env() == ref_tsdb.cadence_from_env()


def test_the_webhook_posts_the_reference_transition(tmp_path):
    got = []
    done = threading.Event()

    class Hook(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_POST(self):  # noqa: N802
            n = int(self.headers.get("Content-Length") or 0)
            got.append((self.headers.get("Content-Type"),
                        json.loads(self.rfile.read(n))))
            self.send_response(204)
            self.end_headers()
            if len(got) == 2:
                done.set()

    server = ThreadingHTTPServer(("127.0.0.1", 0), Hook)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_port}/slo"
    try:
        for name, (metrics, tsdb, slo, _) in PACKAGES.items():
            reg = metrics.Registry()
            h = reg.histogram("req_s", buckets=(0.1, 1.0))
            db = _db(tsdb, str(tmp_path / name), _clock(5.0), reg,
                     resolutions=(("1s", 1.0, 60),))
            slo.SLOEngine(db, objectives=[slo.Objective(
                "lat", "latency", target=0.9, metric="req_s",
                threshold=0.1)], windows=(("2s", 2.0),),
                burn_threshold=1.0, webhook=url)
            h.observe(0.5)
            db.sample_once()
        assert done.wait(30), got
    finally:
        server.shutdown()
        server.server_close()
    assert got[0] == got[1]
    assert got[0][0] == "application/json"
    assert got[0][1]["event"] == "slo.breach"
