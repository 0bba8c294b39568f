"""The port's observability layer on the CPU, against the reference's.

* The metrics registry: one scripted series of operations (counters
  with labels, gauges, histograms with exemplars, escaping) gives the
  reference's Prometheus text byte for byte and its JSON snapshot.
* The tracer: spans nest and carry the trace context, ``trace.jsonl``
  tolerates a torn tail, the Chrome export has the reference's structure
  (the reference's golden file), and ``JTPU_TRACE=0`` records nothing.
* ``obs.start_run``/``finish_run`` write the run's artifacts, none with
  tracing off; the device gauges and ``memory_stats`` answer nothing on
  the CPU.
* The gpu module's compile accounting and ``compile_line``; the engine's
  counters, warm records and evictions: the byte budget and the headroom
  eviction drop warm buckets in the reference ``Engine``'s order under
  the same records and the same injected headroom readings.
* The CUDA-init probe: a hanging child gives None within its timeout and
  ``ensure_usable`` raises (never falls back to the CPU); a CPU device
  needs no probe; ``JEPSEN_ACCEL_OK`` skips it; the verdict is cached.
"""

import collections
import json
import os
import threading
import time

import pytest
import torch

from jepsen_tpu.checker import engine as j_engine
from jepsen_tpu.obs import metrics as j_metrics
from jepsen_tpu.obs import trace as j_trace

from jepsen_tpu_torch import accel, obs
from jepsen_tpu_torch.checker import engine as p_engine
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.obs import devices as p_devices
from jepsen_tpu_torch.obs import metrics as p_metrics
from jepsen_tpu_torch.obs import trace as p_trace

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(metrics_mod):
    """One series of operations on a fresh registry of ``metrics_mod``."""
    reg = metrics_mod.Registry()
    c = reg.counter("jtpu_a_total", "a help")
    c.inc()
    c.inc(2, f='with"quote', g="line\nbreak")
    c.inc(0.5, f="read")
    g = reg.gauge("jtpu_b", "b help\\with backslash")
    g.set(1.5)
    g.set_max(0.5)
    g.inc(2, device="cuda:0")
    h = reg.histogram("jtpu_lat_seconds", "latency",
                      buckets=(0.01, 0.1, 1.0))
    for v, ex in ((0.005, None), (0.05, {"trace_id": "ab" * 16}),
                  (0.5, None), (50.0, {"trace_id": "cd" * 16})):
        h.observe(v, tenant="t1", exemplar=ex)
    h.observe(0.2)
    reg.histogram("jtpu_empty_seconds", "never observed")
    return reg


def _no_ts(doc):
    if isinstance(doc, dict):
        return {k: _no_ts(v) for k, v in doc.items() if k != "ts"}
    if isinstance(doc, list):
        return [_no_ts(v) for v in doc]
    return doc


def test_the_prometheus_text_is_the_references_byte_for_byte():
    ours, ref = _script(p_metrics), _script(j_metrics)
    assert ours.to_prometheus() == ref.to_prometheus()
    assert ours.to_prometheus().encode() == ref.to_prometheus().encode()
    # the snapshots too, but for the exemplars' wall-clock stamps
    assert _no_ts(ours.snapshot()) == _no_ts(ref.snapshot())
    h = ours.histogram("jtpu_lat_seconds")
    assert h.quantile(0.5, tenant="t1") == \
        ref.histogram("jtpu_lat_seconds").quantile(0.5, tenant="t1")


def test_write_snapshot_is_json(tmp_path):
    p_metrics.counter("jtpu_test_obs_total", "a test counter").inc(3)
    path = str(tmp_path / "metrics.json")
    p_metrics.write_snapshot(path)
    doc = json.load(open(path))
    assert doc["jtpu_test_obs_total"]["series"][""] >= 3


def test_the_chrome_export_has_the_references_structure():
    records = [
        {"name": "core.run", "ts": 1000, "dur": 9000, "tid": 7,
         "sid": 1, "name_attr": "demo"},
        {"name": "checker.segment", "ts": 2000, "dur": 3000,
         "tid": 7, "sid": 2, "pid": 1, "phase": "compile", "level": 0},
        {"name": "search.oom", "ts": 6000, "dur": 0, "tid": 7,
         "sid": 3, "pid": 1, "outcome": "pool-halved-to-64"},
    ]
    with open(os.path.join(REPO, "tests", "fixtures", "obs",
                           "chrome_golden.json")) as f:
        golden = json.load(f)
    assert p_trace.to_chrome(records, process_name="golden") == golden
    assert p_trace.to_chrome(records) == j_trace.to_chrome(records)


def test_spans_nest_and_carry_the_trace_context(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    tr = p_trace.Tracer(path=path)
    tid = p_trace.new_trace_id()
    with tr.context(tid, "00f067aa0ba902b7"):
        with tr.span("serve.request", id="r1"):
            with tr.span("checker.segment", phase="execute") as sp:
                sp.set(level_end=64)
            tr.event("serve.verdict", valid="True")
    tr.detach()
    recs, stats = p_trace.read_trace(path)
    assert stats["spans"] == 3 and stats["traces"] == 1
    by = {r["name"]: r for r in recs}
    assert by["checker.segment"]["pid"] == by["serve.request"]["sid"]
    assert by["checker.segment"]["level_end"] == 64
    assert all(r["trace"] == tid for r in recs)
    assert by["serve.request"]["parent"] == "00f067aa0ba902b7"
    # the traceparent header round-trips, in both packages' formats
    hdr = p_trace.format_traceparent(tid, 5)
    assert hdr == j_trace.format_traceparent(tid, 5)
    assert p_trace.parse_traceparent(hdr) == j_trace.parse_traceparent(hdr)
    # a torn tail is dropped, the records before it kept
    with open(path, "ab") as f:
        f.write(b'{"name": "torn", "ts": 12')
    assert p_trace.read_trace(path)[1]["torn"] == 1
    assert len(p_trace.read_trace(path)[0]) == 3


def test_the_kill_switch_records_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("JTPU_TRACE", "0")
    before = obs.tracer().recorded
    sp = obs.span("nope", x=1)
    assert sp is p_trace.NOOP_SPAN
    with sp:
        sp.set(y=2)
    obs.event("nope-either")
    assert obs.tracer().recorded == before
    obs.start_run(str(tmp_path))
    with obs.span("nope"):
        pass
    obs.finish_run()
    assert os.listdir(tmp_path) == []
    monkeypatch.setenv("JTPU_TRACE", "1")
    obs.start_run(str(tmp_path))
    with obs.span("yes"):
        pass
    obs.finish_run()
    assert sorted(os.listdir(tmp_path)) == ["metrics.json", "trace.jsonl"]


def test_the_device_gauges_answer_nothing_on_the_cpu():
    assert p_devices.poll("cpu") == []
    assert p_devices.memory_stats("cpu") is None
    assert p_devices.headroom_ratio(device="cpu") is None
    # rows given: the ratio is their minimum, published to its gauge
    rows = [{"headroom": 0.4}, {"headroom": 0.25}, {"headroom": None}]
    assert p_devices.headroom_ratio(rows) == 0.25
    assert p_metrics.REGISTRY.gauge(
        "jtpu_device_headroom_ratio").value() == 0.25
    names = set(p_metrics.REGISTRY.snapshot())
    assert {"jtpu_device_bytes_in_use", "jtpu_device_bytes_limit",
            "jtpu_device_peak_bytes_in_use",
            "jtpu_device_headroom_ratio"} <= names


def test_the_compile_accounting_splits_first_calls():
    before = G.compile_snapshot()
    key = ("segment", "test-shape", time.monotonic())
    assert G.call_phase(key) == "compile"
    G.note_call_phase("segment", "compile", 0.25)
    G.mark_executed(key)
    assert G.call_phase(key) == "execute"
    G.note_call_phase("segment", "execute", 0.125)
    d = G.compile_delta(before)
    assert (d["cold"], d["cache-hits"]) == (1, 1)
    assert abs(d["compile-s"] - 0.25) < 1e-9
    assert abs(d["execute-s"] - 0.125) < 1e-9
    line = G.compile_line(d, wall_s=1.0)
    assert line.startswith("# compile: cold=1 shape(s) 0.250s | "
                           "cache-hit=1 | execute=0.125s")
    assert line.endswith("host=0.625s of 1.000s wall")
    assert "persistent-cache hit=" in line


def _records(n):
    """n warm records of growing bytes, by made-up bucket keys."""
    return [(("cas-register", 16 * (i + 1), 8, 32),
             {"shapes": 1, "bytes": 1000 * (i + 1), "seconds": 0.0,
              "ts": 0.0, "device": "cpu"}) for i in range(n)]


def _engines(n):
    ours = p_engine.Engine(max_warm_buckets=0, max_warm_bytes=0)
    ref = j_engine.Engine(name="test", max_warm_buckets=0)
    ref.max_warm_bytes = 0
    for b, rec in _records(n):
        ours._warm[b] = dict(rec)
        ref._warm[b] = dict(rec)
    return ours, ref


@pytest.mark.parametrize("readings", [
    [0.01, 0.02, 0.03, 0.5],        # three evictions, then enough room
    [0.01] * 10,                    # down to the newest, which stays
    [0.9],                          # room: nothing
    [None],                         # no device reading: nothing
])
def test_headroom_eviction_follows_the_references_order(readings):
    ours, ref = _engines(6)
    seq = {"port": collections.deque(readings),
           "ref": collections.deque(readings)}

    def poll(tag):
        def read():
            q = seq[tag]
            return q.popleft() if len(q) > 1 else q[0]
        return read

    n_ours = ours.evict_below_headroom(0.05, poll=poll("port"))
    n_ref = ref.evict_below_headroom(0.05, poll=poll("ref"))
    assert n_ours == n_ref
    assert ours.warm_buckets() == ref.warm_buckets()
    assert ours.evictions == ref.evictions == n_ref
    assert ours.warm_bytes() == ref.warm_bytes()


def test_a_raising_poll_evicts_nothing():
    ours, _ = _engines(3)

    def poll():
        raise RuntimeError("no gauge")
    assert ours.evict_below_headroom(0.5, poll=poll) == 0
    assert len(ours.warm_buckets()) == 3


@pytest.mark.parametrize("budget", [0, 21000, 15000, 6000, 1])
def test_the_byte_budget_follows_the_references_order(budget):
    ours, ref = _engines(6)
    ours.set_max_warm_bytes(budget)
    ref.set_max_warm_bytes(budget)
    assert ours.warm_buckets() == ref.warm_buckets()
    assert ours.warm_bytes() == ref.warm_bytes()
    b = ours.warm_buckets()[-1]
    assert ours.warm_info(b) == ref.warm_info(b)
    assert ours.warm_info(("nope",)) is None


def test_the_byte_budget_env(monkeypatch):
    monkeypatch.setenv("JTPU_ENGINE_BYTES_BUDGET", "4096")
    assert p_engine.Engine().max_warm_bytes == 4096
    monkeypatch.setenv("JTPU_ENGINE_BYTES_BUDGET", "x")
    assert p_engine.Engine().max_warm_bytes == 0


def test_the_engine_counts_builds_and_hits():
    from jepsen_tpu_torch.kernels.search import LevelShape
    builds = p_metrics.REGISTRY.counter("jtpu_engine_builds_total")
    hits = p_metrics.REGISTRY.counter("jtpu_engine_cache_hits_total")
    b0, h0 = builds.value(), hits.value()
    eng = p_engine.Engine()
    shape = LevelShape(C=8, W=32, E=2, n=16, CR=0)
    dev = torch.device("cpu")
    eng.state(shape, dev)
    eng.state(shape, dev)
    eng.state(shape, dev, stats=False)
    assert (builds.value() - b0, hits.value() - h0) == (2, 1)
    on, off = eng.state(shape, dev)[0], eng.state(shape, dev, False)[0]
    assert on.stats is not None and off.stats is None


@pytest.fixture
def fresh_probe(monkeypatch):
    accel._reset_probe_for_tests()
    monkeypatch.delenv("JEPSEN_ACCEL_OK", raising=False)
    yield
    accel._reset_probe_for_tests()


def test_a_hanging_probe_gives_none_and_ensure_usable_raises(
        fresh_probe, monkeypatch):
    monkeypatch.setattr(accel, "_PROBE_CODE",
                        "import time\ntime.sleep(60)\n")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    t0 = time.monotonic()
    assert accel.probe_default_backend(timeout=0.5) is None
    assert time.monotonic() - t0 < 30
    with pytest.raises(accel.AcceleratorUnavailable,
                       match="did not initialise within"):
        accel.ensure_usable("a test", timeout=0.5)
    # the verdict is cached: no second child, the same refusal
    monkeypatch.setattr(accel, "_spawn_probe",
                        lambda t: pytest.fail("probed twice"))
    with pytest.raises(accel.AcceleratorUnavailable):
        accel.ensure_usable("a test")
    # a CPU device never needs the card
    assert accel.ensure_usable("a test", device="cpu") == "cpu"


def test_the_probe_names_the_platform_and_honours_the_env(
        fresh_probe, monkeypatch):
    monkeypatch.setattr(accel, "_PROBE_CODE",
                        "print('JEPSEN_ACCEL', 'cuda')\n")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert accel.probe_default_backend(timeout=60) == "cuda"
    assert accel.ensure_usable("a test") == "cuda"
    accel._reset_probe_for_tests()
    monkeypatch.setenv("JEPSEN_ACCEL_OK", "1")
    monkeypatch.setattr(accel, "_spawn_probe",
                        lambda t: pytest.fail("probed despite the env"))
    assert accel.probe_default_backend() == "cuda"
    accel._reset_probe_for_tests()
    monkeypatch.setenv("JEPSEN_ACCEL_PROBE_TIMEOUT", "7.5")
    assert accel._probe_timeout() == 7.5


def test_the_probe_child_fails_without_cuda(fresh_probe):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the probe succeeds")
    assert accel._spawn_probe(120) is None


def test_the_search_refuses_cuda_when_the_probe_hangs(
        fresh_probe, monkeypatch):
    from jepsen_tpu_torch import resilience as R
    from jepsen_tpu_torch import testing as pt
    from jepsen_tpu_torch.models.core import CASRegister
    monkeypatch.setattr(accel, "_spawn_probe", lambda t: None)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    h = pt.simulate_register_history(40, n_procs=3, seed=1)
    with pytest.raises(accel.AcceleratorUnavailable):
        R.supervised_check_history(h, CASRegister(), device="cuda")
    # the CPU still checks, and needs no probe
    r = R.supervised_check_history(h, CASRegister(), device="cpu")
    assert r["valid"] is True


def test_metrics_are_thread_safe():
    reg = p_metrics.Registry()
    c = reg.counter("jtpu_threads_total")
    h = reg.histogram("jtpu_threads_seconds", buckets=(0.5,))

    def work():
        for _ in range(2000):
            c.inc()
            h.observe(0.25)

    ts = [threading.Thread(target=work) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
        assert not t.is_alive()
    assert c.value() == 16000 and h.series()["count"] == 16000
