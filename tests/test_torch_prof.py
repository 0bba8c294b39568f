"""The device profiler and the level cost model on the CPU.

* A ``JTPU_PROF=1`` capture of a supervised search on the CPU
  (``torch.profiler``, whose CPU operators stand in for the device lane
  there) writes its trace under ``profile/``, parses, and merges under
  the run's ``checker.segment`` host spans; the check's result is the
  uncaptured one's. ``JTPU_PROF=0``, or ``JTPU_TRACE=0``, leaves no
  ``profile/`` directory. A nested capture does nothing; a refused one
  is counted, sticky, and leaves no directory; a torn trace file parses
  to nothing without raising.
* ``segment_kernel_times``: per-execution records are summed, and a
  segment holding one WHILE iteration's records is scaled by the levels
  its span says it ran (the attribution is labelled).
* ``kernels/cost.py``: the level's stages are a function of the shape
  alone (the group-start scan counted whichever kernel runs it), the
  ``cost`` entries and ``plan.trace_candidate`` read it, and the live
  ``touched`` refinement moves only the expansion's bytes.
"""

import gzip
import json
import os

import pytest
import torch

from jepsen_tpu_torch import obs
from jepsen_tpu_torch import resilience as R
from jepsen_tpu_torch import testing as pt
from jepsen_tpu_torch.checker import plan
from jepsen_tpu_torch.kernels import cost as kcost
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.models.core import CASRegister
from jepsen_tpu_torch.obs import metrics as obs_metrics
from jepsen_tpu_torch.obs import profiler
from jepsen_tpu_torch.ops.encode import pack_with_init

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_profiler():
    profiler._reset_for_tests()
    yield
    profiler._reset_for_tests()
    obs.finish_run()


def _packed(n=160, seed=2):
    h = pt.simulate_register_history(n, n_procs=4, n_vals=6, seed=seed,
                                     crash_p=0.02)
    return pack_with_init(h, CASRegister())


def _check(p, k):
    return R.supervised_check_packed(p, k, device="cpu", segment_iters=32)


def _captures(outcome):
    return obs_metrics.REGISTRY.counter(
        "jtpu_prof_captures_total").value(outcome=outcome)


def test_a_capture_parses_and_merges_under_its_segments(tmp_path,
                                                        monkeypatch):
    p, k = _packed(90)
    plain = _check(p, k)
    monkeypatch.setenv("JTPU_PROF", "1")
    ok0 = _captures("ok")
    obs.start_run(str(tmp_path))
    out = _check(p, k)
    obs.finish_run()
    for f in ("valid", "levels", "segments", "searchstats",
              "segment-levels"):
        assert out[f] == plain[f], f
    assert _captures("ok") == ok0 + 1
    files = profiler.find_traces(profiler.profile_dir(str(tmp_path)))
    assert len(files) == 1
    dev, stats = profiler.read_profile(str(tmp_path))
    assert stats["files"] == 1 and stats["errors"] == 0 and dev
    merged, mstats = profiler.merged_records(str(tmp_path))
    assert mstats["device"] == len(dev) and mstats["profile-files"] == 1
    segs = {r["sid"]: r for r in merged if r["name"] == "checker.segment"}
    assert len(segs) == out["segments"]
    under = [r for r in merged
             if r.get("track") == "device" and r.get("pid") in segs]
    # most device records land inside a segment span, each with its rung
    assert len(under) > len(dev) // 2
    assert all(r["rung"] == list(out["rung"]) for r in under)
    rows = profiler.kernel_self_times(under)
    assert rows and rows[0]["self-ns"] >= rows[-1]["self-ns"] >= 0
    assert profiler.top_kernels(under, k=3) == rows[:3]
    times = profiler.segment_kernel_times(merged)
    assert {r["sid"] for r in times} <= set(segs)
    # on the host loop a segment span has no graph body: per execution
    assert {r["attribution"] for r in times} == {"per-execution"}
    # the merged records export to Chrome JSON
    chrome = obs.to_chrome(merged)
    assert any(e.get("tid", 0) >= profiler.DEVICE_TID_BASE
               for e in chrome["traceEvents"])


@pytest.mark.parametrize("env", [{"JTPU_PROF": "0"},
                                 {"JTPU_PROF": "1", "JTPU_TRACE": "0"}])
def test_no_capture_leaves_no_profile_dir(tmp_path, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    p, k = _packed(80)
    obs.start_run(str(tmp_path))
    _check(p, k)
    obs.finish_run()
    assert not os.path.exists(profiler.profile_dir(str(tmp_path)))


def test_nested_captures_do_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("JTPU_PROF", "1")
    profiler.attach(str(tmp_path))
    with profiler.capture() as outer:
        with profiler.capture() as inner:
            torch.ones(8).sum()
    assert outer.dir is not None and inner.dir is None
    assert len(profiler.find_traces(str(tmp_path / "profile"))) == 1


def test_a_refused_capture_is_counted_and_sticky(tmp_path, monkeypatch):
    monkeypatch.setenv("JTPU_PROF", "1")

    def refuse(*a, **kw):
        raise RuntimeError("CUPTI unavailable")
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    failed0 = _captures("failed")
    profiler.attach(str(tmp_path))
    with profiler.capture() as cap:
        pass
    assert cap.dir is None
    assert _captures("failed") == failed0 + 1
    assert "CUPTI unavailable" in profiler.failure()
    assert not os.path.exists(tmp_path / "profile")
    # sticky: a later capture does not try again
    monkeypatch.undo()
    monkeypatch.setenv("JTPU_PROF", "1")
    with profiler.capture() as again:
        pass
    assert again.dir is None and _captures("failed") == failed0 + 1


def test_a_torn_trace_parses_to_nothing(tmp_path):
    path = tmp_path / "x.trace.json"
    path.write_text('{"traceEvents": [{"ph": "X", "name": "a", "ts": 1')
    recs, stats = profiler.parse_trace(str(path))
    assert recs == [] and "error" in stats
    gz = tmp_path / "y.trace.json.gz"
    gz.write_bytes(gzip.compress(b'{"traceEvents": 3}'))
    assert profiler.parse_trace(str(gz))[1]["error"] == "no traceEvents"


def _doc(kernels, launches):
    """A Chrome trace with graph-node records ``(name, ts_us, dur_us)``,
    ``launches`` graph launches' worth (their correlation ids), a memset
    node in each, and one copy kernel of PyTorch's after them."""
    evs = [{"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 0,
            "dur": 1, "pid": 1, "tid": 1}]
    per = len(kernels) // launches
    for i, (n, ts, d) in enumerate(kernels):
        corr = 1000 + i // per
        if i % per == 0:
            evs.append({"ph": "X", "cat": "gpu_memset", "name": "Memset",
                        "ts": ts - 1, "dur": 1, "pid": 0, "tid": 7,
                        "args": {"device": 0, "stream": 7,
                                 "correlation": corr}})
        evs.append({"ph": "X", "cat": "kernel", "name": n, "ts": ts,
                    "dur": d, "pid": 0, "tid": 15,
                    "args": {"device": 0, "stream": 15,
                             "correlation": corr}})
    evs.append({"ph": "X", "cat": "kernel", "name": "copy_kernel",
                "ts": kernels[-1][1] + 50, "dur": 7, "pid": 0, "tid": 7,
                "args": {"device": 0, "stream": 7, "correlation": 5}})
    return {"traceEvents": evs}


@pytest.mark.parametrize("per_execution,late_span", [
    (True, False), (False, False), (False, True)])
def test_segment_kernel_times_attributes_the_graph(tmp_path,
                                                   per_execution,
                                                   late_span):
    # one segment of 8 levels (4 WHILE iterations) whose body launches
    # expand, sort and dedup once per level: 6 launches an iteration
    body = [("expand_kernel", 3), ("sort_tile_kernel", 5),
            ("dedup_block_kernel", 2)] * 2
    iters = 4 if per_execution else 1
    kernels, ts = [], 100
    for _ in range(iters):
        for name, d in body:
            kernels.append((name, ts, d))
            ts += d + 1
    path = tmp_path / "c.trace.json"
    # per execution: every node of the one launch recorded
    path.write_text(json.dumps(_doc(kernels, 1)))
    dev, stats = profiler.parse_trace(str(path))
    assert not stats["cpu-stand-in"] and len(dev) == len(kernels) + 2
    for r in dev:
        r["file"] = str(path)
    host = [{"name": profiler.CAPTURE_SPAN, "ts": 10_000, "dur": 10**7,
             "sid": 1, "tid": 1},
            # a late span: the clock mapping alone puts the launch's
            # nodes before it; the launch still goes under it
            {"name": "checker.segment",
             "ts": 10_000 + (400_000 if late_span else 0), "dur": 10**7,
             "sid": 2, "pid": 1, "tid": 1, "level": 16, "level_end": 24,
             "body": 6, "rung": [128, 32, 8]}]
    merged = host + profiler.merge_into_host(host, dev,
                                             {str(path): stats["t0"]})
    rows = {r["name"]: r for r in profiler.segment_kernel_times(merged)}
    assert set(rows) == {"expand_kernel", "sort_tile_kernel",
                         "dedup_block_kernel", "Memset"} | (
        set() if late_span else {"copy_kernel"})
    for name, d in (("expand_kernel", 3), ("sort_tile_kernel", 5),
                    ("dedup_block_kernel", 2)):
        r = rows[name]
        assert r["records"] == 2 * iters and r["graph"]
        assert r["ns"] == 8 * d * 1000     # 8 levels of d microseconds
        assert r["attribution"] == ("per-execution" if per_execution
                                    else "scaled-by-level-counter")
    # the memset node runs once a launch, the copy outside the graph
    # (which the late span does not hold)
    for name, ns in (("Memset", 1000), ("copy_kernel", 7000)):
        if name == "copy_kernel" and late_span:
            assert name not in rows
            continue
        assert rows[name]["ns"] == ns and not rows[name]["graph"]
        assert rows[name]["attribution"] == "per-execution"


SHAPES = [K.LevelShape(C=128, W=32, E=8, n=8192, CR=16),
          K.LevelShape(C=512, W=128, E=512, n=256, CR=8),
          K.LevelShape(C=128, W=32, E=16, n=2048, CR=0, B=184,
                       tiebreak="hash"),
          K.LevelShape(C=512, W=64, E=512, n=2048, CR=8, B=3)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s.C}-{s.W}-"
                         f"{s.E}-{s.CR}-{s.B}")
def test_the_cost_model_is_the_levels_work(shape):
    stages = kcost.level_cost(shape)
    assert tuple(stages) == kcost.STAGES
    nbytes, ops = kcost.level_total(shape)
    assert nbytes == sum(b for b, _ in stages.values()) > 0
    assert ops == sum(o for _, o in stages.values()) > 0
    # the scan is counted whether K3 runs it or K4 does
    assert (stages["group_starts"] == (0, 0)) == (shape.CR == 0)
    # only the expansion reads the touched column entries
    live = kcost.level_cost(shape, touched=1)
    assert {s: v for s, v in live.items() if s != "expand"} == {
        s: v for s, v in stages.items() if s != "expand"}
    assert live["expand"][1] == stages["expand"][1]
    ent = kcost.cost_entry("segment", (shape.C, shape.W, None), shape, 70)
    assert ent == {"kind": "segment", "rung": [shape.C, shape.W, None],
                   "unroll": 2, "levels": 70, "flops": float(ops),
                   "bytes-accessed": float(nbytes)}


def test_the_plan_rows_carry_the_cost_model():
    dims = plan.PlanDims(n_required=2000, n_crashed=3, window_needed=20)
    p, k = _packed(60)
    rep = plan.analyze(dims, kernel=k, trace=True, device="cpu")
    ok = [c for c in rep["candidates"] if c["status"] == "ok"]
    assert ok and all(c["cost"]["flops"] > 0 for c in ok)
    cand = plan.enumerate_candidates(dims, device="cpu")[0]
    tr = plan.trace_candidate(cand, k)
    assert tr["ok"] and tr["cost"] == kcost.per_level(cand.shape(k.name))
