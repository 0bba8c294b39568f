"""The segment watchdog and the wedge record of the port on the CPU, against
the reference's ``TestInjectedWedge`` (``tests/test_resilience.py``) under
the same faults.

The port goes on nowhere by itself after a wedge: its result is UNKNOWN
with the search's last segment end as its ``checkpoint``, and a caller
resumes that with ``device="cpu"``. The reference goes on on its CPU
fallback by itself. So the port's wedge and its caller's resumption are
held together against the reference's one search.

* An injected wedge at segment 2 under a watchdog: the wedge event's
  segment and level, the warning, and the resumed ``valid``, ``levels``
  and rung-complete event, each the reference's.
* A wedge of the resumption too: UNKNOWN, "wedged", in both packages.
* A real hung segment (``gpu.run_segment`` waiting on an event) under a
  0.5 s deadline: the watchdog thread fires, and the checkpoint resumes
  to the unwedged verdict.
* No watchdog: UNKNOWN, the wedge's ``gave-up`` event, the checkpoint at
  the rung's start.
* After a wedge the lock is free and the wedged shape's buffers are never
  handed out again. A check on CUDA after a CUDA wedge answers UNKNOWN at
  once, before it touches the card, and so does one that waited for the
  lock while the wedge was noted; a check on the CPU runs.
* The stream runner's wedge branch, injected and under a real hung
  segment: UNKNOWN, and a runner on the CPU resumes the stream's
  checkpoint to the clean verdict.

Every test clears both packages' wedge records after its abandoned
workers have ended. Both packages run segments of 64 levels, so their
segment ends fall on the same levels. Tolerance: none.
"""

import threading
import time
import warnings

import pytest
import torch

from jepsen_tpu import accel as JA
from jepsen_tpu import resilience as JR
from jepsen_tpu import stream as JS
from jepsen_tpu import testing as jt
from jepsen_tpu.models import CASRegister as JCASRegister
from jepsen_tpu.ops.encode import pack_with_init as j_pack

from jepsen_tpu_torch import accel as A
from jepsen_tpu_torch import resilience as R
from jepsen_tpu_torch import stream as S
from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.checker import engine as engine_mod
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.ops.encode import pack_with_init

from test_stream import _chunks, _conc_ops
from test_torch_stream_runner import VERDICT, feed, offline, run, session

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

SEG = 64


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    """No fault seam, wedge record or hung worker leaks out of a test;
    each gets a fresh engine. Yields a list of events to set at teardown
    (the hung workers' releases)."""
    monkeypatch.setattr(R, "_inject_fault", None)
    monkeypatch.setattr(JR, "_inject_fault", None)
    monkeypatch.setenv("JEPSEN_RETRY_BASE", "0.001")
    monkeypatch.delenv("JTPU_SEGMENT_DEADLINE_S", raising=False)
    monkeypatch.delenv("JTPU_PLAN_BYTES_LIMIT", raising=False)
    monkeypatch.setattr(engine_mod, "_DEFAULT", engine_mod.Engine())
    releases = []
    yield releases
    for ev in releases:
        ev.set()
    A._reset_for_tests()
    JA._reset_for_tests()


def _both():
    h = jt.simulate_register_history(220, n_procs=5, n_vals=8, seed=6,
                                     crash_p=0.02)
    p, k = pack_with_init(History.of(o.to_dict() for o in h), CASRegister())
    jp, jk = j_pack(h, JCASRegister())
    return p, k, jp, jk


def _ours(p, k, **kw):
    return R.supervised_check_packed(p, k, device="cpu", segment_iters=SEG,
                                     **kw)


def _ref(jp, jk, **kw):
    return JR.supervised_check_packed(jp, jk, segment_iters=SEG, **kw)


def _wedge_at(mod, segment):
    """A fault seam that wedges the first time it sees ``segment``; the
    backends it wedged."""
    wedged = []

    def inject(ctx):
        if ctx["segment"] == segment and not wedged:
            wedged.append(ctx["backend"])
            raise mod.WedgeError("injected wedged execution")

    return inject, wedged


def _hang_first_segment(monkeypatch, releases):
    """``gpu.run_segment`` whose first call blocks until teardown (or
    20 s) and then fails; the (carry, shape) it was handed."""
    release = threading.Event()
    releases.append(release)
    real, held = G.run_segment, []

    def hanging(cols, carry, scratch, shape, *a, **kw):
        if not held:
            held.append((carry, shape))
            release.wait(20)
            raise RuntimeError("hung call released at teardown")
        return real(cols, carry, scratch, shape, *a, **kw)

    monkeypatch.setattr(G, "run_segment", hanging)
    return held


def _wedge_then_resume(p, k, **kw):
    """The port's wedged check, then its checkpoint resumed on the CPU."""
    wedged = _ours(p, k, **kw)
    assert wedged["valid"] is UNKNOWN and "wedged" in wedged["error"]
    assert isinstance(wedged["checkpoint"], R.Checkpoint)
    return wedged, _ours(p, k, resume=wedged["checkpoint"])


def _complete(r):
    return [(a["segments"], a["levels"]) for a in r["attempts"]
            if a.get("event") == "rung-complete"]


def test_an_injected_wedge_continues_on_the_cpu_as_the_reference_does(
        monkeypatch):
    p, k, jp, jk = _both()
    base = _ours(p, k)
    out, seen = {}, {}
    for mod, name in ((R, "port"), (JR, "ref")):
        inject, seen[name] = _wedge_at(mod, 2)
        monkeypatch.setattr(mod, "_inject_fault", inject)
        with pytest.warns(RuntimeWarning, match="execution wedged.*mid-run"):
            out[name] = (_wedge_then_resume(p, k, deadline_s=30)
                         if mod is R else _ref(jp, jk))
    (wedged, ours), ref = out["port"], out["ref"]
    assert seen["port"] == seen["ref"] == ["default"]
    assert ours["valid"] == ref["valid"] == base["valid"] is True
    assert ours["levels"] == ref["levels"] == base["levels"]
    assert ref["backend-fallback"] == "cpu"
    assert "backend-fallback" not in wedged and "backend-fallback" not in ours
    # the wedge at the same segment end, resumed from it
    mine = [a for a in wedged["attempts"] if a.get("event") == R.WEDGE]
    theirs = [a for a in ref["attempts"] if a.get("event") == R.WEDGE]
    assert [(a["outcome"], a["segment"], a["level"]) for a in mine] == [
        ("gave-up", 2, 2 * SEG)]
    assert [(a["segment"], a["level"]) for a in theirs] == [(2, 2 * SEG)]
    cp = wedged["checkpoint"]
    assert (cp.segment, cp.level, cp.rung) == (2, 2 * SEG,
                                               mine[0]["rung"])
    assert _complete(ours) == _complete(ref)
    assert A.runtime_wedged() and JA.runtime_wedged()
    assert A.wedged_devices() == ["cpu"] and A.wedge_count() == 1
    assert not A.runtime_wedged("cpu") and not A.runtime_wedged("cuda")


def test_a_wedge_on_the_fallback_too_gives_up(monkeypatch):
    p, k, jp, jk = _both()

    def always(mod):
        def inject(ctx):
            raise mod.WedgeError("wedged everywhere")
        return inject

    out = {}
    for mod, name in ((R, "port"), (JR, "ref")):
        monkeypatch.setattr(mod, "_inject_fault", always(mod))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if mod is R:
                first = _ours(p, k, capacity=32, expand=4)
                out[name] = [first, _ours(p, k, capacity=32, expand=4,
                                          resume=first["checkpoint"])]
            else:
                out[name] = [_ref(jp, jk, capacity=32, expand=4)]
    for r in out["port"] + out["ref"]:
        assert r["valid"] is UNKNOWN and "wedged" in r["error"]
    for r in out["port"]:
        assert [(a["event"], a.get("outcome")) for a in r["attempts"]] == [
            ("wedge", "gave-up"), ("rung-aborted", None)]
    assert [(a["event"], a.get("outcome"))
            for a in out["ref"][0]["attempts"]] == [
        ("wedge", "cpu-fallback"), ("wedge", "gave-up"),
        ("rung-aborted", None)]
    assert A.wedge_count() == 2


def test_the_real_watchdog_fires_on_a_hung_segment(monkeypatch, clean):
    p, k, _, _ = _both()
    base = _ours(p, k)
    held = _hang_first_segment(monkeypatch, clean)
    t0 = time.monotonic()
    with pytest.warns(RuntimeWarning, match="execution wedged"):
        r = _ours(p, k, deadline_s=0.5)
    assert held, "the hang must have been exercised"
    assert time.monotonic() - t0 < 5
    assert r["valid"] is UNKNOWN
    assert r["attempts"][0]["event"] == R.WEDGE
    assert "0.5s deadline" in r["attempts"][0]["error"]
    assert r["checkpoint"].level == 0
    workers = A.abandoned_workers()
    assert [w.name for w in workers] == ["jepsen-device-segment"]
    assert workers[0].is_alive()
    resumed = _ours(p, k, resume=r["checkpoint"])
    assert (resumed["valid"], resumed["levels"]) == (base["valid"],
                                                     base["levels"])


def test_without_a_fallback_a_wedge_is_unknown(monkeypatch):
    p, k, _, _ = _both()
    inject, _ = _wedge_at(R, 1)
    monkeypatch.setattr(R, "_inject_fault", inject)
    with pytest.warns(RuntimeWarning, match="execution wedged.*mid-run"):
        r = _ours(p, k)
    assert r["valid"] is UNKNOWN and "wedged" in r["error"]
    assert [(a["event"], a.get("outcome")) for a in r["attempts"]] == [
        ("wedge", "gave-up"), ("rung-aborted", None)]
    assert R.result_failure_class(r) == R.WEDGE
    assert "backend-fallback" not in r
    # no watchdog and no checkpoint asked for: the rung's start
    assert (r["checkpoint"].segment, r["checkpoint"].level) == (0, 0)


def test_a_check_after_a_wedge_answers_at_once(monkeypatch, clean):
    p, k, _, _ = _both()
    eng = engine_mod.default_engine()
    held = _hang_first_segment(monkeypatch, clean)
    t0 = time.monotonic()
    with pytest.warns(RuntimeWarning, match="gives up"):
        r = _ours(p, k, deadline_s=0.5)
    assert time.monotonic() - t0 < 5
    assert r["valid"] is UNKNOWN and "0.5s deadline" in r["error"]
    worker = A.abandoned_workers()[0]
    assert worker.is_alive()
    # the engine's lock is free, and a second check does not wait
    assert eng.lock.acquire(blocking=False)
    eng.lock.release()
    again = _ours(p, k)
    assert again["valid"] is True
    # the wedged shape's buffers are never handed out again
    wedged, shape = held[0]
    assert all(c is not wedged for c, _ in eng._states.values())
    fresh, _ = eng.state(shape, torch.device("cpu"))
    assert fresh.scal.data_ptr() != wedged.scal.data_ptr()
    # a CUDA wedge: a check on CUDA answers at once, before it touches
    # the card, and the engine hands out no CUDA state
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        A.note_runtime_wedge("test", 0.5, device="cuda")
    t0 = time.monotonic()
    on_cuda = R.supervised_check_packed(p, k, device="cuda")
    assert time.monotonic() - t0 < 1.0
    assert on_cuda["valid"] is UNKNOWN
    assert "wedged earlier" in on_cuda["error"]
    assert R.result_failure_class(on_cuda) == R.WEDGE
    with pytest.raises(R.WedgeError):
        eng.state(shape, torch.device("cuda"))
    # cleared once the worker has ended
    clean[-1].set()
    A._reset_for_tests()
    assert not worker.is_alive() and not A.runtime_wedged()
    assert _ours(p, k)["valid"] is True


def test_a_cpu_check_after_a_cuda_wedge_runs():
    """The record refuses CUDA only: a check on the CPU after a CUDA
    wedge runs as before it, on the engine's CPU state."""
    p, k, _, _ = _both()
    base = _ours(p, k)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        A.note_runtime_wedge("test", 0.5, device="cuda:0")
    assert A.runtime_wedged("cuda") and A.runtime_wedged("cuda:0")
    assert not A.runtime_wedged("cpu")
    after = _ours(p, k)
    assert (after["valid"], after["levels"]) == (base["valid"],
                                                 base["levels"])
    assert after["attempts"] == base["attempts"]


def _stream(tmp_path, sid, **kw):
    """A session fed and closed, its runner's verdict, and the session
    (its WAL still open)."""
    ops = _conc_ops(200, 26)
    s = session(S, tmp_path, sid)
    chunks = _chunks(ops, 40)
    feed(s, chunks)
    run(S, s, [len(c) for c in chunks], seg=8, **kw)
    return s.result, s


def _resume_on_the_cpu(s):
    """A runner on the CPU over the same session: it resumes the stream's
    checkpoint."""
    run(S, s, [], seg=8)
    s.stop_wal()
    return s.result


def _same_verdict(res, want):
    """The verdict's fields, and its levels where a stream's may fall: the
    resumed runner meets fewer barriers than the runner it takes over
    from, and each barrier at which the search is done costs a level
    (ROADMAP C), so its levels lie between offline's and ``want``'s."""
    for key in VERDICT:
        if key != "levels":
            assert res.get(key) == want.get(key), key
    off = offline(_conc_ops(200, 26))["levels"]
    assert off <= res["levels"] <= want["levels"]


@pytest.mark.parametrize("resume", [False, True])
def test_the_stream_runner_wedge_branch(tmp_path, resume):
    clean_result, s0 = _stream(tmp_path, "clean")
    s0.stop_wal()
    seen = []

    def inject(ctx):
        seen.append(ctx)
        if len(seen) == 3:
            raise R.WedgeError("injected wedged execution")

    R._inject_fault = inject
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res, s = _stream(tmp_path, "wedged")
    finally:
        R._inject_fault = None
    assert A.runtime_wedged() and A.wedged_devices() == ["cpu"]
    assert res["valid"] is UNKNOWN
    assert res["error"].startswith("stream segment wedged: ")
    assert res["levels"] == seen[2]["level"]
    if not resume:
        s.stop_wal()
        return
    res = _resume_on_the_cpu(s)
    assert res["stream"]["resume-level"] == seen[2]["level"]
    _same_verdict(res, clean_result)
    # the reference's runner under a wedge of the same segment goes on
    # on its CPU fallback to the same verdict
    calls = []
    real = JR._call_segment

    def wedge_third(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise JR.WedgeError("injected wedged execution")
        return real(*a, **kw)

    JR._call_segment = wedge_third
    try:
        s = session(JS, tmp_path / "ref", "ref")
        chunks = _chunks(_conc_ops(200, 26), 40)
        feed(s, chunks)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            run(JS, s, [len(c) for c in chunks], seg=8)
        s.stop_wal()
    finally:
        JR._call_segment = real
    _same_verdict(res, s.result)


def test_a_hung_stream_segment_goes_on_on_the_cpu(tmp_path, monkeypatch,
                                                  clean):
    clean_result, s0 = _stream(tmp_path, "clean")
    s0.stop_wal()
    held = _hang_first_segment(monkeypatch, clean)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res, s = _stream(tmp_path, "hung", deadline_s=0.5)
    assert held and A.runtime_wedged()
    assert res["valid"] is UNKNOWN and "0.5s deadline" in res["error"]
    res = _resume_on_the_cpu(s)
    _same_verdict(res, clean_result)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_a_check_waiting_for_the_lock_sees_a_wedge(monkeypatch, device):
    """A check blocked on the engine's lock while a CUDA search wedges
    reads the record once it has the lock: on CUDA it answers UNKNOWN and
    takes none of the engine's state; on the CPU it runs. (The CUDA check
    is driven here with the device check patched out: the record stops it
    before anything touches the card.)"""
    p, k, _, _ = _both()
    if device == "cuda":
        monkeypatch.setattr(G, "resolve_device", torch.device)
    eng = engine_mod.default_engine()
    out = {}
    eng.lock.acquire()
    try:
        t = threading.Thread(target=lambda: out.update(
            r=R.supervised_check_packed(p, k, device=device,
                                        segment_iters=SEG)))
        t.start()
        time.sleep(0.3)
        assert t.is_alive(), "the check must wait for the lock"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            A.note_runtime_wedge("test", 0.5, device="cuda")
    finally:
        eng.lock.release()
    t.join(30)
    assert not t.is_alive()
    r = out["r"]
    if device == "cuda":
        assert r["valid"] is UNKNOWN and "wedged earlier" in r["error"]
        assert not eng._states and not eng._cols
    else:
        assert r["valid"] is True
        assert all(key[1] == "cpu" for key in eng._states)
