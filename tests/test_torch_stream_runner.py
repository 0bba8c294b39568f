"""The port's online stream check (``jepsen_tpu_torch.stream.StreamRunner``
on ``device="cpu"``) against the JAX package's ``StreamRunner`` on JAX's
CPU, on the same chunk sequences.

Both runners are driven in lock step: a runner takes the next chunk only
when its search is idle (done over the prefix it has, or not started),
so each barrier falls at the same point in both, whatever the threads'
timing. On each fixture the two results agree on the verdict fields and
on the ``stream`` dict's watermark, barriers, rebases and fail-fast flag,
and both equal the offline check of the whole history:

* duplicates and a reordered pair (240 ops, seed 21);
* fail-fast on a corrupted read while the last chunk is unsent (200 ops,
  seed 22);
* crashed ops: a carry taken through close's crashed section, a crash
  that pins the watermark mid-stream, and close adding more crashed-mask
  words than the carry holds (a rebase);
* a needed window that outgrows the rung mid-stream (a rebase);
* a checkpoint written by either package's runner, resumed by the other's
  at a level above 0.

And the port's own segment loop: an OOM halves the pool, a transient
failure is retried, any other failure ends the stream UNKNOWN with its
error; a set stream is checked offline at close.
"""

import os
import time

import pytest
import torch

from jepsen_tpu import stream as JS
from jepsen_tpu.models import CASRegister as JCASRegister

from jepsen_tpu_torch import resilience as R
from jepsen_tpu_torch import stream as S
from jepsen_tpu_torch import testing
from jepsen_tpu_torch.checker import UNKNOWN, check_safe
from jepsen_tpu_torch.checker.wgl import linearizable
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import CASRegister, SetModel

from test_stream import _chunks, _conc_ops, _offline

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

VERDICT = ("valid", "levels", "max-linearized-prefix", "final-states",
           "frontier-op")
STREAM = ("watermark", "barriers", "rebases", "failed-fast")


def lockstep(base):
    """``base`` (either package's StreamRunner) fed one chunk of the
    scripted sizes at a time, each only once the search is idle; past
    the script, whatever the session holds, and the close."""

    class Lockstep(base):
        def __init__(self, *a, sizes=(), halt_after=None, **kw):
            super().__init__(*a, **kw)
            self._sizes = list(sizes)
            self._halt_after = halt_after

        def _poll(self):
            if self._work_pending():
                return [], False
            s = self.session
            with s.cond:
                if self._sizes:
                    k = self._sizes.pop(0)
                    new = list(s.ops[self._fed:self._fed + k])
                    self._fed += len(new)
                    return new, False
                new = list(s.ops[self._fed:])
                self._fed += len(new)
                if s.state == "open" and not new:
                    s.cond.wait(0.02)
                return new, s.state != "open"

        def _segment(self):
            super()._segment()
            # a kill after the given segment: the loop returns at its next
            # poll, leaving the checkpoint
            if self._halt_after is not None and \
                    self._seg_idx >= self._halt_after and \
                    int(self._carry[8]) > 0:
                self._halt.set()

    return Lockstep


def session(pkg, root, sid="s1"):
    return pkg.StreamSession(sid, "t", "cas-register", str(root))


def feed(s, chunks, close=True, hold_last=False):
    sent = chunks[:-1] if hold_last else chunks
    for i, ch in enumerate(sent):
        code, _ = s.append(i, ch, S.chunk_crc(ch))
        assert code == 202
    if close:
        assert s.close(len(chunks))[0] == 200


def run(pkg, s, sizes, model=None, seg=64, timeout=120.0, **kw):
    """Run a lockstep runner of package ``pkg`` over session ``s`` to its
    end; returns the runner."""
    if pkg is S:
        kw.setdefault("device", "cpu")
        model = model or CASRegister()
    else:
        kw.setdefault("backend", "tpu")
        model = model or JCASRegister()
    r = lockstep(pkg.StreamRunner)(s, model, segment_iters=seg,
                                   sizes=sizes, **kw)
    s.runner = r
    r.start()
    r.join(timeout)
    assert not r.is_alive(), s.status()
    return r


def offline(ops):
    return check_safe(linearizable(CASRegister(), device="cpu"),
                      {"name": "offline"}, History.of(ops))


def both(tmp_path, ops, size, close=True, hold_last=False, seg=64,
         arrive=None):
    """The same chunks through both packages' runners; returns (port
    result, reference result)."""
    out = []
    for pkg in (S, JS):
        s = session(pkg, tmp_path / pkg.__name__)
        chunks = _chunks(ops, size)
        if arrive is None:
            feed(s, chunks, close, hold_last)
        else:
            arrive(s, chunks)
        run(pkg, s, [len(c) for c in chunks], seg=seg)
        assert s.state == "done", s.status()
        out.append(s.result)
        s.stop_wal()
    return out


def agree(port, ref, ops, extra_levels=0):
    """The two runners' results are equal, and equal the offline check's
    (the port's and the reference's). ``extra_levels``: the levels the
    stream runs past the offline search, in both packages. A barrier at
    which the search is done, followed by a forced op, costs one: the
    offline search's forced run goes on past the barrier within a level,
    while the online search stops at the old required count (the forced
    run's bound), sets ``done``, and takes the run up a level later."""
    for k in VERDICT:
        assert port.get(k) == ref.get(k), (k, port, ref)
    for k in STREAM:
        assert port["stream"][k] == ref["stream"][k], (k, port["stream"],
                                                       ref["stream"])
    want, jwant = offline(ops), _offline(ops)
    assert want["levels"] == jwant["levels"]
    assert port["levels"] == want["levels"] + extra_levels, (port, want)
    for k in VERDICT[:1] + VERDICT[2:]:
        assert port.get(k) == want.get(k) == jwant.get(k), (k, port, want)


def test_duplicates_and_a_reordered_pair(tmp_path):
    ops = _conc_ops(240, 21)

    def arrive(s, c):
        for i, ch in enumerate(c):
            if i == 3:
                s.append(4, c[4])
                s.append(3, c[3])
                s.append(4, c[4])          # a duplicate
            elif i != 4:
                s.append(i, ch, S.chunk_crc(ch))
        assert s.close(len(c))[0] == 200

    port, ref = both(tmp_path, ops, 24, arrive=arrive)
    agree(port, ref, ops)
    st = port["stream"]
    assert st["ops"] == len(ops) and st["watermark"] == len(ops)
    assert st["dup-chunks"] == 1 and st["reordered"] == 1
    assert st["barriers"] > 5 and st["rebases"] == []
    assert st["failed-fast"] is False and port["valid"] is True


def test_fail_fast_with_the_last_chunk_unsent(tmp_path):
    ops = _conc_ops(200, 22, corrupt_at=3)
    port, ref = both(tmp_path, ops, 20, close=False, hold_last=True)
    agree(port, ref, ops)
    assert port["valid"] is False
    assert port["stream"]["failed-fast"] is True
    assert port["stream"]["watermark"] < len(ops) - 20


def _with_crashed_tail(ops, n_crashed):
    """``ops`` then ``n_crashed`` writes from fresh processes that never
    return (crashed at close)."""
    tail = [{"process": 10 + i, "type": "invoke", "f": "write",
             "value": 1000 + i} for i in range(n_crashed)]
    return ops + tail


@pytest.mark.parametrize("n_crashed,rebases,extra", [
    (3, [], 1), (33, ["crash-width-64"], 0)])
def test_close_adds_crashed_ops(tmp_path, n_crashed, rebases, extra):
    """Up to 32 crashed ops fit the carry's one crashed-mask word, and the
    carry goes on through close; more need a second word: a rebase, and
    a new search over the whole history. The carried search is one level
    past the offline one: at the barrier after 40 events the required op
    that follows (the 21st) is forced (see :func:`agree`)."""
    ops = _with_crashed_tail(_conc_ops(160, 24), n_crashed)
    port, ref = both(tmp_path, ops, 20)
    agree(port, ref, ops, extra_levels=extra)
    assert port["stream"]["rebases"] == rebases
    assert port["crash-width"] == (8 if n_crashed == 3 else 64)
    assert port["valid"] is True


def test_a_crash_pins_the_watermark(tmp_path):
    h = testing.simulate_register_history(300, n_procs=5, n_vals=8, seed=4,
                                          crash_p=0.02)
    ops = [o.to_dict() for o in h]
    first = next(i for i, o in enumerate(ops) if o["type"] == "info")
    port, ref = both(tmp_path, ops, 25)
    agree(port, ref, ops)
    assert port["stream"]["watermark"] == len(ops)
    assert port["crash-width"] > 0 and port["stream"]["rebases"] == []
    assert first < len(ops) - 50


def _window_growth_ops():
    """A sequential start, then one write that stays open across 40
    sequential ops of another process: the stable prefix after it needs a
    window of 41, past the first rungs' 32."""
    ops = []
    for v in range(1, 6):
        ops += [{"process": 1, "type": "invoke", "f": "write", "value": v},
                {"process": 1, "type": "ok", "f": "write", "value": v},
                {"process": 1, "type": "invoke", "f": "read", "value": None},
                {"process": 1, "type": "ok", "f": "read", "value": v}]
    ops.append({"process": 0, "type": "invoke", "f": "write", "value": 99})
    for v in range(6, 26):
        ops += [{"process": 1, "type": "invoke", "f": "write", "value": v},
                {"process": 1, "type": "ok", "f": "write", "value": v},
                {"process": 1, "type": "invoke", "f": "read", "value": None},
                {"process": 1, "type": "ok", "f": "read", "value": v}]
    ops += [{"process": 0, "type": "ok", "f": "write", "value": 99},
            {"process": 1, "type": "invoke", "f": "read", "value": None},
            {"process": 1, "type": "ok", "f": "read", "value": 99}]
    return ops


def test_a_window_that_outgrows_the_rung_rebases(tmp_path):
    ops = _window_growth_ops()
    port, ref = both(tmp_path, ops, 20)
    agree(port, ref, ops)
    assert port["stream"]["rebases"] == ["window-41"]
    assert port["rung"][1] == 64 and port["valid"] is True


@pytest.mark.parametrize("first,second", [(S, JS), (JS, S)])
def test_a_checkpoint_resumes_in_the_other_package(tmp_path, first,
                                                   second):
    ops = _conc_ops(320, 23)
    chunks = _chunks(ops, 16)
    s = session(first, tmp_path)
    feed(s, chunks, close=False)
    # killed after its third segment of 2 levels, mid-stream
    r = run(first, s, [len(c) for c in chunks], seg=2, halt_after=3)
    assert s.state == "open" and r._halt.is_set()
    cp = R.Checkpoint.load(os.path.join(s.dir, S.CHECKPOINT_NAME))
    assert cp.level > 0 and 0 < cp.n_required < len(ops) // 2
    assert 0 < cp.watermark < len(ops)
    s.stop_wal()
    s2 = second.StreamSession.replay(s.dir, str(tmp_path))
    assert s2.state == "open" and s2.ops == ops
    assert s2.close(len(chunks))[0] == 200
    r2 = run(second, s2, [], seg=64)
    res = s2.result
    assert res["stream"]["resume-level"] == cp.level > 0
    want = offline(ops)
    for k in VERDICT:
        assert res.get(k) == want.get(k), (k, res, want)
    s2.stop_wal()
    assert r2._resume_cp is None


def test_a_resumed_stream_goes_on_from_its_level(tmp_path):
    """Killed with the stream half sent, the replayed session's runner
    resumes the checkpoint's level over the longer prefix the WAL
    holds."""
    ops = _conc_ops(320, 25)
    chunks = _chunks(ops, 16)
    s = session(S, tmp_path)
    feed(s, chunks[:8], close=False)
    run(S, s, [len(c) for c in chunks[:8]], seg=2, halt_after=4)
    level = R.Checkpoint.load(os.path.join(s.dir, S.CHECKPOINT_NAME)).level
    for i in range(8, len(chunks)):
        assert s.append(i, chunks[i])[0] == 202
    s.stop_wal()
    s2 = S.StreamSession.replay(s.dir, str(tmp_path))
    assert s2.close(len(chunks))[0] == 200
    run(S, s2, [len(ops) - sum(map(len, chunks[:8]))])
    assert s2.result["stream"]["resume-level"] == level > 0
    want = offline(ops)
    for k in VERDICT:
        assert s2.result.get(k) == want.get(k), k
    s2.stop_wal()


def _faulty(tmp_path, fault, ops):
    """The stream of ``ops`` in 40-op chunks with ``fault(ctx, n)`` called
    before the n-th segment; returns its result, the segments' contexts
    and the result of the same stream without faults."""
    seen = []

    def inject(ctx):
        seen.append(ctx)
        fault(ctx, len(seen))

    out = []
    for sid, seam in (("clean", None), ("faulty", inject)):
        s = session(S, tmp_path, sid)
        chunks = _chunks(ops, 40)
        feed(s, chunks)
        R._inject_fault = seam
        try:
            run(S, s, [len(c) for c in chunks], seg=8)
        finally:
            R._inject_fault = None
        s.stop_wal()
        out.append(s.result)
    return out[1], seen, out[0]


def test_an_oom_halves_the_pool_and_the_stream_goes_on(tmp_path):
    def fault(ctx, n):
        if n == 3:
            raise MemoryError("injected OOM")

    ops = _conc_ops(200, 26)
    res, seen, clean = _faulty(tmp_path, fault, ops)
    assert all(c["backend"] == "stream" for c in seen)
    assert seen[3]["effective"][0] == seen[2]["effective"][0] // 2
    assert seen[3]["level"] == seen[2]["level"]
    assert res["rung"][0] == 16 and res["valid"] is True
    assert clean["rung"][0] == 32 and clean["valid"] is True


def test_a_transient_failure_is_retried(tmp_path, monkeypatch):
    monkeypatch.setenv("JEPSEN_RETRY_BASE", "0.001")

    def fault(ctx, n):
        if n in (2, 3):
            raise ConnectionError("injected reset")

    ops = _conc_ops(200, 27)
    res, seen, clean = _faulty(tmp_path, fault, ops)
    assert seen[1]["level"] == seen[2]["level"] == seen[3]["level"]
    for k in VERDICT + ("segments",):
        assert res.get(k) == clean.get(k), k
    assert res["stream"]["barriers"] == clean["stream"]["barriers"]


def test_a_fatal_failure_ends_the_stream_unknown(tmp_path):
    def fault(ctx, n):
        if n == 2:
            raise RuntimeError("kernel launch failed")

    res, seen, _ = _faulty(tmp_path, fault, _conc_ops(200, 28))
    assert res["valid"] is UNKNOWN and len(seen) == 2
    assert "kernel launch failed" in res["error"]


def test_no_cuda_ends_the_stream_unknown(tmp_path):
    """The default device is CUDA; without one the stream is UNKNOWN with
    the error, never checked on the CPU instead."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    s = session(S, tmp_path)
    feed(s, _chunks(_conc_ops(40, 29), 20))
    run(S, s, [], device=None)
    assert s.result["valid"] is UNKNOWN
    assert "no CUDA device" in s.result["error"]
    s.stop_wal()


def test_the_set_is_checked_offline_at_close(tmp_path):
    h = testing.simulate_set_history(60, n_procs=3, seed=2, crash_p=0.0,
                                     lost_p=0.0)
    ops = [o.to_dict() for o in h]
    s = S.StreamSession("s1", "t", "set", str(tmp_path))
    r = S.StreamRunner(s, SetModel(), device="cpu")
    s.runner = r
    r.start()
    chunks = _chunks(ops, 25)
    for i, ch in enumerate(chunks):
        assert s.append(i, ch)[0] == 202
    time.sleep(0.1)
    assert s.state == "open" and s.result is None
    assert s.close(len(chunks))[0] == 200
    r.join(60)
    want = check_safe(linearizable(SetModel(), device="cpu"), {},
                      History.of(ops))
    for k in VERDICT:
        assert s.result.get(k) == want.get(k), k
    assert s.result["stream"]["barriers"] == 0
    s.stop_wal()


def test_stop_leaves_an_idle_runner_without_a_verdict(tmp_path):
    s = session(S, tmp_path)
    r = S.StreamRunner(s, CASRegister(), device="cpu")
    r.start()
    ch = _conc_ops(40, 30)
    s.append(0, ch)
    deadline = time.monotonic() + 30
    while s.checked_events < len(ch) and time.monotonic() < deadline:
        time.sleep(0.01)
    r.stop()
    r.join(10)
    assert not r.is_alive() and s.state == "open" and s.result is None
    assert s.lag() == 0 and s.status()["checked-level"] > 0
    s.stop_wal()


def test_checks_between_segments_on_the_same_buffers(tmp_path):
    """After each of the stream's segments, a check of another history of
    the same shape runs on the engine's buffers for that shape (the
    stream releases the engine between segments): the stream's result
    is the one it gives alone."""
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.checker.engine import default_engine
    from jepsen_tpu_torch.ops.encode import pack_with_init
    others = {}
    for n in range(20, 400, 4):
        # the shortest history of each required-op bucket
        p, kernel = pack_with_init(History.of(_conc_ops(n, 50)),
                                   CASRegister())
        others.setdefault(G._bucket(p.n_required), (p, kernel))
    ran = []

    class Interleaved(lockstep(S.StreamRunner)):
        def _segment(self):
            super()._segment()
            other = others.get(self._cols["f"].shape[0])
            if other is not None and self._seg_idx % 3 == 0:
                before = dict(default_engine()._states)
                out = R.supervised_check_packed(*other, device="cpu")
                assert out["valid"] is True
                assert default_engine()._states.keys() == before.keys()
                ran.append(out["levels"])

    ops = _conc_ops(320, 51)
    chunks = _chunks(ops, 16)
    results = []
    for sid, cls in (("alone", lockstep(S.StreamRunner)),
                     ("interleaved", Interleaved)):
        s = session(S, tmp_path, sid)
        feed(s, chunks)
        r = cls(s, CASRegister(), device="cpu", segment_iters=4,
                sizes=[len(c) for c in chunks])
        r.start()
        r.join(120)
        assert s.state == "done"
        results.append(s.result)
        s.stop_wal()
    alone, mixed = results
    assert len(ran) >= 8
    for k in VERDICT + ("segments", "rung"):
        assert mixed.get(k) == alone.get(k), k
    for k in STREAM + ("captures",):
        assert mixed["stream"][k] == alone["stream"][k], k
    assert alone["valid"] is True
