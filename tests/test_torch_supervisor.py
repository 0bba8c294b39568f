"""The segment supervisor on the CPU, against the reference's.

* ``Checkpoint`` files interchange: one saved by the port loads in
  ``jepsen_tpu.resilience.Checkpoint.load`` with every field and array
  (dtype included) equal, and the reverse.
* A search resumed from a mid-run checkpoint of either package ends with
  the uninterrupted run's ``valid``, ``levels`` and ``best-k``, and with
  the reference's own resumed result.
* ``_shrink_carry``, ``_fit_carry_stats`` and ``_grow_carry_stats`` equal
  the reference's on the same carries, ``lossy`` when live rows drop.
* Faults through the ``_inject_fault`` seam, with the reference's
  context dict: an OOM halves the pool and resumes the checkpoint (the
  same verdict, levels, effective rung and trail as the reference under
  the same fault), at the pool floor it gives up; a transient retries;
  a fatal failure raises with the trail. An OOM of the allocator
  (``Engine._alloc``) halves too.
* ``RetryPolicy.delay`` with a seeded ``rng`` equals the reference's;
  ``retry_until_deadline`` and ``deadline_stop``.
* ``supervised_check_history`` equals the reference's on the register and
  mutex generators, and is None for a model without a kernel.

Both packages run segments of 64 levels, so their checkpoints fall on the
same levels. Tolerance: none (integer state, equal result fields).
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from jepsen_tpu import resilience as JR
from jepsen_tpu import testing as jt
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.models import core as J
from jepsen_tpu.ops.encode import pack_with_init as j_pack

from jepsen_tpu_torch import resilience as R
from jepsen_tpu_torch import testing as pt
from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.checker import engine as engine_mod
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import core as P
from jepsen_tpu_torch.ops.encode import pack_with_init

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

SEG = 64
FIELDS = ("valid", "levels", "max-linearized-prefix", "final-states",
          "rung", "work")


def _histories():
    """A valid register history deeper than two segments, and a
    corrupted one that the first rung refutes."""
    ok = jt.simulate_register_history(220, n_procs=5, n_vals=8, seed=6,
                                      crash_p=0.02)
    bad = jt.corrupt_one_read(jt.simulate_register_history(
        100, n_procs=5, n_vals=8, seed=15), random.Random(15))
    return {"valid": ok, "invalid": bad}


def _both(h):
    """(port packed, its kernel, reference packed, its kernel)."""
    p, k = pack_with_init(History.of(o.to_dict() for o in h), P.CASRegister())
    jp, jk = j_pack(h, J.CASRegister())
    return p, k, jp, jk


def pick(r, fields=FIELDS):
    return {f: r.get(f) for f in fields}


def _ours(p, k, **kw):
    return R.supervised_check_packed(p, k, device="cpu", segment_iters=SEG,
                                     **kw)


def _ref(jp, jk, **kw):
    return JR.supervised_check_packed(jp, jk, segment_iters=SEG, **kw)


def _assert_same_checkpoint(a, b):
    assert len(a.carry) == len(b.carry) == 14
    for x, y in zip(a.carry, b.carry):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for f in ("rung", "window", "expand_eff", "crash_width", "segment",
              "watermark", "n_required", "capacity_eff", "level"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("name", ["valid", "invalid"])
def test_checkpoints_round_trip_between_the_packages(tmp_path, name):
    p, k, jp, jk = _both(_histories()[name])
    ours, ref = [], []
    _ours(p, k, on_checkpoint=ours.append)
    _ref(jp, jk, on_checkpoint=ref.append)
    assert ours and len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.level == b.level and a.rung == b.rung
    cp = dataclasses.replace(ours[0], watermark=17, n_required=40)
    cp.save(str(tmp_path / "port.npz"))
    _assert_same_checkpoint(cp, JR.Checkpoint.load(str(tmp_path / "port.npz")))
    ref[-1].save(str(tmp_path / "ref.npz"))
    _assert_same_checkpoint(ref[-1], R.Checkpoint.load(str(tmp_path /
                                                           "ref.npz")))
    # the port's and the reference's checkpoints of one segment are equal
    _assert_same_checkpoint(
        R.Checkpoint.load(str(tmp_path / "ref.npz")), ours[-1])


@pytest.mark.parametrize("name", ["valid", "invalid"])
def test_a_resumed_search_equals_the_uninterrupted_one(tmp_path, name):
    """Resumed from its middle checkpoint (the valid history's second of
    three segments; the refuted one has one, where its search ended)."""
    p, k, jp, jk = _both(_histories()[name])
    cps = []
    full = _ours(p, k, on_checkpoint=cps.append)
    assert len(cps) == full["segments"] == (3 if name == "valid" else 1)
    path = str(tmp_path / "mid.npz")
    cps[len(cps) // 2].save(path)
    resumed = _ours(p, k, resume=R.Checkpoint.load(path))
    ref_resumed = _ref(jp, jk, resume=JR.Checkpoint.load(path))
    ref_full = _ref(jp, jk)
    fields = ("valid", "levels", "best-k")
    assert pick(resumed, fields) == pick(full, fields)
    assert pick(resumed) == pick(ref_resumed) == pick(ref_full)
    assert resumed["segments"] == full["segments"]
    # the reference's own middle checkpoint resumes in the port
    jcps = []
    _ref(jp, jk, on_checkpoint=jcps.append)
    jcps[len(jcps) // 2].save(path)
    from_ref = _ours(p, k, resume=R.Checkpoint.load(path))
    assert pick(from_ref) == pick(ref_full)


def _carries():
    """A mid-run carry with live rows all over its pool, and a fresh one
    with its single live row first."""
    p, k, _, _ = _both(_histories()["valid"])
    cps = []
    _ours(p, k, on_checkpoint=cps.append)
    fresh = G._carry0_host(32, 32, 8, 3, 10, stats_rows=0)
    return cps[0].carry, fresh


def test_the_carry_fits_equal_the_references():
    mid, fresh = _carries()
    assert np.count_nonzero(mid[4][16:]) > 0
    for carry in (mid, fresh, mid[:13]):
        for cap in (32, 16, 4):
            a, da = R._shrink_carry(carry, cap)
            b, db = JR._shrink_carry(carry, cap)
            assert da == db and len(a) == len(b)
            for x, y in zip(a, b):
                assert np.asarray(x).dtype == np.asarray(y).dtype
                assert np.array_equal(x, y)
    assert R._shrink_carry(mid, 16)[1] is True
    assert bool(R._shrink_carry(mid, 16)[0][6]) is True
    assert R._shrink_carry(fresh, 4)[1] is False
    lmax = mid[13].shape[0] - 1
    for carry in (mid, mid[:13], fresh):
        for stats in (True, False):
            a = R._fit_carry_stats(carry, stats, lmax)
            b = JR._fit_carry_stats(carry, stats, lmax)
            assert len(a) == len(b)
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        for grow in (lmax - 5, lmax, lmax + 40):
            a = R._grow_carry_stats(carry, grow)
            b = JR._grow_carry_stats(carry, grow)
            assert len(a) == len(b)
            assert all(np.array_equal(x, y) for x, y in zip(a, b))


def _fault_once(segment, exc):
    """An ``_inject_fault`` that raises ``exc`` the first time it sees
    ``segment``; the contexts it saw."""
    seen = []

    def inject(ctx):
        seen.append(ctx)
        if ctx["segment"] == segment and sum(
                c["segment"] == segment for c in seen) == 1:
            raise exc

    return inject, seen


def _policy(**kw):
    return dict(backoff_base_s=0.0, jitter=False, **kw)


def _events(r):
    return [(e["event"], e.get("outcome")) for e in r["attempts"]]


def test_an_injected_oom_halves_the_pool_as_the_reference_does(monkeypatch):
    p, k, jp, jk = _both(_histories()["valid"])
    out = {}
    for mod, run, name in ((R, _ours, "port"), (JR, _ref, "ref")):
        inject, seen = _fault_once(1, MemoryError("injected OOM"))
        monkeypatch.setattr(mod, "_inject_fault", inject)
        args = (p, k) if mod is R else (jp, jk)
        out[name] = run(*args, policy=mod.RetryPolicy(**_policy()))
        out[name + " seen"] = [(c["segment"], c["level"], c["effective"])
                               for c in seen]
    ours, ref = out["port"], out["ref"]
    assert pick(ours) == pick(ref)
    assert ours["rung"] == (16, 32, 2) and ours["rung-requested"] == (32, 32,
                                                                       4)
    assert _events(ours) == _events(ref) == [
        ("oom", "pool-halved-to-16"), ("rung-complete", None)]
    assert ours["attempts"][0]["level"] == ref["attempts"][0]["level"] == SEG
    assert out["port seen"] == out["ref seen"]
    assert ours["valid"] is True


def test_an_oom_at_the_pool_floor_gives_up_as_the_reference_does(
        monkeypatch):
    p, k, jp, jk = _both(_histories()["valid"])
    out = {}
    for mod, run, name in ((R, _ours, "port"), (JR, _ref, "ref")):
        inject, _ = _fault_once(0, MemoryError("injected OOM"))
        monkeypatch.setattr(mod, "_inject_fault", inject)
        args = (p, k) if mod is R else (jp, jk)
        out[name] = run(*args, capacity=32, window=32, expand=4,
                        policy=mod.RetryPolicy(**_policy(min_capacity=32)))
    ours, ref = out["port"], out["ref"]
    assert ours["valid"] == ref["valid"] == UNKNOWN
    assert ours["error"] == ref["error"]
    assert _events(ours) == _events(ref) == [("oom", "gave-up"),
                                             ("rung-aborted", None)]


def test_a_transient_fault_retries_and_a_fatal_one_raises(monkeypatch):
    p, k, jp, jk = _both(_histories()["valid"])
    plain = _ours(p, k)
    for mod, run, args in ((R, _ours, (p, k)), (JR, _ref, (jp, jk))):
        inject, _ = _fault_once(1, ConnectionError("connection reset"))
        monkeypatch.setattr(mod, "_inject_fault", inject)
        r = run(*args, policy=mod.RetryPolicy(**_policy()))
        assert _events(r) == [("transient", "retry-1"),
                              ("rung-complete", None)]
        assert pick(r) == pick(plain)
    for mod, run, args in ((R, _ours, (p, k)), (JR, _ref, (jp, jk))):
        inject, _ = _fault_once(1, ValueError("corrupted state"))
        monkeypatch.setattr(mod, "_inject_fault", inject)
        with pytest.raises(ValueError) as e:
            run(*args)
        trail = e.value.resilience_trail
        assert [(t["event"], t["outcome"]) for t in trail] == [
            ("fatal", "raised")]
        assert trail[0]["segment"] == 1 and trail[0]["level"] == SEG


def test_an_allocator_oom_halves_the_pool(monkeypatch):
    """``Engine._alloc`` turns the device's out-of-memory into a
    MemoryError; the supervisor halves the pool and resumes the rung's
    start, with no checkpoint asked for."""
    monkeypatch.setattr(engine_mod, "_DEFAULT", engine_mod.Engine())
    real = G.empty_scratch

    def scratch(shape, device):
        if shape.C == 32:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return real(shape, device)

    monkeypatch.setattr(G, "empty_scratch", scratch)
    p, k, _, _ = _both(_histories()["valid"])
    r = _ours(p, k, policy=R.RetryPolicy(**_policy()))
    assert r["valid"] is True and r["rung"] == (16, 32, 2)
    assert _events(r) == [("oom", "pool-halved-to-16"),
                          ("rung-complete", None)]
    assert "needs" in r["attempts"][0]["error"]


def test_retry_policy_delay_equals_the_references():
    for seed in (0, 7):
        ours = R.RetryPolicy(rng=random.Random(seed))
        ref = JR.RetryPolicy(rng=random.Random(seed))
        assert [ours.delay(a) for a in range(8)] == [
            ref.delay(a) for a in range(8)]
    flat = R.RetryPolicy(jitter=False, backoff_base_s=0.5, backoff_cap_s=3.0)
    assert [flat.delay(a) for a in range(1, 6)] == [0.5, 1.0, 2.0, 3.0, 3.0]


def test_retry_until_deadline_and_deadline_stop():
    policy = R.RetryPolicy(backoff_base_s=0.0, jitter=False)
    calls = []

    def third():
        calls.append(1)
        if len(calls) == 1:
            raise ConnectionError("down")
        return len(calls) >= 3

    assert R.retry_until_deadline(third, 5.0, policy) == (True, 3, None)
    ok, attempts, err = R.retry_until_deadline(lambda: False, 0.0, policy)
    assert (ok, attempts, err) == (False, 1, "probe returned falsy")
    assert R.deadline_stop(0.0)() is True
    assert R.deadline_stop(60.0)() is False
    assert R.deadline_stop(60.0, inner=lambda: True)() is True


class _Opaque(P.Model):
    """A model with no word kernel."""


class _JOpaque(J.Model):
    """The reference's model with no word kernel."""


def test_supervised_check_history_equals_the_references():
    reg = jt.simulate_register_history(120, n_procs=5, n_vals=8, seed=3,
                                       crash_p=0.02)
    mutex = pt.simulate_mutex_history(120, 4, seed=5, crash_p=0.02)
    for h, model, jmodel in ((reg, P.CASRegister(), J.CASRegister()),
                             (mutex, P.Mutex(), J.Mutex())):
        ours = R.supervised_check_history(
            History.of(o.to_dict() for o in h), model, device="cpu")
        ref = JR.supervised_check_history(
            JHistory.of(o.to_dict() for o in h), jmodel)
        assert pick(ours) == pick(ref) and ours["valid"] is True
    assert R.supervised_check_history(
        History.of(o.to_dict() for o in reg), _Opaque(), device="cpu") is None
    assert JR.supervised_check_history(reg, _JOpaque()) is None
