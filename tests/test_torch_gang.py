"""The port's gang search against the JAX gang search, on the CPU.

* ``check_packed_gang_gpu(device="cpu")`` against
  ``jepsen_tpu.checker.tpu.check_packed_gang`` member by member, at
  ``segment_iters`` 1, 64 and the default: valid, levels, prefix, final
  states, frontier op, rung, work, gang size and crash width; trivial,
  crashed-overflow, refuted and escalating members among them.
* Each member of a one-bucket gang equals the port's own serial search
  (``check_packed_gpu``).
* A deadline cancels one lane on the device (its pool rows and its
  live-row count), its gang mates finish with their serial results.
* The ``_GANG_FAULT`` seam, the failure taxonomy and ``bisect_poison``.
* The cooperative deadline of the serial search, which releases the
  engine's lock.
* The engine's buckets, warm state and LRU bound, and the admission
  footprint.

Tolerance: none (integer state and equal result fields).
"""

import random
import time

import pytest
import torch

from jepsen_tpu import testing as jt
from jepsen_tpu.checker import tpu as T
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.models import CASRegister as JCASRegister
from jepsen_tpu.ops.encode import pack_with_init as j_pack

from jepsen_tpu_torch import interop, resilience
from jepsen_tpu_torch.checker import UNKNOWN, check_safe
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.checker import plan
from jepsen_tpu_torch.checker.engine import Engine, default_engine
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.kernels import parity
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.ops.encode import pack_with_init

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

#: the fields a gang member's result must share with the reference's and
#: with its serial search
FIELDS = ("valid", "levels", "max-linearized-prefix", "final-states",
          "frontier-op", "rung", "work", "crash-width")


def conc_ops(n, seed, value_base=0):
    """A concurrent register history as op dicts (4 processes,
    interleaved invocations), drawn from ``random.Random(seed)``."""
    rng = random.Random(seed)
    ops, t, pend, val = [], 0, {}, value_base
    for _ in range(n):
        p = rng.choice((0, 1, 2, 3))
        if p in pend:
            inv = pend.pop(p)
            ops.append({"process": p, "type": "ok", "f": inv["f"],
                        "value": inv["value"], "time": t})
        else:
            f = rng.choice(("write", "read"))
            v = val if f == "write" else None
            if f == "write":
                val += 1
            inv = {"process": p, "type": "invoke", "f": f, "value": v,
                   "time": t}
            ops.append(inv)
            pend[p] = inv
        t += 1
    for p, inv in pend.items():
        ops.append({"process": p, "type": "ok", "f": inv["f"],
                    "value": inv["value"], "time": t})
        t += 1
    return ops


def bad_read(ops):
    """The history with its first ok read answered by a value never
    written."""
    out = [dict(o) for o in ops]
    i = next(i for i, o in enumerate(out)
             if o["type"] == "ok" and o["f"] == "read")
    out[i]["value"] = 10**6
    return out


def crashed_writes(n):
    """``n`` writes that all crashed: no required op."""
    ops = []
    for p in range(n):
        ops.append({"process": p, "type": "invoke", "f": "write",
                    "value": p, "time": 2 * p})
        ops.append({"process": p, "type": "info", "f": "write",
                    "value": p, "time": 2 * p + 1})
    return ops


def jsim(n, seed, corrupt=False, **kw):
    """A simulated register history (the JAX package's simulator) as op
    dicts, optionally with one read corrupted."""
    h = jt.simulate_register_history(n, n_procs=5, n_vals=8, seed=seed,
                                     **kw)
    if corrupt:
        h = jt.corrupt_one_read(h, random.Random(seed))
    return [o.to_dict() for o in h]


def packs(histories):
    """(port packs, port kernel, reference packs, reference kernel)."""
    ours = [pack_with_init(History.of(h), CASRegister()) for h in histories]
    ref = [j_pack(JHistory.of(h), JCASRegister()) for h in histories]
    return ([p for p, _ in ours], ours[0][1], [p for p, _ in ref],
            ref[0][1])


def pick(r):
    return {k: r.get(k) for k in FIELDS}


#: a mixed gang: concurrent histories, one refuted at once, a crashy one,
#: corrupted simulated histories that escalate past the first CPU rung
#: (refuted on the second and the third), a trivial member and one with
#: more crashed ops than the crashed-set width
MIXED = (
    lambda: conc_ops(24, 3), lambda: conc_ops(40, 4, 100),
    lambda: bad_read(conc_ops(24, 5)),
    lambda: jsim(100, 6, crash_p=0.05),
    lambda: jsim(100, 12, corrupt=True), lambda: jsim(200, 8, corrupt=True),
    lambda: crashed_writes(3), lambda: crashed_writes(130) + conc_ops(8, 9),
)


@pytest.mark.parametrize("segment_iters", [1, 64, None])
def test_the_gang_matches_the_jax_gang(segment_iters):
    hs = [make() for make in MIXED]
    ours_p, kernel, ref_p, ref_kernel = packs(hs)
    ref = T.check_packed_gang(ref_p, ref_kernel,
                              segment_iters=segment_iters)
    ours = G.check_packed_gang_gpu(ours_p, kernel,
                                   segment_iters=segment_iters,
                                   device="cpu")
    assert len(ours) == len(hs)
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert pick(a) == pick(b), (i, a, b)
        assert a.get("gang-size") == b.get("gang-size"), i
        assert a.get("error") == b.get("error"), i
        assert a["backend"] == "gpu"
    valids = [r["valid"] for r in ours]
    assert valids[:3] == [True, True, False]
    assert valids[4] is False and valids[5] is False
    assert valids[6] is True and valids[7] is UNKNOWN
    # members 4 and 5 escalated: the gang ran more than one rung
    assert len(ours[4]["work"]) > 1 and len(ours[5]["work"]) > 1


def test_each_member_equals_its_serial_search():
    """A one-bucket gang (16 required ops, no crashed op, window 32):
    every member's result is its serial search's."""
    hs = [conc_ops(24, s, 100 * s) for s in range(20, 26)]
    hs.append(bad_read(conc_ops(24, 26)))
    ours_p, kernel, _, _ = packs(hs)
    buckets = {Engine.bucket_key(p, kernel) for p in ours_p}
    assert len(buckets) == 1, buckets
    gang = G.check_packed_gang_gpu(ours_p, kernel, device="cpu")
    for p, g in zip(ours_p, gang):
        serial = G.check_packed_gpu(p, kernel, device="cpu")
        assert pick(g) == pick(serial), (g, serial)
        assert g["gang-size"] == len(hs) and g["tiebreak"] == "lex"
    assert gang[-1]["valid"] is False and gang[-1]["final-states"]


def test_an_empty_gang_and_a_trivial_member():
    p, kernel, _, _ = packs([crashed_writes(2)])
    assert G.check_packed_gang_gpu([], kernel, device="cpu") == []
    assert G.check_packed_gang_gpu(p, kernel, device="cpu") == [
        {"valid": True, "levels": 0, "backend": "gpu"}]


def test_a_deadline_cancels_one_lane_not_the_gang():
    """The victim's deadline has passed: it is cancelled at the first
    segment barrier, as in the reference, and its gang mate ends with its
    serial result. The port runs segments in level pairs, so a one-level
    segment is rounded up to two: its barrier is the reference's at
    ``segment_iters=2``."""
    hs = [conc_ops(24, 5), conc_ops(24, 6, value_base=100)]
    ours_p, kernel, ref_p, ref_kernel = packs(hs)
    dls = [time.monotonic() - 1.0, None]
    ours = G.check_packed_gang_gpu(ours_p, kernel, deadlines=dls,
                                   segment_iters=1, device="cpu")
    ref = T.check_packed_gang(ref_p, ref_kernel, deadlines=dls,
                              segment_iters=2)
    assert ours[0] == dict(ref[0], backend="gpu")
    assert ours[0] == {"valid": UNKNOWN, "error": ":info/timeout",
                       "error-class": "wedge", "backend": "gpu",
                       "levels": 2, "rung": (32, 32, 4),
                       "gang-cancelled": True}
    serial = G.check_packed_gpu(ours_p[1], kernel, device="cpu")
    assert ours[1]["valid"] is True and pick(ours[1]) == pick(serial)
    assert pick(ours[1]) == pick(ref[1])


def test_cancel_lanes_clears_both_the_rows_and_the_count():
    """``active`` reads the live-row count: clearing the pool rows alone
    leaves a lane searching; cancel_lanes clears both, and the lane's
    carry then stays as it was while its neighbour goes on."""
    hs = [conc_ops(40, 30), conc_ops(40, 31, 100)]
    ours_p, kernel, _, _ = packs(hs)
    breq = max(G._bucket(p.n_required) for p in ours_p)
    cols = [G._split_packed(p, breq, 0, kernel) for p in ours_p]
    lv = parity.Level(cols, (32, 32, 4), "cpu")
    assert lv.advance(3) > 0
    rows_only = parity.copy_state(lv.carry, lv.scratch)[0]
    rows_only.pool.alive[0] = False
    assert K.active(rows_only.scal, lv.shape.lmax).tolist() == [1, 1]
    G.cancel_lanes(lv.carry, [0])
    assert not bool(lv.carry.pool.alive[0].any())
    assert int(lv.carry.scal[0, K.NALIVE]) == 0
    assert K.active(lv.carry.scal, lv.shape.lmax).tolist() == [0, 1]
    before = interop.batch_carry_to_numpy(lv.carry)
    lv.advance(5)
    after = interop.batch_carry_to_numpy(lv.carry)
    for x, y in zip(before, after):
        assert (x[0] == y[0]).all()
    assert int(after[8][1]) == int(before[8][1]) + 5


def test_the_gang_fault_seam_raises_through(monkeypatch):
    p, kernel, _, _ = packs([conc_ops(24, 3)])

    def boom(pks):
        raise MemoryError("injected")

    monkeypatch.setattr(G, "_GANG_FAULT", boom)
    with pytest.raises(MemoryError, match="injected"):
        G.check_packed_gang_gpu(p, kernel, device="cpu")


# ---------------------------------------------------------------------------
# Failure taxonomy and poison bisection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exc,cls", [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"),
     resilience.OOM),
    (RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB"),
     resilience.OOM),
    (MemoryError("the search state needs 9 bytes"), resilience.OOM),
    (resilience.WedgeError("late"), resilience.WEDGE),
    (RuntimeError("NCCL error: unhandled system error"), resilience.DCN),
    (ConnectionError("reset"), resilience.TRANSIENT),
    (ValueError("bad shape"), resilience.FATAL),
])
def test_classify_failure(exc, cls):
    assert resilience.classify_failure(exc) == cls


def test_check_safe_reports_the_failure_class():
    class Boom:
        def check(self, test, history, opts=None):
            err = MemoryError("no room")
            err.resilience_trail = [{"event": "oom", "outcome": "gave-up"}]
            raise err

    out = check_safe(Boom(), {}, [])
    assert out["valid"] is UNKNOWN and out["error-class"] == "oom"
    assert out["attempts"] == [{"event": "oom", "outcome": "gave-up"}]
    assert resilience.result_failure_class(
        {"valid": UNKNOWN, "attempts": out["attempts"]}) == "oom"
    assert resilience.result_failure_class({"valid": False}) is None


def test_bisect_isolates_a_single_poison():
    calls = []

    def run_gang(span):
        calls.append(list(span))
        if 3 in span:
            raise MemoryError("poison")
        return [{"valid": True, "member": m} for m in span]

    results, poison, bisections = resilience.bisect_poison(
        list(range(6)), run_gang)
    assert poison == [3] and bisections >= 1
    assert results[3]["error-class"] == "oom"
    for i in (0, 1, 2, 4, 5):
        assert results[i] == {"valid": True, "member": i}
    assert calls[0] == [0, 1, 2, 3, 4, 5]


def test_a_clean_gang_is_not_bisected():
    results, poison, bisections = resilience.bisect_poison(
        [10, 11], lambda span: [{"valid": True}] * len(span))
    assert poison == [] and bisections == 0
    assert results == [{"valid": True}, {"valid": True}]


def test_the_result_failure_class_drives_the_split():
    """A gang call that returns one failure dict (instead of raising) is
    split too; an unclassified failure is not."""
    def run_gang(span):
        if 1 in span:
            return {"valid": UNKNOWN, "error": "wedged",
                    "error-class": "wedge"}
        return [{"valid": True}] * len(span)

    results, poison, _ = resilience.bisect_poison([0, 1], run_gang)
    assert poison == [1] and results[0] == {"valid": True}
    assert results[1]["error-class"] == "wedge"
    results, poison, bisections = resilience.bisect_poison(
        [0, 1], lambda span: {"valid": UNKNOWN, "error": "?"})
    assert poison == [0, 1] and bisections == 0


# ---------------------------------------------------------------------------
# The serial search's cooperative deadline
# ---------------------------------------------------------------------------


def test_the_serial_deadline_stops_at_a_barrier_and_frees_the_engine():
    p, kernel, _, _ = packs([conc_ops(200, 40)])
    eng = default_engine()
    # a one-level segment is rounded up to a level pair
    out = resilience.supervised_check_packed(
        p[0], kernel, segment_iters=1, device="cpu",
        deadline=time.monotonic() - 1.0)
    assert out == {"valid": UNKNOWN, "error": ":info/timeout",
                   "error-class": "wedge", "backend": "gpu", "levels": 2,
                   "rung": (32, 32, 4)}
    assert not eng.lock.locked()
    # a search that ends within its deadline is not cut
    full = G.check_packed_gpu(p[0], kernel, device="cpu",
                              deadline=time.monotonic() + 600)
    plain = G.check_packed_gpu(p[0], kernel, device="cpu")
    # the host-timed seconds differ from run to run; their keys do not
    assert full.pop("device-s").keys() == plain.pop("device-s").keys()
    assert full == plain
    # through the facade: the timeout is returned, with no host search
    from jepsen_tpu_torch.checker.wgl import linearizable
    r = linearizable(CASRegister(), device="cpu").check(
        {}, History.of(conc_ops(200, 40)),
        {"deadline": time.monotonic() - 1.0})
    assert r["error"] == ":info/timeout" and "fallback-from" not in r


# ---------------------------------------------------------------------------
# Engine buckets and warm state; the admission footprint
# ---------------------------------------------------------------------------


def test_bucket_key_matches_the_reference():
    hs = [conc_ops(24, 3), jsim(100, 6, crash_p=0.05), crashed_writes(3),
          crashed_writes(130) + conc_ops(8, 9)]
    ours_p, kernel, ref_p, ref_kernel = packs(hs)
    from jepsen_tpu.checker.engine import Engine as JEngine
    for a, b in zip(ours_p, ref_p):
        assert Engine.bucket_key(a, kernel) == JEngine.bucket_key(
            b, ref_kernel)


def test_warm_allocates_the_buckets_buffers_and_eviction_frees_them():
    eng = Engine(max_warm_buckets=2)
    hs = [conc_ops(24, 3), conc_ops(300, 4), jsim(100, 6, crash_p=0.05)]
    ps, kernel, _, _ = packs(hs)
    buckets = [Engine.bucket_key(p, kernel) for p in ps]
    assert len(set(buckets)) == 3
    w = eng.warm(ps[0], kernel, device="cpu")
    assert (w["shapes"], w["already-warm"]) == (4, False)
    assert eng.warm(ps[0], kernel, device="cpu")["already-warm"] is True
    assert len(eng._states) == 4 and w["bytes"] == sum(
        G.state_bytes(s) for s, *_ in eng._states)
    eng.warm(ps[1], kernel, rungs=1, device="cpu")
    assert eng.warm_buckets() == buckets[:2]
    eng.warm(ps[0], kernel, device="cpu")          # touch: now newest
    eng.warm(ps[2], kernel, rungs=1, device="cpu")  # evicts bucket 1
    assert eng.warm_buckets() == [buckets[0], buckets[2]]
    assert eng.evictions == 1
    # every buffer of the evicted bucket went; the others stayed
    assert {(s.n, s.CR) for s, *_ in eng._states} == {
        (b[1], b[2]) for b in (buckets[0], buckets[2])}
    eng.set_max_warm_buckets(1)
    assert eng.warm_buckets() == [buckets[2]] and eng.evictions == 2
    assert {(s.n, s.CR) for s, *_ in eng._states} == {
        (buckets[2][1], buckets[2][2])}


def test_the_max_warm_buckets_env(monkeypatch):
    monkeypatch.setenv("JTPU_ENGINE_MAX_BUCKETS", "3")
    assert Engine().max_warm_buckets == 3
    monkeypatch.setenv("JTPU_ENGINE_MAX_BUCKETS", "x")
    assert Engine().max_warm_buckets == 0


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_the_footprint_prices_the_first_rungs_buffers(device):
    ps, kernel, _, _ = packs([jsim(100, 6, crash_p=0.05)])
    p = ps[0]
    dims = plan.PlanDims.from_packed(p)
    assert dims == plan.PlanDims.from_history(
        History.of(jsim(100, 6, crash_p=0.05)), CASRegister())
    cap, win, exp = G._ladder_for(G._window_needed(p),
                                  torch.device(device))[0]
    crw = G._crash_width(p.n - p.n_required)
    breq = G._bucket(p.n_required)
    shape = K.LevelShape(C=cap, W=win, E=min(exp, cap), n=breq, CR=crw)
    fp = plan.request_footprint(dims, device)
    cols = interop.cols_from_numpy(G._split_packed(p, breq, crw, kernel),
                                   "cpu")
    assert fp == G.state_bytes(shape) + sum(
        t.numel() * t.element_size() for t in cols.values())
    assert plan.gang_footprint(dims, 8, device) == 8 * fp
    assert plan.request_footprint(plan.PlanDims(10, 200), device) is None


def test_the_bytes_limit(monkeypatch):
    monkeypatch.setenv("JTPU_PLAN_BYTES_LIMIT", "4096")
    assert plan.plan_bytes_limit() == 4096
    monkeypatch.delenv("JTPU_PLAN_BYTES_LIMIT")
    assert plan.plan_bytes_limit("cpu") is None


def test_the_register_corruption_is_refuted_at_once():
    """``corrupt_model_history`` on a register history answers its first
    ok read with a value never written: the port and the reference refute
    it within a few levels, on the first rung."""
    from jepsen_tpu.checker.tpu import check_history_tpu
    from jepsen_tpu_torch.testing import (corrupt_model_history,
                                          simulate_register_history)
    h = simulate_register_history(300, n_procs=5, n_vals=16, seed=42,
                                  crash_p=0.01)
    bad = corrupt_model_history(h, "cas-register")
    changed = [i for i, (a, b) in enumerate(zip(h, bad)) if a != b]
    assert len(changed) == 1 and bad[changed[0]].f == "read"
    ours = G.check_history_gpu(bad, CASRegister(), device="cpu")
    ref = check_history_tpu(JHistory.of(o.to_dict() for o in bad),
                            JCASRegister())
    assert pick(ours) == pick(ref)
    assert ours["valid"] is False and ours["levels"] < 20
    assert len(ours["work"]) == 1


def test_the_port_prices_its_own_buffers_not_the_references_model():
    """At one rung the port's admission footprint (its carry, scratch and
    per-level stats log, and the columns) is about twice the reference's
    model of its XLA buffers, so one byte budget admits about half as
    many requests: 161,732 against 80,241 bytes for a 2,000-op register
    request at the CPU's first rung (32, 32, 4), 87,380 of the port's in
    the stats log and 32 in its crash-bound column."""
    from jepsen_tpu.checker import plan as jplan
    from jepsen_tpu_torch.testing import simulate_register_history
    h = simulate_register_history(2000, n_procs=5, n_vals=16, seed=9000,
                                  crash_p=0.002)
    dims = plan.PlanDims.from_history(h, CASRegister())
    ref = jplan.request_footprint(jplan.PlanDims(
        n_required=dims.n_required, n_crashed=dims.n_crashed,
        window_needed=dims.window_needed))
    ours = plan.request_footprint(dims, "cpu")
    assert (ours, ref) == (161732, 80241)
    # more than half of the port's bytes are the per-level stats log
    stats_log = 4 * K.NSTAT * (K.LevelShape(32, 32, 4, 2048, 8).lmax + 1)
    assert stats_log == 87380 and 2 * stats_log > ours
