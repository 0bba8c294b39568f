"""The port's checker against the JAX checker on the CPU: verdict,
levels, max-linearized-prefix, rung and work (every rung the search ran,
with its level count) must be equal. ``device="cpu"`` runs the kernels'
plain versions; the first rung is then (32, 4), as in the JAX package on
its CPU backend."""

import random

import pytest
import torch

from jepsen_tpu.checker.tpu import check_history_tpu
from jepsen_tpu.models import CASRegister as JCASRegister
from jepsen_tpu import testing as jt

from jepsen_tpu_torch.analysis.history_lint import MalformedHistoryError
from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.checker.gpu import check_history_gpu
from jepsen_tpu_torch.checker.wgl import (LinearizableChecker, check_packed,
                                          linearizable)
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.ops.encode import pack_with_init

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

KEYS = ("valid", "levels", "max-linearized-prefix", "rung", "work")


def _port(h):
    return History.of(o.to_dict() for o in h)


def assert_same(h, **kw):
    ref = check_history_tpu(h, JCASRegister(), **kw)
    ours = check_history_gpu(_port(h), CASRegister(), device="cpu", **kw)
    assert {k: ours.get(k) for k in KEYS} == {k: ref.get(k) for k in KEYS}
    assert ours["backend"] == "gpu"
    return ours


@pytest.mark.parametrize("n_ops,seed,crash_p", [
    (1000, 1, 0.0), (1000, 2, 0.0), (2000, 3, 0.0), (1000, 6, 0.01)])
def test_valid_histories_match_jax(n_ops, seed, crash_p):
    h = jt.simulate_register_history(n_ops, n_procs=5, n_vals=8, seed=seed,
                                     crash_p=crash_p)
    assert assert_same(h)["valid"] is True


#: corrupt_one_read seeds whose sampled row is a read (the mutation lands);
#: they are refuted on the first, second and third rungs
@pytest.mark.parametrize("n_ops,seed", [(100, 15), (100, 12), (200, 8),
                                        (200, 13)])
def test_corrupted_histories_match_jax(n_ops, seed):
    base = jt.simulate_register_history(n_ops, n_procs=5, n_vals=8,
                                        seed=seed)
    h = jt.corrupt_one_read(base, random.Random(seed))
    assert [o.value for o in h] != [o.value for o in base]
    out = assert_same(h)
    assert out["valid"] is False
    assert out["final-states"]


#: the valid wide history at the JAX package's own test rung; the
#: corrupted one at a slimmer rung, where it goes lossy within ~300 levels
#: instead of burning the wide rung's whole level budget
@pytest.mark.parametrize("corrupt,rung", [(False, (4096, 128, 256)),
                                          (True, (256, 128, 64))])
def test_wide_history_matches_jax(corrupt, rung):
    h = jt.wide_history(100, 2, seed=5, corrupt=corrupt)
    cap, win, exp = rung
    out = assert_same(h, capacity=cap, window=win, expand=exp)
    assert (out["valid"] is True) is (not corrupt)


def test_segment_length_does_not_change_the_result():
    h = jt.simulate_register_history(300, n_procs=5, seed=6, crash_p=0.02)
    a = check_history_gpu(_port(h), CASRegister(), device="cpu",
                          segment_iters=7)
    b = check_history_gpu(_port(h), CASRegister(), device="cpu",
                          segment_iters=0)
    assert a["segments"] > 1 and b["segments"] == 1
    assert {k: a.get(k) for k in KEYS} == {k: b.get(k) for k in KEYS}


def test_host_search_matches_jax_host_search():
    from jepsen_tpu.checker.wgl import check_packed as j_check_packed
    from jepsen_tpu.ops.encode import pack_with_init as j_pack
    for seed in (15, 12):
        h = jt.corrupt_one_read(jt.simulate_register_history(100, seed=seed),
                                random.Random(seed))
        jp, jk = j_pack(h, JCASRegister())
        pp, pk = pack_with_init(_port(h), CASRegister())
        assert check_packed(pp, pk) == j_check_packed(jp, jk)


def test_facade_uses_the_device_search():
    h = _port(jt.simulate_register_history(200, seed=4))
    out = linearizable(CASRegister(), device="cpu").check({}, h)
    assert out["valid"] is True and out["backend"] == "gpu"
    assert "fallback-from" not in out
    host = LinearizableChecker(CASRegister(), backend="cpu").check({}, h)
    assert host["valid"] is True and host["backend"] == "cpu"


def _too_many_crashes():
    """One required read, then 130 crashed writes: more crashed ops than
    the device's crashed set holds, so the device answers UNKNOWN."""
    ops = [Op("invoke", "read", None, process=0), Op("ok", "read", None,
                                                     process=0)]
    ops += [Op("invoke", "write", i % 3, process=1 + i) for i in range(130)]
    return History(ops)


def test_facade_falls_back_to_the_host_on_unknown():
    h = _too_many_crashes()
    dev = check_history_gpu(h, CASRegister(), device="cpu")
    assert dev["valid"] == UNKNOWN and "crashed" in dev["error"]
    out = linearizable(CASRegister(), device="cpu").check({}, h)
    assert out["valid"] is True
    assert out["backend"] == "cpu" and out["fallback-from"] == "gpu"
    assert out["fallback-reason"] == dev["error"]


def test_malformed_history_is_rejected_before_the_search():
    h = History([Op("ok", "read", 1, process=0)])
    with pytest.raises(MalformedHistoryError):
        check_history_gpu(h, CASRegister(), device="cpu")


@pytest.mark.slow
def test_headline_matches_jax():
    h = jt.simulate_register_history(10000, n_procs=5, n_vals=16, seed=42,
                                     crash_p=0.002)
    assert assert_same(h)["valid"] is True


@pytest.mark.parametrize("segment_iters", [None, 100])
def test_the_single_path_runs_the_batch_schedule(segment_iters,
                                                 monkeypatch):
    """One history runs the keyed batch's loop: segments grow from 64
    levels, doubling up to the segment length, and stop at the first
    segment end with the search over. ``None`` is the default length: the
    test unsets JTPU_SEGMENT_ITERS, which other code in the process may
    have set."""
    monkeypatch.delenv("JTPU_SEGMENT_ITERS", raising=False)
    h = jt.simulate_register_history(300, n_procs=5, seed=6, crash_p=0.02)
    r = check_history_gpu(_port(h), CASRegister(), device="cpu",
                          segment_iters=segment_iters)
    cap = segment_iters or G.DEFAULT_SEGMENT_ITERS
    segs, seg = [], G.FIRST_BATCH_SEGMENT
    while sum(segs) < r["levels"]:
        segs.append(seg)
        seg = min(2 * seg, cap)
    assert r["valid"] is True and r["levels"] > G.FIRST_BATCH_SEGMENT
    assert r["segments"] == len(segs) and r["segment-iters"] == cap
