"""The port's native engine (``jepsen_tpu_torch/native/wgl_engine.cc``
through ``checker/native.py``) against the JAX package's, on the CPU.

The same histories, drawn from seeds by the JAX package's fixtures (or
by the port's simulators and converted), go through both packages'
``check_history_native``. The searches are integer, so the comparison is
exact, with no tolerance: ``valid``, ``configs-explored``,
``max-linearized-prefix``, ``final-states``, ``frontier-op``,
``tiers-escalated``, ``error`` and ``engine`` are equal. Each result is
also held against the reference's Python ``check_packed`` on the
reference's packing: the verdict always, the explored configurations
where no wider mask tier was needed (an escalation adds the narrower
tiers' configurations), and a refutation's prefix and final states.

The classes mirror ``tests/test_native_wgl.py``: golden cases, the six
model families, wide shapes (escalation to the 256/512-offset tiers and
both overflows), the keyed batch, and budgets and cancellation. The
1M-op case is left out (``slow`` in the reference too).

The no-op model: the reference's kernel has no f-codes, so its histories
never reach its native engine (UNKNOWN there, the object search answers
in the facade); the port's packs every op and its engine answers True.
"""

import os
import random
import re
import unittest.mock as mock

import numpy as np
import pytest
import torch

from jepsen_tpu.checker import UNKNOWN as J_UNKNOWN
from jepsen_tpu.checker import native as jn
from jepsen_tpu.checker.wgl import check_model as j_check_model
from jepsen_tpu.checker.wgl import check_packed as j_check_packed
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.models import core as J
from jepsen_tpu.ops.encode import pack_with_init as j_pack
from jepsen_tpu.testing import wide_history as j_wide_history

from jepsen_tpu_torch import testing as pt
from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.checker import native as pn
from jepsen_tpu_torch.checker.wgl import LinearizableChecker
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.models import core as P
from jepsen_tpu_torch.ops.encode import pack_with_init

from test_checker_tpu import (random_fifo_history, random_queue_history,
                              random_set_history)
from test_linearizable import random_register_history

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    not (pn.available() and jn.available()),
    reason="native engine unavailable (no g++?)")

#: the result fields held equal between the two packages
KEYS = ("valid", "configs-explored", "max-linearized-prefix",
        "final-states", "frontier-op", "tiers-escalated", "error", "engine")

#: family -> (port model class, JAX model class)
FAMILIES = {
    "cas-register": (P.CASRegister, J.CASRegister),
    "mutex": (P.Mutex, J.Mutex),
    "noop": (P.NoOp, J.NoOp),
    "set": (P.SetModel, J.SetModel),
    "unordered-queue": (P.UnorderedQueue, J.UnorderedQueue),
    "fifo-queue": (P.FIFOQueue, J.FIFOQueue),
}


def _port(jh) -> History:
    return History.of(o.to_dict() for o in jh)


def _jax(h) -> JHistory:
    return JHistory.of(o.to_dict() for o in h)


def _fields(r):
    return {k: r.get(k) for k in KEYS}


def both(jh, family, max_configs=None, python=True, **kw):
    """The port's and the reference's native results on one history, held
    equal, and (with ``python``) against the reference's Python search.
    Returns the port's result."""
    pm, jm = FAMILIES[family]
    got = pn.check_history_native(_port(jh), pm(**kw), max_configs)
    want = jn.check_history_native(jh, jm(**kw), max_configs)
    assert _fields(got) == _fields(want), (got, want)
    if not python:
        return got
    try:
        packed, kernel = j_pack(jh, jm(**kw))
    except ValueError:
        assert got["valid"] is UNKNOWN
        return got
    py = j_check_packed(packed, kernel, max_configs)
    if got["valid"] is UNKNOWN:
        return got
    assert got["valid"] is py["valid"], (got, py)
    if got.get("configs-explored", 0) and not _escalated(packed):
        assert got["configs-explored"] == py["configs-explored"], (got, py)
    if got["valid"] is False:
        assert got["max-linearized-prefix"] == py["max-linearized-prefix"]
        assert got["final-states"] == py["final-states"]
    return got


def _escalated(packed) -> bool:
    """Whether some required op lies 128 or more offsets past a frontier
    op it is concurrent with (the native search then needs a wider tier)."""
    nr = packed.n_required
    if nr <= 128:
        return False
    sufmin = np.minimum.accumulate(packed.inv[:nr][::-1])[::-1]
    return bool((sufmin[128:] < packed.ret[:nr - 128]).any())


def H(*rows):
    return JHistory.of([JOp(type=t, f=f, value=v, process=p, time=i)
                        for i, (p, t, f, v) in enumerate(rows)])


# ---------------------------------------------------------------------------
# The engine's constants against the port's
# ---------------------------------------------------------------------------


def _cc_constants():
    with open(os.path.join(ROOT, "jepsen_tpu_torch", "native",
                           "wgl_engine.cc")) as fh:
        src = fh.read()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr\s+\w+\s+(\w+)\s*=\s*(-?\d+);", src)}
    abi = int(re.search(r"jepsen_wgl_abi_version\(void\)\s*\{\s*return\s+"
                        r"(\d+);", src).group(1))
    return consts, abi


def test_engine_f_codes_equal_the_ports():
    """The engine's f-codes and nil id are the port's models/core.py
    constants: a drift on either side fails here."""
    consts, _ = _cc_constants()
    names = ("F_READ", "F_WRITE", "F_CAS", "F_ACQUIRE", "F_RELEASE",
             "F_ADD", "F_ENQUEUE", "F_DEQUEUE", "NIL_ID")
    assert {n: consts[n] for n in names} == {n: getattr(P, n)
                                             for n in names}
    # every f-code a port kernel packs is one the engine knows
    codes = {consts[n] for n in names if n.startswith("F_")}
    for spec in P.KERNELS:
        assert set(dict(spec.f_codes).values()) <= codes, spec.name


def test_engine_kernel_ids_and_abi_equal_the_wrappers():
    consts, abi = _cc_constants()
    cc_ids = {"cas-register": "KERNEL_CAS_REGISTER", "mutex": "KERNEL_MUTEX",
              "noop": "KERNEL_NOOP", "set": "KERNEL_SET",
              "unordered-queue": "KERNEL_UQUEUE", "fifo-queue": "KERNEL_FIFO"}
    assert pn.KERNEL_IDS == {k: consts[v] for k, v in cc_ids.items()}
    assert set(pn.KERNEL_IDS) == {s.name for s in P.KERNELS}
    assert abi == pn.ABI_VERSION
    assert consts["CRASH_WINDOW"] == 128
    assert consts["FIFO_SLOTS"] == P.FIFO_SLOTS


def test_the_engine_is_the_ports_copy():
    """The library is built from the port's source into the port's
    git-ignored build directory."""
    from jepsen_tpu_torch import native
    path = os.path.realpath(pn.library_path())
    assert path.startswith(os.path.join(ROOT, "jepsen_tpu_torch", "_build")
                           + os.sep), path
    assert native.source_path("wgl_engine") == os.path.join(
        ROOT, "jepsen_tpu_torch", "native", "wgl_engine.cc")
    assert os.path.exists(path[:-3] + ".log")


def test_disabled_and_missing_compilers(monkeypatch, tmp_path):
    """JEPSEN_TPU_NO_NATIVE disables the build; a missing compiler gives
    no library, and its log says why."""
    from jepsen_tpu_torch import native
    monkeypatch.setenv("JEPSEN_TPU_NO_NATIVE", "1")
    assert native.build("wgl_engine") is None
    monkeypatch.setenv("JEPSEN_TPU_NO_NATIVE", "0")
    monkeypatch.setenv("JEPSEN_TPU_CXX", str(tmp_path / "no-such-cxx"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    assert native.build("wgl_engine") is None
    names = os.listdir(tmp_path)
    assert not any(n.endswith(".so") for n in names), names
    (log,) = [n for n in names if n.endswith(".log")]
    assert "no-such-cxx" in (tmp_path / log).read_text()


# ---------------------------------------------------------------------------
# Golden cases
# ---------------------------------------------------------------------------


class TestGolden:
    def test_trivial_valid(self):
        h = H((0, "invoke", "write", 1), (0, "ok", "write", 1),
              (1, "invoke", "read", None), (1, "ok", "read", 1))
        assert both(h, "cas-register")["valid"] is True

    def test_trivial_invalid(self):
        h = H((0, "invoke", "write", 0), (0, "ok", "write", 0),
              (1, "invoke", "read", None), (1, "ok", "read", 1))
        r = both(h, "cas-register")
        assert r["valid"] is False
        assert r["frontier-op"] is not None
        assert isinstance(r["final-states"], list)

    def test_empty_history_valid(self):
        assert both(JHistory(), "cas-register")["valid"] is True

    def test_mutex(self):
        ok = H((0, "invoke", "acquire", None), (0, "ok", "acquire", None),
               (0, "invoke", "release", None), (0, "ok", "release", None))
        assert both(ok, "mutex")["valid"] is True
        bad = H((0, "invoke", "acquire", None), (0, "ok", "acquire", None),
                (1, "invoke", "acquire", None), (1, "ok", "acquire", None))
        assert both(bad, "mutex")["valid"] is False

    def test_set_with_initial_items(self):
        h = H((0, "invoke", "read", None), (0, "ok", "read", [7]))
        pm, jm = FAMILIES["set"]
        for items, want in (({7}, True), ({8}, False)):
            got = pn.check_history_native(_port(h), pm(items))
            ref = jn.check_history_native(h, jm(items))
            assert _fields(got) == _fields(ref)
            assert got["valid"] is want

    def test_unsupported_op_unknown(self):
        h = H((0, "invoke", "frobnicate", 1), (0, "ok", "frobnicate", 1))
        r = both(h, "cas-register")
        assert r["valid"] is UNKNOWN and r["error"]

    def test_headline_10k(self):
        """The 10,000-op headline history and its corrupted copy."""
        h = pt.simulate_register_history(10_000, n_procs=5, n_vals=16,
                                          seed=42, crash_p=0.002)
        assert both(_jax(h), "cas-register")["valid"] is True
        bad = pt.corrupt_model_history(h, "cas-register")
        assert both(_jax(bad), "cas-register")["valid"] is False


# ---------------------------------------------------------------------------
# The six model families
# ---------------------------------------------------------------------------


def _histories(family, seed):
    rng = random.Random(seed)
    if family == "cas-register":
        return [random_register_history(rng, n_procs=4, n_ops=10, n_vals=3,
                                        crash_p=0.15) for _ in range(120)]
    if family == "noop":
        return [random_register_history(rng, n_procs=4, n_ops=10, n_vals=3,
                                        crash_p=0.15) for _ in range(40)]
    if family == "set":
        return [random_set_history(rng, n_procs=3, n_ops=10, n_vals=4)
                for _ in range(100)]
    if family == "unordered-queue":
        return [random_queue_history(rng, n_procs=3, n_ops=10, n_vals=4)
                for _ in range(100)]
    if family == "fifo-queue":
        return [random_fifo_history(rng, n_procs=3, n_ops=10)
                for _ in range(100)]
    assert family == "mutex"
    out = []
    for s in range(30):
        h = pt.simulate_mutex_history(40, n_procs=3, seed=seed + s,
                                      crash_p=0.05)
        out += [_jax(h), _jax(pt.corrupt_model_history(h, "mutex"))]
    return out


@pytest.mark.parametrize("family", ["cas-register", "mutex", "set",
                                    "unordered-queue", "fifo-queue"])
def test_family_differential(family):
    """Port against reference, and against the reference's Python search,
    history by history."""
    seed = {"cas-register": 11, "mutex": 100, "set": 12,
            "unordered-queue": 13, "fifo-queue": 14}[family]
    verdicts = [both(h, family)["valid"] for h in _histories(family, seed)]
    # the fixtures hold both verdicts
    assert True in verdicts and False in verdicts, verdicts


def test_noop_answers_true_on_the_ports_engine():
    """The port packs a no-op history and its engine answers True, with
    the reference's object search; the reference's engine cannot pack it."""
    for jh in _histories("noop", 15):
        got = pn.check_history_native(_port(jh), P.NoOp())
        assert got["valid"] is True and got["engine"] == "native", got
        assert j_check_model(jh, J.NoOp())["valid"] is True
        assert jn.check_history_native(jh, J.NoOp())["valid"] is J_UNKNOWN


def test_longer_register_histories():
    rng = random.Random(15)
    for _ in range(20):
        h = random_register_history(rng, n_procs=5, n_ops=80, n_vals=4,
                                    crash_p=0.05)
        both(h, "cas-register")


@pytest.mark.parametrize("family", ["set", "unordered-queue", "fifo-queue",
                                    "mutex"])
def test_family_full_size_simulators(family):
    """The port's simulators of the other models at 1,000 ops (the
    smoke's histories at a tenth of their length), valid and corrupted."""
    sims = {
        "set": lambda: pt.simulate_set_history(1000, n_procs=5, seed=42,
                                               crash_p=0.002, lost_p=0.0),
        "unordered-queue": lambda: pt.simulate_queue_history(
            1000, n_procs=5, seed=42, backlog=8, fifo=False),
        "fifo-queue": lambda: pt.simulate_queue_history(
            1000, n_procs=3, seed=42, backlog=2, fifo=True),
        "mutex": lambda: pt.simulate_mutex_history(1000, n_procs=5, seed=42,
                                                   crash_p=0.002),
    }
    h = sims[family]()
    assert both(_jax(h), family)["valid"] is True
    bad = both(_jax(pt.corrupt_model_history(h, family)), family)
    assert bad["valid"] is not True


# ---------------------------------------------------------------------------
# Wide shapes: escalation and the two overflows
# ---------------------------------------------------------------------------


class TestWideShapes:
    """Rounds of 100 and more fully concurrent ops. The Python search
    takes seconds to minutes on the 100-wide rounds, so those are held
    against the reference's engine only."""

    def test_100_concurrency_within_masks(self):
        assert both(j_wide_history(100, 2, seed=5), "cas-register",
                    python=False)["valid"] is True

    def test_100_concurrency_corrupted(self):
        h = j_wide_history(100, 2, seed=5, corrupt=True)
        assert both(h, "cas-register", python=False)["valid"] is False

    @pytest.mark.parametrize("width", [150, 300])
    def test_wide_windows_escalate_exactly(self, width):
        r = both(j_wide_history(width, 1, seed=2), "cas-register")
        assert r["valid"] is True, r

    def test_wide_window_exact_refutation(self):
        bad = j_wide_history(150, 1, write_frac=0.05, seed=2, corrupt=True)
        assert both(bad, "cas-register")["valid"] is False

    def test_far_write_escalates(self):
        """The port's far-write history (one candidate 129 offsets past
        the frontier) needs the 256-offset tier: answered there, its
        configurations counted over both tiers."""
        for value, want in ((7, True), (8, False)):
            jh = _jax(pt.far_write_history(130, value))
            r = both(jh, "cas-register")
            assert r["valid"] is want
            packed, kernel = j_pack(jh, J.CASRegister())
            py = j_check_packed(packed, kernel)
            assert r["configs-explored"] == py["configs-explored"] + 1

    def test_window_overflow_goes_unknown(self):
        r = both(j_wide_history(600, 1, seed=2), "cas-register")
        assert r["valid"] is UNKNOWN and "window" in r["error"]

    def test_crash_overflow_goes_unknown(self):
        rows = []
        for p in range(140):
            rows.append(Op(type="invoke", f="write", value=p % 5,
                           process=p, time=p))
        for p in range(140):
            rows.append(Op(type="info", f="write", value=p % 5,
                           process=p, time=140 + p))
        rows.append(Op(type="invoke", f="read", value=None, process=200,
                       time=300))
        rows.append(Op(type="ok", f="read", value=None, process=200,
                       time=301))
        r = both(_jax(History(rows)), "cas-register")
        assert r["valid"] is UNKNOWN and "crashed" in r["error"]


# ---------------------------------------------------------------------------
# The keyed batch
# ---------------------------------------------------------------------------


class TestKeyedBatch:
    def test_keyed_matches_reference_and_per_key(self):
        rng = random.Random(21)
        keyed = {k: random_register_history(rng, n_procs=3, n_ops=10,
                                            n_vals=3, crash_p=0.1)
                 for k in range(12)}
        got = pn.check_keyed_native({k: _port(h) for k, h in keyed.items()},
                                    P.CASRegister())
        want = jn.check_keyed_native(keyed, J.CASRegister())
        assert got["valid"] == want["valid"]
        assert got["engine"] == "native"
        assert set(got["results"]) == set(keyed)
        for k in keyed:
            assert _fields(got["results"][k]) == _fields(
                want["results"][k]), k
            assert got["results"][k]["valid"] is pn.check_history_native(
                _port(keyed[k]), P.CASRegister())["valid"]

    def test_keyed_invalid_key_fails_batch(self):
        good = H((0, "invoke", "write", 1), (0, "ok", "write", 1))
        bad = H((0, "invoke", "write", 0), (0, "ok", "write", 0),
                (1, "invoke", "read", None), (1, "ok", "read", 1))
        out = pn.check_keyed_native({"g": _port(good), "b": _port(bad)},
                                    P.CASRegister())
        assert out["valid"] is False
        assert out["results"]["g"]["valid"] is True
        assert out["results"]["b"]["valid"] is False

    def test_etcd_shaped_batch(self):
        """64 keys x 300 ops, one corrupted (the smoke's etcd batch)."""
        hs = {k: pt.simulate_register_history(300, n_procs=10, n_vals=5,
                                              seed=9000 + k, overlap_p=0.05)
              for k in range(64)}
        hs[0] = pt.corrupt_model_history(hs[0], "cas-register")
        got = pn.check_keyed_native(hs, P.CASRegister())
        want = jn.check_keyed_native({k: _jax(h) for k, h in hs.items()},
                                     J.CASRegister())
        assert got["valid"] is want["valid"] is False
        for k in hs:
            assert _fields(got["results"][k]) == _fields(want["results"][k])
        assert [k for k, r in got["results"].items()
                if r["valid"] is not True] == [0]


# ---------------------------------------------------------------------------
# Budgets and cancellation
# ---------------------------------------------------------------------------


class TestControls:
    @pytest.mark.parametrize("budget", [-1, 0, 1, 2, 100])
    def test_budget_exhaustion(self, budget):
        h = _jax(pt.simulate_register_history(400, n_procs=5, n_vals=4,
                                              seed=16))
        r = both(h, "cas-register", max_configs=budget)
        assert r["valid"] is UNKNOWN and "budget" in r["error"]
        assert r["tiers-escalated"] is False

    def test_budget_across_tiers(self):
        """A budget spent before the 128-offset tier overflows: the search
        stops escalated, and the budget bounds the total."""
        jh = _jax(pt.far_write_history(130, 7))
        r = both(jh, "cas-register", max_configs=1)
        assert r["valid"] is UNKNOWN and r["tiers-escalated"] is True
        r = both(jh, "cas-register", max_configs=2)
        assert r["valid"] is UNKNOWN and r["tiers-escalated"] is True
        assert r["configs-explored"] == 3

    def test_escalated_budget_not_short_circuited(self):
        h = pt.simulate_register_history(60, n_procs=3, n_vals=4, seed=5)
        esc = {"valid": UNKNOWN, "engine": "native",
               "error": "config budget 100 exhausted",
               "tiers-escalated": True, "configs-explored": 100}
        with mock.patch.object(pn, "check_packed_native",
                               return_value=esc) as m:
            r = LinearizableChecker(P.CASRegister(), backend="cpu",
                                    algorithm="native",
                                    max_configs=100).check({}, h)
        assert m.call_count == 1
        assert r["valid"] is True and "engine" not in r

    def test_first_tier_budget_short_circuits(self):
        h = pt.simulate_register_history(60, n_procs=3, n_vals=4, seed=5)
        final = {"valid": UNKNOWN, "engine": "native",
                 "error": "config budget 100 exhausted",
                 "tiers-escalated": False, "configs-explored": 100}
        with mock.patch.object(pn, "check_packed_native",
                               return_value=final) as m:
            r = LinearizableChecker(P.CASRegister(), backend="cpu",
                                    algorithm="native",
                                    max_configs=100).check({}, h)
        assert r["valid"] is UNKNOWN and r["engine"] == "native"
        assert m.call_count == 1

    def test_cancellation(self):
        """A stop flag set from the start cancels within the first 1,024
        pops (the watcher polls every 5 ms)."""
        h = pt.simulate_register_history(2000, n_procs=5, n_vals=8, seed=1)
        r = pn.check_history_native(h, P.CASRegister(),
                                    should_stop=lambda: True)
        assert r["valid"] in (True, UNKNOWN)
        if r["valid"] is UNKNOWN:
            assert r["error"] == "cancelled"
            assert r["configs-explored"] % 1024 == 0
        # never asked: the same search to its end, as the reference's
        full = both(_jax(h), "cas-register")
        assert full["valid"] is True

    def test_python_search_cancellation_equals_the_reference(self):
        """The Python search polls every 512 configurations: cancelled at
        the first poll, in both packages alike."""
        from jepsen_tpu_torch.checker.wgl import check_packed
        h = pt.simulate_register_history(2000, n_procs=5, n_vals=8, seed=1)
        got = check_packed(*pack_with_init(h, P.CASRegister()),
                           should_stop=lambda: True)
        want = j_check_packed(*j_pack(_jax(h), J.CASRegister()),
                              should_stop=lambda: True)
        assert got == want == {"valid": UNKNOWN, "configs-explored": 512,
                               "error": "cancelled"}
