"""The port's ``:linear`` search and ``competition`` race
(``jepsen_tpu_torch/checker/jitlin.py``) against the JAX package's, on
the CPU.

The cases of ``tests/test_jitlin.py``: golden histories, the WGL/JIT
fuzz on the packed and the object path, and the race. Each history goes
through both packages' ``check_jit_packed`` / ``check_jit_model``; the
searches are integer, so the whole result dict is equal, with no
tolerance (``valid``, ``configs-explored``, ``failed-at-event``,
``failed-op``, ``error``). The race's winner depends on thread timing,
so a race is held to the verdict of every racer.
"""

import random
import threading
import time

import pytest
import torch

from jepsen_tpu.checker.jitlin import check_jit_model as j_jit_model
from jepsen_tpu.checker.jitlin import check_jit_packed as j_jit_packed
from jepsen_tpu.checker.wgl import check_model as j_check_model
from jepsen_tpu.checker.wgl import check_packed as j_check_packed
from jepsen_tpu.models import core as J
from jepsen_tpu.ops.encode import pack_with_init as j_pack

from jepsen_tpu_torch import testing as pt
from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.checker import native as pn
from jepsen_tpu_torch.checker.jitlin import (check_jit_model,
                                             check_jit_packed, competition)
from jepsen_tpu_torch.checker.wgl import check_model, check_packed
from jepsen_tpu_torch.checker.wgl import linearizable
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import core as P
from jepsen_tpu_torch.ops.encode import pack_with_init

from test_linearizable import H, random_register_history

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)


def _port(jh) -> History:
    return History.of(o.to_dict() for o in jh)


def jit_both(jh, model="cas-register", max_configs=None):
    """The port's and the reference's packed JIT results, held equal."""
    pm, jm = {"cas-register": (P.CASRegister, J.CASRegister),
              "mutex": (P.Mutex, J.Mutex)}[model]
    got = check_jit_packed(*pack_with_init(_port(jh), pm()), max_configs)
    want = j_jit_packed(*j_pack(jh, jm()), max_configs)
    assert got == want, (got, want)
    return got


def jit_model_both(jh, pm, jm, max_configs=None):
    got = check_jit_model(_port(jh), pm, max_configs)
    want = j_jit_model(jh, jm, max_configs)
    assert got == want, (got, want)
    return got


class TestGoldenJit:
    def test_sequential(self):
        ok = H((0, "invoke", "write", 0), (0, "ok", "write", 0),
               (1, "invoke", "read", None), (1, "ok", "read", 0))
        bad = H((0, "invoke", "write", 0), (0, "ok", "write", 0),
                (1, "invoke", "read", None), (1, "ok", "read", 1))
        assert jit_both(ok)["valid"] is True
        r = jit_both(bad)
        assert r["valid"] is False and r["failed-op"]["f"] == "read"

    def test_concurrent_reorder(self):
        h = H((0, "invoke", "write", 1),
              (1, "invoke", "read", None), (1, "ok", "read", 1),
              (0, "ok", "write", 1))
        assert jit_both(h)["valid"] is True

    def test_crashed_write_may_apply(self):
        h = H((0, "invoke", "write", 7), (0, "info", "write", 7),
              (1, "invoke", "read", None), (1, "ok", "read", 7))
        assert jit_both(h)["valid"] is True

    def test_mutex(self):
        bad = H((0, "invoke", "acquire", None), (0, "ok", "acquire", None),
                (1, "invoke", "acquire", None), (1, "ok", "acquire", None))
        assert jit_both(bad, "mutex")["valid"] is False

    def test_model_object_path(self):
        h = H((0, "invoke", "enqueue", 1), (0, "ok", "enqueue", 1),
              (1, "invoke", "dequeue", None), (1, "ok", "dequeue", 1))
        assert jit_model_both(h, P.UnorderedQueue(),
                              J.UnorderedQueue())["valid"] is True
        bad = H((0, "invoke", "dequeue", None), (0, "ok", "dequeue", 9))
        assert jit_model_both(bad, P.UnorderedQueue(),
                              J.UnorderedQueue())["valid"] is False

    @pytest.mark.parametrize("budget", [0, 1, 3])
    def test_budget_returns_unknown(self, budget):
        h = random_register_history(random.Random(1), n_procs=4, n_ops=20,
                                    n_vals=3)
        assert jit_both(h, max_configs=budget)["valid"] is UNKNOWN
        assert jit_model_both(h, P.CASRegister(), J.CASRegister(),
                              budget)["valid"] is UNKNOWN

    def test_deadline(self):
        """A deadline already past cancels at the first poll, with the
        deadline named."""
        h = pt.simulate_register_history(2000, n_procs=5, n_vals=8, seed=1)
        r = check_jit_packed(*pack_with_init(h, P.CASRegister()),
                             deadline_s=0.0)
        assert r["valid"] is UNKNOWN and r["configs-explored"] == 512
        assert r["error"] == "deadline 0.0s exceeded"


class TestDifferentialOracle:
    def test_register_fuzz(self):
        rng = random.Random(21)
        seen = set()
        for _ in range(200):
            h = random_register_history(rng, n_procs=4, n_ops=9, n_vals=3,
                                        crash_p=0.15)
            r = jit_both(h)
            pk = pack_with_init(_port(h), P.CASRegister())
            assert r["valid"] is check_packed(*pk)["valid"]
            seen.add(r["valid"])
        assert seen == {True, False}

    def test_register_fuzz_object_path(self):
        rng = random.Random(22)
        for _ in range(100):
            h = random_register_history(rng, n_procs=3, n_ops=8, n_vals=3,
                                        crash_p=0.1)
            r = jit_model_both(h, P.CASRegister(), J.CASRegister())
            assert r["valid"] is check_model(_port(h),
                                             P.CASRegister())["valid"]

    def test_longer_histories(self):
        rng = random.Random(23)
        for _ in range(12):
            h = random_register_history(rng, n_procs=5, n_ops=60, n_vals=4,
                                        crash_p=0.05)
            b = jit_both(h, max_configs=500_000)["valid"]
            a = j_check_packed(*j_pack(h, J.CASRegister()))["valid"]
            assert b is a or b is UNKNOWN, (a, b)


class TestCompetition:
    def test_first_answer_wins(self):
        h = random_register_history(random.Random(5), n_procs=4, n_ops=12,
                                    n_vals=3, crash_p=0.1)
        want = j_check_model(h, J.CASRegister())["valid"]
        out = linearizable(P.CASRegister(), backend="cpu",
                           algorithm="competition").check({}, _port(h))
        assert out["valid"] is want
        assert out["algorithm"] in (("wgl", "linear", "native")
                                    if pn.available() else ("wgl", "linear"))

    def test_competition_fuzz(self):
        rng = random.Random(6)
        for _ in range(40):
            h = random_register_history(rng, n_procs=4, n_ops=10, n_vals=3,
                                        crash_p=0.1)
            want = j_check_model(h, J.CASRegister())["valid"]
            out = linearizable(P.CASRegister(), backend="cpu",
                               algorithm="competition").check({}, _port(h))
            assert out["valid"] is want

    def test_all_unknown_reported(self):
        out = competition({
            "a": lambda stop: {"valid": UNKNOWN, "error": "x"},
            "b": lambda stop: {"valid": UNKNOWN, "error": "y"},
        })
        assert out["valid"] is UNKNOWN
        assert out["algorithm"] in ("a", "b")

    def test_a_raising_racer_loses(self):
        def boom(stop):
            raise RuntimeError("racer fault")
        out = competition({"boom": boom,
                           "ok": lambda stop: {"valid": True}})
        assert out == {"valid": True, "algorithm": "ok"}

    @pytest.mark.skipif(not pn.available(), reason="no native engine")
    def test_losers_are_cancelled(self):
        """On the 10,000-op headline the native engine answers in
        milliseconds; the Python WGL and JIT racers stop at their next
        poll, so the race ends long before either would."""
        h = pt.simulate_register_history(10_000, n_procs=5, n_vals=16,
                                          seed=42, crash_p=0.002)
        packed, kernel = pack_with_init(h, P.CASRegister())
        losers = {}
        alive = []

        def racer(name, fn):
            def run(stop):
                alive.append(threading.current_thread())
                losers[name] = fn(stop)
                return losers[name]
            return run

        t0 = time.perf_counter()
        out = competition({
            "native": lambda stop: pn.check_packed_native(
                packed, kernel, should_stop=stop),
            "wgl": racer("wgl", lambda stop: check_packed(
                packed, kernel, should_stop=stop)),
            "linear": racer("linear", lambda stop: check_jit_packed(
                packed, kernel, should_stop=stop)),
        })
        took = time.perf_counter() - t0
        assert out["valid"] is True and out["algorithm"] == "native"
        assert not any(t.is_alive() for t in alive)
        for name in ("wgl", "linear"):
            assert losers[name] == {
                "valid": UNKNOWN, "error": "cancelled",
                "configs-explored": losers[name]["configs-explored"]}
            assert losers[name]["configs-explored"] % 512 == 0
        # the whole Python search takes several times longer than the race
        t0 = time.perf_counter()
        assert check_packed(packed, kernel)["valid"] is True
        assert took < time.perf_counter() - t0

    def test_object_path_race(self):
        """A FIFO queue deeper than its word's 7 slots goes to the object
        path, where the race is WGL against JIT."""
        rows = []
        for v in range(1, 10):
            rows += [(0, "invoke", "enqueue", v), (0, "ok", "enqueue", v)]
        for v in range(1, 10):
            rows += [(1, "invoke", "dequeue", None), (1, "ok", "dequeue", v)]
        h = H(*rows)
        with pytest.raises(ValueError):
            pack_with_init(_port(h), P.FIFOQueue())
        out = linearizable(P.FIFOQueue(), backend="cpu",
                           algorithm="competition").check({}, _port(h))
        assert out["valid"] is True and out["algorithm"] in ("wgl",
                                                             "linear")
