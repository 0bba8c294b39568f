"""The port's workload library against the JAX package's, on the CPU.

Each workload (bank, monotonic, sequential, G2 and the queue) runs
through the port's ``core.run`` against its in-memory backend of
``jepsen_tpu_torch.testing``: valid on the correct backend, invalid on
the broken one, as the reference's workload tests find. Each recorded
history then goes through the reference's checker too, and the result
dicts are equal. ``independent``'s sequential and concurrent generators
give the reference's ops, key for key, when drawn in the same order.
"""

import itertools
import random

import pytest
import torch

from jepsen_tpu import generator as jgen
from jepsen_tpu import independent as jind
from jepsen_tpu.checker import total_queue as j_total_queue
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.suites import workloads as jwl

from jepsen_tpu_torch import core, independent
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.checker import linearizable, total_queue
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.suites import workloads as wl
from jepsen_tpu_torch.testing import (BankClient, FlakyClient, G2Client,
                                      MonotonicClient, QueueClient,
                                      SequentialClient, SharedBank, SharedKV,
                                      SharedMonotonic, SharedQueue,
                                      SharedRegister, noop_test)

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)


def run_test(client, generator, checker, **over):
    t = noop_test()
    t.update({
        "client": client,
        "generator": gen.clients(generator),
        "checker": checker,
        "store-dir": None,
        "name": over.pop("name", "workload-test"),
    })
    t.update(over)
    return core.run(t)


def _value(v):
    """An op value with the port's keyed tuples made the reference's."""
    if isinstance(v, independent.KV):
        return jind.KV(v.key, v.value)
    return v


def jax_history(h) -> JHistory:
    return JHistory([JOp(type=o.type, f=o.f, value=_value(o.value),
                         process=o.process, time=o.time, index=o.index,
                         error=o.error) for o in h])


def same_result(t, ref_checker):
    """The run's result equals the reference checker's on its history."""
    ours = t["results"]
    theirs = ref_checker.check(t, jax_history(t["history"]))
    assert ours == theirs, (ours, theirs)
    return ours


class TestBank:
    def gen(self):
        mix = gen.mix([wl.bank_read, wl.bank_diff_transfer(5)])
        return gen.limit(200, mix)

    def test_atomic_bank_valid(self):
        t = run_test(BankClient(SharedBank(5, 10)), self.gen(),
                     wl.bank_checker(5, 50), name="bank")
        res = same_result(t, jwl.bank_checker(5, 50))
        assert res["valid"] is True
        assert any(o.f == "read" and o.is_ok for o in t["history"])
        assert all(o.value["from"] != o.value["to"] for o in t["history"]
                   if o.f == "transfer")

    def test_broken_bank_detected(self):
        t = run_test(BankClient(SharedBank(5, 10), broken=True), self.gen(),
                     wl.bank_checker(5, 50), name="bank-broken")
        res = same_result(t, jwl.bank_checker(5, 50))
        assert res["valid"] is False
        kinds = {b["type"] for b in res["bad-reads"]}
        assert kinds & {"wrong-total", "negative-value"}

    def test_wrong_n(self):
        t = run_test(BankClient(SharedBank(4, 10)), self.gen(),
                     wl.bank_checker(5, 40), name="bank-wrong-n")
        res = same_result(t, jwl.bank_checker(5, 40))
        assert {b["type"] for b in res["bad-reads"]} == {"wrong-n"}


class TestMonotonic:
    def gen(self):
        adds = gen.limit(100, lambda test, p: {"f": "add", "value": None})
        final = gen.once({"f": "read", "value": None})
        return gen.phases(adds, final)

    @pytest.mark.parametrize("kw", [{}, {"linearizable": True},
                                    {"global_order": False}])
    def test_monotonic_valid(self, kw):
        t = run_test(MonotonicClient(SharedMonotonic()), self.gen(),
                     wl.monotonic_checker(**kw), name="monotonic")
        res = same_result(t, jwl.monotonic_checker(**kw))
        assert res["valid"] is True, res

    def test_skewed_timestamps_detected(self):
        t = run_test(MonotonicClient(SharedMonotonic(), broken=True),
                     self.gen(), wl.monotonic_checker(),
                     name="monotonic-broken")
        res = same_result(t, jwl.monotonic_checker())
        assert res["valid"] is False
        assert res["order-by-errors"]

    def test_never_read_is_unknown(self):
        t = run_test(MonotonicClient(SharedMonotonic()),
                     gen.limit(10, lambda _t, _p: {"f": "add",
                                                   "value": None}),
                     wl.monotonic_checker(), name="monotonic-noread")
        assert same_result(t, jwl.monotonic_checker())["valid"] == "unknown"


class TestSequential:
    def test_ordered_writes_valid(self):
        t = run_test(SequentialClient(SharedKV()),
                     gen.time_limit(1.0, gen.stagger(
                         0.001, wl.sequential_gen(2))),
                     wl.SequentialChecker(),
                     name="sequential", **{"key-count": 5,
                                           "concurrency": 5})
        res = same_result(t, jwl.SequentialChecker())
        assert res["valid"] is True, res
        assert res["all-count"] > 0

    def test_reversed_writes_detected(self):
        # reversed subkey writes and concurrent readers give trailing
        # nils; the race is probabilistic, so a few attempts
        for _ in range(4):
            t = run_test(SequentialClient(SharedKV(), broken=True),
                         gen.time_limit(1.5, wl.sequential_gen(2)),
                         wl.SequentialChecker(),
                         name="sequential-broken", **{"key-count": 8,
                                                      "concurrency": 5})
            res = same_result(t, jwl.SequentialChecker())
            if res["bad-count"] >= 1:
                break
        assert res["bad-count"] >= 1
        assert res["valid"] is False

    @pytest.mark.parametrize("coll", [["b", None], [None, "a"], ["a", "b"],
                                      [None, None], [], [None, "a", None]])
    def test_trailing_nil(self, coll):
        assert wl.trailing_nil(coll) == jwl.trailing_nil(coll)

    def test_subkeys(self):
        assert wl.subkeys(3, 7) == jwl.subkeys(3, 7) == ["7_0", "7_1", "7_2"]


class TestG2:
    def test_serializable_valid(self):
        t = run_test(G2Client(), gen.time_limit(1.0, wl.g2_gen()),
                     wl.g2_checker(), name="g2", concurrency=4)
        res = same_result(t, jwl.g2_checker())
        assert res["valid"] is True
        assert res["key-count"] > 0

    def test_racy_inserts_detected(self):
        t = run_test(G2Client(broken=True),
                     gen.time_limit(1.5, wl.g2_gen()),
                     wl.g2_checker(), name="g2-broken", concurrency=4)
        res = same_result(t, jwl.g2_checker())
        assert res["valid"] is False
        assert res["illegal-count"] >= 1


class TestQueueWorkload:
    def gen(self):
        q = gen.queue_gen()
        return gen.phases(gen.limit(150, q),
                          gen.limit(80, {"f": "dequeue"}))

    def test_fifo_queue_valid(self):
        t = run_test(QueueClient(SharedQueue()), self.gen(), total_queue(),
                     name="queue")
        res = same_result(t, j_total_queue())
        assert res["valid"] is True, res

    def test_lost_enqueues_detected(self):
        t = run_test(QueueClient(SharedQueue(), broken=True), self.gen(),
                     total_queue(), name="queue-broken")
        res = same_result(t, j_total_queue())
        assert res["valid"] is False
        assert res.get("lost") or res.get("lost-count")


def test_flaky_client_crashes_ops():
    """Timeouts become info completions, the processes reincarnate, and
    the register stays linearizable with its crashed ops."""
    t = run_test(FlakyClient(SharedRegister(), flake_p=0.3, seed=3),
                 gen.limit(60, gen.cas_gen()),
                 linearizable(CASRegister(), device="cpu"), name="flaky",
                 model=CASRegister())
    infos = [o for o in t["history"] if o.type == "info"
             and o.process != "nemesis"]
    assert infos and len(t["history"]) >= 100
    assert len({o.process for o in t["history"]}) > 5
    assert t["results"]["valid"] is True


# -- independent's generators ------------------------------------------------

def _draw(g, test, procs, n):
    out = []
    for p in itertools.islice(itertools.cycle(procs), n):
        o = g.op(test, p)
        out.append(None if o is None else
                   (o.f, o.value.key, o.value.value))
    return out


def _per_key(fgen_mod, k):
    return fgen_mod.limit(3, {"f": "write", "value": k * 10})


@pytest.mark.parametrize("n_keys", [1, 3])
def test_sequential_generator(n_keys):
    test = {"concurrency": 2, "nodes": ["n1"]}
    ours = independent.sequential_generator(
        range(n_keys), lambda k: _per_key(gen, k))
    theirs = jind.sequential_generator(
        range(n_keys), lambda k: _per_key(jgen, k))
    a = _draw(ours, test, [0, 1], 3 * n_keys + 2)
    assert a == _draw(theirs, test, [0, 1], 3 * n_keys + 2)
    assert a[-1] is None and {k for _, k, _ in a[:-2]} == set(range(n_keys))


@pytest.mark.parametrize("n,concurrency", [(1, 3), (2, 4), (3, 6)])
def test_concurrent_generator(n, concurrency):
    test = {"concurrency": concurrency, "nodes": ["n1"]}
    ours = independent.concurrent_generator(
        n, range(5), lambda k: _per_key(gen, k))
    theirs = jind.concurrent_generator(
        n, range(5), lambda k: _per_key(jgen, k))
    procs = list(range(concurrency))
    a = _draw(ours, test, procs, 40)
    assert a == _draw(theirs, test, procs, 40)
    assert a[-1] is None
    assert {k for r in a if r for _, k, _ in [r]} == set(range(5))


def test_concurrent_generator_refuses_an_uneven_split():
    test = {"concurrency": 3, "nodes": ["n1"]}
    g = independent.concurrent_generator(2, range(2),
                                         lambda k: _per_key(gen, k))
    with pytest.raises(AssertionError, match="groups of 2"):
        g.op(test, 0)


def test_g2_gen_draws_the_references_ops():
    test = {"concurrency": 4, "nodes": ["n1"]}
    a = [(o.f, o.value.key, o.value.value)
         for o in (wl.g2_gen().op(test, p) for p in range(4))]
    b = [(o.f, o.value.key, o.value.value)
         for o in (jwl.g2_gen().op(test, p) for p in range(4))]
    assert a == b


def test_bank_transfers_draw_the_references_ops():
    test = {"concurrency": 1, "nodes": ["n1"]}
    random.seed(11)
    a = [wl.bank_transfer(5)(test, 0) for _ in range(20)]
    random.seed(11)
    b = [jwl.bank_transfer(5)(test, 0) for _ in range(20)]
    assert a == b
