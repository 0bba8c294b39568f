"""The port's generator against the JAX package's, on the CPU.

Both draw from the module-level ``random``. For each tree below, the same
seed goes to ``random`` before each package builds and drains the same
tree in one thread; the ops they hand out (``type``, ``f``, ``value``,
``process``), and where each hands out none (an exhausted generator, or
one that has nothing for that thread), are equal, draw for draw. The
trees: ``mix``/``stagger``/``limit``/``time_limit``, ``phases``,
``on_threads``, ``cas_gen``, ``reserve``, ``each``, ``filter``, and the
local-kv suites' own generators (the clients' staggered register mix and
the nemesis's sleep/start/sleep/stop cycle, and the unsafe suite's
phased schedule).
"""

import pytest
import torch

from jepsen_tpu import generator as jgen
from jepsen_tpu.history import NEMESIS
from jepsen_tpu.suites import localkv as jlocalkv
from jepsen_tpu.suites import workloads as jwl

from jepsen_tpu_torch import generator as pgen
from jepsen_tpu_torch.suites import localkv as plocalkv
from jepsen_tpu_torch.suites import workloads as pwl
from jepsen_tpu_torch.util import with_relative_time

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

TEST = {"concurrency": 3, "nodes": ["n1", "n2", "n3"]}


def drain(gen_ns, g, processes, draws, scope):
    """``draws`` calls of ``op_and_validate`` in one thread, cycling
    through ``processes`` with the thread scope ``scope``: each call's op
    as (type, f, value, the process it was drawn for), or None where the
    generator gave none."""
    out = []
    with gen_ns.threads_bound(scope), with_relative_time():
        for i in range(draws):
            p = processes[i % len(processes)]
            o = gen_ns.op_and_validate(g, TEST, p)
            out.append(None if o is None else (o.type, o.f, o.value, p))
    return out


def both(build, seed, processes=(0,), draws=40, scope=(0,)):
    """Drain the tree ``build(gen, workloads)`` makes in each package from
    the same seed; returns the port's draws after holding them equal."""
    import random
    random.seed(seed)
    want = drain(jgen, build(jgen, jwl), list(processes), draws, scope)
    random.seed(seed)
    got = drain(pgen, build(pgen, pwl), list(processes), draws, scope)
    assert got == want
    return got


SEEDS = (0, 7, 123)


@pytest.mark.parametrize("seed", SEEDS)
def test_mix_stagger_limit_time_limit(seed):
    got = both(lambda g, wl: g.time_limit(600, g.limit(25, g.stagger(
        1e-4, g.mix([wl.r, wl.w, wl.cas])))), seed, draws=30)
    assert all(o is not None for o in got[:25])
    assert got[25:] == [None] * 5
    assert {o[1] for o in got[:25]} == {"read", "write", "cas"}


@pytest.mark.parametrize("seed", SEEDS)
def test_cas_gen(seed):
    got = both(lambda g, wl: g.limit(50, g.cas_gen(values=7)), seed,
               draws=52)
    assert got[50:] == [None, None]
    assert all(o[0] == "invoke" for o in got[:50])


def test_time_limit_expires():
    """A 0.6 s limit over ops 0.4 s apart: two ops, then none."""
    got = both(lambda g, wl: g.time_limit(0.6, g.delay(0.4, g.cas_gen())),
               1, draws=4)
    assert [o is not None for o in got] == [True, True, False, False]


@pytest.mark.parametrize("seed", SEEDS)
def test_phases(seed):
    got = both(lambda g, wl: g.phases(
        g.limit(3, g.cas_gen()),
        g.limit(2, {"type": "invoke", "f": "read", "value": None}),
        g.sleep(0.001),
        g.once(wl.w)), seed, draws=8)
    # three cas_gen ops (read, write or cas), two reads, one write, done
    assert [o is not None for o in got] == [True] * 6 + [False] * 2
    assert [o[1] for o in got[3:6]] == ["read", "read", "write"]


@pytest.mark.parametrize("seed", SEEDS)
def test_on_threads(seed):
    def build(g, wl):
        return g.Any_([
            g.on_threads(lambda t: t == 0, g.limit(4, g.cas_gen())),
            g.on_threads(lambda t: t == 1, g.limit(3, wl.w))])
    got = both(build, seed, processes=(0, 1, 2), draws=15,
               scope=(0, 1, 2))
    assert [o and o[3] for o in got[:6]] == [0, 1, None, 0, 1, None]
    assert got[-3:] == [None] * 3


@pytest.mark.parametrize("seed", SEEDS)
def test_reserve_each_filter(seed):
    def build(g, wl):
        return g.reserve(
            1, g.limit(3, g.filter_gen(lambda o: o.f != "read",
                                       g.mix([wl.r, wl.w, wl.cas]))),
            g.each(lambda: g.limit(2, g.cas_gen())))
    got = both(build, seed, processes=(0, 1, 2), draws=18,
               scope=(0, 1, 2))
    assert all(o is None or o[1] != "read" for o in got[0::3])
    assert [o is not None for o in got[1::3]] == [True] * 2 + [False] * 4


@pytest.mark.parametrize("seed", SEEDS)
def test_localkv_clients_and_nemesis_cycle(seed):
    """The local-kv suite's own generator tree, as each package's
    ``localkv_test`` builds it: the clients' staggered register mix, and
    the nemesis's cycle with a 1 ms period."""
    def build(g, wl):
        ns = plocalkv if g is pgen else jlocalkv
        return ns.localkv_test({"time-limit": 600,
                                "nemesis-period": 0.001})["generator"]
    got = both(build, seed, processes=(0, 1, 2), draws=18, scope=(0, 1, 2))
    assert all(o is not None and o[1] in ("read", "write", "cas")
               for o in got)
    nem = both(build, seed, processes=(NEMESIS,), draws=6,
               scope=(NEMESIS,))
    assert [o and o[1] for o in nem] == ["start", "stop"] * 3
    assert all(o[0] == "info" and o[3] == NEMESIS for o in nem)


def test_localkv_unsafe_schedule():
    """The unsafe suite's phased schedule, thread 0 (the primary's writes)
    then thread 1 (the backup's read), each drained in its own scope."""
    def build(g, wl):
        ns = plocalkv if g is pgen else jlocalkv
        return ns.localkv_unsafe_test({"time-limit": 600})["generator"]
    w0 = both(build, 5, processes=(0,), draws=4, scope=(0,))
    assert [o and (o[1], o[2]) for o in w0] == [
        ("write", 1), ("write", 2), None, None]
    r1 = both(build, 5, processes=(1,), draws=2, scope=(1,))
    assert [o and o[1] for o in r1] == ["read", None]
