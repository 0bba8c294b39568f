"""The port's host utilities against the reference's ``jepsen_tpu.util``
on the same inputs, made from a seed: majority and minority, the sleeps,
``name_or_str``, the common-prefix helpers, the lazy atom (and the atom
as its subclass) and exponential draws from an explicit generator."""

import random
import threading
import time

import pytest
import torch

from jepsen_tpu import util as j_util

from jepsen_tpu_torch import util

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)


@pytest.mark.parametrize("n", range(0, 12))
def test_majority_and_minority(n):
    assert util.majority(n) == j_util.majority(n)
    assert util.minority(n) == j_util.minority(n)
    if n:
        assert util.minority(n) < util.majority(n) \
            and util.minority(n) + util.majority(n) <= n


@pytest.mark.parametrize("dt", [-5, 0, 2_000_000])
def test_sleep_nanos(dt):
    t0 = time.monotonic()
    assert util.sleep_nanos(dt) is j_util.sleep_nanos(dt) is None
    took = time.monotonic() - t0
    assert took >= 2 * max(dt, 0) / 1e9 - 1e-4
    assert took < 1.0


@pytest.mark.parametrize("x", [len, util.Atom, "name", 7, None, 2.5,
                               util.minority])
def test_name_or_str(x):
    assert util.name_or_str(x) == j_util.name_or_str(x)


def _sequences(seed):
    """Seeded collections of strings and lists with shared prefixes."""
    rng = random.Random(seed)
    out = []
    for _ in range(40):
        base = "".join(rng.choice("ab") for _ in range(rng.randrange(5)))
        strings = [base + "".join(rng.choice("abc")
                                  for _ in range(rng.randrange(4)))
                   for _ in range(rng.randrange(1, 5))]
        out.append(strings)
        out.append([list(s) for s in strings])
    return out + [[], ["", "x"], ["ab", "ab"], ["abcd", "abce"]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_common_prefix_helpers(seed):
    for xs in _sequences(seed):
        assert util.longest_common_prefix(xs) == \
            j_util.longest_common_prefix(xs), xs
        assert util.drop_common_proper_prefix(xs) == \
            j_util.drop_common_proper_prefix(xs), xs


def test_the_lazy_atom_is_the_references():
    for mod in (util, j_util):
        calls = []
        a = mod.LazyAtom(lambda: calls.append(1) or 10)
        assert not calls
        assert a.deref() == 10 and a.deref() == 10 and len(calls) == 1
        assert a.swap(lambda x, y: x + y, 5) == 15
        b = mod.LazyAtom(lambda: calls.append(2) or 0)
        assert b.reset(3) == 3 and b.deref() == 3
        assert calls == [1]   # a reset value is never computed


def test_the_lazy_atom_computes_once_across_threads():
    calls = []
    a = util.LazyAtom(lambda: calls.append(1) or len(calls))
    threads = [threading.Thread(target=a.swap, args=(lambda x: x + 1,))
               for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == [1] and a.deref() == 17


def test_the_atom_is_a_lazy_atom():
    assert issubclass(util.Atom, util.LazyAtom)
    a = util.Atom(0)
    assert a.deref() == 0
    assert a.swap(lambda x: x + 5) == 5
    a.reset(9)
    assert a.deref() == 9


@pytest.mark.parametrize("mean", [0.5, 3.0])
def test_rand_exp_draws_the_references(mean):
    ours = [util.rand_exp(mean, random.Random(7)) for _ in range(3)]
    rng, jrng = random.Random(11), random.Random(11)
    a = [util.rand_exp(mean, rng) for _ in range(500)]
    b = [j_util.rand_exp(mean, jrng) for _ in range(500)]
    assert a == b and len(set(ours)) == 1
    assert all(x >= 0 for x in a)
    assert abs(sum(a) / len(a) - mean) < 0.2 * mean
