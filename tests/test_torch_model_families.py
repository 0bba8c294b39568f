"""The other model families (mutex, no-op, set, unordered queue, FIFO
queue) in the port against the JAX package, on the CPU.

* (a) Each numpy step and torch twin equals the JAX ``KernelSpec.step``
  on an exhaustive small grid of (state, f, v1, v2): state' and ok, on
  every input (a failed step's state' too, since the rows sort on it).
* (b) ``pack_with_init`` gives the reference's columns, ``init_state``
  and ``value_table``, and raises ValueError on the same histories.
* (c) The search carry equals the JAX segment carry lane by lane, under
  ``lex`` (``_jit_segment``) and ``hash`` (the vmapped ``_search_fn``).
* (d) ``check_history_gpu(device="cpu")`` equals ``check_history_tpu`` on
  valid, levels, max-linearized-prefix, rung and work.
* (e) A history beyond the word takes the object search, labelled.
* (f) ``check_keyed_gpu`` equals ``check_keyed_tpu`` key by key.

The reference's no-op kernel has no f-codes, so it packs no op; the
port's packs every op with nil values. For the no-op model, (b) asserts
that difference and (d) holds the port against the JAX search run with
the port's f-codes, and against the reference's object search.

Tolerance: none (integer state, exact verdicts).
"""

import dataclasses
import itertools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_checker_tpu as ref_fixtures
from jepsen_tpu.checker import tpu as T
from jepsen_tpu.checker.wgl import check_model as j_check_model
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.models import core as J
from jepsen_tpu.ops.encode import pack_history as j_pack_history
from jepsen_tpu.ops.encode import pack_with_init as j_pack

from jepsen_tpu_torch import testing as pt
from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.checker.gpu import check_history_gpu, check_keyed_gpu
from jepsen_tpu_torch.checker.wgl import check_model, linearizable
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.models import core as P
from jepsen_tpu_torch.ops.encode import pack_with_init

from test_torch_keyed import run_batch_both
from test_torch_search import run_both

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

KEYS = ("valid", "levels", "max-linearized-prefix", "rung", "work")

#: port model -> JAX model, by family
MODELS = {
    "mutex": (P.Mutex, J.Mutex),
    "noop": (P.NoOp, J.NoOp),
    "set": (P.SetModel, J.SetModel),
    "unordered-queue": (P.UnorderedQueue, J.UnorderedQueue),
    "fifo-queue": (P.FIFOQueue, J.FIFOQueue),
}
JSPECS = {
    "cas-register": J.CAS_REGISTER_KERNEL, "mutex": J.MUTEX_KERNEL,
    "noop": J.NOOP_KERNEL, "set": J.SET_KERNEL,
    "unordered-queue": J.UNORDERED_QUEUE_KERNEL,
    "fifo-queue": J.FIFO_QUEUE_KERNEL,
}
#: the JAX no-op kernel with the port's f-codes and value encoding
J_NOOP_PORTED = dataclasses.replace(
    J.NOOP_KERNEL, f_codes=P.NOOP_KERNEL.f_codes,
    encode_op=P.NOOP_KERNEL.encode_op)


def _jax(h):
    return JHistory.of(o.to_dict() for o in h)


def H(*rows):
    return History([Op(type=t, f=f, value=v, process=p, time=i)
                    for i, (p, t, f, v) in enumerate(rows)])


# ---------------------------------------------------------------------------
# (a) the steps
# ---------------------------------------------------------------------------

_SPECIAL = [2**30, 2**31 - 1, -2**31, 0x1111111, 0x7654321, 0x0FFFFFFF]
GRID = np.array(list(itertools.product(
    list(range(-2, 36)) + _SPECIAL, range(-1, 9),
    list(range(-2, 34)) + _SPECIAL[:3], list(range(-2, 34)) + _SPECIAL[:3])),
    np.int32)


def _wrap(a):
    """Values as int32 words (the numpy steps may widen to int64)."""
    return ((np.asarray(a, np.int64) + 2**31) % 2**32 - 2**31).astype(
        np.int32)


@pytest.mark.parametrize("spec", P.KERNELS, ids=lambda s: s.name)
def test_each_step_equals_the_jax_step_on_a_grid(spec):
    S, F, V1, V2 = (GRID[:, i] for i in range(4))
    js, jok = JSPECS[spec.name].step(*(jnp.asarray(x) for x in (S, F, V1,
                                                                 V2)))
    js = np.broadcast_to(np.asarray(js), S.shape)
    jok = np.broadcast_to(np.asarray(jok), S.shape)
    assert js.dtype == np.int32
    ns, nok = spec.step(S, F, V1, V2)
    np.testing.assert_array_equal(_wrap(np.broadcast_to(ns, S.shape)), js)
    np.testing.assert_array_equal(np.broadcast_to(nok, S.shape), jok)
    ts, tok = spec.step_torch(*(torch.from_numpy(x.copy())
                                for x in (S, F, V1, V2)))
    assert ts.dtype == torch.int32 and tok.dtype == torch.bool
    np.testing.assert_array_equal(ts.expand(S.shape).numpy(), js)
    np.testing.assert_array_equal(tok.expand(S.shape).numpy(), jok)


@pytest.mark.parametrize("spec", P.KERNELS, ids=lambda s: s.name)
def test_each_step_broadcasts_like_the_search_calls_it(spec):
    """[E, 1] states against [E, W] op columns, as the expansion calls
    it."""
    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.integers(0, 64, (5, 1)).astype(np.int32))
    f, v1, v2 = (torch.from_numpy(rng.integers(-1, 8, (5, 7))
                                  .astype(np.int32)) for _ in range(3))
    s2, ok = spec.step_torch(s, f, v1, v2)
    assert s2.shape == ok.shape == (5, 7)


def test_every_model_has_a_kernel():
    for port_cls, _ in MODELS.values():
        assert P.kernel_spec_for(port_cls()) is not None
    assert [k.name for k in P.KERNELS] == list(JSPECS)
    for spec in P.KERNELS:
        j = JSPECS[spec.name]
        assert spec.init_state == j.init_state
        if spec.name != "noop":
            assert spec.f_codes == j.f_codes


# ---------------------------------------------------------------------------
# (b) packing
# ---------------------------------------------------------------------------


def _seq_set(n_adds, reads_at):
    """Sequential adds of 0..n_adds-1 by process 0, with a read by process
    1 after each index in ``reads_at``."""
    rows, added = [], []
    for i in range(n_adds):
        rows += [(0, "invoke", "add", i), (0, "ok", "add", i)]
        added.append(i)
        if i + 1 in reads_at:
            rows += [(1, "invoke", "read", None),
                     (1, "ok", "read", list(added))]
    return H(*rows)


def _enqueues_of_one(n, dequeue=True):
    rows = []
    for _ in range(n):
        rows += [(0, "invoke", "enqueue", 9), (0, "ok", "enqueue", 9)]
    if dequeue:
        rows += [(1, "invoke", "dequeue", None), (1, "ok", "dequeue", 9)]
    return H(*rows)


def _fifo_depth(depth):
    rows = []
    for v in range(depth):
        rows += [(0, "invoke", "enqueue", v), (0, "ok", "enqueue", v)]
    for v in range(depth):
        rows += [(1, "invoke", "dequeue", None), (1, "ok", "dequeue", v)]
    return H(*rows)


def _fifo_crashed_nil_dequeue():
    """A crashed dequeue with no value (a drain that died) between an
    enqueue and its dequeue: the encoder drops it."""
    return H((0, "invoke", "enqueue", "a"), (0, "ok", "enqueue", "a"),
             (1, "invoke", "dequeue", None), (1, "info", "dequeue", None),
             (2, "invoke", "dequeue", None), (2, "ok", "dequeue", "a"))


def _mutex_double_acquire():
    return H((0, "invoke", "acquire", None), (0, "ok", "acquire", None),
             (1, "invoke", "acquire", None), (1, "ok", "acquire", None))


#: (family, model instance args, history); the ones marked True raise in
#: both packers
PACK_CASES = [
    ("mutex", (), lambda: pt.simulate_mutex_history(300, 4, seed=1,
                                                    crash_p=0.03), False),
    ("mutex", (True,), _mutex_double_acquire, False),
    ("set", (), lambda: pt.simulate_set_history(200, 4, seed=2,
                                                crash_p=0.05), False),
    ("set", (frozenset({7}),), lambda: H((0, "invoke", "read", None),
                                         (0, "ok", "read", [7, 8])), False),
    ("set", (), lambda: _seq_set(10000, {3333, 6666, 10000}), True),
    ("set", (), lambda: _seq_set(600, {200, 400, 600}), False),
    ("unordered-queue", (), lambda: pt.unique_queue_history(200, seed=1),
     False),
    ("unordered-queue", (), lambda: pt.unique_queue_history(500, seed=1),
     True),
    ("unordered-queue", (), lambda: _enqueues_of_one(17), True),
    ("unordered-queue", (), lambda: _enqueues_of_one(17, False), False),
    ("unordered-queue", (("x", "y"),), lambda: pt.simulate_queue_history(
        400, 5, seed=3, backlog=8, fifo=False), False),
    ("fifo-queue", (), lambda: pt.simulate_queue_history(
        400, 3, seed=4, backlog=2, fifo=True), False),
    ("fifo-queue", (), lambda: _fifo_depth(8), True),
    ("fifo-queue", (), lambda: _fifo_depth(7), False),
    ("fifo-queue", (("q",),), _fifo_crashed_nil_dequeue, False),
    ("noop", (), lambda: H(), False),
]
PACK_CASES += [(fam, (), (lambda f=f, s=s: f(random.Random(s))), None)
               for fam, f in (("set", pt.random_set_history),
                              ("unordered-queue", pt.random_queue_history),
                              ("fifo-queue", pt.random_fifo_history))
               for s in range(6)]


def _assert_packed_equal(ours, ref):
    pp, pk = ours
    jp, jk = ref
    assert pk.name == jk.name
    for c in ("f", "v1", "v2", "inv", "ret", "process"):
        a, b = getattr(jp, c), getattr(pp, c)
        assert a.dtype == b.dtype and np.array_equal(a, b), c
    assert pp.n_required == jp.n_required
    assert int(pp.init_state) == int(jp.init_state)
    assert pp.value_table == jp.value_table
    assert [tuple(o.to_dict() if o else None for o in pair)
            for pair in pp.ops] == [tuple(o.to_dict() if o else None
                                          for o in pair) for pair in jp.ops]


@pytest.mark.parametrize("i", range(len(PACK_CASES)))
def test_packing_matches_jax(i):
    family, args, make, raises = PACK_CASES[i]
    port_cls, jax_cls = MODELS[family]
    h = make()
    try:
        ref = j_pack(_jax(h), jax_cls(*args))
    except ValueError:
        ref = None
    if raises is not None:
        assert (ref is None) is raises
    if ref is None:
        with pytest.raises(ValueError):
            pack_with_init(h, port_cls(*args))
        return
    _assert_packed_equal(pack_with_init(h, port_cls(*args)), ref)


def test_the_noop_kernel_packs_every_op():
    """The reference's no-op kernel has no f-codes: any op makes its
    packer raise, and its checker then takes the object search. The
    port's packs every op, as a nil-valued read, and drops crashed ones;
    the columns are otherwise the reference packer's."""
    h = pt.simulate_register_history(200, seed=5, crash_p=0.05)
    with pytest.raises(ValueError):
        j_pack(_jax(h), J.NoOp())
    pp, pk = pack_with_init(h, P.NoOp())
    assert pk is P.NOOP_KERNEL
    assert pp.n == pp.n_required > 0
    assert (pp.f == P.F_READ).all() and (pp.v1 == P.NIL_ID).all()
    assert (pp.v2 == P.NIL_ID).all()
    jp = j_pack_history(_jax(h), J_NOOP_PORTED)
    _assert_packed_equal((pp, pk), (jp, J_NOOP_PORTED))


@pytest.mark.parametrize("name", ["set", "queue", "fifo"])
def test_the_fixture_copies_match_the_reference(name):
    port, ref = {
        "set": (pt.random_set_history, ref_fixtures.random_set_history),
        "queue": (pt.random_queue_history,
                  ref_fixtures.random_queue_history),
        "fifo": (pt.random_fifo_history, ref_fixtures.random_fifo_history),
    }[name]
    for seed in range(5):
        a, b = port(random.Random(seed)), ref(random.Random(seed))
        assert [o.to_dict() for o in a] == [o.to_dict() for o in b]
    a = pt.unique_queue_history(120, seed=3, corrupt=True)
    b = ref_fixtures.unique_queue_history(120, seed=3, corrupt=True)
    assert [o.to_dict() for o in a] == [o.to_dict() for o in b]


@pytest.mark.parametrize("family,make", [
    ("mutex", lambda: pt.simulate_mutex_history(400, 5, seed=6,
                                                crash_p=0.02)),
    ("unordered-queue", lambda: pt.simulate_queue_history(
        400, 5, seed=6, backlog=8, fifo=False)),
    ("fifo-queue", lambda: pt.simulate_queue_history(
        400, 3, seed=6, backlog=2, fifo=True)),
    ("set", lambda: pt.simulate_set_history(300, 5, seed=6, crash_p=0.02)),
])
def test_the_simulators_are_linearizable(family, make):
    """Each simulator's history is valid under the reference's object
    search, and fits its model's word."""
    h = make()
    assert j_check_model(_jax(h), MODELS[family][1]())["valid"] is True
    assert pack_with_init(h, MODELS[family][0]()) is not None


# ---------------------------------------------------------------------------
# (c) the search carry
# ---------------------------------------------------------------------------

#: small histories of each family, rich enough to keep a live pool
CARRY = {
    "mutex": (lambda: pt.simulate_mutex_history(300, 5, seed=11,
                                                crash_p=0.03), ()),
    "mutex-locked": (lambda: pt.simulate_mutex_history(60, 3, seed=12),
                     (True,)),
    "noop": (lambda: pt.simulate_register_history(200, 5, seed=13), ()),
    "set": (lambda: pt.simulate_set_history(150, 5, seed=14,
                                            crash_p=0.05), ()),
    "set-reads": (lambda: pt.random_set_history(random.Random(3), 4, 40,
                                                corrupt_p=0.0), ()),
    "unordered-queue": (lambda: pt.simulate_queue_history(
        300, 5, seed=15, backlog=8, fifo=False), ()),
    "unordered-queue-crashed": (lambda: pt.random_queue_history(
        random.Random(5), 4, 40, corrupt_p=0.0), ()),
    "fifo-queue": (lambda: pt.simulate_queue_history(
        300, 3, seed=16, backlog=2, fifo=True), ()),
    "fifo-queue-crashed": (lambda: pt.random_fifo_history(
        random.Random(12), 3, 16, corrupt_p=0.0), ()),
}


def _family(name):
    return name if name in MODELS else name.rsplit("-", 1)[0]


def _jcols(name, breq=None, cr=None):
    make, args = CARRY[name]
    port_cls, jax_cls = MODELS[_family(name)]
    h = make()
    if jax_cls is J.NoOp:
        p, kernel = j_pack_history(_jax(h), J_NOOP_PORTED), J_NOOP_PORTED
    else:
        p, kernel = j_pack(_jax(h), jax_cls(*args))
    if cr is None:
        cr = T._crash_width(p.n - p.n_required)
    return p, kernel, T._split_packed(p, breq or T._bucket(p.n_required),
                                      cr, kernel)


@pytest.mark.parametrize("rung", [(32, 4), (64, None)])
@pytest.mark.parametrize("name", sorted(CARRY))
def test_lex_segments_match_jax(name, rung):
    p, kernel, cols = _jcols(name)
    C, E = rung
    W = max(32, T._window_bucket(T._window_needed(p)))
    jc, _ = run_both(cols, kernel, C, W, E, seg=12, nseg=2)
    assert int(jc[8]) > 0


@pytest.mark.parametrize("family", sorted(MODELS))
def test_hash_batches_match_jax_vmap(family):
    names = [n for n in sorted(CARRY) if _family(n) == family]
    packs = [_jcols(n) for n in names]
    breq = max(T._bucket(p.n_required) for p, _, _ in packs)
    cr = max(c["cf"].shape[0] for _, _, c in packs)
    cols = [_jcols(n, breq, cr)[2] for n in names]
    W = max(32, max(T._window_bucket(T._window_needed(p))
                    for p, _, _ in packs))
    run_batch_both(packs[0][1], cols, (32, W, 4), "hash", seg=12, nseg=2)


# ---------------------------------------------------------------------------
# (d) the checker
# ---------------------------------------------------------------------------


def _assert_same(h, family, args=(), **kw):
    port_cls, jax_cls = MODELS[family]
    ours = check_history_gpu(h, port_cls(*args), device="cpu", **kw)
    if jax_cls is J.NoOp:
        assert T.check_history_tpu(_jax(h), J.NoOp()) is None
        ref = T.check_packed_tpu(j_pack_history(_jax(h), J_NOOP_PORTED),
                                 J_NOOP_PORTED, **kw)
        assert j_check_model(_jax(h), J.NoOp())["valid"] is ours["valid"]
    else:
        ref = T.check_history_tpu(_jax(h), jax_cls(*args), **kw)
    assert {k: ours.get(k) for k in KEYS} == {k: ref.get(k) for k in KEYS}
    assert ours["backend"] == "gpu"
    return ours


def _corrupt_last(h, f, value):
    rows = list(h)
    for i in range(len(rows) - 1, -1, -1):
        if rows[i].type == "ok" and rows[i].f == f:
            rows[i] = rows[i].replace(value=value)
            return History(rows)
    raise AssertionError(f"no ok {f}")


def _drop_a_release(h, nth=3):
    """The history without the nth ok release (its invocation and
    completion): the next acquire then finds the lock held."""
    rows = list(h)
    done = [i for i, o in enumerate(rows) if o.type == "ok"
            and o.f == "release"][nth]
    p = rows[done].process
    inv = max(i for i in range(done) if rows[i].process == p
              and rows[i].type == "invoke")
    return History([o for i, o in enumerate(rows) if i not in (inv, done)])


CHECK_CASES = {
    "mutex": ("mutex", (), lambda: pt.simulate_mutex_history(
        600, 5, seed=21, crash_p=0.01), True),
    "mutex-locked-valid": ("mutex", (True,), lambda: H(
        (0, "invoke", "release", None), (0, "ok", "release", None),
        (1, "invoke", "acquire", None), (1, "ok", "acquire", None)), True),
    "mutex-locked-invalid": ("mutex", (True,), lambda: H(
        (0, "invoke", "acquire", None), (0, "ok", "acquire", None)), False),
    "mutex-dropped-release": ("mutex", (), lambda: _drop_a_release(
        pt.simulate_mutex_history(300, 5, seed=22)), False),
    "noop": ("noop", (), lambda: pt.simulate_register_history(
        500, 5, seed=23, crash_p=0.01), True),
    "set": ("set", (), lambda: pt.simulate_set_history(
        400, 5, seed=24, crash_p=0.01), True),
    "set-bad-read": ("set", (), lambda: _corrupt_last(
        pt.simulate_set_history(200, 5, seed=25), "read", [0, 1]), False),
    "uqueue-unique": ("unordered-queue", (), lambda: pt.unique_queue_history(
        200, seed=1), True),
    "uqueue-unique-corrupt": ("unordered-queue", (),
                              lambda: pt.unique_queue_history(
                                  200, seed=1, corrupt=True), False),
    "uqueue-backlog": ("unordered-queue", (), lambda: pt.simulate_queue_history(
        800, 5, seed=26, backlog=8, fifo=False), True),
    "fifo": ("fifo-queue", (), lambda: pt.simulate_queue_history(
        800, 3, seed=27, backlog=2, fifo=True), True),
    "fifo-out-of-order": ("fifo-queue", (), lambda: H(
        (0, "invoke", "enqueue", "a"), (0, "ok", "enqueue", "a"),
        (0, "invoke", "enqueue", "b"), (0, "ok", "enqueue", "b"),
        (1, "invoke", "dequeue", None), (1, "ok", "dequeue", "b")), False),
    "fifo-crashed-nil-dequeue": ("fifo-queue", (), _fifo_crashed_nil_dequeue,
                                 True),
    "fifo-initial": ("fifo-queue", (("x",),), lambda: H(
        (0, "invoke", "dequeue", None), (0, "ok", "dequeue", "x")), True),
}


@pytest.mark.parametrize("name", sorted(CHECK_CASES))
def test_checks_match_jax(name):
    family, args, make, valid = CHECK_CASES[name]
    assert _assert_same(make(), family, args)["valid"] is valid


@pytest.mark.parametrize("family,make", [
    ("set", pt.random_set_history), ("unordered-queue",
                                     pt.random_queue_history),
    ("fifo-queue", pt.random_fifo_history)])
def test_random_histories_match_jax(family, make):
    """Seeded random histories, valid and refuted, where both packers
    fit them in the word."""
    rng = random.Random(17)
    seen = set()
    for _ in range(12):
        h = make(rng)
        try:
            pack_with_init(h, MODELS[family][0]())
        except ValueError:
            continue
        seen.add(_assert_same(h, family)["valid"])
    assert seen == {True, False}


def test_the_facade_keeps_a_fitting_history_on_the_device():
    for name in ("mutex-locked-invalid", "noop", "set", "uqueue-unique",
                 "fifo-crashed-nil-dequeue", "fifo-initial"):
        family, args, make, valid = CHECK_CASES[name]
        out = linearizable(MODELS[family][0](*args), device="cpu").check(
            {}, make())
        assert out["valid"] is valid and out["backend"] == "gpu"
        assert "fallback-from" not in out


# ---------------------------------------------------------------------------
# (e) histories beyond the word
# ---------------------------------------------------------------------------


def test_host_fallback_is_labeled():
    h = _enqueues_of_one(17)
    assert check_history_gpu(h, P.UnorderedQueue(), device="cpu") is None
    out = linearizable(P.UnorderedQueue(), device="cpu").check({}, h)
    assert out["valid"] is True
    assert out["backend"] == "cpu"
    assert out["fallback-from"] == "gpu"
    assert "kernel" in out["fallback-reason"] \
        or "encoding" in out["fallback-reason"]


@pytest.mark.parametrize("corrupt", [False, True])
def test_the_object_search_matches_jax_beyond_the_word(corrupt):
    h = pt.unique_queue_history(500, seed=1, corrupt=corrupt)
    with pytest.raises(ValueError):
        pack_with_init(h, P.UnorderedQueue())
    ours = linearizable(P.UnorderedQueue(), device="cpu").check({}, h)
    ref = j_check_model(_jax(h), J.UnorderedQueue())
    assert ours["fallback-from"] == "gpu"
    for k in ("valid", "configs-explored", "max-linearized-prefix",
              "final-models"):
        assert ours.get(k) == ref.get(k), k
    assert ours["valid"] is (not corrupt)


def test_the_object_search_matches_jax_on_every_family():
    rng = random.Random(23)
    for family, make in (("set", pt.random_set_history),
                         ("unordered-queue", pt.random_queue_history),
                         ("fifo-queue", pt.random_fifo_history)):
        for _ in range(8):
            h = make(rng)
            ours = check_model(h, MODELS[family][0]())
            ref = j_check_model(_jax(h), MODELS[family][1]())
            assert ours == ref


# ---------------------------------------------------------------------------
# (f) the keyed batch
# ---------------------------------------------------------------------------

KEYED = {
    "mutex": {k: (lambda k=k: pt.simulate_mutex_history(
        200, 4, seed=300 + k, crash_p=0.02)) for k in range(5)},
    "unordered-queue": {k: (lambda k=k: pt.simulate_queue_history(
        200, 5, seed=400 + k, backlog=8, fifo=False)) for k in range(4)},
}
KEYED["mutex"]["bad"] = lambda: _drop_a_release(
    pt.simulate_mutex_history(200, 4, seed=399))
KEYED["unordered-queue"]["bad"] = lambda: pt.unique_queue_history(
    150, seed=2, corrupt=True)
KEYED["unordered-queue"]["wide"] = lambda: _enqueues_of_one(17)


@pytest.mark.parametrize("family", sorted(KEYED))
def test_keyed_batches_match_jax(family):
    keyed = {k: f() for k, f in KEYED[family].items()}
    port_cls, jax_cls = MODELS[family]
    ref = T.check_keyed_tpu({k: _jax(h) for k, h in keyed.items()},
                            jax_cls())
    ours = check_keyed_gpu(keyed, port_cls(), device="cpu")
    assert set(ours["results"]) == set(ref["results"])
    for k in keyed:
        a, b = ours["results"][k], ref["results"][k]
        assert ({x: a.get(x) for x in KEYS + ("crash-width", "tiebreak")}
                == {x: b.get(x) for x in KEYS + ("crash-width", "tiebreak")
                    }), k
    assert ours["results"]["bad"]["valid"] is False
    assert ours["valid"] is False
    if family == "unordered-queue":
        assert ours["results"]["wide"]["valid"] == UNKNOWN


@pytest.mark.parametrize("family,make", [
    ("mutex", lambda: pt.simulate_mutex_history(300, 5, seed=31,
                                                crash_p=0.01)),
    ("unordered-queue", lambda: pt.simulate_queue_history(
        300, 5, seed=32, backlog=8, fifo=False)),
    ("fifo-queue", lambda: pt.simulate_queue_history(
        300, 3, seed=33, backlog=2, fifo=True)),
    ("set", lambda: pt.simulate_set_history(40, 3, seed=34)),
])
def test_the_corrupted_copies_are_not_linearizable(family, make):
    """corrupt_model_history's copies are refuted by the reference's
    object search; the queue copies also by the port's device search."""
    bad = pt.corrupt_model_history(make(), family)
    assert j_check_model(_jax(bad), MODELS[family][1]())["valid"] is False
    if family.endswith("queue"):
        _assert_same(bad, family)


def test_a_lost_crashed_add_is_unknown_in_both():
    """A valid set history where a crashed add's effect was lost: the
    pool search at (64, 32, 64) drops every lineage that leaves that add
    untaken, and the final read then fails in all of them. The port
    reproduces the reference's UNKNOWN at the same level; the facade
    then takes the host search."""
    h = pt.simulate_set_history(300, 5, seed=0, crash_p=0.01)
    out = _assert_same(h, "set", capacity=64, window=32, expand=64)
    assert out["valid"] == UNKNOWN
    assert j_check_model(_jax(h), J.SetModel())["valid"] is True
