"""The port's search level against the JAX search body, carry by carry.

Each case runs checkpointed segments of the JAX segment executable
(``_search_fn(segment=True, tiebreak="lex", stats=True)``) and the port's
``search_level`` (the kernels' plain versions, on the CPU) from the same
``_split_packed`` columns and ``_carry0_host`` carry, converted with
``interop``, and compares the carries after every segment: the scalar
lanes, the stats lane and ``alive`` exactly, the configurations on the
alive rows and the snapshot on the ``pa`` rows. Tolerance: none (integer
state).
"""

import numpy as np
import pytest
import torch

from jepsen_tpu.checker import tpu as T
from jepsen_tpu.models import CASRegister as JCASRegister
from jepsen_tpu.ops.encode import pack_with_init as j_pack
from jepsen_tpu.testing import simulate_register_history, wide_history

from jepsen_tpu_torch import interop
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.ops.encode import pack_with_init

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

FIXTURES = {
    # the 48-op history of __graft_entry__.entry()
    "entry": lambda: simulate_register_history(48, n_procs=4, seed=3,
                                               crash_p=0.05),
    "sim200": lambda: simulate_register_history(200, n_procs=4, n_vals=8,
                                                seed=1),
    "crashed": lambda: simulate_register_history(200, n_procs=4, n_vals=8,
                                                 seed=2, crash_p=0.05),
    "wide48": lambda: wide_history(48, 2, seed=3),
    # more than 32 crashed ops: two crashed-mask words
    "mc2": lambda: simulate_register_history(260, n_procs=6, n_vals=8,
                                             seed=3, crash_p=0.3),
}
#: (capacity, expand); the window is 32, or 64 for the wide fixture
RUNGS = {"32/4": (32, 4), "128/8": (128, 8), "bfs": (32, None)}
SEG, NSEG = 16, 2


def _columns(name):
    h = FIXTURES[name]()
    p, kernel = j_pack(h, JCASRegister())
    cr = T._crash_width(p.n - p.n_required)
    return h, p, kernel, T._split_packed(p, T._bucket(p.n_required), cr,
                                         kernel)


def assert_carry_equal(jc, pc, where):
    jc = tuple(np.asarray(x) for x in jc)
    names = ("k", "mask", "cmask", "state", "alive", "done", "lossy", "wovf",
             "level", "best_k", "pk", "ps", "pa", "stats")
    assert len(pc) == len(jc) == 14
    for i in (4, 5, 6, 7, 8, 9, 12, 13):
        assert np.array_equal(jc[i], pc[i]), (where, names[i])
    alive, pa = jc[4], jc[12]
    for i in range(4):
        assert pc[i].dtype == jc[i].dtype, (where, names[i])
        assert np.array_equal(jc[i][alive], pc[i][alive]), (where, names[i])
    for i in (10, 11):
        assert np.array_equal(jc[i][pa], pc[i][pa]), (where, names[i])


def run_both(cols, kernel, C, W, E, seg=SEG, nseg=NSEG):
    """Segments of both searches from the same start; returns the last
    pair of carries after comparing every pair."""
    n, cr = cols["f"].shape[0], cols["cf"].shape[0]
    lmax = T._level_budget(n, cr)
    carry0 = T._carry0_host(C, W, cr, cols["ini"], int(cols["nr"]),
                            stats_rows=lmax + 1)
    fn = T._jit_segment(T._kernel_key(kernel), C, W, E, 1, stats=True)
    shape = K.LevelShape(C, W, min(E or C, C), n, cr, model=kernel.name)
    tcols = interop.cols_from_numpy(cols, "cpu")
    carry = interop.carry_from_numpy(carry0, "cpu")
    scratch = G.empty_scratch(shape, "cpu")
    jc = carry0
    for s in range(nseg):
        jc = tuple(np.asarray(x) for x in fn(*[cols[c] for c in T._COLS],
                                              np.int32(seg), jc))
        G.run_segment(tcols, carry, scratch, shape, tcols["nr"], seg)
        pc = interop.carry_to_numpy(carry)
        assert_carry_equal(jc, pc, (s, int(jc[8])))
    return jc, pc


@pytest.mark.parametrize("rung", sorted(RUNGS))
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_segments_match_jax(name, rung):
    _, _, kernel, cols = _columns(name)
    C, E = RUNGS[rung]
    W = 64 if name == "wide48" else 32
    jc, _ = run_both(cols, kernel, C, W, E)
    assert int(jc[8]) > 0


def test_entry_rung_matches_jax():
    # __graft_entry__.entry()'s own shape: capacity 256, window 16, BFS
    _, _, kernel, cols = _columns("entry")
    jc, _ = run_both(cols, kernel, 256, 16, None, seg=64, nseg=1)
    assert bool(jc[5])


def test_fixtures_exercise_every_branch():
    """The crashed fixtures reach the dominance kill and the wide one the
    second mask word, so the parity above covers them."""
    _, _, kernel, cols = _columns("mc2")
    assert cols["cf"].shape[0] > 32
    jc, pc = run_both(cols, kernel, 128, 32, 8, seg=32, nseg=1)
    stats = pc[13]
    assert stats[:, 2].sum() > 0 and stats[:, 1].sum() > 0
    _, _, kernel, cols = _columns("wide48")
    jc, pc = run_both(cols, kernel, 128, 64, 8, seg=8, nseg=1)
    assert (pc[1][pc[4]][:, 1] != 0).any()


def test_search_continues_after_done():
    """Levels after the search is done change nothing (the masked update),
    so a long segment equals a short one."""
    _, _, kernel, cols = _columns("entry")
    jc, pc = run_both(cols, kernel, 32, 32, 4, seg=200, nseg=1)
    assert bool(jc[5]) and int(jc[8]) < 200


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_split_packed_matches_jax(name):
    h, p, kernel, cols = _columns(name)
    pp, pkernel = pack_with_init(History.of(o.to_dict() for o in h),
                                 CASRegister())
    cr = G._crash_width(pp.n - pp.n_required)
    assert cr == T._crash_width(p.n - p.n_required)
    ours = G._split_packed(pp, G._bucket(pp.n_required), cr, pkernel)
    # the reference's columns, and the port's crash-bound column
    assert sorted(ours) == sorted(list(cols) + ["cb"])
    assert [c for c in G._COLS if c != "cb"] == list(T._COLS)
    for c in T._COLS:
        a, b = np.asarray(cols[c]), np.asarray(ours[c])
        assert a.dtype == b.dtype and np.array_equal(a, b), c
    cb = np.searchsorted(cols["ret"], cols["cinv"], side="right")
    assert ours["cb"].dtype == np.int32 and np.array_equal(ours["cb"], cb)
    assert G._window_needed(pp) == T._window_needed(p)
    assert G._level_budget(300, 16) == T._level_budget(300, 16)


def test_carry0_and_interop_round_trip():
    _, _, _, cols = _columns("mc2")
    cr = cols["cf"].shape[0]
    lmax = T._level_budget(cols["f"].shape[0], cr)
    ref = T._carry0_host(64, 64, cr, cols["ini"], int(cols["nr"]),
                         stats_rows=lmax + 1)
    ours = G._carry0_host(64, 64, cr, cols["ini"], int(cols["nr"]),
                          stats_rows=lmax + 1)
    for a, b in zip(ref, ours):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(a, b)
    rng = np.random.default_rng(0)
    mixed = list(ours)
    mixed[1] = rng.integers(0, 2**32, size=ours[1].shape, dtype=np.uint32)
    mixed[2] = rng.integers(0, 2**32, size=ours[2].shape, dtype=np.uint32)
    mixed[4] = rng.random(64) < 0.5
    back = interop.carry_to_numpy(interop.carry_from_numpy(tuple(mixed),
                                                           "cpu"))
    for a, b in zip(mixed, back):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(a, b)


def test_plain_helpers_match_jax_bit_ops():
    """The plain versions' unsigned whole-mask helpers against the JAX
    bit helpers on random four-word masks."""
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    m = rng.integers(0, 2**32, size=(256, 4), dtype=np.uint32)
    m[::7] = 0xFFFFFFFF
    t = rng.integers(0, 129, size=256).astype(np.int32)
    mu = torch.from_numpy(m.astype(np.int64))
    np.testing.assert_array_equal(
        K._trailing_ones(mu).numpy(),
        np.asarray(T._trailing_ones_mw(jnp.asarray(m), 4)))
    np.testing.assert_array_equal(
        K._shr1(mu).numpy(), np.asarray(T._shr1_multi(jnp.asarray(m), 4)))
    np.testing.assert_array_equal(
        K._shr_by(mu, torch.from_numpy(t.astype(np.int64))).numpy(),
        np.asarray(T._shr_by_mw(jnp.asarray(m), jnp.asarray(t), 4)))
    np.testing.assert_array_equal(
        K._popc(mu).numpy(), T._popcount32_host(m))
