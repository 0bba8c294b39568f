"""The segment loop (B9) on the CPU: the port's level-pair loop with its
early stop against the reference's ``lax.while_loop(seg_active, body_n,
carry)``.

``gpu.run_segment`` with the plain versions runs the control flow the
card's segment graph runs: level pairs, then ``seg_active``, until no key
is active or the segment's bound is reached (an odd bound rounded up to
the next pair). Each case runs segments of the port and of the
reference's segment executable (``Engine.jit_segment``; under ``vmap``
for a keyed batch under either tie-break; ``Engine.jit_batch_segment``
for a gang) from the same columns and carry, and compares the carries
after every segment, lane by lane, and the levels the port's counter says
it ran with the levels the reference advanced. The reference runs the
rounded length, and each starts on an active search, as the host
launches one. Then a level run after every key's search has ended leaves
the carry bit for bit as it was, and ``seg_active``'s count and test are
checked on their own.

Tolerance: none (integer state).
"""

import jax
import numpy as np
import pytest
import torch

from jepsen_tpu import testing as jt
from jepsen_tpu.checker import tpu as T
from jepsen_tpu.checker.engine import Engine as JEngine
from jepsen_tpu.models import CASRegister as JCASRegister
from jepsen_tpu.ops.encode import pack_with_init as j_pack

from jepsen_tpu_torch import interop
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.kernels import search as K

from test_torch_keyed import assert_batch_equal
from test_torch_search import assert_carry_equal

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

#: segment lengths asked for (1 and 7 run as 2 and 8)
LENGTHS = (1, 2, 7, 64)
#: segments compared per case
NSEG = 4
RUNG = (32, 32, 4)

_JENGINE = JEngine()
_VMAPPED = {}


def _pack(histories, cr):
    packed = [j_pack(h, JCASRegister()) for h in histories]
    kernel = packed[0][1]
    breq = T._bucket(max(p.n_required for p, _ in packed))
    return kernel, [T._split_packed(p, breq, cr, kernel) for p, _ in packed]


def _single():
    h = jt.simulate_register_history(60, n_procs=4, n_vals=8, seed=11,
                                     crash_p=0.05)
    return _pack([h], 8)


def _batch():
    return _pack([jt.simulate_register_history(n, n_procs=4, n_vals=8,
                                               seed=s, crash_p=0.03)
                  for n, s in ((60, 21), (24, 22), (80, 23))], 8)


def _gang():
    """Three lanes, the last deeper than one 64-level segment."""
    return _pack([jt.simulate_register_history(n, n_procs=4, n_vals=8,
                                               seed=s, crash_p=0.03)
                  for n, s in ((60, 21), (24, 22), (160, 24))], 8)


def _port_state(cols, shape):
    tcols = interop.batch_cols_from_numpy(interop.stack_cols(cols), "cpu")
    carry = interop.batch_carry_from_numpy(G._batch_carry0_host(
        shape.C, shape.W, shape.CR, [c["ini"] for c in cols],
        [int(c["nr"]) for c in cols], shape.lmax + 1), "cpu")
    return tcols, carry, G.empty_scratch(shape, "cpu")


def _port_segment(tcols, carry, scratch, shape, n):
    """One segment of the pair loop; the levels its counter ran."""
    seg, graph = G.run_segment(tcols, carry, scratch, shape, tcols["nr"], n,
                               G.PLAIN)
    assert graph is None
    return G.end_segment(carry, shape, seg, graph)[0]


@pytest.mark.parametrize("n", LENGTHS)
def test_a_single_history_matches_jit_segment(n):
    kernel, cols = _single()
    C, W, E = RUNG
    fn = _JENGINE.jit_segment(T._kernel_key(kernel), C, W, E, stats=True)
    shape = K.LevelShape(C, W, E, cols[0]["f"].shape[0],
                         cols[0]["cf"].shape[0])
    tcols, carry, scratch = _port_state(cols, shape)
    jc = T._carry0_host(C, W, shape.CR, cols[0]["ini"], int(cols[0]["nr"]),
                        stats_rows=shape.lmax + 1)
    bound = n + n % 2
    for s in range(NSEG):
        if not T._carry_active(jc, shape.lmax):
            break
        before = int(jc[8])
        jc = tuple(np.asarray(x) for x in fn(
            *[cols[0][c] for c in T._COLS], np.int32(bound), jc))
        run = _port_segment(tcols, carry, scratch, shape, n)
        assert_carry_equal(jc, interop.carry_to_numpy(carry), (n, s))
        assert run == int(jc[8]) - before, (n, s)
    assert int(jc[8]) > 0


def _vmapped(kernel, shape):
    key = (shape.C, shape.W, shape.E, shape.n, shape.CR, shape.tiebreak)
    if key not in _VMAPPED:
        search = T._search_fn(kernel.step, shape.n, shape.CR, shape.C,
                              shape.W, shape.E, tiebreak=shape.tiebreak,
                              segment=True, stats=True)
        _VMAPPED[key] = jax.jit(jax.vmap(search,
                                         in_axes=(0,) * 15 + (None, 0)))
    return _VMAPPED[key]


@pytest.mark.parametrize("tiebreak", K.TIEBREAKS)
@pytest.mark.parametrize("n", LENGTHS)
def test_a_keyed_batch_matches_the_vmapped_segment(n, tiebreak):
    """Exact under both tie-breaks (the parity rule asks verdict and
    levels of ``hash``; the carries agree throughout)."""
    kernel, cols = _batch()
    C, W, E = RUNG
    shape = K.LevelShape(C, W, E, cols[0]["f"].shape[0], 8, B=len(cols),
                         tiebreak=tiebreak)
    fn = _vmapped(kernel, shape)
    stacked = interop.stack_cols(cols)
    tcols, carry, scratch = _port_state(cols, shape)
    jc = G._batch_carry0_host(C, W, 8, [c["ini"] for c in cols],
                              [int(c["nr"]) for c in cols], shape.lmax + 1)
    bound = n + n % 2
    for s in range(NSEG):
        if not K.active(carry.scal, shape.lmax).any():
            break
        before = np.asarray(jc[8]).copy()
        jc = tuple(np.asarray(x) for x in fn(
            *[stacked[c] for c in T._COLS], np.int32(bound), jc))
        run = _port_segment(tcols, carry, scratch, shape, n)
        pc = interop.batch_carry_to_numpy(carry)
        assert_batch_equal(jc, pc, (n, tiebreak, s))
        assert run == int((jc[8] - before).max()), (n, tiebreak, s)


@pytest.mark.parametrize("n", LENGTHS)
def test_a_gang_with_a_cancelled_lane_matches_jit_batch_segment(n):
    """The gang's executable (13 lanes, lex); lane 0 is cancelled at the
    first barrier, on the reference's host carry (its ``alive`` cleared)
    and on the port's device carry (``cancel_lanes``)."""
    kernel, cols = _gang()
    C, W, E = RUNG
    fn = _JENGINE.jit_batch_segment(T._kernel_key(kernel), C, W, E)
    shape = K.LevelShape(C, W, E, cols[0]["f"].shape[0], 8, B=len(cols))
    stacked = interop.stack_cols(cols)
    tcols, carry, scratch = _port_state(cols, shape)
    jc = G._batch_carry0_host(C, W, 8, [c["ini"] for c in cols],
                              [int(c["nr"]) for c in cols], 0)
    bound = n + n % 2
    for s in range(NSEG):
        if not K.active(carry.scal, shape.lmax).any():
            break
        if s == 1:
            cut = int(jc[8][0])
            alive = np.asarray(jc[4]).copy()
            alive[0] = False
            jc = jc[:4] + (alive,) + jc[5:]
            G.cancel_lanes(carry, [0])
        before = np.asarray(jc[8]).copy()
        jc = tuple(np.asarray(x) for x in fn(
            *[stacked[c] for c in T._COLS], np.int32(bound), jc))
        run = _port_segment(tcols, carry, scratch, shape, n)
        pc = interop.batch_carry_to_numpy(carry)
        assert_batch_equal(jc + (pc[13],), pc, (n, s))
        assert run == int((jc[8] - before).max()), (n, s)
    assert int(jc[8][0]) == cut and int(jc[8].max()) > cut


def test_a_level_past_every_keys_end_changes_nothing():
    """Once no key is active a level changes no lane of the carry, the
    pool included (the kernels' masked update copies it into the other
    buffer): what makes a pair's second level and a rounded-up bound
    safe."""
    kernel, cols = _batch()
    C, W, E = RUNG
    shape = K.LevelShape(C, W, E, cols[0]["f"].shape[0], 8, B=len(cols))
    tcols, carry, scratch = _port_state(cols, shape)
    runs = G.run_batch(tcols, carry, scratch, shape, 1024, G.PLAIN)
    assert not K.active(carry.scal, shape.lmax).any()
    before = interop.batch_carry_to_numpy(carry)
    for _ in range(3):
        G.search_level(tcols, carry, scratch, shape, tcols["nr"], G.PLAIN)
        after = interop.batch_carry_to_numpy(carry)
        for x, y in zip(before, after, strict=True):
            assert np.array_equal(x, y)
    assert sum(runs) == int(before[8].max())


@pytest.mark.parametrize("ops", ["kernels", "plain"])
def test_seg_active_counts_the_pair_and_tests_the_bound(ops):
    """The counter adds 1 + (some key ran the pair's second level); go is
    any key active and the count under the bound. The wrapper takes the
    plain version on CPU tensors."""
    fn = K.seg_active if ops == "kernels" else K.seg_active_plain
    lmax = 10
    scal = torch.zeros(3, K.NSCAL, dtype=torch.int32)
    scal[:, K.DONE] = torch.tensor([1, 0, 0])
    scal[:, K.NALIVE] = torch.tensor([5, 0, 2])
    scal[:, K.LEVEL] = torch.tensor([4, 4, 4])
    cases = [
        # (ACT of key 2, its level, run, bound) -> (run, go)
        ((1, 4, 0, 8), (2, 1)),
        ((1, 4, 6, 8), (8, 0)),
        ((0, 4, 0, 8), (1, 1)),
        ((1, 11, 0, 8), (2, 0)),
    ]
    for (act, level, run, bound), want in cases:
        s = scal.clone()
        s[2, K.ACT], s[2, K.LEVEL] = act, level
        seg = torch.tensor([run, bound, 7, 0], dtype=torch.int32)
        given = s.clone()
        fn(s, lmax, seg)
        assert (int(seg[K.SEG_RUN]), int(seg[K.SEG_GO])) == want
        assert int(seg[K.SEG_BOUND]) == bound
        assert torch.equal(s, given)
