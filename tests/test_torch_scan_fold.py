"""K3 (``group_scan``) and K5 (``seg_active``) folded into K4, on the CPU.

On the narrow rungs ``dedup_truncate``'s one-block kernel scans the group
starts (tpu.py:605) in its shared memory, in stripes of its block; on the
wide rungs ``group_scan`` is one launch that scans each 1,024-row block,
and ``dedup_truncate`` adds the blocks' carry where it reads the starts;
where there are no crashed ops nothing scans. Here:

* a numpy emulation, one array lane per CUDA thread, of the striped block
  max-scan of ``block_group_starts`` and of ``scan_local_kernel`` with the
  carry ``dedup_kernel`` applies, each against ``torch.cummax``;
* the plain route, which takes the kernels' route, after segments against
  the reference's segment executables (JAX on the CPU), lane by lane,
  under both tie-breaks, with and without crashed ops, on a narrow rung
  and on (512, 64, 512);
* the launches the route makes: no ``group_scan`` at CR = 0 nor on a
  narrow rung, one a level on a wide rung with crashed ops; and a segment
  graph's count of its pair ends, with no ``seg_active`` launch.

Tolerance: none (integer state).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jepsen_tpu import testing as jt
from jepsen_tpu.checker import tpu as T
from jepsen_tpu.models import CASRegister as JCASRegister
from jepsen_tpu.ops.encode import pack_with_init as j_pack

from jepsen_tpu_torch import interop
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.kernels import search as K

from test_torch_keyed import assert_batch_equal
from test_torch_segloop import _port_segment, _port_state, _vmapped

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

SIZES = (1, 31, 32, 33, 512, 768, 1025, 4096)
THREADS = (32, 512, 1024)


# -- the scans, a lane per CUDA thread ---------------------------------------


def _warp_scan(v):
    """Each warp's inclusive max-scan by ``__shfl_up_sync`` steps."""
    lane = np.arange(v.size) % 32
    for d in (1, 2, 4, 8, 16):
        y = v[np.maximum(np.arange(v.size) - d, 0)]
        v = np.where(lane >= d, np.maximum(v, y), v)
    return v


def _block_max_scan(v):
    """``block_max_scan``: (each thread's prefix max, the block's max)."""
    v = _warp_scan(v)
    nw = v.size // 32
    wmax = np.zeros(32, v.dtype)
    wmax[:nw] = v[31::32]
    wmax = _warp_scan(wmax)            # warp 0 over the warp maxima
    warp = np.arange(v.size) // 32
    out = np.where(warp > 0, np.maximum(v, wmax[np.maximum(warp - 1, 0)]),
                   v)
    return out, wmax[nw - 1]


def _marks(same):
    """``where(same_grp, 0, i)``."""
    return np.where(same, 0, np.arange(same.size)).astype(np.int64)


def _striped_starts(same, nt):
    """``block_group_starts`` with nt threads: stripes of nt rows, each a
    block max-scan carried on from the stripes before."""
    R, marks = same.size, _marks(same)
    gs = np.full(R, -1, np.int64)
    carry = 0
    for i0 in range(0, R, nt):
        i = i0 + np.arange(nt)
        pre, total = _block_max_scan(np.where(i < R, marks[np.minimum(
            i, R - 1)], 0))
        gs[i[i < R]] = np.maximum(pre, carry)[i < R]
        carry = max(carry, total)
    return gs


def _scan_and_carry(same):
    """``scan_local_kernel`` as ``jt_group_scan`` launches it (blocks of
    SCAN_ROWS threads, fewer rounded up to a warp below that), then the
    carry each 256-row block of ``dedup_kernel`` takes: a warp's max over
    gagg[0 .. q), q the scan block of the block's rows."""
    R, marks = same.size, _marks(same)
    nt = K.SCAN_ROWS if R >= K.SCAN_ROWS else -(-R // 32) * 32
    blocks = -(-R // nt)
    g = np.zeros(R, np.int64)
    gagg = np.zeros(blocks, np.int64)
    for q in range(blocks):
        i = q * nt + np.arange(nt)
        pre, gagg[q] = _block_max_scan(np.where(i < R, marks[np.minimum(
            i, R - 1)], 0))
        g[i[i < R]] = pre[i < R]
    out = np.zeros(R, np.int64)
    for x in range(-(-R // 256)):
        q = x * 256 // K.SCAN_ROWS
        lanes = [gagg[j:q:32].max(initial=0) for j in range(32)]
        carry = max(lanes)              # __reduce_max_sync over the warp
        rows = np.arange(x * 256, min(R, (x + 1) * 256))
        out[rows] = np.maximum(g[rows], carry)
    return out, gagg, blocks


def _same(R, seed):
    """Random same_grp flags (row 0 never continues a group), long runs
    and short ones."""
    rng = np.random.default_rng(seed)
    p = rng.choice([0.02, 0.5, 0.999])
    same = rng.random(R) > p
    same[0] = False
    return same


def _cummax(same):
    return torch.cummax(torch.from_numpy(_marks(same)), 0).values.numpy()


@pytest.mark.parametrize("nt", THREADS)
@pytest.mark.parametrize("R", SIZES)
def test_the_striped_block_scan_is_the_cummax(R, nt):
    for seed in range(3):
        same = _same(R, R * 7 + nt + seed)
        assert np.array_equal(_striped_starts(same, nt), _cummax(same)), (
            R, nt, seed)


@pytest.mark.parametrize("R", SIZES)
def test_the_block_scan_with_the_carry_k4_applies_is_the_cummax(R):
    """The kernels' two-level form resolved as ``dedup_kernel`` resolves
    it, and the plain version's form (equal block maxima) through
    :func:`group_starts`."""
    for seed in range(3):
        same = _same(R, R + seed)
        starts, gagg, blocks = _scan_and_carry(same)
        assert np.array_equal(starts, _cummax(same)), (R, seed)
        # rows whose first word numbers their group: same_grp is `same`
        rows = torch.zeros(1, R, 4 + 1 + 1, dtype=torch.int32)
        rows[0, :, 0] = torch.from_numpy(np.cumsum(~same)).int()
        g = torch.zeros(1, R, dtype=torch.int32)
        ga = torch.zeros(1, blocks, dtype=torch.int32)
        scal = torch.zeros(1, K.NSCAL, dtype=torch.int32)
        scal[0, K.ACT] = 1
        K.group_scan_plain(rows, scal, g, ga, SimpleNamespace(R=R, MW=1))
        assert np.array_equal(ga[0].numpy(), gagg), (R, seed)
        assert np.array_equal(K.group_starts(g, ga, R)[0].numpy(),
                              _cummax(same)), (R, seed)


# -- the route: the plain versions against the reference ---------------------


#: a narrow rung, the keyed path's window-deferred rung (R = 37,376 at
#: CR = 8: the sort's merge passes, K3 and its carry), and a rung just
#: past one sort tile (R = 4,736 at CR = 8, 4,224 at CR = 0)
NARROW, WIDE, PAST_TILE = (32, 32, 4), (512, 64, 512), (128, 64, 64)


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain versions on one thread: under the test run's parallel
    workers, torch's own threads on the wide rung's rows only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pack(cr, seeds):
    """Register histories (with crashed ops where cr > 0), packed by the
    reference at crash width cr: (kernel, columns)."""
    hs = [jt.simulate_register_history(n, n_procs=4, n_vals=8, seed=s,
                                       crash_p=0.05 if cr else 0.0)
          for n, s in seeds]
    packed = [j_pack(h, JCASRegister()) for h in hs]
    breq = T._bucket(max(p.n_required for p, _ in packed))
    kernel = packed[0][1]
    return kernel, [T._split_packed(p, breq, cr, kernel) for p, _ in packed]


#: (tie-break, crash width, rung, segments, levels a segment): the wide
#: rung's levels are the costly ones
ROUTE_CASES = [("lex", 0, NARROW, 3, 8), ("lex", 8, NARROW, 3, 8),
               ("hash", 0, NARROW, 3, 8), ("hash", 8, NARROW, 3, 8),
               ("lex", 0, WIDE, 2, 2), ("lex", 8, WIDE, 2, 2),
               ("hash", 8, WIDE, 2, 2)]


@pytest.mark.parametrize("tiebreak,cr,rung,segments,levels", ROUTE_CASES)
def test_the_plain_route_matches_the_reference_segment(tiebreak, cr, rung,
                                                       segments, levels):
    """Two keys: the plain route's carry against the reference's vmapped
    segment executable after each segment, lane by lane (the hash
    tie-break's too), and the levels its counter ran."""
    kernel, cols = _pack(cr, ((40, 31), (24, 32)))
    if cr:
        assert int(cols[0]["cf"].shape[0]) == cr
    C, W, E = rung
    shape = K.LevelShape(C, W, E, cols[0]["f"].shape[0], cr, B=len(cols),
                         tiebreak=tiebreak)
    assert K.group_scan_runs(shape) == (cr > 0 and rung == WIDE)
    fn = _vmapped(kernel, shape)
    stacked = interop.stack_cols(cols)
    tcols, carry, scratch = _port_state(cols, shape)
    jc = G._batch_carry0_host(C, W, cr, [c["ini"] for c in cols],
                              [int(c["nr"]) for c in cols], shape.lmax + 1)
    for s in range(segments):
        if not K.active(carry.scal, shape.lmax).any():
            break
        before = np.asarray(jc[8]).copy()
        jc = tuple(np.asarray(x) for x in fn(
            *[stacked[c] for c in T._COLS], np.int32(levels), jc))
        run = _port_segment(tcols, carry, scratch, shape, levels)
        assert_batch_equal(jc, interop.batch_carry_to_numpy(carry),
                           (tiebreak, cr, rung, s))
        assert run == int((jc[8] - before).max()), (tiebreak, cr, rung, s)
    assert int(np.asarray(jc[8]).max()) > 0


@pytest.mark.parametrize("cr,rung,per_level", [(0, NARROW, 0),
                                               (8, NARROW, 0),
                                               (0, PAST_TILE, 0),
                                               (8, PAST_TILE, 1)])
def test_group_scan_is_called_only_on_the_wide_rungs_with_crashes(
        cr, rung, per_level):
    """A level calls ``group_scan`` only where K4 does not scan in place and
    CR > 0, on the plain route as on the card; the counts of the kernels'
    CUDA launches do not move on CPU tensors."""
    _, cols = _pack(cr, ((30, 41),))
    C, W, E = rung
    shape = K.LevelShape(C, W, E, cols[0]["f"].shape[0], cr)
    assert K.dedup_one_block(shape) == (rung == NARROW)
    tcols, carry, scratch = _port_state(cols, shape)
    calls = []

    def spy(name, fn):
        def call(*args):
            calls.append(name)
            return fn(*args)
        return call
    ops = G.Ops(*(spy(name, fn) for name, fn in zip(G.Ops._fields,
                                                     G.PLAIN)))
    K.reset_launches()
    G.run_segment_host(tcols, carry, scratch, shape, tcols["nr"], 3, ops)
    assert calls.count("expand") == calls.count("dedup_truncate") == 3
    assert calls.count("group_scan") == 3 * per_level
    assert K.launches == dict.fromkeys(K.launches, 0)
    assert K.grid_launches_total == dict.fromkeys(K.launches, 0)


def test_k4_counts_its_group_starts_in_its_shared_memory():
    """R = 4,096 rows at NK = 12 (four mask and four crashed words): the
    rows at 13 words and their 16-bit starts, 221,184 bytes, and the
    block's 896 static bytes fit the 232,448 a block may use."""
    shape = K.LevelShape(4096 - 24 * (128 + 1 + 128) + 24, 128, 24, 512,
                         128)
    assert (shape.R, shape.NK) == (4096, 12)
    assert K.dedup_block_smem(shape) == 4096 * 13 * 4 + 2 * 4096 == 221184
    assert K.dedup_one_block(shape) and not K.group_scan_runs(shape)
    no_crash = K.LevelShape(4096 - 24 * 129 + 24, 128, 24, 512, 0)
    assert K.dedup_block_smem(no_crash) == 4096 * 9 * 4
    assert K.DEDUP_BLOCK_STATIC == 896


def test_a_graph_segment_counts_its_pair_ends_and_no_k5_launch():
    """A segment graph's body has no K5 node: a segment that ran 7 levels
    (4 pairs) adds two levels of each kernel the body launches a pair and
    4 pair ends, and no ``seg_active`` launch."""
    graph = K.SegmentGraph.__new__(K.SegmentGraph)
    graph.body = {"expand": 2, "sort_rows": 2, "group_scan": 0,
                  "dedup_truncate": 2}
    assert tuple(graph.body) == K.GRAPH_KERNELS
    K.reset_launches()
    graph.account(7)
    assert K.launches == {"expand": 8, "sort_rows": 8, "sort_rows_hash": 0,
                          "group_scan": 0, "dedup_truncate": 8,
                          "seg_active": 0}
    assert K.grid_launches_total == {**dict.fromkeys(K.launches, 0),
                                     "expand": 8, "sort_rows": 8,
                                     "dedup_truncate": 8}
    assert K.segments == {"captures": 0, "launches": 0, "levels": 7,
                          "pair_ends": 4}
    K.reset_launches()
