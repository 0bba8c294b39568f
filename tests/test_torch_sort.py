"""The invariant the sort kernel (K2) rests on, and its buffers, on the CPU.

K2 sorts only the R live rows of each key and leaves the RP - R pad rows
after them where the expansion (K1) wrote them. That is exact when a sort
of all RP rows puts every pad row after every live row: here
``sort_rows_plain`` over the live rows alone, the pad tail left alone,
equals ``sort_rows_plain`` over all RP rows bit for bit, at the states a
real search reaches level by level (``expand_plain`` from the plain
versions' carry), under both tie-breaks. Then the tile size, the second
rows buffer the merge passes need beyond one tile, its bytes, and the
wrapper's refusal to launch without it. Tolerance: none (integer state).
"""

import types

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.kernels import parity
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.ops.encode import pack_with_init
from jepsen_tpu_torch.testing import (crash_writes, simulate_register_history,
                                      wide_history)

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

#: two histories per shape (one keyed batch of B = 2): register histories
#: with crashed writes for the narrow rungs, window-40 histories for the
#: wide rung, and a crash-heavy pair for four crashed-mask words
HISTORIES = {
    "narrow": lambda: [simulate_register_history(200, n_procs=4, n_vals=8,
                                                 seed=s, crash_p=0.02)
                       for s in (2, 4)],
    "wide": lambda: [crash_writes(wide_history(40, 2, seed=s), 2)
                     for s in (1, 2)],
    "crashy": lambda: [simulate_register_history(260, n_procs=6, n_vals=8,
                                                 seed=s, crash_p=0.3)
                       for s in (3, 5)],
}
#: (rung, crash width, histories): the first rungs at CR 8 and 16, the
#: wide rung (R = 37,376 rows: ten tiles), and four mask and four crashed
#: words (NK = 12)
SHAPES = [((32, 32, 4), 8, "narrow"), ((32, 32, 4), 16, "narrow"),
          ((128, 32, 8), 8, "narrow"), ((128, 32, 8), 16, "narrow"),
          ((128, 32, 16), 8, "narrow"), ((128, 32, 16), 16, "narrow"),
          ((512, 64, 512), 8, "wide"), ((128, 128, 8), 128, "crashy")]
LEVELS = 3


def _level(rung, cr, histories, tiebreak):
    packs = [pack_with_init(h, CASRegister()) for h in HISTORIES[histories]()]
    breq = G._bucket(max(p.n_required for p, _ in packs))
    cols = [G._split_packed(p, breq, cr, kernel) for p, kernel in packs]
    return parity.Level(cols, rung, "cpu", tiebreak=tiebreak)


@pytest.mark.parametrize("tiebreak", K.TIEBREAKS)
@pytest.mark.parametrize("rung,cr,histories", SHAPES)
def test_sorting_the_live_rows_alone_gives_the_whole_sort(rung, cr,
                                                          histories,
                                                          tiebreak):
    lv = _level(rung, cr, histories, tiebreak)
    shape = lv.shape
    R, RP = shape.R, shape.RP
    assert (shape.B, shape.CR) == (2, cr)
    for level in range(LEVELS):
        carry, scratch = parity.copy_state(lv.carry, lv.scratch)
        K.expand_plain(lv.cols, carry.pool, carry.scal, scratch.acc,
                       scratch.rows, shape, lv.nr)
        assert bool((carry.scal[:, K.ACT] == 1).all()), level
        rows = scratch.rows
        pad = torch.zeros(shape.NK, dtype=torch.int32)
        pad[0] = K.INT32_MAX
        assert bool((rows[:, R:] == pad).all())
        whole = rows.clone()
        K.sort_rows_plain(whole, carry.scal, shape)
        live = rows.clone()
        K.sort_rows_plain(live[:, :R], carry.scal, shape)
        assert torch.equal(live, whole), (level, tiebreak)
        # the live rows reach past every valid key: invalid ones sort too
        assert bool((whole[:, :R, 0] > K.MAXK).any()) or level == 0
        assert lv.advance(1) > 0


@pytest.mark.parametrize("rung,cr,tiebreak,stride,tile,alt", [
    # NK = 6: 7 words a row under hash; 4,096 x (28 + 4) bytes fit
    ((32, 32, 4), 8, "hash", 7, 4096, False),
    # NK = 7: 7 words under lex; R = 37,376 rows span ten tiles
    ((512, 64, 512), 8, "lex", 7, 4096, True),
    # NK = 12: 13 words under either; 4,096 x (52 + 4) = 229,376 bytes
    ((128, 128, 8), 128, "hash", 13, 4096, False),
    ((16384, 128, 4096), 128, "lex", 13, 4096, True),
])
def test_the_tile_and_the_second_buffer(rung, cr, tiebreak, stride, tile,
                                        alt):
    shape = K.LevelShape(*rung, 2048, cr, B=2, tiebreak=tiebreak)
    assert K.tile_stride(shape) == stride
    assert K.tile_rows(shape) == tile
    assert tile * (4 * stride + 4) <= K.SMEM_MAX
    assert (K.sort_passes(shape) > 0) is alt is (shape.R > tile)
    scratch = G.empty_scratch(shape, "meta")
    if alt:
        assert scratch.rows_alt.shape == scratch.rows.shape
        assert scratch.rows_alt.dtype == torch.int32
    else:
        assert scratch.rows_alt is None


def test_state_bytes_count_the_second_buffer_only_beyond_one_tile():
    """By hand, at n = 2,048 (lmax = 4,368: a stats log of 4 x 4,369 x 5
    = 87,380 bytes a key)."""
    # (32, 32, 4), CR 8, one key: R = 192 rows fit one tile. Pools 32 x
    # (4 x 4 + 1) = 544 bytes each; carry 2 x 544 + 32 x 9 + 32 + 87,380
    # = 88,788; scratch 36 + 4 x 256 x 7 + 4 = 7,208
    narrow = K.LevelShape(32, 32, 4, 2048, 8, tiebreak="hash")
    assert K.sort_passes(narrow) == 0
    assert G.state_bytes(narrow) == 88788 + 7208 == 95996
    # (512, 64, 512), CR 8, three keys: R = 37,376 rows, ten tiles, four
    # merge passes. Pools 512 x (4 x 5 + 1) = 10,752; carry 21,504 + 4,608
    # + 32 + 87,380 = 113,524; scratch 36 + 4 x 65,536 x 8 + 4 x 37 (the
    # group scan's maxima, one per 1,024 live rows) = 2,097,336, and the
    # second buffer 4 x 65,536 x 7 = 1,835,008
    wide = K.LevelShape(512, 64, 512, 2048, 8, B=3)
    assert (wide.R, K.sort_passes(wide)) == (37376, 4)
    assert G.state_bytes(wide) == 3 * (113524 + 2097336 + 1835008)
    assert G.state_bytes(wide) == 12137604


def test_search_level_hands_the_sort_its_second_buffer():
    """``search_level`` passes the scratch's second buffer to the sort
    (None on a narrow rung), and the plain version ignores it."""
    seen = []

    def spy(rows, scal, shape, rows_alt):
        seen.append(rows_alt)
        G.PLAIN.sort_rows(rows, scal, shape, rows_alt)

    ops = G.PLAIN._replace(sort_rows=spy)
    for rung, histories in (((32, 32, 4), "narrow"),
                            ((512, 64, 512), "wide")):
        lv = _level(rung, 8, histories, "lex")
        G.run_segment(lv.cols, lv.carry, lv.scratch, lv.shape, lv.nr, 1,
                      ops)
        assert seen.pop() is lv.scratch.rows_alt
    assert lv.scratch.rows_alt is not None


def test_a_cuda_sort_beyond_one_tile_without_its_buffer_raises(
        monkeypatch):
    """On CUDA tensors the wrapper refuses a shape with merge passes when
    the second buffer is missing, before any launch, and never runs the
    plain version in its place."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    called = []
    monkeypatch.setattr(K, "sort_rows_plain", lambda *a: called.append(a))
    shape = K.LevelShape(512, 64, 512, 2048, 8)
    before = dict(K.launches)
    with FakeTensorMode():
        rows = torch.zeros(1, shape.RP, shape.NK, dtype=torch.int32,
                           device="cuda")
        scal = torch.zeros(1, K.NSCAL, dtype=torch.int32, device="cuda")
        with pytest.raises(ValueError, match="rows_alt"):
            K.sort_rows(rows, scal, shape)
        with pytest.raises(ValueError, match="rows_alt"):
            K.sort_rows(rows, scal, shape,
                        torch.zeros(1, shape.RP, shape.NK - 1,
                                    dtype=torch.int32, device="cuda"))
    assert called == [] and K.launches == before


def test_a_sort_call_counts_the_launches_its_entry_point_made(monkeypatch):
    """On CUDA tensors the wrapper hands the entry point the tile T and
    the merge passes of the shape, and adds to ``grid_launches_total``
    the launches the entry point reports having made, not a prediction."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    seen = []

    def jt_sort_rows(*args):
        *rest, launched = args
        seen.append(rest)
        launched._obj.value += 3
        return 0
    monkeypatch.setattr(K, "_lib", lambda: types.SimpleNamespace(
        jt_sort_rows=jt_sort_rows))
    monkeypatch.setattr(K, "_ptr", lambda t: None)
    monkeypatch.setattr(K, "_stream", lambda t: None)
    shape = K.LevelShape(512, 64, 512, 2048, 8)
    calls = K.launches["sort_rows"]
    before = K.grid_launches_total["sort_rows"]
    with FakeTensorMode():
        rows, alt = (torch.zeros(1, shape.RP, shape.NK, dtype=torch.int32,
                                 device="cuda") for _ in range(2))
        scal = torch.zeros(1, K.NSCAL, dtype=torch.int32, device="cuda")
        K.sort_rows(rows, scal, shape, alt)
    assert [r[3:11] for r in seen] == [[1, 37376, 65536, shape.NK,
                                        shape.MW, 0, 4096, 4]]
    assert K.launches["sort_rows"] == calls + 1
    assert K.grid_launches_total["sort_rows"] == before + 3


def test_the_cpu_sort_ignores_the_second_buffer():
    shape = K.LevelShape(512, 64, 512, 2048, 8)
    rng = np.random.default_rng(7)
    rows = torch.from_numpy(rng.integers(0, 1000, (1, shape.RP, shape.NK))
                            .astype(np.int32))
    scal = torch.zeros(1, K.NSCAL, dtype=torch.int32)
    scal[:, K.ACT] = 1
    want = rows.clone()
    K.sort_rows_plain(want, scal, shape)
    alt = torch.full_like(rows, -5)
    K.sort_rows(rows, scal, shape, alt)
    assert torch.equal(rows, want)
    assert bool((alt == -5).all())
