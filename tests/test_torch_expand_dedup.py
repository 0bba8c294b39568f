"""What the redesigned K1 (expand) and K4 (dedup_truncate) rest on, on the
CPU.

K1 finds a row's crash bound without searching ``ret``: the reference's
``searchsorted(ret, min over untaken cinv, right)`` equals ``min(n, min
over untaken cb)`` with ``cb = searchsorted(ret, cinv, right)``, a column
of the history, because ``ret`` is sorted and the search is monotone. Held
here against the plain version's ``_crash_bound`` for random crashed masks
on register histories (the headline's shape cut to 2,000 ops, a
crash-heavy one with more than 32 crashed ops, one with none).

K1's warp walks a row's forced run over columns it loaded in chunks of 32
positions (the window and one chunk beyond it, then one chunk at a time),
reading each position's operands by shuffles and the state-free part of
the test from one ballot a chunk. ``warp_run`` below does the same with
lists (a shuffle is a list read), and is held against the plain version's
``_fast_forward`` at the rows of real levels and on a one-client history
whose forced run is the whole history.

K4 takes its block-per-key path while the R live rows fit one sort tile,
and either path is one CUDA launch. Tolerance: none (integer state).
"""

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.kernels import parity
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.ops.encode import pack_with_init
from jepsen_tpu_torch.testing import simulate_register_history

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

HISTORIES = {
    "headline-2000": lambda: simulate_register_history(
        2000, n_procs=5, n_vals=16, seed=42, crash_p=0.002),
    "crash-heavy": lambda: simulate_register_history(
        300, n_procs=6, n_vals=8, seed=3, crash_p=0.3),
    "no-crash": lambda: simulate_register_history(500, n_procs=5, n_vals=8,
                                                  seed=4),
}


def _cols(history, cr=None):
    packed, kernel = pack_with_init(history, CASRegister())
    if cr is None:
        cr = G._crash_width(packed.n - packed.n_required)
    return packed, G._split_packed(packed, G._bucket(packed.n_required),
                                   cr, kernel)


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_the_least_untaken_cb_is_the_crash_bound(name):
    packed, cols = _cols(HISTORIES[name]())
    n, cr = cols["f"].shape[0], cols["cf"].shape[0]
    n_cr = packed.n - packed.n_required
    assert (name == "no-crash") == (cr == 0)
    assert (name == "crash-heavy") == (n_cr > 32)
    cb = cols["cb"]
    assert cb.dtype == np.int32 and cb.shape == (cr,)
    assert np.all(cb[n_cr:] == n) and np.all(cb <= n)
    rng = np.random.default_rng(7)
    shape = K.LevelShape(64, 32, 64, n, cr)
    taken = rng.random((1, 64, 32 * shape.MCX)) < rng.random((1, 64, 1))
    taken[..., cr:] = False
    taken[0, 0] = True                 # every crashed op taken
    taken[0, 1] = False                # none
    words = (taken.reshape(1, 64, -1, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1)
    cm = torch.from_numpy(words.astype(np.int64))
    tcols = {c: torch.from_numpy(cols[c][None]) for c in ("ret", "cinv")}
    want = K._crash_bound(cm, tcols, shape)[0].numpy()
    got = np.where(taken[0, :, :cr], n, cb[None, :]).min(-1, initial=n)
    assert np.array_equal(got, want)


def warp_run(cols, step, ke, kk, ss, bound, nr, W):
    """K1's forced run (csrc/search.cu forced_run) with lists for lanes:
    chunk q holds positions ke + 32 q + lane (clamped) of f, v1, v2 and
    fr; chunks 0..W/32 are loaded with the window, the next one when the
    walk enters a chunk past them. Returns (kk, ss, chunks loaded)."""
    n, MW = len(cols["f"]), (W + 31) // 32

    def chunk(base):
        idx = np.clip(np.arange(base, base + 32), 0, n - 1)
        return [cols[c][idx] for c in ("f", "v1", "v2", "fr")]

    pre = [chunk(ke + 32 * q) for q in range(MW + 1)]
    loaded = len(pre)
    q = (kk - ke) >> 5
    base, nxt = ke + 32 * q, None

    def enter():
        nonlocal nxt, loaded
        cur = pre[q] if q <= MW else nxt
        if q >= MW:
            nxt = chunk(base + 32)
            loaded += 1
        ballot = [cur[3][i] > 0 and base + i < bound and base + i < nr
                  for i in range(32)]
        return cur, ballot

    cur, sgo = enter()
    while True:
        li = kk - base
        if li == 32:
            q, base = q + 1, base + 32
            cur, sgo = enter()
            continue
        s2, ok = step(torch.tensor(ss), *(torch.tensor(int(cur[i][li]))
                                          for i in range(3)))
        if not (sgo[li] and bool(ok)):
            return kk, ss, loaded
        kk, ss = kk + 1, int(s2)


def _plain_run(cols, step, kk, ss, bound, nr):
    tcols = {c: torch.from_numpy(cols[c][None]) for c in ("f", "v1", "v2",
                                                          "fr")}
    k, s = K._fast_forward(torch.tensor([[kk]]), torch.tensor([[ss]]),
                           torch.tensor([[True]]), torch.tensor([[bound]]),
                           tcols, len(cols["f"]), torch.tensor([nr]), step)
    return int(k), int(s)


@pytest.mark.parametrize("name", ["headline-2000", "crash-heavy"])
def test_the_warp_run_is_the_fast_forward_at_real_levels(name):
    """From every live expanded row of a few real levels, from its
    offset-0 frontier advance (k + 1 + trailing ones) and from its own
    frontier, in its state."""
    _, cols = _cols(HISTORIES[name]())
    step = K.STEPS["cas-register"]
    lv = parity.Level(cols, (128, 32, 8), "cpu")
    n, cr, nr = lv.shape.n, lv.shape.CR, int(cols["nr"])
    starts = 0
    for _ in range(4):
        lv.advance(7)
        pool = lv.carry.pool
        m = K._u(pool.mask[0, :8])
        t1 = K._trailing_ones(K._shr1(m))
        cm = K._u(pool.cmask[0, :8])
        for r in range(8):
            if not bool(pool.alive[0, r]):
                continue
            ke, se = int(pool.k[0, r]), int(pool.state[0, r])
            taken = [cr and bool((int(cm[r, i >> 5]) >> (i & 31)) & 1)
                     for i in range(cr)]
            bound = min([n] + [int(cols["cb"][i]) for i in range(cr)
                               if not taken[i]])
            for kk in (ke + 1 + int(t1[r]), ke):
                got = warp_run(cols, step, ke, kk, se, bound, nr, 32)[:2]
                assert got == _plain_run(cols, step, kk, se, bound, nr)
                starts += 1
    assert starts > 20


def test_the_warp_run_crosses_a_sequential_history():
    """One client: every op is forced, and the run from op 1 in op 0's
    state walks through all the history's required ops, loading one
    chunk of 32 positions ahead of the one it enters."""
    _, cols = _cols(simulate_register_history(2000, n_procs=1, n_vals=8,
                                              seed=11))
    step = K.STEPS["cas-register"]
    nr, n = int(cols["nr"]), cols["f"].shape[0]
    s0, ok = step(torch.tensor(int(cols["ini"])),
                  *(torch.tensor(int(cols[c][0])) for c in ("f", "v1", "v2")))
    assert bool(ok)
    for W in (32, 48, 128):
        kk, ss, loaded = warp_run(cols, step, 0, 1, int(s0), n, nr, W)
        assert kk == nr > 1500
        assert (kk, ss) == _plain_run(cols, step, 1, int(s0), n, nr)
        assert loaded == nr // 32 + 2


@pytest.mark.parametrize("C,one_block", [(2048, True), (2049, False)])
def test_dedup_takes_one_block_while_the_rows_fit_a_tile(C, one_block):
    shape = K.LevelShape(C, 32, 64, 256, 0)
    assert shape.R == 4096 + (C - 2048) == K.tile_rows(shape) + C - 2048
    assert K.dedup_one_block(shape) is one_block
    assert K.grid_launches("dedup_truncate", shape) == 1
    wide = K.LevelShape(512, 128, 512, 4096, 128)
    assert not K.dedup_one_block(wide)
    assert K.dedup_one_block(K.LevelShape(128, 32, 8, 8192, 16))
