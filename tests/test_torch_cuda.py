"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and nvcc; without a device they skip.
On a machine with an H100: ``python -m pytest tests/test_torch_cuda.py``.
The file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed. All comparisons are exact (integer state).
"""

import ctypes
import math
import random

import numpy as np
import pytest
import torch

from jepsen_tpu_torch import interop, resilience
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.checker.gpu import check_history_gpu
from jepsen_tpu_torch.kernels import parity
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.ops.encode import pack_with_init
from jepsen_tpu_torch.testing import (corrupt_one_read, crash_writes,
                                      simulate_register_history,
                                      wide_history)

pytestmark = pytest.mark.cuda

FIXTURES = {
    "entry": lambda: simulate_register_history(48, n_procs=4, seed=3,
                                               crash_p=0.05),
    "crashed": lambda: simulate_register_history(200, n_procs=4, n_vals=8,
                                                 seed=2, crash_p=0.05),
    "mc2": lambda: simulate_register_history(260, n_procs=6, n_vals=8,
                                             seed=3, crash_p=0.3),
    "wide48": lambda: wide_history(48, 2, seed=3),
    "wide100": lambda: crash_writes(wide_history(100, 2, seed=5), 6),
    "wide40a": lambda: crash_writes(wide_history(40, 2, seed=1), 2),
    "wide40b": lambda: crash_writes(wide_history(40, 2, seed=2), 2),
}
#: (fixture, rung): narrow rungs, BFS, and rungs whose rows span several
#: sort and scan blocks
CASES = [("entry", (32, 32, 4)), ("entry", (256, 16, None)),
         ("crashed", (128, 32, 8)), ("crashed", (32, 32, None)),
         ("mc2", (128, 32, 8)), ("mc2", (1024, 32, 64)),
         ("wide48", (128, 64, 8)), ("wide100", (512, 128, 512))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cols(history):
    packed, kernel = pack_with_init(history, CASRegister())
    cr = G._crash_width(packed.n - packed.n_required)
    return packed, kernel, G._split_packed(
        packed, G._bucket(packed.n_required), cr, kernel)


@pytest.mark.parametrize("name,rung", CASES)
def test_each_kernel_matches_its_plain_version(cuda, name, rung):
    _, _, cols = _cols(FIXTURES[name]())
    lv = parity.Level(cols, rung, cuda)
    walked = 0
    for _ in range(6):
        if lv.advance(3) == 0:
            break
        for stage, _, _, _, err in lv.walk():
            assert err == 0, (name, rung, stage)
        walked += 1
    assert walked > 0


@pytest.mark.parametrize("name,rung", CASES[::2])
def test_segments_match_the_plain_versions(cuda, name, rung):
    _, _, cols = _cols(FIXTURES[name]())
    carries = []
    for ops in (G.KERNELS, G.PLAIN):
        lv = parity.Level(cols, rung, cuda)
        for _ in range(2):
            G.run_segment(lv.cols, lv.carry, lv.scratch, lv.shape, lv.nr,
                          40, ops)
            carries.append(interop.carry_to_numpy(lv.carry))
    for a, b in zip(carries[:2], carries[2:]):
        for x, y in zip(a, b, strict=True):
            assert np.array_equal(x, y)


def _corrupted():
    h = simulate_register_history(100, n_procs=5, n_vals=8, seed=15)
    return corrupt_one_read(h, random.Random(15))


@pytest.mark.parametrize("history", [
    lambda: simulate_register_history(1000, n_procs=5, n_vals=8, seed=1),
    _corrupted, lambda: wide_history(100, 2, seed=5)])
def test_check_matches_the_plain_versions(cuda, history):
    h = history()
    ours = check_history_gpu(h, CASRegister(), device=cuda)
    packed, kernel, _ = _cols(h)
    ref = resilience.supervised_check_packed(packed, kernel, device=cuda,
                                             ops=G.PLAIN)
    keys = ("valid", "levels", "max-linearized-prefix", "rung", "work",
            "best-k")
    assert {k: ours.get(k) for k in keys} == {k: ref.get(k) for k in keys}
    assert ours["backend"] == "gpu"


def test_each_wrapper_counts_its_launches(cuda):
    _, _, cols = _cols(FIXTURES["crashed"]())
    lv = parity.Level(cols, (128, 32, 8), cuda)
    K.reset_launches()
    lv.advance(5)
    # a narrow rung: K4 scans the group starts itself
    assert K.launches == {**{name: 5 for name in K.launches},
                          "sort_rows_hash": 0, "group_scan": 0,
                          "seg_active": 0}
    assert K.grid_launches_total == K.launches


def test_grid_launches_count_the_sorts_passes(cuda):
    cols = _batch_cols([FIXTURES[n]() for n in ("wide40a", "wide40b")], 8)
    lv = parity.Level(cols, (512, 64, 512), cuda)
    K.reset_launches()
    lv.advance(2)
    tiles = math.ceil(lv.shape.R / K.tile_rows(lv.shape))
    assert (lv.shape.R, tiles) == (37376, 10)
    assert K.launches["sort_rows"] == 2
    assert K.grid_launches_total["sort_rows"] == 2 * (
        1 + math.ceil(math.log2(tiles)))
    # one scan launch a level, its blocks' carry applied in K4
    assert K.grid_launches_total["group_scan"] == 2 * 1


def _batch_cols(histories, cr):
    """The histories' columns padded to one required width and to
    crashed width ``cr``: one keyed cohort."""
    packed = [pack_with_init(h, CASRegister()) for h in histories]
    breq = G._bucket(max(p.n_required for p, _ in packed))
    return [G._split_packed(p, breq, cr, kernel) for p, kernel in packed]


#: (fixtures, crashed width, rung): the keyed first rungs, a rung whose
#: rows span several sort and scan blocks, the keyed window-deferred rung
#: (R = 37,376 in 10 sort tiles: 5 sort launches a call), and four mask and
#: four crashed words (NK = 12: the sort's widest tile row)
BATCH_CASES = [
    (("entry", "crashed", "mc2"), 64, (32, 32, 4)),
    (("entry", "crashed", "mc2"), 64, (128, 32, 16)),
    (("crashed", "mc2"), 64, (1024, 32, 64)),
    (("wide40a", "wide40b"), 8, (512, 64, 512)),
    (("wide100", "wide48"), 128, (512, 128, 512)),
]


@pytest.mark.parametrize("tiebreak", K.TIEBREAKS)
@pytest.mark.parametrize("names,cr,rung", BATCH_CASES)
def test_each_batched_kernel_matches_its_plain_version(cuda, tiebreak,
                                                       names, cr, rung):
    cols = _batch_cols([FIXTURES[n]() for n in names], cr)
    lv = parity.Level(cols, rung, cuda, tiebreak=tiebreak)
    walked = 0
    for _ in range(4):
        if lv.advance(3) == 0:
            break
        for stage, _, _, _, err in lv.walk():
            assert err == 0, (names, rung, tiebreak, stage)
        walked += 1
    assert walked > 0


@pytest.mark.parametrize("tiebreak", K.TIEBREAKS)
def test_batched_segments_match_the_plain_versions(cuda, tiebreak):
    cols = _batch_cols([FIXTURES[n]() for n in ("entry", "crashed", "mc2")],
                       64)
    carries = []
    for ops in (G.KERNELS, G.PLAIN):
        lv = parity.Level(cols, (128, 32, 8), cuda, tiebreak=tiebreak)
        G.run_segment(lv.cols, lv.carry, lv.scratch, lv.shape, lv.nr, 60,
                      ops)
        carries.append(interop.batch_carry_to_numpy(lv.carry))
    for x, y in zip(*carries, strict=True):
        assert np.array_equal(x, y)


def test_keyed_check_matches_the_plain_versions(cuda):
    from jepsen_tpu_torch.checker.gpu import check_keyed_gpu
    keyed = {"stag": simulate_register_history(300, n_procs=5, n_vals=8,
                                               seed=7000, overlap_p=0.05),
             "dense": simulate_register_history(300, n_procs=5, n_vals=8,
                                                seed=7001, crash_p=0.001),
             "crashy": simulate_register_history(300, n_procs=5, n_vals=8,
                                                 seed=7002, crash_p=0.05),
             "bad": _corrupted(),
             # deferred by their window to the (512, 64, 512) lex rung
             "wide_a": FIXTURES["wide40a"](), "wide_b": FIXTURES["wide40b"]()}
    K.reset_launches()
    ours = check_keyed_gpu(keyed, CASRegister(), device=cuda)
    # the first rungs sort under the hash tie-break; the lex sort runs
    # only for keys that escalate
    assert all(K.launches[k] > 0 for k in (
        "expand", "sort_rows_hash", "group_scan", "dedup_truncate")), \
        K.launches
    ref = check_keyed_gpu(keyed, CASRegister(), device=cuda, ops=G.PLAIN)
    keys = ("valid", "levels", "max-linearized-prefix", "rung", "tiebreak",
            "work", "crash-width")
    for k in keyed:
        assert ({x: ours["results"][k].get(x) for x in keys}
                == {x: ref["results"][k].get(x) for x in keys}), k
    assert ours["results"]["bad"]["valid"] is False
    assert ours["results"]["stag"]["tiebreak"] == "hash"
    assert ours["results"]["wide_a"]["rung"] == (512, 64, 512)
    assert K.launches["sort_rows"] > 0


# ---------------------------------------------------------------------------
# The other model families: K1's template instantiation per model
# ---------------------------------------------------------------------------

def _model_fixtures():
    from jepsen_tpu_torch import models as M
    from jepsen_tpu_torch import testing as pt
    return {
        "mutex": (M.Mutex(), [
            lambda: pt.simulate_mutex_history(300, 5, seed=11,
                                              crash_p=0.03),
            lambda: pt.simulate_mutex_history(200, 4, seed=12),
            lambda: pt.simulate_mutex_history(250, 5, seed=13,
                                              crash_p=0.05)]),
        "noop": (M.NoOp(), [
            lambda: simulate_register_history(300, 5, seed=14),
            lambda: simulate_register_history(200, 5, seed=15,
                                              crash_p=0.05),
            lambda: wide_history(48, 2, seed=3)]),
        "set": (M.SetModel(), [
            lambda: pt.simulate_set_history(200, 5, seed=16, crash_p=0.05),
            lambda: pt.simulate_set_history(150, 4, seed=17),
            lambda: pt.random_set_history(random.Random(3), 4, 40,
                                          corrupt_p=0.0)]),
        "unordered-queue": (M.UnorderedQueue(), [
            lambda: pt.simulate_queue_history(300, 5, seed=18, backlog=8,
                                              fifo=False),
            lambda: pt.unique_queue_history(200, seed=1),
            lambda: pt.random_queue_history(random.Random(5), 4, 40,
                                            corrupt_p=0.0)]),
        "fifo-queue": (M.FIFOQueue(), [
            lambda: pt.simulate_queue_history(300, 3, seed=19, backlog=2,
                                              fifo=True),
            lambda: pt.simulate_queue_history(200, 5, seed=20, backlog=2,
                                              fifo=True),
            lambda: pt.random_fifo_history(random.Random(12), 3, 16,
                                           corrupt_p=0.0)]),
    }


def _model_cols(model, histories):
    """The histories' columns under ``model`` at one required width and
    crash width; the window the widest needs."""
    packed = [pack_with_init(h(), model) for h in histories]
    breq = G._bucket(max(p.n_required for p, _ in packed))
    cr = max(G._crash_width(p.n - p.n_required) for p, _ in packed)
    W = max(32, max(G._window_bucket(G._window_needed(p))
                    for p, _ in packed))
    return [G._split_packed(p, breq, cr, k) for p, k in packed], W


MODEL_NAMES = ("mutex", "noop", "set", "unordered-queue", "fifo-queue")


@pytest.mark.parametrize("tiebreak", K.TIEBREAKS)
@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("name", MODEL_NAMES)
def test_each_model_kernel_matches_its_plain_version(cuda, name, batch,
                                                     tiebreak):
    """K1 stepping each model, and K2-K4 after it, against their plain
    versions bit for bit: one key (B = 1) and a batch of three."""
    model, makers = _model_fixtures()[name]
    cols, W = _model_cols(model, makers)
    if not batch:
        cols = cols[:1]
    lv = parity.Level(cols, (64, W, 8), cuda, tiebreak=tiebreak,
                      model=name)
    walked = 0
    for _ in range(5):
        if lv.advance(4) == 0:
            break
        for stage, _, _, _, err in lv.walk():
            assert err == 0, (name, batch, tiebreak, stage)
        walked += 1
    assert walked > 0


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_each_model_check_matches_the_plain_versions(cuda, name):
    from jepsen_tpu_torch.checker.wgl import linearizable
    model, makers = _model_fixtures()[name]
    h = makers[0]()
    ours = linearizable(model, device=cuda).check({}, h)
    packed, kernel = pack_with_init(h, model)
    ref = resilience.supervised_check_packed(packed, kernel, device=cuda,
                                             ops=G.PLAIN)
    keys = ("valid", "levels", "max-linearized-prefix", "rung", "work",
            "best-k")
    assert {k: ours.get(k) for k in keys} == {k: ref.get(k) for k in keys}
    assert ours["valid"] is True and ours["backend"] == "gpu"
    assert "fallback-from" not in ours


def test_the_register_kernel_is_the_default_instantiation(cuda):
    """The register's K1 is model code 0, the shape's default: a level
    of the crashed fixture launched with the default shape and with the
    model named equals its plain version either way."""
    _, _, cols = _cols(FIXTURES["crashed"]())
    outs = []
    for kw in ({}, {"model": "cas-register"}):
        lv = parity.Level(cols, (128, 32, 8), cuda, **kw)
        lv.advance(6)
        for stage, _, _, _, err in lv.walk():
            assert err == 0, (kw, stage)
        outs.append(interop.carry_to_numpy(lv.carry))
    for x, y in zip(*outs, strict=True):
        assert np.array_equal(x, y)


# ---------------------------------------------------------------------------
# The serve daemon's gangs
# ---------------------------------------------------------------------------

GANG_FIELDS = ("valid", "levels", "max-linearized-prefix", "final-states",
               "frontier-op", "rung", "work", "crash-width")


def _gang():
    """Six same-bucket register histories, one of them refuted."""
    hs = [simulate_register_history(300, n_procs=5, n_vals=16, seed=s)
          for s in range(9100, 9105)]
    hs.append(corrupt_one_read(hs[0], random.Random(15)))
    pks = [pack_with_init(h, CASRegister()) for h in hs]
    return [p for p, _ in pks], pks[0][1]


def test_the_gang_matches_the_plain_versions_and_serial(cuda):
    pks, kernel = _gang()
    ours = G.check_packed_gang_gpu(pks, kernel, device=cuda)
    plain = G.check_packed_gang_gpu(pks, kernel, device=cuda, ops=G.PLAIN)
    for p, a, b in zip(pks, ours, plain):
        pick = {k: a.get(k) for k in GANG_FIELDS}
        assert pick == {k: b.get(k) for k in GANG_FIELDS}
        serial = G.check_packed_gpu(p, kernel, device=cuda)
        assert pick == {k: serial.get(k) for k in GANG_FIELDS}
    assert [r["valid"] for r in ours].count(True) >= 5


def test_a_deadline_cancels_a_lane_on_the_card(cuda):
    import time
    pks, kernel = _gang()
    out = G.check_packed_gang_gpu(pks[:2], kernel, device=cuda,
                                  segment_iters=1,
                                  deadlines=[time.monotonic() - 1, None])
    # the one-level segment runs as a level pair
    assert out[0]["error"] == ":info/timeout" and out[0]["levels"] == 2
    assert out[0]["gang-cancelled"] is True
    serial = G.check_packed_gpu(pks[1], kernel, device=cuda)
    assert {k: out[1].get(k) for k in GANG_FIELDS} == {
        k: serial.get(k) for k in GANG_FIELDS}


def test_the_daemon_serves_gangs_on_the_card(cuda, tmp_path):
    import time
    from jepsen_tpu_torch import serve
    from jepsen_tpu_torch.checker import check_safe
    from jepsen_tpu_torch.checker.wgl import linearizable
    hs = [simulate_register_history(300, n_procs=5, n_vals=16, seed=s)
          for s in range(9100, 9104)]
    d1 = serve.CheckDaemon(serve.ServeConfig(root=str(tmp_path)))
    ids = {}
    for i, h in enumerate(hs):
        code, body, _ = d1.submit({"tenant": f"t{i % 2}",
                                   "history": [o.to_dict() for o in h]})
        assert code == 202
        ids[body["id"]] = h
    d1.journal.close()
    d = serve.CheckDaemon(serve.ServeConfig(root=str(tmp_path),
                                            batch_wait_ms=200.0)).start()
    try:
        for rid, h in ids.items():
            t0 = time.monotonic()
            while d.status(rid)["state"] != "done":
                assert time.monotonic() - t0 < 120
                time.sleep(0.02)
            r = d.status(rid)["result"]
            want = check_safe(linearizable(CASRegister(), device=cuda),
                              {}, h)
            assert (r["valid"], r["levels"]) == (want["valid"],
                                                 want["levels"])
            assert r["serve"]["gang"]["size"] == len(hs)
    finally:
        d.stop()


# ---------------------------------------------------------------------------
# K2 on adversarial rows: tile edges, odd merge passes, ties, hash equality
# ---------------------------------------------------------------------------

MAXK = 1 << 30
PAD_KEY = 2**31 - 1


def _sort_shape(R, B, tiebreak, wide=False):
    """A level shape with exactly R rows: one expanded row, so R = C + W +
    CR. ``wide``: four mask and four crashed words (NK = 12)."""
    W, CR = (128, 128) if wide else (32, 8)
    return K.LevelShape(R - W - CR, W, 1, 2048, CR, B=B, tiebreak=tiebreak)


def _colliding_rows(MW, rng):
    """Pairs of rows with distinct (k, mask, state) and equal hash h: a
    birthday search over 2^18 random rows (about 8 pairs expected)."""
    n = 1 << 18
    rows = torch.zeros(n, 3 + MW, dtype=torch.int32)
    rows[:, 1] = torch.from_numpy(rng.integers(0, 1 << 20, n))
    rows[:, 2:] = torch.from_numpy(
        rng.integers(-2**31, 2**31, (n, 1 + MW)).astype(np.int32))
    h = K.row_hash_plain(rows, MW).numpy()
    order = np.argsort(h, kind="stable")
    same = np.nonzero(h[order][1:] == h[order][:-1])[0]
    pairs = [(order[i], order[i + 1]) for i in same
             if not torch.equal(rows[order[i]], rows[order[i + 1]])]
    assert pairs, "no hash collision found"
    return rows[[i for p in pairs for i in p], 1:].numpy().astype(np.int64)


def _mixed_rows(R, NK, MW, rng, colliding):
    """R live rows, shuffled: a third share few (key1, k) values and differ
    only in later words (a fifth of them invalid), a third are copies of
    eight rows, and the rest share one key1 and their hash: one (k, mask,
    state) under other crashed masks, and the colliding pairs."""
    out = np.zeros((R, NK), np.int64)
    q = R // 3
    k = rng.integers(0, 3, q)
    out[:q, 0] = np.where(rng.random(q) < 0.8,
                          MAXK - k - rng.integers(0, 2, q), MAXK + 1 + k)
    out[:q, 1] = k
    out[:q, 2:] = rng.choice(np.array([0, 1, 2**31, 2**32 - 1]),
                             (q, NK - 2))
    base = rng.integers(0, 2**32, (8, NK))
    base[:, 0] = MAXK - rng.integers(0, 100, 8)
    base[:, 1] = rng.integers(0, 100, 8)
    out[q:2 * q] = base[rng.integers(0, 8, q)]
    rest = out[2 * q:]
    rest[:, 0] = MAXK - 7
    kms = np.concatenate([np.tile(rng.integers(0, 2**31, (1, 2 + MW)),
                                  (4, 1)), colliding])
    rest[:, 1:3 + MW] = kms[rng.integers(0, len(kms), len(rest))]
    rest[:, 3 + MW:] = rng.integers(0, 2, (len(rest), NK - 3 - MW))
    return out[rng.permutation(R)]


def _adversarial_rows(shape, seed, all_pad=(), inactive=()):
    """Rows [B, RP, NK] and scal [B, NSCAL] for K2 from numpy with
    ``seed``: each key's R live rows from :func:`_mixed_rows`, then the pad
    tail as K1 writes it. The keys in ``all_pad`` hold pad rows only; the
    keys in ``inactive`` have their active flag clear."""
    rng = np.random.default_rng(seed)
    colliding = _colliding_rows(shape.MW, rng)
    rows = np.zeros((shape.B, shape.RP, shape.NK), np.int64)
    rows[:, :, 0] = PAD_KEY
    for b in range(shape.B):
        if b not in all_pad:
            rows[b, :shape.R] = _mixed_rows(shape.R, shape.NK, shape.MW, rng,
                                            colliding)
    rows = np.where(rows >= 2**31, rows - 2**32, rows).astype(np.int32)
    scal = np.zeros((shape.B, K.NSCAL), np.int32)
    scal[:, K.ACT] = 1
    scal[list(inactive), K.ACT] = 0
    return rows, scal


#: (R, B, NK = 12): R = 512 at B = 1, 3 and 256; one tile's T - 1, T and
#: T + 1 rows (T = 4,096); 3 and 5 tiles (2 and 3 merge passes, each with
#: a run that has no partner); the dwide rung's 37,376; NK = 12 above 2T
SORT_CASES = [(512, 1, False), (512, 3, False), (512, 256, False),
              (4095, 3, False), (4096, 3, False), (4097, 3, False),
              (3 * 4096 - 5, 3, False), (5 * 4096 - 5, 3, False),
              (37376, 3, False), (2 * 4096 + 500, 3, True)]


def _check_sort(shape, rows_np, scal_np, inactive, cuda):
    rows = torch.from_numpy(rows_np).to(cuda)
    scal = torch.from_numpy(scal_np).to(cuda)
    want = rows.clone()
    K.sort_rows_plain(want, scal, shape)
    got = rows.clone()
    alt = torch.full_like(rows, -1) if K.sort_passes(shape) else None
    name = "sort_rows" if shape.tiebreak == "lex" else "sort_rows_hash"
    K.reset_launches()
    K.sort_rows(got, scal, shape, alt)
    torch.cuda.synchronize()
    assert parity.max_abs_err([got], [want]) == 0
    for b in inactive:
        assert torch.equal(got[b], rows[b])
    # the launches the C side counted as it made them
    tiles = math.ceil(shape.R / K.tile_rows(shape))
    assert K.grid_launches_total[name] == 1 + (
        math.ceil(math.log2(tiles)) if tiles > 1 else 0)


@pytest.mark.parametrize("tiebreak", K.TIEBREAKS)
@pytest.mark.parametrize("R,B,wide", SORT_CASES)
def test_the_sort_matches_its_plain_version_on_adversarial_rows(
        cuda, tiebreak, R, B, wide):
    shape = _sort_shape(R, B, tiebreak, wide)
    assert shape.R == R and K.tile_rows(shape) == 4096
    all_pad, inactive = {1: ((), ()), 3: ((1,), (2,)),
                         256: ((7,), (9, 200))}[B]
    rows, scal = _adversarial_rows(shape, R + B, all_pad, inactive)
    _check_sort(shape, rows, scal, inactive, cuda)


@pytest.mark.parametrize("tiebreak", K.TIEBREAKS)
def test_the_sort_matches_its_plain_version_at_the_top_wide_rung(
        cuda, tiebreak):
    """(16384, 128, 4096) at CR = 8: R = 573,440 rows, 140 tiles, 8 merge
    passes."""
    shape = K.LevelShape(16384, 128, 4096, 2048, 8, tiebreak=tiebreak)
    assert shape.R == 573440 and K.sort_passes(shape) == 8
    rows, scal = _adversarial_rows(shape, 573440)
    _check_sort(shape, rows, scal, (), cuda)


def test_the_sort_refuses_a_tile_plan_that_cannot_sort(cuda):
    """The host picks T and the merge passes; the kernel refuses runs that
    do not cover R, a tile whose shared memory the device does not grant
    and a T beyond its 16-bit slots, and launches nothing then."""
    from jepsen_tpu_torch.kernels import build
    shape = _sort_shape(37376, 1, "lex")
    rows, scal = (torch.from_numpy(a).to(cuda)
                  for a in _adversarial_rows(shape, 1))
    alt = torch.empty_like(rows)
    T, passes = K.tile_rows(shape), K.sort_passes(shape)
    assert (T, passes) == (4096, 4)
    for t, p in ((T, passes - 1), (4 * T, passes - 2), (2 * 65536, 0)):
        launched = ctypes.c_int(0)
        rc = build.load().jt_sort_rows(
            K._ptr(rows), K._ptr(alt), K._ptr(scal), 1, shape.R, shape.RP,
            shape.NK, shape.MW, 0, t, p, K._stream(rows),
            ctypes.byref(launched))
        assert rc != 0 and launched.value == 0, (t, p)
    got = rows.clone()
    K.sort_rows(got, scal, shape, alt)
    want = rows.clone()
    K.sort_rows_plain(want, scal, shape)
    assert parity.max_abs_err([got], [want]) == 0


# ---------------------------------------------------------------------------
# The segment loop (B9): K5 and the segment graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B", [1, 3, 256, 1000])
def test_seg_active_matches_its_plain_version(cuda, B):
    """K5 against its plain version on random scalars and segment words:
    done, live rows and levels around the budget, the pair's second
    level run by some key or by none, counts below, at and past the
    bound. ``scal`` is left as it was."""
    rng = np.random.default_rng(B)
    lmax = 100
    for trial in range(24):
        scal = np.zeros((B, K.NSCAL), np.int32)
        scal[:, K.DONE] = rng.random(B) < (0.5 if trial % 3 else 1.0)
        scal[:, K.NALIVE] = rng.integers(0, 3, B)
        scal[:, K.LEVEL] = rng.integers(lmax - 3, lmax + 3, B)
        scal[:, K.ACT] = rng.random(B) < (0.3 if trial % 4 else 0.0)
        seg = np.array([rng.integers(0, 10), rng.integers(0, 12), 7, 0],
                       np.int32)
        got_scal = torch.from_numpy(scal).to(cuda)
        got = torch.from_numpy(seg).to(cuda)
        want = torch.from_numpy(seg.copy())
        K.seg_active(got_scal, lmax, got)
        K.seg_active_plain(torch.from_numpy(scal), lmax, want)
        assert torch.equal(got.cpu(), want), (trial, seg)
        assert np.array_equal(got_scal.cpu().numpy(), scal)


def _gang_cols():
    pks, kernel = _gang()
    breq = max(G._bucket(p.n_required) for p in pks)
    cr = max(G._crash_width(p.n - p.n_required) or 0 for p in pks)
    return [G._split_packed(p, breq, cr, kernel) for p in pks]


#: the smoke's states, at a small size: single, keyed staggered (hash)
#: and dense (both tie-breaks), the deferred keys' wide rung, a gang with
#: a lane cancelled after the first segment, the sort's odd merge pass,
#: four mask words, a sequential history (one forced run through it), and
#: each model's first rung
ROUTE_STATES = ("single", "stag", "dense lex", "dense hash", "dwide",
                "gang", "odd", "wide", "seq") + MODEL_NAMES


def _route_state(name):
    """(columns, rung, tie-break, model, lane cancelled after the first
    segment) of state ``name``."""
    if name in MODEL_NAMES:
        model, makers = _model_fixtures()[name]
        cols, W = _model_cols(model, makers[:1])
        return cols, (64, W, 8), "lex", name, None
    batch = _batch_cols([FIXTURES[n]() for n in ("entry", "crashed",
                                                 "mc2")], 64)
    reg = "cas-register"
    return {
        "single": lambda: ([_cols(FIXTURES["crashed"]())[2]], (128, 32, 8),
                           "lex", reg, None),
        "stag": lambda: (batch, (32, 32, 4), "hash", reg, None),
        "dense lex": lambda: (batch, (128, 32, 16), "lex", reg, None),
        "dense hash": lambda: (batch, (128, 32, 16), "hash", reg, None),
        "dwide": lambda: (_batch_cols([FIXTURES["wide40a"](),
                                       FIXTURES["wide40b"]()], 8),
                          (512, 64, 512), "lex", reg, None),
        "gang": lambda: (_gang_cols(), (128, 32, 8), "lex", reg, 1),
        "odd": lambda: (batch[1:], (1024, 32, 64), "lex", reg, None),
        "wide": lambda: ([_cols(FIXTURES["wide100"]())[2]], (512, 128, 512),
                         "lex", reg, None),
        "seq": lambda: ([_cols(_sequential())[2]], (32, 32, 4), "lex", reg,
                        None),
    }[name]()


#: segment lengths asked for: odd ones run as the next even length
ROUTE_SEGMENTS = (7, 2, 64, 1, 2000)


@pytest.mark.parametrize("name", ROUTE_STATES)
def test_the_graph_loop_matches_the_host_loop(cuda, name):
    """At every segment end the graph loop's carry equals, bit for bit,
    the host loop's over the kernels (the same levels, each launched from
    Python) and the plain route's (the host pair loop over the plain
    versions), and its levels run equal the plain route's."""
    cols, rung, tb, model, cancel = _route_state(name)
    lvs = {r: parity.Level(cols, rung, cuda, tiebreak=tb, model=model)
           for r in ("graph", "host", "plain")}
    for i, n in enumerate(ROUTE_SEGMENTS):
        if cancel is not None and i == 1:
            for lv in lvs.values():
                G.cancel_lanes(lv.carry, [cancel])
        lv = lvs["graph"]
        words, graph = G.run_segment(lv.cols, lv.carry, lv.scratch, lv.shape,
                                     lv.nr, n)
        assert graph is not None
        run = G.end_segment(lv.carry, lv.shape, words, graph)[0]
        lv = lvs["host"]
        G.run_segment_host(lv.cols, lv.carry, lv.scratch, lv.shape, lv.nr,
                           n + n % 2)
        lv = lvs["plain"]
        words, none = G.run_segment(lv.cols, lv.carry, lv.scratch, lv.shape,
                                    lv.nr, n, G.PLAIN)
        assert none is None and int(words[K.SEG_RUN]) == run, (name, i)
        carries = [interop.batch_carry_to_numpy(v.carry)
                   for v in lvs.values()]
        for other in carries[1:]:
            for x, y in zip(carries[0], other, strict=True):
                assert np.array_equal(x, y), (name, i)
        assert run <= n + n % 2
    assert int(lvs["graph"].carry.scal[:, K.LEVEL].max()) > 0


def test_a_segment_is_one_graph_launch(cuda):
    """The batch loop on the card: one capture of K1, K2 and K4 from
    Python (a narrow rung: K4 scans the group starts, and the pair's
    second K4 ends the pair), one graph launch a segment, and the launches
    counted from the levels the device ran times the body's captured
    launches (K5's step: one a pair in the second K4, counted as a pair
    end and not as a ``seg_active`` launch)."""
    from jepsen_tpu_torch.checker.engine import default_engine
    _, _, cols = _cols(FIXTURES["mc2"]())
    lv = parity.Level([cols], (128, 32, 8), cuda)
    K.reset_launches()
    segs = G.run_batch(lv.cols, lv.carry, lv.scratch, lv.shape, 64,
                       first=8)
    levels = int(lv.carry.scal[0, K.LEVEL])
    assert len(segs) > 2 and sum(segs) == levels
    pairs = sum((r + 1) // 2 for r in segs)
    graph = default_engine().segment_graph(lv.cols, lv.nr, lv.carry,
                                           lv.scratch, lv.shape)
    assert graph.body == {"expand": 2, "sort_rows": 2, "group_scan": 0,
                          "dedup_truncate": 2}
    assert K.host_calls == {"expand": 1, "sort_rows": 1,
                            "sort_rows_hash": 0, "group_scan": 0,
                            "dedup_truncate": 1, "seg_active": 0}
    assert K.launches == {"expand": 2 * pairs, "sort_rows": 2 * pairs,
                          "sort_rows_hash": 0, "group_scan": 0,
                          "dedup_truncate": 2 * pairs, "seg_active": 0}
    assert K.segments["pair_ends"] == pairs
    assert K.grid_launches_total == {
        name: pairs * graph.body.get(name, 0) for name in K.launches}
    # the host loop over the same levels ends in the same carry
    ref = parity.Level([cols], (128, 32, 8), cuda)
    G.run_segment_host(ref.cols, ref.carry, ref.scratch, ref.shape, ref.nr,
                       2 * pairs)
    for x, y in zip(interop.batch_carry_to_numpy(lv.carry),
                    interop.batch_carry_to_numpy(ref.carry), strict=True):
        assert np.array_equal(x, y)


def test_engine_eviction_destroys_the_segment_graph(cuda, monkeypatch):
    """A graph is destroyed with the engine state it points into: fill
    the state cache past MAX_ENTRIES, and the evicted shape's graph is
    gone; the shape allocated again runs a new graph to the same carry.
    A fresh engine stands in for the process's, so the counts are this
    test's alone."""
    from jepsen_tpu_torch.checker import engine as engine_mod
    eng = engine_mod.Engine()
    monkeypatch.setattr(engine_mod, "_DEFAULT", eng)
    _, _, cols_np = _cols(FIXTURES["crashed"]())
    n, cr = cols_np["f"].shape[0], cols_np["cf"].shape[0]

    def shape(C):
        return K.LevelShape(C, 32, 8, n, cr)

    def run(sh):
        carry, scratch = eng.state(sh, cuda)
        cols = eng.cols(cols_np, cuda)
        interop.carry_from_numpy(G._carry0_host(
            sh.C, sh.W, cr, cols_np["ini"], int(cols_np["nr"]),
            stats_rows=sh.lmax + 1), cuda, out=carry)
        scratch.acc.zero_()
        G.run_batch(cols, carry, scratch, sh, 64)
        return interop.carry_to_numpy(carry)

    with eng.lock:
        first = run(shape(96))
        second = run(shape(64))
        assert len(eng._graphs) == 2
        for i in range(engine_mod.Engine.MAX_ENTRIES - 1):
            eng.state(shape(100 + 4 * i), cuda)
        # shape(96) left the state cache, and its graph with it
        assert [k[0] for k in eng._graphs] == [shape(64)]
        assert len(eng._graphs) == 1
        # allocating it again evicts shape(64), the stalest, and its graph
        again = run(shape(96))
        assert [k[0] for k in eng._graphs] == [shape(96)]
        assert len(eng._graphs) == 1
    for x, y in zip(first, again, strict=True):
        assert np.array_equal(x, y)
    assert int(second[8]) > 0


# -- K1 (a warp per expanded row) and K4 (a block per key) ------------------


def _sequential():
    """One client's history: every op is forced, so the first level's
    offset-0 successor runs through the whole history."""
    return simulate_register_history(3000, n_procs=1, n_vals=8, seed=11)


@pytest.mark.parametrize("CR", [0, 8, 40])
@pytest.mark.parametrize("W", [16, 32, 48, 64, 128])
@pytest.mark.parametrize("model", K.MODELS)
def test_each_kernel_matches_its_plain_version_on_random_states(
        cuda, model, W, CR):
    """K1 at one, two and four mask words, windows that are not a
    multiple of 32 among them (lanes past W have no candidate), and zero,
    one and two crashed mask words (CR = 40), every model, three keys one
    of them done; the other kernels from the plain versions' outputs."""
    shape = K.LevelShape(64, W, 8, 256, CR, B=3, model=model)
    lv = parity.Level.random(shape, W + CR, cuda, inactive=(1,))
    for stage, _, _, _, err in lv.walk():
        assert err == 0, (model, W, CR, stage)


@pytest.mark.parametrize("CR", [0, 40])
@pytest.mark.parametrize("W", [16, 48])
@pytest.mark.parametrize("model", K.MODELS)
def test_expand_gives_the_lanes_past_the_window_no_candidate(cuda, model, W,
                                                             CR):
    """A window that is not a multiple of 32, every row expanded, and
    every op concurrent with every other (lag = the returns' whole span):
    the last mask word's lanes past W then meet ops that would be
    candidates, and they must stay out of the closure and the rows, as in
    the plain version."""
    shape = K.LevelShape(64, W, 64, 256, CR, B=3, model=model)
    lv = parity.Level.random(shape, W + CR, cuda, inactive=(1,),
                             lag=8 * shape.n)
    for stage, _, _, _, err in lv.walk():
        assert err == 0, (model, W, CR, stage)


def test_expand_runs_a_sequential_history_to_its_end(cuda):
    """The first level of a one-client history: its one forced run (the
    closure's, the first op being a read) crosses every 32-op chunk of
    the history, bit for bit with the plain version, and ends at the last
    required op."""
    _, _, cols = _cols(_sequential())
    lv = parity.Level(cols, (32, 32, 4), cuda)
    stage, kern, _, state, err = next(lv.walk())
    assert stage == "expand" and err == 0
    carry, scratch = parity.copy_state(*state)
    kern(carry, scratch)
    closure = lv.shape.E * lv.shape.W
    assert int(scratch.rows[0, closure, 1]) == int(cols["nr"]) > 2000


@pytest.mark.parametrize("model", ["noop", "cas-register"])
def test_expand_matches_on_long_forced_runs(cuda, model):
    """Every op forced and no crashed op: runs as long as the random
    states allow (a no-op run to the history's end), at W = 32, 48 and
    128."""
    for W in (32, 48, 128):
        shape = K.LevelShape(64, W, 16, 2048, 0, B=2, model=model)
        lv = parity.Level.random(shape, 5, cuda, forced=1.0)
        for stage, _, _, _, err in lv.walk():
            assert err == 0, (model, W, stage)


@pytest.mark.parametrize("CR,C", [(0, 2048), (0, 2049), (8, 1536),
                                  (8, 1537)])
def test_dedup_matches_on_both_sides_of_one_block(cuda, CR, C):
    """R = T = 4,096 takes the block-per-key path, R = T + 1 the
    multi-block one; a done key among live ones is copied through; each
    is one CUDA launch and leaves every active key's accumulators zero."""
    shape = K.LevelShape(C, 32, 64, 256, CR, B=3)
    assert shape.R == K.tile_rows(shape) + (C % 2)
    assert K.dedup_one_block(shape) == (C % 2 == 0)
    lv = parity.Level.random(shape, C, cuda, inactive=(1,))
    for stage, kern, _, state, err in lv.walk():
        assert err == 0, (CR, C, stage)
        if stage == "dedup_truncate":
            carry, scratch = parity.copy_state(*state)
            before = K.grid_launches_total["dedup_truncate"]
            kern(carry, scratch)
            assert K.grid_launches_total["dedup_truncate"] == before + 1
            assert int(scratch.acc[[0, 2]].abs().sum()) == 0
            assert int(carry.scal[1, K.LEVEL]) == int(state[0].scal[1,
                                                                   K.LEVEL])


# -- K3 in K4's shared memory, one K3 launch on the wide rungs, K5 in K4 ----


@pytest.mark.parametrize("CR", [0, 8, 40])
@pytest.mark.parametrize("W", [16, 48, 128])
@pytest.mark.parametrize("model", K.MODELS)
def test_the_fused_dedup_matches_scan_and_dedup_plain(cuda, model, W, CR):
    """K4 scanning the group starts in its shared memory (CR > 0) or not
    at all (CR = 0), every model, three keys one of them done, against
    ``group_scan_plain`` and ``dedup_truncate_plain``; no K3 stage runs."""
    shape = K.LevelShape(64, W, 8, 256, CR, B=3, model=model)
    assert K.dedup_one_block(shape) and not K.group_scan_runs(shape)
    lv = parity.Level.random(shape, W * CR + 7, cuda, inactive=(1,))
    stages = []
    for stage, _, _, _, err in lv.walk():
        assert err == 0, (model, W, CR, stage)
        stages.append(stage)
    assert stages == ["expand", "sort_rows", "dedup_truncate"]


def _grouped_level(shape, seed, device, inactive=()):
    """A random state of ``shape`` whose rows are
    :func:`~jepsen_tpu_torch.kernels.parity.grouped_rows` (long groups
    across scan blocks and stripes), as K2 leaves them."""
    lv = parity.Level.random(shape, seed, device, inactive=inactive)
    lv.scratch.rows.copy_(torch.from_numpy(parity.grouped_rows(shape,
                                                               seed)))
    lv.carry.scal[:, K.ACT] = 1
    lv.carry.scal[list(inactive), K.ACT] = 0
    return lv


#: (C, W, E, CR): R = 4,095, 4,096 (one block, NK = 12: 221,184 bytes of
#: rows and starts) and 4,097 (the wide path, K3 and its carry) at four
#: mask and four crashed words; R = 4,096 at NK = 6; 37,376 rows at CR = 8
EDGE_SHAPES = [(2047, 128, 8, 128), (2048, 128, 8, 128), (2049, 128, 8, 128),
               (1536, 32, 64, 8), (512, 64, 512, 8)]


@pytest.mark.parametrize("C,W,E,CR", EDGE_SHAPES)
def test_group_starts_across_blocks_and_stripes(cuda, C, W, E, CR):
    """Groups longer than a 1,024-row scan block and than K4's stripe:
    the fused K4, or K3 and K4 with its carry, against the plain
    versions from the sorted rows."""
    shape = K.LevelShape(C, W, E, 512, CR, B=3)
    lv = _grouped_level(shape, C + CR, cuda, inactive=(1,))
    stages = []
    for stage, _, _, _, err in lv.walk(2):
        assert err == 0, (shape.R, stage)
        stages.append(stage)
    want = (["group_scan"] if shape.R > 4096 else []) + ["dedup_truncate"]
    assert stages == want, (shape.R, stages)
    if shape.R <= 4096:
        assert K.dedup_one_block(shape)
        assert K.dedup_block_smem(shape) + K.DEDUP_BLOCK_STATIC <= K.SMEM_MAX


#: (keys, rung, CR): the one-block kernel at 1, 8 and 256 keys, the wide
#: one (R = 4,097) at 1 and 8
DECIDE_CASES = [(B, rung, CR) for B in (1, 8, 256)
                for rung, CR in (((32, 32, 4), 8), ((64, 48, 8), 0))] + [
    (B, (1537, 32, 64), 8) for B in (1, 8)]


@pytest.mark.parametrize("B,rung,CR", DECIDE_CASES)
def test_the_deciding_dedup_matches_seg_active_plain(cuda, B, rung, CR):
    """K5's step at the end of K4: the segment words (levels run, go, the
    batch's ticket word back at 0) and every K4 output, with a third of the
    keys done (all of them in the second state), the pair's second level
    run or not, and the count below, at and past the bound."""
    C, W, E = rung
    shape = K.LevelShape(C, W, E, 256, CR, B=B)
    cases = ((0, 2), (0, 1024), (1022, 1024), (5, 4), (7, 8))
    for seed, inactive in ((B, tuple(range(0, B, 3))),
                           (B + 1, tuple(range(B)))):
        lv = parity.Level.random(shape, seed, cuda, inactive=inactive)
        assert lv.pair_end(cases)[0] == 0, (B, rung, CR, inactive)
    # a state where every key is done after the pair's second level
    lv = parity.Level.random(shape, B + 2, cuda)
    lv.carry.scal[:, K.LEVEL] = shape.lmax
    assert lv.pair_end(cases)[0] == 0, (B, rung, CR)


@pytest.mark.parametrize("B", [1, 8, 256])
def test_the_graph_decides_inside_dedup_as_the_plain_route(cuda, B):
    """The WHILE node's condition, set by the pair's second K4: segments
    of random states at B = 1, 8 and 256 (a third of the keys done, and
    every key's level budget near its end so that keys stop at other
    pairs) run the levels the plain route runs, to the same carry."""
    shape = K.LevelShape(32, 32, 4, 64, 8, B=B)
    lvs = {}
    for route in ("graph", "plain"):
        lv = parity.Level.random(shape, B, cuda,
                                 inactive=tuple(range(1, B, 3)), forced=0.2)
        lv.carry.scal[:, K.LEVEL] = shape.lmax - 2 * torch.arange(
            B, device=cuda, dtype=torch.int32) % 9
        lvs[route] = lv
    for n in (2, 6, 64):
        runs = []
        for route, lv in lvs.items():
            words, graph = G.run_segment(
                lv.cols, lv.carry, lv.scratch, lv.shape, lv.nr, n,
                G.KERNELS if route == "graph" else G.PLAIN)
            assert (graph is None) == (route == "plain")
            runs.append(words.tolist())
            G.end_segment(lv.carry, lv.shape, words, graph)
        assert runs[0] == runs[1], (B, n, runs)
        for x, y in zip(*(interop.batch_carry_to_numpy(v.carry)
                          for v in lvs.values()), strict=True):
            assert np.array_equal(x, y), (B, n)


@pytest.mark.parametrize("rung,cr,scan", [((128, 32, 8), 8, 0),
                                          ((512, 64, 512), 8, 2),
                                          ((512, 64, 512), 0, 0)])
def test_the_graph_body_launches_k3_only_where_it_runs(cuda, rung, cr, scan):
    """The captured body: two levels of K1, K2 (its merge passes on the
    wide rung) and K4, K3 only on a wide rung with crashed ops, and no
    K5 launch."""
    from jepsen_tpu_torch.checker.engine import default_engine
    hs = ([FIXTURES[n]() for n in ("wide40a", "wide40b")] if cr
          else [wide_history(40, 2, seed=s) for s in (1, 2)])
    lv = parity.Level(_batch_cols(hs, cr), rung, cuda)
    graph = default_engine().segment_graph(lv.cols, lv.nr, lv.carry,
                                           lv.scratch, lv.shape)
    assert graph.body == {"expand": 2,
                          "sort_rows": 2 * (1 + K.sort_passes(lv.shape)),
                          "group_scan": scan, "dedup_truncate": 2}
