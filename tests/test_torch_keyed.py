"""The port's keyed batch against the JAX keyed batch, on the CPU.

* The batched plain versions against ``jax.vmap`` of the JAX segment
  search, carry by carry, under both tie-breaks (``lex`` and ``hash``):
  the scalar lanes, ``alive`` and the stats lane exactly, the
  configurations on the alive rows and the snapshot on the ``pa`` rows.
* A batch of one equals the same key's lane in a larger batch.
* The hash tie-break's mix and order against the reference's.
* ``check_keyed_gpu(device="cpu")`` against ``check_keyed_tpu`` per key.

Tolerance: none (integer state).
"""

import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from jepsen_tpu import testing as jt
from jepsen_tpu.checker import tpu as T
from jepsen_tpu.history import History as JHistory, Op as JOp
from jepsen_tpu.models import CASRegister as JCASRegister
from jepsen_tpu.ops.encode import pack_with_init as j_pack

from jepsen_tpu_torch import interop
from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.checker.gpu import check_keyed_gpu
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.models import CASRegister

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

KEYS = ("valid", "levels", "max-linearized-prefix", "rung", "crash-width",
        "tiebreak", "work")
LANES = ("k", "mask", "cmask", "state", "alive", "done", "lossy", "wovf",
         "level", "best_k", "pk", "ps", "pa", "stats")


def _port(h):
    return History.of(o.to_dict() for o in h)


def _sim(n, seed, **kw):
    return jt.simulate_register_history(n, n_procs=5, n_vals=8, seed=seed,
                                        **kw)


#: per-key histories for the vmapped parity: staggered, dense, crashy,
#: and a short one that is done in a few levels
BATCH = {
    "staggered": lambda: _sim(200, 7000, overlap_p=0.05),
    "dense": lambda: _sim(200, 7001, crash_p=0.001),
    "crashy": lambda: _sim(200, 7002, crash_p=0.03),
    "short": lambda: _sim(24, 7003),
}
#: more than 8 crashed ops: the CR = 32 cohort
CRASHIER = lambda: _sim(200, 7004, crash_p=0.12)  # noqa: E731


def _batch_cols(histories, cr):
    packed = [j_pack(h, JCASRegister()) for h in histories]
    kernel = packed[0][1]
    breq = T._bucket(max(p.n_required for p, _ in packed))
    cols = [T._split_packed(p, breq, cr, kernel) for p, _ in packed]
    assert all(c is not None for c in cols)
    return kernel, cols


def assert_batch_equal(jc, pc, where):
    jc = tuple(np.asarray(x) for x in jc)
    assert len(pc) == len(jc) == 14
    for i in (4, 5, 6, 7, 8, 9, 12, 13):
        assert np.array_equal(jc[i], pc[i]), (where, LANES[i])
    alive, pa = jc[4], jc[12]
    for i in range(4):
        assert pc[i].dtype == jc[i].dtype, (where, LANES[i])
        assert np.array_equal(jc[i][alive], pc[i][alive]), (where, LANES[i])
    for i in (10, 11):
        assert np.array_equal(jc[i][pa], pc[i][pa]), (where, LANES[i])


def run_batch_both(kernel, cols, rung, tiebreak, seg=16, nseg=3):
    """Segments of the vmapped JAX search and of the port's batched plain
    versions from the same stacked columns and carry; compares every
    pair and returns the last port carry."""
    C, W, E = rung
    n, cr = cols[0]["f"].shape[0], cols[0]["cf"].shape[0]
    lmax = T._level_budget(n, cr)
    search = T._search_fn(kernel.step, n, cr, C, W, E, tiebreak=tiebreak,
                          segment=True, stats=True)
    fn = jax.jit(jax.vmap(search, in_axes=(0,) * 15 + (None, 0)))
    stacked = interop.stack_cols(cols)
    jc = G._batch_carry0_host(C, W, cr, [c["ini"] for c in cols],
                              [int(c["nr"]) for c in cols],
                              stats_rows=lmax + 1)
    shape = K.LevelShape(C, W, E, n, cr, B=len(cols), tiebreak=tiebreak,
                         model=kernel.name)
    tcols = interop.batch_cols_from_numpy(stacked, "cpu")
    carry = interop.batch_carry_from_numpy(jc, "cpu")
    scratch = G.empty_scratch(shape, "cpu")
    for s in range(nseg):
        jc = tuple(np.asarray(x) for x in fn(
            *[stacked[c] for c in T._COLS], np.int32(seg), jc))
        G.run_segment(tcols, carry, scratch, shape, tcols["nr"], seg)
        pc = interop.batch_carry_to_numpy(carry)
        assert_batch_equal(jc, pc, (tiebreak, s, jc[8].tolist()))
    return pc


@pytest.mark.parametrize("tiebreak", K.TIEBREAKS)
@pytest.mark.parametrize("cr,rung", [(8, (32, 32, 4)), (32, (64, 32, 8))])
def test_batched_plain_matches_jax_vmap(tiebreak, cr, rung):
    hs = [f() for f in BATCH.values()] + ([CRASHIER()] if cr == 32 else [])
    kernel, cols = _batch_cols(hs, cr)
    pc = run_batch_both(kernel, cols, rung, tiebreak)
    done, level = pc[5], pc[8]
    # the short key finished early and stayed put while the others ran
    assert done[3] and level[3] < level.max()
    assert not done.all()
    if cr == 32:
        assert pc[13][:, :, 2].sum() > 0      # dominance kills happened


def test_the_tiebreaks_differ_on_a_batch():
    """The two tie-breaks keep different beams, so the parity above tells
    them apart."""
    kernel, cols = _batch_cols([f() for f in BATCH.values()], 8)
    out = {}
    for tb in K.TIEBREAKS:
        shape = K.LevelShape(32, 32, 4, cols[0]["f"].shape[0], 8,
                             B=len(cols), tiebreak=tb)
        tcols = interop.batch_cols_from_numpy(interop.stack_cols(cols),
                                              "cpu")
        carry = interop.batch_carry_from_numpy(G._batch_carry0_host(
            32, 32, 8, [c["ini"] for c in cols],
            [int(c["nr"]) for c in cols], shape.lmax + 1), "cpu")
        G.run_segment(tcols, carry, G.empty_scratch(shape, "cpu"), shape,
                      tcols["nr"], 12)
        out[tb] = interop.batch_carry_to_numpy(carry)
    assert not np.array_equal(out["lex"][3], out["hash"][3])


#: the single-history fixtures of tests/test_torch_search.py
SINGLE = {
    "entry": lambda: jt.simulate_register_history(48, n_procs=4, seed=3,
                                                  crash_p=0.05),
    "sim200": lambda: jt.simulate_register_history(200, n_procs=4,
                                                   n_vals=8, seed=1),
    "crashed": lambda: jt.simulate_register_history(200, n_procs=4,
                                                    n_vals=8, seed=2,
                                                    crash_p=0.05),
    "mc2": lambda: jt.simulate_register_history(260, n_procs=6, n_vals=8,
                                                seed=3, crash_p=0.3),
}


@pytest.mark.parametrize("tiebreak", K.TIEBREAKS)
def test_a_batch_of_one_equals_its_lane_in_a_batch(tiebreak):
    """Each single-history fixture searched alone (B = 1) ends where its
    lane of the four-key batch ends, lane for lane."""
    kernel, cols = _batch_cols([f() for f in SINGLE.values()], 64)
    n, cr = cols[0]["f"].shape[0], 64
    C, W, E = 32, 32, 4
    lmax = T._level_budget(n, cr)

    def run(batch):
        shape = K.LevelShape(C, W, E, n, cr, B=len(batch), tiebreak=tiebreak)
        tcols = interop.batch_cols_from_numpy(interop.stack_cols(batch),
                                              "cpu")
        carry = interop.batch_carry_from_numpy(G._batch_carry0_host(
            C, W, cr, [c["ini"] for c in batch],
            [int(c["nr"]) for c in batch], lmax + 1), "cpu")
        G.run_segment(tcols, carry, G.empty_scratch(shape, "cpu"), shape,
                      tcols["nr"], 40)
        return interop.batch_carry_to_numpy(carry)

    together = run(cols)
    for i, name in enumerate(SINGLE):
        alone = run([cols[i]])
        for lane, (a, b) in enumerate(zip(alone, together)):
            assert np.array_equal(a[0], b[i]), (name, LANES[lane])


def _reference_mix(fk, fm, fs):
    """The reference's hash mix, written as in tpu.py:552-557."""
    h = fk.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
    for w in range(fm.shape[1]):
        h = (h ^ fm[:, w]) * jnp.uint32(0x85EBCA6B)
        h = h ^ (h >> jnp.uint32(13))
    h = (h ^ fs.astype(jnp.uint32)) * jnp.uint32(0xC2B2AE35)
    return h ^ (h >> jnp.uint32(16))


def _random_rows(rng, R, MW, MCX):
    rows = np.zeros((R, 4 + MW + MCX), np.int32)
    rows[:, 0] = rng.integers(2**30 - 40, 2**30 + 40, R)
    rows[:, 1] = rng.integers(0, 2**20, R)
    rows[:, 2:2 + MW] = rng.integers(0, 2**32, (R, MW),
                                     dtype=np.uint32).view(np.int32)
    rows[::5, 2:2 + MW] = -1                        # all-ones mask words
    rows[:, 2 + MW] = rng.integers(-2**31, 2**31, R)  # negative states too
    cm = rng.integers(0, 2**32, (R, MCX), dtype=np.uint32)
    rows[:, 4 + MW:] = cm.view(np.int32)
    rows[:, 3 + MW] = np.vectorize(lambda x: bin(x).count("1"))(
        cm.astype(np.int64)).sum(1)
    return rows


@pytest.mark.parametrize("MW", [1, 4])
def test_row_hash_equals_the_reference_mix(MW):
    rng = np.random.default_rng(MW)
    rows = _random_rows(rng, 4096, MW, 2)
    ref = np.asarray(_reference_mix(jnp.asarray(rows[:, 1]),
                                    jnp.asarray(rows[:, 2:2 + MW])
                                    .view(jnp.uint32),
                                    jnp.asarray(rows[:, 2 + MW])))
    ours = K.row_hash_plain(torch.from_numpy(rows), MW).numpy()
    assert ours.dtype == np.int64 and ours.min() >= 0
    np.testing.assert_array_equal(ours, ref.astype(np.int64))


@pytest.mark.parametrize("MW,CR", [(1, 0), (1, 8), (2, 64)])
def test_hash_sort_equals_the_reference_sort(MW, CR):
    """sort_rows_plain under the hash tie-break puts rows where
    ``lax.sort`` of the reference's keys (key1, h[, pc, cmask]) with an
    index payload puts them (the rows are distinct, so no two share
    every key)."""
    rng = np.random.default_rng(10 + MW + CR)
    MC = (CR + 31) // 32
    MCX = max(MC, 1)
    rows = _random_rows(rng, 1000, MW, MCX)
    if not CR:
        rows[:, 3 + MW:] = 0
    rows[::7, 0] = rows[0, 0]                       # many key1 ties
    shape = K.LevelShape(C=8, W=32 * MW, E=1, n=16, CR=CR, tiebreak="hash")
    RP = 1024
    padded = np.zeros((1, RP, rows.shape[1]), np.int32)
    padded[0, :1000] = rows
    padded[0, 1000:, 0] = 2**31 - 1
    t = torch.from_numpy(padded)
    scal = torch.zeros(1, K.NSCAL, dtype=torch.int32)
    scal[0, K.ACT] = 1
    K.sort_rows_plain(t, scal, shape)

    j = jnp.asarray(rows)
    h = _reference_mix(j[:, 1], j[:, 2:2 + MW].view(jnp.uint32),
                       j[:, 2 + MW])
    keys = [j[:, 0], h]
    if MC:
        keys += [j[:, 3 + MW]] + [j[:, 4 + MW + w].view(jnp.uint32)
                                  for w in range(MC)]
    out = lax.sort(tuple(keys) + (jnp.arange(1000),), num_keys=len(keys))
    perm = np.asarray(out[-1])
    np.testing.assert_array_equal(t[0, :1000].numpy(), rows[perm])


def _wide():
    return jt.wide_history(48, 2, seed=3)


def _unencodable():
    h = _sim(60, 7005)
    return JHistory(list(h) + [
        JOp(type="invoke", f="append", value=3, process=0, time=10**6),
        JOp(type="ok", f="append", value=3, process=0, time=10**6 + 1)])


def _malformed():
    return JHistory.of([JOp(type="ok", f="read", value=1, process=0,
                            time=0)])


KEYED = {
    "staggered": lambda: _sim(200, 7100, overlap_p=0.05),
    "staggered2": lambda: _sim(200, 7101, overlap_p=0.05),
    "dense": lambda: _sim(200, 7102, crash_p=0.001),
    "crashy": lambda: _sim(200, 7103, crash_p=0.05),
    "corrupted": lambda: jt.corrupt_one_read(_sim(200, 13),
                                             random.Random(13)),
    "unencodable": _unencodable,
    "malformed": _malformed,
    "empty": lambda: JHistory(),
    "wide": _wide,
}


def _compare(ref, ours):
    assert list(ours["results"]) == list(ref["results"])
    for k, r in ref["results"].items():
        o = ours["results"][k]
        assert {x: o.get(x) for x in KEYS} == {x: r.get(x) for x in KEYS}, k
        assert ("error" in o) == ("error" in r), k
        assert o.get("lint") == r.get("lint"), k
        assert o["backend"] == "gpu"
    assert ours["valid"] == ref["valid"]


def test_check_keyed_matches_jax():
    keyed = {k: f() for k, f in KEYED.items()}
    ref = T.check_keyed_tpu(keyed, JCASRegister())
    ours = check_keyed_gpu({k: _port(h) for k, h in keyed.items()},
                           CASRegister(), device="cpu")
    _compare(ref, ours)
    res = ours["results"]
    assert ours["valid"] is False
    assert res["corrupted"]["valid"] is False
    assert res["corrupted"]["final-states"]
    assert res["unencodable"]["valid"] == UNKNOWN
    assert res["malformed"]["lint"] == {"HIST-UNMATCHED-COMPLETE": 1}
    assert res["empty"] == {"valid": True, "levels": 0, "backend": "gpu"}
    assert res["wide"]["rung"][1] > 32            # deferred to a wide rung
    assert res["dense"]["work"][0][0] == (32, 32, 8)   # the dense rung
    assert res["staggered"]["tiebreak"] == "hash"
    assert res["crashy"]["crash-width"] > 0
    for k in ("staggered", "staggered2", "dense", "crashy", "wide"):
        assert res[k]["valid"] is True, k
    # one batch per rung and crash width, covering every key's work
    runs = sorted((b["rung"], b["crash-width"], b["tiebreak"])
                  for b in ours["batches"] for _ in range(b["keys"]))
    assert runs == sorted((rung, crw, tb) for r in res.values()
                          for rung, crw, tb, _ in r.get("work", []))
    for b in ours["batches"]:
        assert b["levels-launched"] >= b["levels"] > 0


def test_an_explicit_hash_rung_matches_jax(monkeypatch):
    keyed = {k: KEYED[k]() for k in ("staggered", "dense", "corrupted")}
    ladder = ((64, 32, 8),)
    monkeypatch.setenv("JTPU_TIEBREAK0", "hash")
    ref = T.check_keyed_tpu(keyed, JCASRegister(), ladder=ladder)
    monkeypatch.delenv("JTPU_TIEBREAK0")
    ours = check_keyed_gpu({k: _port(h) for k, h in keyed.items()},
                           CASRegister(), ladder=ladder, tiebreak0="hash",
                           device="cpu")
    _compare(ref, ours)
    assert {r["tiebreak"] for r in ours["results"].values()} == {"hash"}
    # without tiebreak0 a single rung sorts in lex order
    lex = check_keyed_gpu({k: _port(h) for k, h in keyed.items()},
                          CASRegister(), ladder=ladder, device="cpu")
    assert {r["tiebreak"] for r in lex["results"].values()} == {"lex"}


def test_a_pinned_capacity_matches_jax():
    keyed = {k: KEYED[k]() for k in ("crashy", "corrupted")}
    ref = T.check_keyed_tpu(keyed, JCASRegister(), capacity=128, expand=16)
    ours = check_keyed_gpu({k: _port(h) for k, h in keyed.items()},
                           CASRegister(), capacity=128, expand=16,
                           device="cpu")
    _compare(ref, ours)


def test_bad_arguments_raise():
    h = {"a": _port(_sim(20, 1))}
    with pytest.raises(ValueError, match="tiebreak0"):
        check_keyed_gpu(h, CASRegister(), tiebreak0="random", device="cpu")
    with pytest.raises(ValueError, match="ladder"):
        check_keyed_gpu(h, CASRegister(), ladder=((32, 32, 4),),
                        capacity=32, device="cpu")
    with pytest.raises(ValueError, match="window"):
        check_keyed_gpu(h, CASRegister(), window=256, device="cpu")
    assert check_keyed_gpu({}, CASRegister(), device="cpu") == {
        "valid": True, "results": {}, "backend": "gpu", "batches": []}


def test_run_batch_stops_when_every_key_is_done():
    """The batch loop runs growing segments until no key is active, and
    ends where one long segment ends. Each segment reports the levels it
    ran, as its counter read them: the whole schedule's length but for the
    last, which stops after the pair that left no key active; together
    they are the most levels any key advanced."""
    kernel, cols = _batch_cols([f() for f in BATCH.values()], 8)
    n = cols[0]["f"].shape[0]
    shape = K.LevelShape(32, 32, 4, n, 8, B=len(cols), tiebreak="hash")
    stacked = interop.stack_cols(cols)
    out = []
    for run in ("batch", "segment"):
        tcols = interop.batch_cols_from_numpy(stacked, "cpu")
        carry = interop.batch_carry_from_numpy(G._batch_carry0_host(
            32, 32, 8, [c["ini"] for c in cols],
            [int(c["nr"]) for c in cols], shape.lmax + 1), "cpu")
        scratch = G.empty_scratch(shape, "cpu")
        if run == "batch":
            ran = G.run_batch(tcols, carry, scratch, shape, 1024)
            launched = sum(ran)
        else:
            G.run_segment(tcols, carry, scratch, shape, tcols["nr"],
                          launched)
        out.append(interop.batch_carry_to_numpy(carry))
    level = out[0][8]
    segs, seg = [], G.FIRST_BATCH_SEGMENT
    while sum(segs) < launched:
        segs.append(seg)
        seg = min(2 * seg, 1024)
    assert segs[:-1] == ran[:-1] and len(segs) > 1
    assert 0 < ran[-1] <= segs[-1]
    # some key was still active before the last segment, none after it
    assert sum(segs[:-1]) < level.max() == launched
    assert out[0][5].any() and not (~out[0][5] & out[0][4].any(1)).any()
    for a, b in zip(*out):
        assert np.array_equal(a, b)


def test_a_state_that_does_not_fit_raises_with_its_size(monkeypatch):
    """Without the plan gate an allocation the device refuses raises,
    naming the cohort's keys and bytes; nothing falls back."""
    from jepsen_tpu_torch.checker.engine import Engine

    def oom(shape, device):
        raise torch.OutOfMemoryError("out of memory")

    monkeypatch.setattr(G, "empty_scratch", oom)
    shape = K.LevelShape(16384, 128, 4096, 2048, 8, B=40)
    with pytest.raises(MemoryError, match=r"40 keys .* needs \d+ bytes"):
        Engine().state(shape, torch.device("cpu"))
    assert G.state_bytes(shape) > 40 * shape.RP * shape.NK * 4


def test_a_cohort_larger_than_a_launch_runs_in_chunks(monkeypatch):
    """A cohort of more keys than one launch's grid takes runs in chunks
    of at most MAX_KEYS keys, with every key's result unchanged."""
    keyed = {k: _port(KEYED[k]()) for k in ("staggered", "staggered2",
                                            "dense", "crashy", "corrupted")}
    whole = check_keyed_gpu(keyed, CASRegister(), device="cpu")
    assert max(b["keys"] for b in whole["batches"]) > 1
    monkeypatch.setattr(K, "MAX_KEYS", 1)
    with pytest.raises(ValueError, match="B = 2 keys"):
        K.LevelShape(32, 32, 4, 256, 0, B=2)
    chunked = check_keyed_gpu(keyed, CASRegister(), device="cpu")
    for k, r in whole["results"].items():
        assert ({x: chunked["results"][k].get(x) for x in KEYS}
                == {x: r.get(x) for x in KEYS}), k
    assert chunked["valid"] == whole["valid"] is False
    assert max(b["keys"] for b in chunked["batches"]) == 1
    assert len(chunked["batches"]) > len(whole["batches"])
    assert (sum(b["keys"] for b in chunked["batches"])
            == sum(b["keys"] for b in whole["batches"]))


def _sort_launches(R, T):
    """The CUDA launches of ``sort_rows`` in csrc/search.cu: one tile pass
    over tiles of T rows, then ceil(log2(tiles)) merge passes."""
    tiles = math.ceil(R / T)
    return 1 + (math.ceil(math.log2(tiles)) if tiles > 1 else 0)


@pytest.mark.parametrize("rung,cr", [((128, 32, 8), 16), ((128, 32, 16), 8),
                                     ((512, 64, 512), 8),
                                     ((512, 128, 512), 8),
                                     ((16384, 128, 4096), 32)])
def test_grid_launches_counts_every_cuda_launch(rung, cr):
    C, W, E = rung
    shape = K.LevelShape(C, W, E, 2048, cr, B=3)
    tile = K.tile_rows(shape)
    assert tile == 4096
    assert K.grid_launches("sort_rows", shape) == _sort_launches(shape.R,
                                                                 tile)
    hashed = K.LevelShape(C, W, E, 2048, cr, B=3, tiebreak="hash")
    assert K.grid_launches("sort_rows_hash", hashed) == _sort_launches(
        hashed.R, K.tile_rows(hashed))
    if shape.R <= tile:    # the narrow rungs: one launch
        assert K.grid_launches("sort_rows", shape) == 1
        assert K.grid_launches("sort_rows_hash", hashed) == 1
    # one scan launch where it runs (past one tile: on the narrow rungs K4
    # scans), its blocks' carry applied in K4
    assert K.grid_launches("group_scan", shape) == 1
    assert K.group_scan_runs(shape) == (shape.R > tile)
    assert K.grid_launches("expand", shape) == 1
    assert K.grid_launches("dedup_truncate", shape) == 1
    if rung == (512, 64, 512):
        assert shape.R == 37376 and K.grid_launches("sort_rows", shape) == 5
