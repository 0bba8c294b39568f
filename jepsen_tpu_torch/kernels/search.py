"""The four kernels of one search level: wrappers, plain versions, counts.

One level of the pool search (``jepsen_tpu/checker/tpu.py`` ``_search_fn``
body, one ``lax.while_loop`` iteration) is four kernels in
``csrc/search.cu``:

==================  =====================================================
``expand``          B1-B4: the [E, W] required grid, the pure-op closure,
                    the frontier advance with its forced fast-forward, the
                    [E, CR] crashed grid, the pool remainder; writes R
                    sortable rows
``sort_rows``       B5 (lex): bitonic sort of the rows, padded to RP
``group_scan``      B6: the cummax group-start scan over the sorted rows
``dedup_truncate``  B6/B7: dup and 8-leader dominance kills, done/best,
                    first-C truncation into the other pool buffer, lossy,
                    the five per-level counters, level+1, pk/ps/pa
==================  =====================================================

Each wrapper checks its tensors and dispatches on their device: CPU
tensors run the plain PyTorch version beside it, CUDA tensors launch the
kernel on the current stream (or raise; there is no fallback). Each
launch adds one to ``launches[name]``. The plain versions take CUDA
tensors too when called directly, which is how the kernels are held
against them on the card.

Row layout (int32 words, ``NK = 4 + MW + MCX``)::

    key1, k, mask[MW], state, popcount(cmask), cmask[MCX]

Mask words are uint32 bit patterns stored in int32 tensors; the plain
versions widen them to int64 in [0, 2**32) wherever order or shifts must
be unsigned (torch has no uint32 ``<`` or ``>>`` on the CPU).

Device-side level state, shared by all four kernels:

* ``scal`` int32[8]: done, lossy, wovf, level, best_k, live pool rows,
  this level's ``active`` flag, spare;
* ``acc`` int32[9]: per-level accumulators (done, best, lossy, expanded,
  dup, dominated, trunc, frontier, block ticket), zero between levels.

``expand`` computes ``active = ~done & any(alive) & level <= LMAX`` and
stores it; every later kernel of the level no-ops when it is false, and
``dedup_truncate`` then copies the pool through unchanged: the masked
update, tested on the device with no host synchronisation.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict

import torch

from jepsen_tpu_torch.models.core import cas_register_step_torch
from jepsen_tpu_torch.ops.encode import RET_INF as _RET_INF

MAXK = 1 << 30
RET_INF = int(_RET_INF)
INT32_MAX = 2**31 - 1
U32 = 0xFFFFFFFF
#: group-prefix rows tested as dominators
LEADERS = 8
#: per-level counters: expanded, dup, dominated, trunc, frontier
NSTAT = 5

# scal lanes
DONE, LOSSY, WOVF, LEVEL, BEST, NALIVE, ACT = range(7)
NSCAL = 8
# acc lanes
(A_DONE, A_BEST, A_LOSSY, A_EXPANDED, A_DUP, A_DOM, A_TRUNC, A_FRONTIER,
 A_TICKET) = range(9)
NACC = 9

COLS = ("f", "v1", "v2", "ro", "fr", "inv", "ret", "sm", "cf", "cv1",
        "cv2", "cinv", "cps")

#: launches of each kernel since the last :func:`reset_launches`
launches: Dict[str, int] = {"expand": 0, "sort_rows": 0, "group_scan": 0,
                            "dedup_truncate": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@dataclass(frozen=True)
class LevelShape:
    """Static shape of one search: pool capacity C, window W, expansion E,
    padded required ops n and padded crashed ops CR."""

    C: int
    W: int
    E: int
    n: int
    CR: int

    @property
    def MW(self) -> int:          # window mask words
        return (self.W + 31) // 32

    @property
    def MC(self) -> int:          # crashed-mask words the sort compares
        return (self.CR + 31) // 32

    @property
    def MCX(self) -> int:         # crashed-mask words stored
        return max(self.MC, 1)

    @property
    def NK(self) -> int:          # int32 words per row
        return 4 + self.MW + self.MCX

    @property
    def R(self) -> int:           # merged rows per level
        return self.E * (self.W + 1 + self.CR) + (self.C - self.E)

    @property
    def RP(self) -> int:          # rows padded to a power of two
        return 1 << max(self.R - 1, 1).bit_length()

    @property
    def lmax(self) -> int:        # the level budget
        return 2 * (self.n + self.CR) + 256


@dataclass
class Pool:
    """C search configurations (k, mask, cmask, state) and their liveness."""

    k: torch.Tensor       # int32 [C]
    mask: torch.Tensor    # int32 [C, MW]
    cmask: torch.Tensor   # int32 [C, MCX]
    state: torch.Tensor   # int32 [C]
    alive: torch.Tensor   # bool [C]

    def tensors(self):
        return (self.k, self.mask, self.cmask, self.state, self.alive)

    def copy_(self, other: "Pool") -> None:
        for dst, src in zip(self.tensors(), other.tensors()):
            dst.copy_(src)


# ---------------------------------------------------------------------------
# Unsigned 32-bit helpers for the plain versions (int64 in [0, 2**32))
# ---------------------------------------------------------------------------


def _u(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 in [0, 2**32)."""
    return x.to(torch.int64) & U32


def _s(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) -> int32 bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _popc(x: torch.Tensor) -> torch.Tensor:
    """Population count of int64 words in [0, 2**32) (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32) >> 24


def _trailing_ones(m: torch.Tensor) -> torch.Tensor:
    """Trailing one-bits across a whole [*, MW] mask."""
    tw = _popc(m & ~(m + 1) & U32)
    t = tw[..., 0]
    for w in range(1, m.shape[-1]):
        t = torch.where(t == 32 * w, 32 * w + tw[..., w], t)
    return t


def _shr1(m: torch.Tensor) -> torch.Tensor:
    """Whole-mask right shift by one bit."""
    hi = torch.zeros_like(m)
    hi[..., :-1] = (m[..., 1:] << 31) & U32
    return (m >> 1) | hi


def _shr_by(m: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Whole-mask right shift by a per-row amount t in [0, 32 * MW]."""
    MW = m.shape[-1]
    mpad = torch.cat([m, torch.zeros_like(m[..., :1])], dim=-1)
    ws = (t >> 5).unsqueeze(-1)
    bs = (t & 31).unsqueeze(-1)
    widx = torch.arange(MW, device=m.device)
    a = mpad.gather(-1, (widx + ws).clamp(0, MW))
    b = mpad.gather(-1, (widx + ws + 1).clamp(0, MW))
    hi = torch.where(bs > 0, (b << (32 - bs).clamp(max=31)) & U32,
                     torch.zeros_like(b))
    return (a >> bs) | hi


def _bit(m: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Bit o of each row's mask: m [E, MW] int64, o [X] -> bool [E, X]."""
    return ((m[:, o >> 5] >> (o & 31)) & 1) == 1


def _bitmat(width: int, words: int, device) -> torch.Tensor:
    """[width, words] int64: row o has bit o of the mask set."""
    o = torch.arange(width, device=device)
    out = torch.zeros(width, words, dtype=torch.int64, device=device)
    out[o, o >> 5] = 1 << (o & 31)
    return out


def _active(scal: torch.Tensor, lmax: int) -> torch.Tensor:
    return ((scal[DONE] == 0) & (scal[NALIVE] > 0)
            & (scal[LEVEL] <= lmax)).to(torch.int32)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def expand_plain(cols: dict, pool: Pool, scal: torch.Tensor,
                 acc: torch.Tensor, rows: torch.Tensor, shape: LevelShape,
                 nr: int) -> None:
    """Plain version of the ``expand`` kernel (tpu.py:380-506)."""
    C, W, E, n, CR = shape.C, shape.W, shape.E, shape.n, shape.CR
    MW, MCX, R = shape.MW, shape.MCX, shape.R
    dev = rows.device
    step = cas_register_step_torch
    act = _active(scal, shape.lmax)
    scal[ACT] = act
    if not bool(act):
        return
    f, v1, v2, ro, fr = (cols[c] for c in ("f", "v1", "v2", "ro", "fr"))
    inv, ret, sm = cols["inv"], cols["ret"], cols["sm"]
    k_e, s_e, a_e = pool.k[:E], pool.state[:E], pool.alive[:E]
    m_e, cm_e = _u(pool.mask[:E]), _u(pool.cmask[:E])
    acc[A_EXPANDED] += a_e.sum(dtype=torch.int32)

    # window-overflow probe
    ret_k = ret[k_e.clamp(0, n - 1).long()]
    beyond = sm[(k_e + W).clamp(0, n).long()]
    scal[WOVF] |= (a_e & (beyond < ret_k)).any().to(torch.int32)

    # [E, W] required grid
    offs = torch.arange(W, device=dev)
    j = k_e[:, None] + offs[None, :]
    jc = j.clamp(0, n - 1).long()
    cand = (a_e[:, None] & (j < n) & (inv[jc] < ret_k[:, None])
            & ~_bit(m_e, offs))
    s2, ok = step(s_e[:, None], f[jc], v1[jc], v2[jc])
    pure = cand & ok & (ro[jc] > 0)
    valid = cand & ok & ~pure

    # closure successor: all pure candidates at once
    bitmat = _bitmat(W, MW, dev)
    pure_bits = (pure[:, :, None].to(torch.int64) * bitmat[None]).sum(1)
    mc_ = m_e | pure_bits
    tc_ = _trailing_ones(mc_)
    kcl = k_e + tc_
    mcl = _shr_by(mc_, tc_)
    closure_ok = a_e & pure.any(1)
    valid = valid & ~closure_ok[:, None]

    # frontier advance for offset 0, with the forced fast-forward
    m1 = _shr1(m_e)
    t = _trailing_ones(m1)
    k_adv = k_e + 1 + t
    m_adv = _shr_by(m1, t)
    bound = _crash_bound(cm_e, cols, shape)
    k_adv, s0 = _fast_forward(k_adv, s2[:, 0], valid[:, 0], bound, cols,
                              n, nr)
    s2 = s2.clone()
    s2[:, 0] = s0
    is0 = (offs == 0)[None, :]
    k2 = torch.where(is0, k_adv[:, None], k_e[:, None])
    m2 = torch.where(is0[:, :, None], m_adv[:, None, :],
                     m_e[:, None, :] | bitmat[None])
    cm2 = cm_e[:, None, :].expand(E, W, MCX)
    kcl, scl = _fast_forward(kcl, s_e, closure_ok, bound, cols, n, nr)
    segs = [(k2.reshape(-1), m2.reshape(-1, MW), cm2.reshape(-1, MCX),
             s2.reshape(-1), valid.reshape(-1)),
            (kcl, mcl, cm_e, scl, closure_ok)]

    # [E, CR] crashed grid with the canonical-order prune
    if CR:
        cinv, cps = cols["cinv"], cols["cps"]
        cidx = torch.arange(CR, device=dev)
        ccand = (a_e[:, None] & ~closure_ok[:, None]
                 & (cinv[None, :] < ret_k[:, None]) & ~_bit(cm_e, cidx))
        prevc = cps.clamp(0, CR - 1).long()
        redundant = ((cps >= 0)[None, :]
                     & (cinv[prevc][None, :] < ret_k[:, None])
                     & ~_bit(cm_e, prevc))
        ccand = ccand & ~redundant
        cs2, cok = step(s_e[:, None], cols["cf"][None, :],
                        cols["cv1"][None, :], cols["cv2"][None, :])
        cvalid = ccand & cok & (cs2 != s_e[:, None])
        ccm2 = cm_e[:, None, :] | _bitmat(CR, MCX, dev)[None]
        segs.append((k_e[:, None].expand(E, CR).reshape(-1),
                     m_e[:, None, :].expand(E, CR, MW).reshape(-1, MW),
                     ccm2.reshape(-1, MCX), cs2.reshape(-1),
                     cvalid.reshape(-1)))

    # the unexpanded pool remainder
    segs.append((pool.k[E:], _u(pool.mask[E:]), _u(pool.cmask[E:]),
                 pool.state[E:], pool.alive[E:]))
    fk, fm, fcm, fs, fv = (torch.cat([s[i] for s in segs]) for i in range(5))
    depth = fk + _popc(fm).sum(1)
    key1 = torch.where(fv, MAXK - depth, MAXK + 1 + fk)
    pc = _popc(fcm).sum(1)
    body = torch.cat([key1[:, None], fk[:, None], _s(fm), fs[:, None],
                      pc[:, None], _s(fcm)], dim=1).to(torch.int32)
    rows[:R] = body
    rows[R:] = 0
    rows[R:, 0] = INT32_MAX


def _crash_bound(cm_e: torch.Tensor, cols: dict,
                 shape: LevelShape) -> torch.Tensor:
    """Per row, the first frontier whose return exceeds the smallest
    untaken crashed invocation (tpu.py:294-306)."""
    E = cm_e.shape[0]
    if not shape.CR:
        return torch.full((E,), shape.n, dtype=torch.int64,
                          device=cm_e.device)
    cinv = cols["cinv"]
    ctk = _bit(cm_e, torch.arange(shape.CR, device=cm_e.device))
    umin = torch.where(ctk, RET_INF, cinv[None, :]).min(1).values
    return torch.searchsorted(cols["ret"], umin.contiguous(), right=True)


def _fast_forward(kk, ss, go, bound, cols, n: int, nr: int):
    """Advance rows through runs of forced ops (tpu.py:308-346)."""
    f, v1, v2, fr = cols["f"], cols["v1"], cols["v2"], cols["fr"]
    kk, ss, go = kk.clone(), ss.clone(), go.clone()
    while bool(go.any()):
        kc = kk.clamp(0, n - 1).long()
        s2, ok = cas_register_step_torch(ss, f[kc], v1[kc], v2[kc])
        go = go & (fr[kc] > 0) & (kk < bound) & (kk < nr) & ok
        kk = kk + go.to(kk.dtype)
        ss = torch.where(go, s2, ss)
    return kk, ss


def _unsigned_word(w: int, MW: int) -> bool:
    return 2 <= w < 2 + MW or w >= 4 + MW   # mask and cmask words


def _sort_keys(rows: torch.Tensor, MW: int):
    """The row's lex order as int64 keys, two 32-bit words per key: the
    high word as a signed value, the low word offset into [0, 2**32)."""
    keys = []
    for w in range(0, rows.shape[1], 2):
        hi = rows[:, w].to(torch.int64)
        if _unsigned_word(w, MW):
            hi = (hi & U32) - 2**31
        if w + 1 == rows.shape[1]:
            keys.append(hi)
            break
        lo = rows[:, w + 1].to(torch.int64)
        lo = lo & U32 if _unsigned_word(w + 1, MW) else lo + 2**31
        keys.append(hi * 2**32 + lo)
    return keys


def sort_rows_plain(rows: torch.Tensor, scal: torch.Tensor,
                    shape: LevelShape) -> None:
    """Plain version of ``sort_rows``: the lex order of tpu.py:574-588, by
    stable sorts from the last key to the first."""
    if not bool(scal[ACT]):
        return
    keys = _sort_keys(rows, shape.MW)
    perm = torch.arange(rows.shape[0], device=rows.device)
    for key in reversed(keys):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    rows.copy_(rows[perm])


def _same_grp(rows: torch.Tensor, MW: int) -> torch.Tensor:
    """Row i has the (key1, k, mask, state) of row i-1, both valid."""
    fv = rows[:, 0] <= MAXK
    eq = (rows[1:, :3 + MW] == rows[:-1, :3 + MW]).all(1)
    out = torch.zeros_like(fv)
    out[1:] = eq & fv[1:] & fv[:-1]
    return out


def group_scan_plain(rows: torch.Tensor, scal: torch.Tensor,
                     g: torch.Tensor, shape: LevelShape) -> None:
    """Plain version of ``group_scan``: g[i] = index of row i's group
    start, ``cummax(where(same_grp, 0, i))`` (tpu.py:605)."""
    if not bool(scal[ACT]):
        return
    iota = torch.arange(rows.shape[0], device=rows.device,
                        dtype=torch.int32)
    v = torch.where(_same_grp(rows, shape.MW), 0, iota)
    g.copy_(torch.cummax(v, 0).values)


def dedup_truncate_plain(rows: torch.Tensor, g: torch.Tensor,
                         pool_in: Pool, pool_out: Pool, pk: torch.Tensor,
                         ps: torch.Tensor, pa: torch.Tensor,
                         scal: torch.Tensor, acc: torch.Tensor,
                         stats: torch.Tensor, shape: LevelShape,
                         nr: int) -> None:
    """Plain version of ``dedup_truncate`` (tpu.py:589-664)."""
    if not bool(scal[ACT]):
        pool_out.copy_(pool_in)
        return
    C, R, MW, MCX = shape.C, shape.R, shape.MW, shape.MCX
    rw = rows[:R]
    key1, fk, fs = rw[:, 0], rw[:, 1], rw[:, 2 + MW]
    fcm = _u(rw[:, 4 + MW:])
    fv = key1 <= MAXK
    same = _same_grp(rw, MW)
    cm_eq = torch.zeros_like(same)
    cm_eq[1:] = (rw[1:, 4 + MW:] == rw[:-1, 4 + MW:]).all(1)
    dup = same & cm_eq
    dominated = torch.zeros_like(fv)
    if shape.CR:
        iota = torch.arange(R, device=rows.device)
        gr = g[:R].long()
        for p in range(LEADERS):
            li = (gr + p).clamp(max=R - 1)
            lead = ((rw[li, :3 + MW] == rw[:, :3 + MW]).all(1)
                    & (li < iota) & fv)
            subset = ((fcm & fcm[li]) == fcm[li]).all(1)
            dominated |= lead & subset
    uniq = fv & ~dup & ~dominated

    pk.copy_(pool_in.k)
    ps.copy_(pool_in.state)
    pa.copy_(pool_in.alive)
    pool_out.k.copy_(fk[:C])
    pool_out.mask.copy_(rw[:C, 2:2 + MW])
    pool_out.cmask.copy_(rw[:C, 4 + MW:4 + MW + MCX])
    pool_out.state.copy_(fs[:C])
    pool_out.alive.copy_(uniq[:C])

    i32 = torch.int32
    frontier = uniq[:C].sum(dtype=i32)
    row = scal[LEVEL].clamp(0, shape.lmax).long()
    stats[row] = torch.stack([acc[A_EXPANDED], dup.sum(dtype=i32),
                              dominated.sum(dtype=i32),
                              uniq[C:].sum(dtype=i32), frontier])
    scal[DONE] |= (fv & (fk >= nr)).any().to(i32)
    scal[LOSSY] |= uniq[C:].any().to(i32)
    scal[LEVEL] += 1
    scal[BEST] = torch.maximum(scal[BEST],
                               torch.where(fv, fk, 0).max().to(i32))
    scal[NALIVE] = frontier
    acc.zero_()


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _on_cpu(tensors) -> bool:
    """Dispatch by device: True for all-CPU tensors, False for all-CUDA
    tensors; anything else raises."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return True
    if types == {"cuda"}:
        return False
    raise ValueError(f"kernel inputs must all lie on the CPU or all on "
                     f"one CUDA device, got {sorted(types)}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_pool(pool: Pool, name: str, shape: LevelShape) -> None:
    C = shape.C
    _check(pool.k, f"{name}.k", torch.int32, (C,))
    _check(pool.mask, f"{name}.mask", torch.int32, (C, shape.MW))
    _check(pool.cmask, f"{name}.cmask", torch.int32, (C, shape.MCX))
    _check(pool.state, f"{name}.state", torch.int32, (C,))
    _check(pool.alive, f"{name}.alive", torch.bool, (C,))


def _check_level(rows, scal, acc, shape: LevelShape) -> None:
    _check(rows, "rows", torch.int32, (shape.RP, shape.NK))
    _check(scal, "scal", torch.int32, (NSCAL,))
    _check(acc, "acc", torch.int32, (NACC,))


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launch(name: str, fn, *args) -> None:
    from jepsen_tpu_torch.kernels import build
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: "
                           f"{build.error_string(rc)}")
    launches[name] += 1


def _lib():
    from jepsen_tpu_torch.kernels import build
    return build.load()


def expand(cols: dict, pool: Pool, scal: torch.Tensor, acc: torch.Tensor,
           rows: torch.Tensor, shape: LevelShape, nr: int) -> None:
    """Expand the top E pool rows into the R merged rows."""
    n, CR = shape.n, shape.CR
    for c in COLS:
        width = n + 1 if c == "sm" else (n if c in COLS[:8] else CR)
        _check(cols[c], c, torch.int32, (width,))
    _check_pool(pool, "pool", shape)
    _check_level(rows, scal, acc, shape)
    tensors = [cols[c] for c in COLS] + list(pool.tensors()) + [scal, acc,
                                                                rows]
    if _on_cpu(tensors):
        expand_plain(cols, pool, scal, acc, rows, shape, nr)
        return
    lib = _lib()
    _launch("expand", lib.jt_expand,
            *[_ptr(t) for t in tensors],
            shape.C, shape.W, shape.E, n, CR, nr, shape.lmax,
            _stream(rows))


def sort_rows(rows: torch.Tensor, scal: torch.Tensor,
              shape: LevelShape) -> None:
    """Sort the padded rows in place in lex order."""
    _check(rows, "rows", torch.int32, (shape.RP, shape.NK))
    _check(scal, "scal", torch.int32, (NSCAL,))
    if _on_cpu([rows, scal]):
        sort_rows_plain(rows, scal, shape)
        return
    _launch("sort_rows", _lib().jt_sort_rows, _ptr(rows), _ptr(scal),
            shape.RP, shape.NK, shape.MW, _stream(rows))


def group_scan(rows: torch.Tensor, scal: torch.Tensor, g: torch.Tensor,
               gagg: torch.Tensor, shape: LevelShape) -> None:
    """Write each sorted row's group start into g; ``gagg`` is the
    kernel's scratch for per-block maxima."""
    _check(rows, "rows", torch.int32, (shape.RP, shape.NK))
    _check(scal, "scal", torch.int32, (NSCAL,))
    _check(g, "g", torch.int32, (shape.RP,))
    _check(gagg, "gagg", torch.int32, (scan_blocks(shape.RP),))
    if _on_cpu([rows, scal, g, gagg]):
        group_scan_plain(rows, scal, g, shape)
        return
    _launch("group_scan", _lib().jt_group_scan, _ptr(rows), _ptr(scal),
            _ptr(g), _ptr(gagg), shape.RP, shape.NK, shape.MW,
            _stream(rows))


def scan_blocks(RP: int) -> int:
    """Blocks the group-scan kernel uses for RP rows (1024 rows each)."""
    return max(1, RP // 1024)


def dedup_truncate(rows: torch.Tensor, g: torch.Tensor, pool_in: Pool,
                   pool_out: Pool, pk: torch.Tensor, ps: torch.Tensor,
                   pa: torch.Tensor, scal: torch.Tensor, acc: torch.Tensor,
                   stats: torch.Tensor, shape: LevelShape, nr: int) -> None:
    """Kill dups and dominated rows, truncate to C rows into ``pool_out``,
    and finish the level's scalars and counters."""
    C = shape.C
    _check_level(rows, scal, acc, shape)
    _check(g, "g", torch.int32, (shape.RP,))
    _check_pool(pool_in, "pool_in", shape)
    _check_pool(pool_out, "pool_out", shape)
    _check(pk, "pk", torch.int32, (C,))
    _check(ps, "ps", torch.int32, (C,))
    _check(pa, "pa", torch.bool, (C,))
    _check(stats, "stats", torch.int32, (shape.lmax + 1, NSTAT))
    tensors = ([rows, g] + list(pool_in.tensors())
               + list(pool_out.tensors()) + [pk, ps, pa, scal, acc, stats])
    if _on_cpu(tensors):
        dedup_truncate_plain(rows, g, pool_in, pool_out, pk, ps, pa, scal,
                             acc, stats, shape, nr)
        return
    _launch("dedup_truncate", _lib().jt_dedup_truncate,
            *[_ptr(t) for t in tensors],
            C, shape.W, shape.CR, shape.R, nr, shape.lmax, _stream(rows))
