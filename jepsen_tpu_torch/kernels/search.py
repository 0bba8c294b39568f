"""The kernels of one search level: wrappers, plain versions, counts.

One level of the pool search (``jepsen_tpu/checker/tpu.py`` ``_search_fn``
body, one ``lax.while_loop`` iteration) is three or four kernels in
``csrc/search.cu``:

==================  =====================================================
``expand``          B1-B4: the [E, W] required grid, the pure-op closure,
                    the frontier advance with its forced fast-forward, the
                    [E, CR] crashed grid, the pool remainder; writes R
                    sortable rows (a warp per expanded row)
``sort_rows``       B5 (lex) or B5' (hash): merge sort of the R live
                    rows (the pad tail after them is already in place)
``group_scan``      B6: the cummax group-start scan over the sorted rows,
                    only where there are crashed ops; a launch of its own
                    only on the wide rungs (:func:`group_scan_runs`), in
                    ``dedup_truncate``'s shared memory elsewhere
``dedup_truncate``  B6/B7: dup and 8-leader dominance kills, done/best,
                    first-C truncation into the other pool buffer, lossy,
                    the five per-level counters, level+1, pk/ps/pa (a
                    block per key while the rows fit one sort tile,
                    :func:`dedup_one_block`)
==================  =====================================================

The model is part of the shape: ``expand`` steps each candidate through
the model's step (B1/B1'), a template parameter of the CUDA kernel picked
once per launch, and through the spec's ``step_torch`` in the plain
version. The other three kernels never look at the state's meaning.

Every tensor has a leading key axis of ``B`` independent searches: the
keyed batch (``jax.vmap`` of the search body in the reference) runs B
keys per launch, and the single-history search is ``B = 1``. Each key has
its own required-op count ``nr`` (an int32 tensor [B] on the device) and
its own ``active`` flag, so a finished key's levels change nothing while
the others go on.

Each wrapper checks its tensors and dispatches on their device: CPU
tensors run the plain PyTorch version beside it, CUDA tensors launch the
kernel on the current stream (or raise; there is no fallback). Each
launch adds one to ``launches[name]``, and the CUDA launches it issued,
as the C entry point counts them where it makes them (the sort's merge
passes are launches of their own; the count :func:`grid_launches`
predicts), to ``grid_launches_total[name]``. The
plain versions take CUDA tensors too when called directly, which is how
the kernels are held against them on the card.

Row layout (int32 words, ``NK = 4 + MW + MCX``)::

    key1, k, mask[MW], state, popcount(cmask), cmask[MCX]

Mask words are uint32 bit patterns stored in int32 tensors; the plain
versions widen them to int64 in [0, 2**32) wherever order, shifts or
products must be unsigned (torch has no uint32 ``<``, ``>>`` or ``*`` on
the CPU).

Device-side level state per key, shared by all four kernels:

* ``scal`` int32[B, 8]: done, lossy, wovf, level, best_k, live pool rows,
  this level's ``active`` flag, spare;
* ``acc`` int32[B, 9]: per-level accumulators (done, best, lossy,
  expanded, dup, dominated, trunc, frontier, block ticket), zero between
  levels.

``expand`` computes ``active = ~done & any(alive) & level <= LMAX`` per
key and stores it; every later kernel of the level no-ops for a key whose
flag is false, and ``dedup_truncate`` then copies that key's pool through
unchanged: the masked update, tested on the device with no host
synchronisation.

A segment of levels (B9, the reference's ``lax.while_loop(seg_active,
body_n, carry)``) is a CUDA graph. ``seg_active`` (K5) ends each pair of
levels: it adds the levels the pair ran to the segment's counter and
decides whether any key is active and the segment under its bound, in the
int32 words ``seg`` (levels run, bound, go, ticket). :class:`SegmentGraph`
captures a level pair once, as the body of a WHILE graph node, and the
pair's second ``dedup_truncate`` runs K5's step at its end and sets the
node's condition, so a whole segment is one graph launch with no host
code between levels. ``seg_active`` standing alone is the step of the
host loop.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from jepsen_tpu_torch.models.core import KERNELS as _SPECS
from jepsen_tpu_torch.ops.encode import RET_INF as _RET_INF

MAXK = 1 << 30
RET_INF = int(_RET_INF)
INT32_MAX = 2**31 - 1
U32 = 0xFFFFFFFF
#: group-prefix rows tested as dominators
LEADERS = 8
#: per-level counters: expanded, dup, dominated, trunc, frontier
NSTAT = 5
#: sort tie-breaks: the whole row (lex), or key1 then a 32-bit mix of
#: (k, mask, state) (hash, the keyed batch's first rungs)
TIEBREAKS = ("lex", "hash")
#: the most keys one launch takes (the grid's y extent)
MAX_KEYS = 65535
#: the dynamic shared memory one block may use on the H100 (227 KB), and
#: the most rows one sort tile holds (its row slots are 16-bit)
SMEM_MAX = 232448
TILE_MAX = 4096
#: the models K1 steps, by KernelSpec name; a model's code is its index
#: (the template argument of ``expand_kernel`` in csrc/search.cu)
MODELS = tuple(spec.name for spec in _SPECS)
#: each model's torch step, the plain version's
STEPS = {spec.name: spec.step_torch for spec in _SPECS}

# scal lanes
DONE, LOSSY, WOVF, LEVEL, BEST, NALIVE, ACT = range(7)
NSCAL = 8
# acc lanes
(A_DONE, A_BEST, A_LOSSY, A_EXPANDED, A_DUP, A_DOM, A_TRUNC, A_FRONTIER,
 A_TICKET) = range(9)
NACC = 9

#: the history's columns the kernels take: the reference's 13, then
#: ``cb``, each crashed op's crash bound (``checker/gpu.py``
#: ``crash_bounds``), which ``expand`` reads in place of a search over ret
COLS = ("f", "v1", "v2", "ro", "fr", "inv", "ret", "sm", "cf", "cv1",
        "cv2", "cinv", "cps", "cb")

#: the words of a segment's ``seg`` tensor (int32 [NSEG]): levels run so
#: far, the segment's bound in levels, whether to run another pair, and
#: the word a batch's keys end a pair on inside the graph (tickets in its
#: low bits, the keys' ran and active flags in bits 30 and 31; 0 between
#: pairs)
SEG_RUN, SEG_BOUND, SEG_GO, SEG_TICKET = range(4)
NSEG = 4
#: rows a block of the ``group_scan`` kernel scans; ``gagg`` holds one
#: maximum per block
SCAN_ROWS = 1024
#: ``dedup_truncate``'s one-block kernel's static shared memory: per-warp
#: sums (32 x 6 ints) and the group-start scan's warp maxima (32 ints)
DEDUP_BLOCK_STATIC = 4 * (32 * 6 + 32)

#: launches of each kernel since the last :func:`reset_launches`: a
#: wrapper call, or a level a segment graph ran where its body launches
#: the kernel, as read from the device (a graph launches no
#: ``seg_active``: K5's step ends each pair in its second
#: ``dedup_truncate``, counted in ``segments["pair_ends"]``); the sort
#: counts its lex and its hash tie-break apart
launches: Dict[str, int] = {"expand": 0, "sort_rows": 0,
                            "sort_rows_hash": 0, "group_scan": 0,
                            "dedup_truncate": 0, "seg_active": 0}
#: the CUDA kernel launches those made, as the C entry points count them
#: where they launch (in a graph: the body's count at capture, times the
#: iterations the device ran)
grid_launches_total: Dict[str, int] = dict.fromkeys(launches, 0)
#: calls from Python into the kernel library: one per wrapper call, and
#: one per kernel a segment graph captures (not one per level it runs)
host_calls: Dict[str, int] = dict.fromkeys(launches, 0)
#: segment graphs captured and launched, the levels they ran, and the
#: level pairs their second ``dedup_truncate`` ended with K5's step
segments: Dict[str, int] = {"captures": 0, "launches": 0, "levels": 0,
                            "pair_ends": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        grid_launches_total[name] = 0
        host_calls[name] = 0
    for name in segments:
        segments[name] = 0


@dataclass(frozen=True)
class LevelShape:
    """Static shape of a batch of searches: pool capacity C, window W,
    expansion E, padded required ops n, padded crashed ops CR, keys B, the
    sort's tie-break and the model (a KernelSpec name) whose step the
    expansion runs."""

    C: int
    W: int
    E: int
    n: int
    CR: int
    B: int = 1
    tiebreak: str = "lex"
    model: str = "cas-register"

    def __post_init__(self):
        if self.model not in MODELS:
            raise ValueError(f"model must be one of {MODELS}, got "
                             f"{self.model!r}")
        if self.tiebreak not in TIEBREAKS:
            raise ValueError(f"tiebreak must be one of {TIEBREAKS}, got "
                             f"{self.tiebreak!r}")
        if not 1 <= self.B <= MAX_KEYS:
            raise ValueError(f"B = {self.B} keys: a launch takes 1 to "
                             f"{MAX_KEYS}")

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
    """C search configurations (k, mask, cmask, state) and their liveness
    for each of B keys."""

    k: torch.Tensor       # int32 [B, C]
    mask: torch.Tensor    # int32 [B, C, MW]
    cmask: torch.Tensor   # int32 [B, C, MCX]
    state: torch.Tensor   # int32 [B, C]
    alive: torch.Tensor   # bool [B, C]

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


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for int64 x in [0, 2**32), in two 16-bit halves of
    c so that no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def _popc(x: torch.Tensor) -> torch.Tensor:
    """Population count of int64 words in [0, 2**32) (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32) >> 24


def _trailing_ones(m: torch.Tensor) -> torch.Tensor:
    """Trailing one-bits across a whole [..., MW] mask."""
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
    """Bit o of each row's mask: m [..., MW] int64, o [X] -> bool [..., X]."""
    return ((m[..., o >> 5] >> (o & 31)) & 1) == 1


def _bit_at(m: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Bit o[b, x] of key b's rows: m [B, E, MW] int64, o [B, X] -> bool
    [B, E, X]."""
    B, E = m.shape[:2]
    words = m.gather(2, (o >> 5)[:, None, :].expand(B, E, -1))
    return ((words >> (o & 31)[:, None, :]) & 1) == 1


def _bitmat(width: int, words: int, device) -> torch.Tensor:
    """[width, words] int64: row o has bit o of the mask set."""
    o = torch.arange(width, device=device)
    out = torch.zeros(width, words, dtype=torch.int64, device=device)
    out[o, o >> 5] = 1 << (o & 31)
    return out


def _take(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Key b's column entries: col [B, m], idx [B, ...] -> [B, ...]."""
    B = col.shape[0]
    return col.gather(1, idx.reshape(B, -1).long()).reshape(idx.shape)


def active(scal: torch.Tensor, lmax: int) -> torch.Tensor:
    """Per key: not done, some pool row alive, the level budget not spent
    (int32 [B])."""
    return ((scal[:, DONE] == 0) & (scal[:, NALIVE] > 0)
            & (scal[:, LEVEL] <= lmax)).to(torch.int32)


def seg_active_plain(scal: torch.Tensor, lmax: int,
                     seg: torch.Tensor) -> None:
    """Plain version of ``seg_active`` (K5), after a level pair: adds the
    levels the pair ran to ``seg[SEG_RUN]`` (the first always ran; the
    second if some key's ``expand`` found it active), then sets
    ``seg[SEG_GO] = any(active(scal, lmax)) & (run < bound)``."""
    ran = (scal[:, ACT] != 0).any().to(torch.int32)
    run = seg[SEG_RUN] + 1 + ran
    go = active(scal, lmax).any() & (run < seg[SEG_BOUND])
    seg[SEG_RUN] = run
    seg[SEG_GO] = go.to(torch.int32)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def expand_plain(cols: dict, pool: Pool, scal: torch.Tensor,
                 acc: torch.Tensor, rows: torch.Tensor, shape: LevelShape,
                 nr: torch.Tensor) -> None:
    """Plain version of the ``expand`` kernel (tpu.py:380-506)."""
    B, C, W, E, n, CR = shape.B, shape.C, shape.W, shape.E, shape.n, shape.CR
    MW, MCX, R = shape.MW, shape.MCX, shape.R
    dev = rows.device
    step = STEPS[shape.model]
    act = active(scal, shape.lmax)
    scal[:, ACT] = act
    act = act.bool()
    if not bool(act.any()):
        return
    f, v1, v2, ro, fr = (cols[c] for c in ("f", "v1", "v2", "ro", "fr"))
    inv, ret, sm = cols["inv"], cols["ret"], cols["sm"]
    k_e, s_e, a_e = pool.k[:, :E], pool.state[:, :E], pool.alive[:, :E]
    m_e, cm_e = _u(pool.mask[:, :E]), _u(pool.cmask[:, :E])
    acc[:, A_EXPANDED] += torch.where(act, a_e.sum(1, dtype=torch.int32), 0)

    # window-overflow probe
    ret_k = _take(ret, k_e.clamp(0, n - 1))
    beyond = _take(sm, (k_e + W).clamp(0, n))
    scal[:, WOVF] |= (act & (a_e & (beyond < ret_k)).any(1)).to(torch.int32)

    # [B, E, W] required grid
    offs = torch.arange(W, device=dev)
    j = k_e[..., None] + offs
    jc = j.clamp(0, n - 1)
    cand = (a_e[..., None] & (j < n) & (_take(inv, jc) < ret_k[..., None])
            & ~_bit(m_e, offs))
    s2, ok = step(s_e[..., None], _take(f, jc), _take(v1, jc),
                  _take(v2, jc))
    pure = cand & ok & (_take(ro, jc) > 0)
    valid = cand & ok & ~pure

    # closure successor: all pure candidates at once
    bitmat = _bitmat(W, MW, dev)
    pure_bits = (pure[..., None].to(torch.int64) * bitmat).sum(-2)
    mc_ = m_e | pure_bits
    tc_ = _trailing_ones(mc_)
    kcl = k_e + tc_
    mcl = _shr_by(mc_, tc_)
    closure_ok = a_e & pure.any(-1)
    valid = valid & ~closure_ok[..., None]

    # frontier advance for offset 0, with the forced fast-forward
    m1 = _shr1(m_e)
    t = _trailing_ones(m1)
    k_adv = k_e + 1 + t
    m_adv = _shr_by(m1, t)
    bound = _crash_bound(cm_e, cols, shape)
    live = act[:, None]
    k_adv, s0 = _fast_forward(k_adv, s2[..., 0], valid[..., 0] & live,
                              bound, cols, n, nr, step)
    s2 = s2.clone()
    s2[..., 0] = s0
    is0 = offs == 0
    k2 = torch.where(is0, k_adv[..., None], k_e[..., None])
    m2 = torch.where(is0[:, None], m_adv[:, :, None, :],
                     m_e[:, :, None, :] | bitmat)
    cm2 = cm_e[:, :, None, :].expand(B, E, W, MCX)
    kcl, scl = _fast_forward(kcl, s_e, closure_ok & live, bound, cols, n,
                             nr, step)
    segs = [(k2.reshape(B, -1), m2.reshape(B, -1, MW),
             cm2.reshape(B, -1, MCX), s2.reshape(B, -1),
             valid.reshape(B, -1)),
            (kcl, mcl, cm_e, scl, closure_ok)]

    # [B, E, CR] crashed grid with the canonical-order prune
    if CR:
        cinv, cps = cols["cinv"], cols["cps"]
        cidx = torch.arange(CR, device=dev)
        ccand = (a_e[..., None] & ~closure_ok[..., None]
                 & (cinv[:, None, :] < ret_k[..., None])
                 & ~_bit(cm_e, cidx))
        prevc = cps.clamp(0, CR - 1).long()
        redundant = ((cps >= 0)[:, None, :]
                     & (cinv.gather(1, prevc)[:, None, :] < ret_k[..., None])
                     & ~_bit_at(cm_e, prevc))
        ccand = ccand & ~redundant
        cs2, cok = step(s_e[..., None], cols["cf"][:, None, :],
                        cols["cv1"][:, None, :], cols["cv2"][:, None, :])
        cvalid = ccand & cok & (cs2 != s_e[..., None])
        ccm2 = cm_e[:, :, None, :] | _bitmat(CR, MCX, dev)
        segs.append((k_e[..., None].expand(B, E, CR).reshape(B, -1),
                     m_e[:, :, None, :].expand(B, E, CR, MW)
                     .reshape(B, -1, MW),
                     ccm2.reshape(B, -1, MCX), cs2.reshape(B, -1),
                     cvalid.reshape(B, -1)))

    # the unexpanded pool remainder
    segs.append((pool.k[:, E:], _u(pool.mask[:, E:]),
                 _u(pool.cmask[:, E:]), pool.state[:, E:],
                 pool.alive[:, E:]))
    fk, fm, fcm, fs, fv = (torch.cat([sg[i] for sg in segs], dim=1)
                           for i in range(5))
    depth = fk + _popc(fm).sum(-1)
    key1 = torch.where(fv, MAXK - depth, MAXK + 1 + fk)
    pc = _popc(fcm).sum(-1)
    body = torch.cat([key1[..., None], fk[..., None], _s(fm), fs[..., None],
                      pc[..., None], _s(fcm)], dim=-1).to(torch.int32)
    new = torch.zeros_like(rows)
    new[:, :R] = body
    new[:, R:, 0] = INT32_MAX
    rows.copy_(torch.where(act[:, None, None], new, rows))


def _crash_bound(cm_e: torch.Tensor, cols: dict,
                 shape: LevelShape) -> torch.Tensor:
    """Per row, the first frontier whose return exceeds the smallest
    untaken crashed invocation (tpu.py:294-306)."""
    if not shape.CR:
        return torch.full(cm_e.shape[:2], shape.n, dtype=torch.int64,
                          device=cm_e.device)
    cinv = cols["cinv"]
    ctk = _bit(cm_e, torch.arange(shape.CR, device=cm_e.device))
    umin = torch.where(ctk, RET_INF, cinv[:, None, :]).min(-1).values
    return torch.searchsorted(cols["ret"], umin.contiguous(), right=True)


def _fast_forward(kk, ss, go, bound, cols, n: int, nr: torch.Tensor, step):
    """Advance rows [B, E] through runs of forced ops with the model's
    ``step`` (tpu.py:308-346)."""
    f, v1, v2, fr = cols["f"], cols["v1"], cols["v2"], cols["fr"]
    kk, ss, go = kk.clone(), ss.clone(), go.clone()
    nr = nr[:, None]
    while bool(go.any()):
        kc = kk.clamp(0, n - 1)
        s2, ok = step(ss, _take(f, kc), _take(v1, kc), _take(v2, kc))
        go = go & (_take(fr, kc) > 0) & (kk < bound) & (kk < nr) & ok
        kk = kk + go.to(kk.dtype)
        ss = torch.where(go, s2, ss)
    return kk, ss


def _unsigned_word(w: int, MW: int) -> bool:
    return 2 <= w < 2 + MW or w >= 4 + MW   # mask and cmask words


def row_hash_plain(rows: torch.Tensor, MW: int) -> torch.Tensor:
    """The hash tie-break's mix of (k, mask, state) per row (tpu.py:552),
    as int64 in [0, 2**32)."""
    h = _mul32(_u(rows[..., 1]), 0x9E3779B9)
    for w in range(MW):
        h = _mul32(h ^ _u(rows[..., 2 + w]), 0x85EBCA6B)
        h = h ^ (h >> 13)
    h = _mul32(h ^ _u(rows[..., 2 + MW]), 0xC2B2AE35)
    return h ^ (h >> 16)


def _order_words(rows: torch.Tensor, shape: LevelShape):
    """The comparator's words in order, each as int64 in [0, 2**32) that
    orders as the word does (signed words offset by 2**31). lex: the row
    in row order. hash: key1, h, popcount, cmask, k, mask, state."""
    MW, NK = shape.MW, shape.NK

    def word(w):
        x = rows[..., w].to(torch.int64)
        return x & U32 if _unsigned_word(w, MW) else x + 2**31

    if shape.tiebreak == "lex":
        return [word(w) for w in range(NK)]
    return ([word(0), row_hash_plain(rows, MW)]
            + [word(w) for w in range(3 + MW, NK)]
            + [word(w) for w in range(1, 3 + MW)])


def _sort_keys(rows: torch.Tensor, shape: LevelShape):
    """The comparator's order as int64 keys, two 32-bit words per key."""
    words = _order_words(rows, shape)
    keys = []
    for i in range(0, len(words), 2):
        hi = words[i] - 2**31
        keys.append(hi if i + 1 == len(words)
                    else hi * 2**32 + words[i + 1])
    return keys


def sort_rows_plain(rows: torch.Tensor, scal: torch.Tensor,
                    shape: LevelShape) -> None:
    """Plain version of ``sort_rows``: each active key's rows in the
    comparator's order (lex, tpu.py:574-588; hash, tpu.py:528-570), by
    stable sorts from the last key to the first."""
    act = scal[:, ACT] != 0
    if not bool(act.any()):
        return
    keys = _sort_keys(rows, shape)
    perm = torch.arange(rows.shape[1], device=rows.device).expand(
        rows.shape[0], -1)
    for key in reversed(keys):
        perm = perm.gather(1, torch.sort(key.gather(1, perm), dim=1,
                                         stable=True).indices)
    out = rows.gather(1, perm[..., None].expand(-1, -1, rows.shape[2]))
    rows.copy_(torch.where(act[:, None, None], out, rows))


def _same_grp(rows: torch.Tensor, MW: int) -> torch.Tensor:
    """Row i has the (key1, k, mask, state) of row i-1, both valid."""
    fv = rows[..., 0] <= MAXK
    eq = (rows[:, 1:, :3 + MW] == rows[:, :-1, :3 + MW]).all(-1)
    out = torch.zeros_like(fv)
    out[:, 1:] = eq & fv[:, 1:] & fv[:, :-1]
    return out


def _start_marks(rows: torch.Tensor, MW: int) -> torch.Tensor:
    """``where(same_grp, 0, i)`` over rows [B, R, NK]: int32 [B, R]."""
    iota = torch.arange(rows.shape[1], device=rows.device,
                        dtype=torch.int32)
    return torch.where(_same_grp(rows, MW), 0, iota)


def group_scan_plain(rows: torch.Tensor, scal: torch.Tensor,
                     g: torch.Tensor, gagg: torch.Tensor,
                     shape: LevelShape) -> None:
    """Plain version of ``group_scan`` over each active key's R live rows,
    in blocks of SCAN_ROWS rows: g[b, i] the group starts' scan (tpu.py:605)
    within row i's block, and gagg[b, q] the largest start in block q; the
    form ``dedup_truncate`` reads them in (:func:`group_starts`)."""
    act = scal[:, ACT] != 0
    if not bool(act.any()):
        return
    B, R, nb = rows.shape[0], shape.R, gagg.shape[1]
    v = _start_marks(rows[:, :R], shape.MW)
    pad = torch.zeros(B, nb * SCAN_ROWS - R, dtype=v.dtype, device=v.device)
    scan = torch.cummax(torch.cat([v, pad], 1).view(B, nb, SCAN_ROWS),
                        2).values
    g[:, :R] = torch.where(act[:, None], scan.view(B, -1)[:, :R], g[:, :R])
    gagg.copy_(torch.where(act[:, None], scan[..., -1], gagg))


def group_starts(g: torch.Tensor, gagg: torch.Tensor, R: int
                 ) -> torch.Tensor:
    """Each of the R rows' group start from ``group_scan``'s outputs: the
    scan within its block raised to the largest start of the blocks before
    (the carry ``dedup_truncate`` applies where it reads g), int32
    [B, R]."""
    B = gagg.shape[0]
    before = torch.cummax(gagg, 1).values[:, :-1]
    carry = torch.cat([torch.zeros(B, 1, dtype=gagg.dtype,
                                   device=gagg.device), before], 1)
    return torch.maximum(g[:, :R],
                         carry.repeat_interleave(SCAN_ROWS, 1)[:, :R])


def dedup_truncate_plain(rows: torch.Tensor, g: torch.Tensor,
                         gagg: torch.Tensor, pool_in: Pool, pool_out: Pool,
                         pk: torch.Tensor, ps: torch.Tensor,
                         pa: torch.Tensor, scal: torch.Tensor,
                         acc: torch.Tensor, stats: Optional[torch.Tensor],
                         shape: LevelShape, nr: torch.Tensor,
                         seg: Optional[torch.Tensor] = None) -> None:
    """Plain version of ``dedup_truncate`` (tpu.py:589-664): the group
    starts from g and gagg, or, where the kernel scans them in its shared
    memory (:func:`group_scan_runs` false), from the rows; with ``seg``,
    then :func:`seg_active_plain` (the pair's second level). Without
    ``stats`` no counter row is written."""
    _dedup_levels(rows, g, gagg, pool_in, pool_out, pk, ps, pa, scal, acc,
                  stats, shape, nr)
    if seg is not None:
        seg_active_plain(scal, shape.lmax, seg)


def _dedup_levels(rows, g, gagg, pool_in, pool_out, pk, ps, pa, scal, acc,
                  stats, shape: LevelShape, nr) -> None:
    act = scal[:, ACT] != 0
    if not bool(act.any()):
        pool_out.copy_(pool_in)
        return
    C, R, MW, MCX = shape.C, shape.R, shape.MW, shape.MCX
    rw = rows[:, :R]
    key1, fk, fs = rw[..., 0], rw[..., 1], rw[..., 2 + MW]
    fcm = _u(rw[..., 4 + MW:])
    fv = key1 <= MAXK
    same = _same_grp(rw, MW)
    cm_eq = torch.zeros_like(same)
    cm_eq[:, 1:] = (rw[:, 1:, 4 + MW:] == rw[:, :-1, 4 + MW:]).all(-1)
    dup = same & cm_eq
    dominated = torch.zeros_like(fv)
    if shape.CR:
        iota = torch.arange(R, device=rows.device)
        # the group starts (tpu.py:605): K3's, or scanned here as the
        # kernel scans them in its shared memory
        gr = (group_starts(g, gagg, R) if group_scan_runs(shape)
              else torch.cummax(_start_marks(rw, MW), 1).values).long()
        for p in range(LEADERS):
            li = (gr + p).clamp(max=R - 1)
            rl = rw.gather(1, li[..., None].expand(-1, -1, rw.shape[2]))
            lead = ((rl[..., :3 + MW] == rw[..., :3 + MW]).all(-1)
                    & (li < iota) & fv)
            cl = _u(rl[..., 4 + MW:])
            subset = ((fcm & cl) == cl).all(-1)
            dominated |= lead & subset
    uniq = fv & ~dup & ~dominated

    a1 = act[:, None]
    a2 = act[:, None, None]
    pk.copy_(torch.where(a1, pool_in.k, pk))
    ps.copy_(torch.where(a1, pool_in.state, ps))
    pa.copy_(torch.where(a1, pool_in.alive, pa))
    pool_out.k.copy_(torch.where(a1, fk[:, :C], pool_in.k))
    pool_out.mask.copy_(torch.where(a2, rw[:, :C, 2:2 + MW], pool_in.mask))
    pool_out.cmask.copy_(torch.where(a2, rw[:, :C, 4 + MW:4 + MW + MCX],
                                     pool_in.cmask))
    pool_out.state.copy_(torch.where(a1, fs[:, :C], pool_in.state))
    pool_out.alive.copy_(torch.where(a1, uniq[:, :C], pool_in.alive))

    i32 = torch.int32
    frontier = uniq[:, :C].sum(1, dtype=i32)
    counts = torch.stack([acc[:, A_EXPANDED], dup.sum(1, dtype=i32),
                          dominated.sum(1, dtype=i32),
                          uniq[:, C:].sum(1, dtype=i32), frontier], dim=1)
    keys = act.nonzero()[:, 0]
    if stats is not None:
        row = scal[:, LEVEL].clamp(0, shape.lmax).long()
        stats[keys, row[keys]] = counts[keys]
    new = scal.clone()
    new[:, DONE] |= (fv & (fk >= nr[:, None])).any(1).to(i32)
    new[:, LOSSY] |= uniq[:, C:].any(1).to(i32)
    new[:, LEVEL] += 1
    new[:, BEST] = torch.maximum(scal[:, BEST],
                                 torch.where(fv, fk, 0).max(1).values
                                 .to(i32))
    new[:, NALIVE] = frontier
    scal.copy_(torch.where(a1, new, scal))
    acc[keys] = 0


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
    B, C = shape.B, shape.C
    _check(pool.k, f"{name}.k", torch.int32, (B, C))
    _check(pool.mask, f"{name}.mask", torch.int32, (B, C, shape.MW))
    _check(pool.cmask, f"{name}.cmask", torch.int32, (B, C, shape.MCX))
    _check(pool.state, f"{name}.state", torch.int32, (B, C))
    _check(pool.alive, f"{name}.alive", torch.bool, (B, C))


def _check_rows(rows, scal, shape: LevelShape) -> None:
    _check(rows, "rows", torch.int32, (shape.B, shape.RP, shape.NK))
    _check(scal, "scal", torch.int32, (shape.B, NSCAL))


def _check_nr(nr, shape: LevelShape) -> None:
    _check(nr, "nr", torch.int32, (shape.B,))


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _nptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """A tensor's pointer, or null for None (an optional buffer)."""
    return ctypes.c_void_p(None) if t is None else _ptr(t)


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launch(name: str, fn, *args) -> None:
    from jepsen_tpu_torch.kernels import build
    launched = ctypes.c_int(0)
    rc = fn(*args, ctypes.byref(launched))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: "
                           f"{build.error_string(rc)}")
    launches[name] += 1
    grid_launches_total[name] += launched.value
    host_calls[name] += 1


def _lib():
    from jepsen_tpu_torch.kernels import build
    return build.load()


def expand(cols: dict, pool: Pool, scal: torch.Tensor, acc: torch.Tensor,
           rows: torch.Tensor, shape: LevelShape, nr: torch.Tensor) -> None:
    """Expand each key's top E pool rows into its R merged rows; ``nr``
    is each key's required-op count."""
    B, n, CR = shape.B, shape.n, shape.CR
    for c in COLS:
        width = n + 1 if c == "sm" else (n if c in COLS[:8] else CR)
        _check(cols[c], c, torch.int32, (B, width))
    _check_nr(nr, shape)
    _check_pool(pool, "pool", shape)
    _check_rows(rows, scal, shape)
    _check(acc, "acc", torch.int32, (B, NACC))
    tensors = ([cols[c] for c in COLS] + [nr] + list(pool.tensors())
               + [scal, acc, rows])
    if _on_cpu(tensors):
        expand_plain(cols, pool, scal, acc, rows, shape, nr)
        return
    _launch("expand", _lib().jt_expand, *[_ptr(t) for t in tensors],
            B, shape.C, shape.W, shape.E, n, CR, shape.lmax,
            MODELS.index(shape.model), _stream(rows))


def sort_rows(rows: torch.Tensor, scal: torch.Tensor, shape: LevelShape,
              rows_alt: Optional[torch.Tensor] = None) -> None:
    """Sort each active key's rows in place in the order of
    ``shape.tiebreak``. ``rows_alt``, a second [B, RP, NK] buffer, is the
    merge passes' scratch: the kernel needs it when R exceeds one tile
    (:func:`sort_passes`), and a CUDA call without it then raises."""
    _check_rows(rows, scal, shape)
    tensors = [rows, scal]
    if rows_alt is not None:
        _check(rows_alt, "rows_alt", torch.int32, rows.shape)
        tensors.append(rows_alt)
    if _on_cpu(tensors):
        sort_rows_plain(rows, scal, shape)
        return
    if rows_alt is None and sort_passes(shape):
        raise ValueError(f"sort_rows: R = {shape.R} rows exceed a tile of "
                         f"{tile_rows(shape)}; the merge passes need "
                         f"rows_alt")
    name = "sort_rows" if shape.tiebreak == "lex" else "sort_rows_hash"
    _launch(name, _lib().jt_sort_rows, _ptr(rows),
            ctypes.c_void_p(None) if rows_alt is None else _ptr(rows_alt),
            _ptr(scal), shape.B, shape.R, shape.RP, shape.NK, shape.MW,
            TIEBREAKS.index(shape.tiebreak), tile_rows(shape),
            sort_passes(shape), _stream(rows))


def tile_stride(shape: LevelShape) -> int:
    """int32 words a row takes in a sort tile: NK, then its hash under
    the hash tie-break, rounded up to an odd count (the stride ``M | 1``
    of csrc/search.cu's sort kernels)."""
    return (shape.NK + (shape.tiebreak == "hash")) | 1


def tile_rows(shape: LevelShape) -> int:
    """T, the rows one sort tile holds: the largest power of two up to
    TILE_MAX whose rows and two 2-byte slot arrays fit in SMEM_MAX. 4,096
    at every NK up to 12. The kernel takes T and :func:`sort_passes` from
    here and refuses a tile the device cannot hold."""
    T = TILE_MAX
    while T * (4 * tile_stride(shape) + 4) > SMEM_MAX:
        T //= 2
    return T


def dedup_block_smem(shape: LevelShape) -> int:
    """Dynamic shared memory of ``dedup_truncate``'s one-block kernel: the
    key's R rows at a stride of NK | 1 words and, where CR > 0, their
    16-bit group starts."""
    return 4 * shape.R * (shape.NK | 1) + (2 * shape.R if shape.CR else 0)


def dedup_one_block(shape: LevelShape) -> bool:
    """Whether ``dedup_truncate`` takes its one-block-per-key path, the
    key's rows and group starts in shared memory: while the R live rows
    fit one sort tile (:func:`tile_rows`) and the block's shared memory
    (:func:`dedup_block_smem` and its static arrays) fits SMEM_MAX. Past
    it (the wide rungs) a block takes 256 rows of a key."""
    return (shape.R <= tile_rows(shape) and dedup_block_smem(shape)
            + DEDUP_BLOCK_STATIC <= SMEM_MAX)


def group_scan_runs(shape: LevelShape) -> bool:
    """Whether a level at ``shape`` launches ``group_scan``: its one
    reader, the dominance test, runs only with crashed ops (CR > 0), and
    on the one-block path ``dedup_truncate`` scans the group starts in
    its own shared memory."""
    return shape.CR > 0 and not dedup_one_block(shape)


def sort_passes(shape: LevelShape) -> int:
    """The sort's merge passes after its tile pass: ceil(log2(ceil(R /
    T))), 0 when the R live rows fit in one tile."""
    tiles = -(-shape.R // tile_rows(shape))
    return (tiles - 1).bit_length()


def group_scan(rows: torch.Tensor, scal: torch.Tensor, g: torch.Tensor,
               gagg: torch.Tensor, shape: LevelShape) -> None:
    """Scan each sorted row's group start over the R live rows: within
    each block of SCAN_ROWS rows into g, each block's largest into
    ``gagg`` (:func:`group_starts` gives the starts)."""
    _check_rows(rows, scal, shape)
    _check(g, "g", torch.int32, (shape.B, shape.RP))
    _check(gagg, "gagg", torch.int32, (shape.B, scan_blocks(shape)))
    if _on_cpu([rows, scal, g, gagg]):
        group_scan_plain(rows, scal, g, gagg, shape)
        return
    _launch("group_scan", _lib().jt_group_scan, _ptr(rows), _ptr(scal),
            _ptr(g), _ptr(gagg), shape.B, shape.R, shape.RP, shape.NK,
            shape.MW, _stream(rows))


def scan_blocks(shape: LevelShape) -> int:
    """Blocks of SCAN_ROWS rows the group-scan kernel takes the R live rows
    in: the width of ``gagg``."""
    return -(-shape.R // SCAN_ROWS)


def grid_launches(name: str, shape: LevelShape) -> int:
    """CUDA kernel launches one call of wrapper ``name`` should issue at
    ``shape`` (what ``grid_launches_total`` is held against). The sort
    takes its tile pass and :func:`sort_passes` merge passes; every other
    kernel one."""
    if name.startswith("sort_rows"):
        return 1 + sort_passes(shape)
    return 1


def dedup_truncate(rows: torch.Tensor, g: torch.Tensor, gagg: torch.Tensor,
                   pool_in: Pool, pool_out: Pool, pk: torch.Tensor,
                   ps: torch.Tensor, pa: torch.Tensor, scal: torch.Tensor,
                   acc: torch.Tensor, stats: Optional[torch.Tensor],
                   shape: LevelShape, nr: torch.Tensor,
                   seg: Optional[torch.Tensor] = None) -> None:
    """Kill dups and dominated rows, truncate to C rows into ``pool_out``,
    and finish each active key's level scalars and counters (its row of
    ``stats``; none when ``stats`` is None, the stats lane off). The group
    starts come from ``group_scan``'s g and gagg where
    :func:`group_scan_runs`, else the kernel scans them itself. With
    ``seg``, the words of a segment, the launch then ends the level pair
    as ``seg_active`` does (the step the segment graph's pair runs at its
    end)."""
    B, C = shape.B, shape.C
    _check_rows(rows, scal, shape)
    _check(g, "g", torch.int32, (B, shape.RP))
    _check(gagg, "gagg", torch.int32, (B, scan_blocks(shape)))
    _check_pool(pool_in, "pool_in", shape)
    _check_pool(pool_out, "pool_out", shape)
    _check(pk, "pk", torch.int32, (B, C))
    _check(ps, "ps", torch.int32, (B, C))
    _check(pa, "pa", torch.bool, (B, C))
    _check_nr(nr, shape)
    _check(acc, "acc", torch.int32, (B, NACC))
    if stats is not None:
        _check(stats, "stats", torch.int32, (B, shape.lmax + 1, NSTAT))
    tensors = ([rows, g, gagg] + list(pool_in.tensors())
               + list(pool_out.tensors())
               + [pk, ps, pa, nr, scal, acc, stats])
    if seg is not None:
        _check(seg, "seg", torch.int32, (NSEG,))
    if _on_cpu([t for t in tensors + [seg] if t is not None]):
        dedup_truncate_plain(rows, g, gagg, pool_in, pool_out, pk, ps, pa,
                             scal, acc, stats, shape, nr, seg)
        return
    _launch("dedup_truncate", _lib().jt_dedup_truncate,
            *[_nptr(t) for t in tensors],
            B, C, shape.W, shape.CR, shape.R, shape.lmax,
            int(dedup_one_block(shape)),
            ctypes.c_void_p(None) if seg is None else _ptr(seg),
            _stream(rows))


def seg_active(scal: torch.Tensor, lmax: int, seg: torch.Tensor) -> None:
    """K5 on its own, outside a graph: count the pair's levels into
    ``seg`` and set its go word (see :func:`seg_active_plain`)."""
    B = scal.shape[0]
    _check(scal, "scal", torch.int32, (B, NSCAL))
    _check(seg, "seg", torch.int32, (NSEG,))
    if _on_cpu([scal, seg]):
        seg_active_plain(scal, lmax, seg)
        return
    _launch("seg_active", _lib().jt_seg_active, _ptr(scal), _ptr(seg), B,
            lmax, _stream(scal))


#: the kernels a segment graph's body launches, in the order of the
#: counts its C entry point returns
GRAPH_KERNELS = ("expand", "sort_rows", "group_scan", "dedup_truncate")


class SegmentGraph:
    """A segment of levels over one shape's buffers as a CUDA graph: a
    memset node zeroes ``seg[SEG_RUN]``, then a WHILE node runs a level
    pair (``pool`` into ``pool_next``, then back), until the pair's
    second ``dedup_truncate``, ending the pair with K5's step, finds no key
    active or ``seg[SEG_RUN]`` at the bound. After any number of
    iterations the pool is back in ``pool``, so the caller's buffers need
    no swap. The graph holds the buffers' device pointers; it keeps
    references to them, and its owner destroys it (:meth:`destroy`)
    before it lets them go. ``body`` is the CUDA launches one iteration
    makes, per kernel, as the C entry points counted them at capture:
    ``group_scan`` only on the wide rungs of a search with crashed ops.
    ``stats`` None captures K4 without its counter rows (the stats lane
    off)."""

    def __init__(self, cols: dict, nr: torch.Tensor, pool: Pool,
                 pool_next: Pool, pk: torch.Tensor, ps: torch.Tensor,
                 pa: torch.Tensor, scal: torch.Tensor, acc: torch.Tensor,
                 stats: Optional[torch.Tensor], rows: torch.Tensor,
                 rows_alt: Optional[torch.Tensor], g: torch.Tensor,
                 gagg: torch.Tensor, shape: LevelShape):
        from jepsen_tpu_torch.kernels import build
        B, C, n, CR = shape.B, shape.C, shape.n, shape.CR
        for c in COLS:
            width = n + 1 if c == "sm" else (n if c in COLS[:8] else CR)
            _check(cols[c], c, torch.int32, (B, width))
        _check_nr(nr, shape)
        _check_pool(pool, "pool", shape)
        _check_pool(pool_next, "pool_next", shape)
        _check(pk, "pk", torch.int32, (B, C))
        _check(ps, "ps", torch.int32, (B, C))
        _check(pa, "pa", torch.bool, (B, C))
        _check_rows(rows, scal, shape)
        _check(acc, "acc", torch.int32, (B, NACC))
        if stats is not None:
            _check(stats, "stats", torch.int32, (B, shape.lmax + 1, NSTAT))
        _check(g, "g", torch.int32, (B, shape.RP))
        _check(gagg, "gagg", torch.int32, (B, scan_blocks(shape)))
        if sort_passes(shape):
            if rows_alt is None:
                raise ValueError(f"segment graph: R = {shape.R} rows exceed "
                                 f"a sort tile; the merge passes need "
                                 f"rows_alt")
            _check(rows_alt, "rows_alt", torch.int32, rows.shape)
        self.shape = shape
        self.seg = torch.zeros(NSEG, dtype=torch.int32, device=scal.device)
        self.tensors = ([cols[c] for c in COLS] + [nr]
                        + list(pool.tensors()) + list(pool_next.tensors())
                        + [pk, ps, pa, scal, acc, stats, rows, rows_alt, g,
                           gagg, self.seg])
        if any(t is not None and t.device.type != "cuda"
               for t in self.tensors):
            raise ValueError("a segment graph's buffers must lie on one "
                             "CUDA device")
        build.require_conditional_nodes()
        handle = ctypes.c_void_p()
        counts = (ctypes.c_int * len(GRAPH_KERNELS))()
        with torch.cuda.device(scal.device):
            rc = _lib().jt_segment_graph_create(
                *[_nptr(t) for t in self.tensors],
                B, C, shape.W, shape.E, n, CR, shape.lmax,
                MODELS.index(shape.model), TIEBREAKS.index(shape.tiebreak),
                tile_rows(shape), sort_passes(shape),
                int(dedup_one_block(shape)), int(group_scan_runs(shape)),
                ctypes.byref(handle), counts)
        if rc != 0:
            raise RuntimeError(f"segment graph: CUDA error {rc}: "
                               f"{build.error_string(rc)}")
        self.handle = handle
        sort = "sort_rows" if shape.tiebreak == "lex" else "sort_rows_hash"
        self.body = {(sort if k == "sort_rows" else k): int(n)
                     for k, n in zip(GRAPH_KERNELS, counts)}
        for name, n in self.body.items():
            if n:
                host_calls[name] += 1
        segments["captures"] += 1

    def ptrs(self) -> frozenset:
        """The device pointers the graph holds."""
        return frozenset(t.data_ptr() for t in self.tensors
                         if t is not None)

    def launch(self, bound: int) -> None:
        """Run one segment of at most ``bound`` levels (even) on the
        current stream; nothing waits for it. ``seg[SEG_RUN]`` then holds
        the levels it ran."""
        from jepsen_tpu_torch.kernels import build
        if self.handle is None:
            raise RuntimeError("segment graph: launched after destroy()")
        self.seg[SEG_BOUND].fill_(bound)
        rc = _lib().jt_segment_graph_launch(self.handle,
                                            _stream(self.seg))
        if rc != 0:
            raise RuntimeError(f"segment graph: CUDA error {rc}: "
                               f"{build.error_string(rc)}")
        segments["launches"] += 1

    def account(self, run: int) -> None:
        """Add a segment that ran ``run`` levels, as read from
        ``seg[SEG_RUN]``, to the launch counts: ceil(run / 2) iterations
        of the body, two levels of each kernel it launches and one end of
        a pair (K5's step, in the second ``dedup_truncate``) each."""
        pairs = (run + 1) // 2
        segments["levels"] += run
        for name, per_body in self.body.items():
            if per_body:
                launches[name] += 2 * pairs
            grid_launches_total[name] += pairs * per_body
        segments["pair_ends"] += pairs

    def destroy(self) -> None:
        """Free the graph and let its buffers go."""
        if self.handle is not None:
            rc = _lib().jt_segment_graph_destroy(self.handle)
            self.handle = None
            self.tensors = []
            if rc != 0:
                from jepsen_tpu_torch.kernels import build
                raise RuntimeError(f"segment graph: CUDA error {rc}: "
                                   f"{build.error_string(rc)}")
