"""Linearizability search on an NVIDIA GPU: the single-history path.

Counterpart of the single-history half of ``jepsen_tpu/checker/tpu.py``.
A WGL configuration is ``(k, mask, cmask, state)``: ops ``[0, k)`` in
return order are linearized, ``mask`` bit *o* marks op ``k+o`` as
linearized too, ``cmask`` marks taken crashed ops, and ``state`` is the
model state. The search is a best-first pool search: a pool of C
configurations, deepest first; each level expands the top E rows into
successors, merges them with the unexpanded remainder, sorts, kills
duplicates and dominated rows, and keeps the first C. A level is four
hand-written kernels (:mod:`jepsen_tpu_torch.kernels.search`) launched
back to back with no host synchronisation; the host looks at the carry
only at segment ends (:mod:`jepsen_tpu_torch.resilience`).

Soundness of the outcomes is the reference's: ``done`` proves
linearizability; pool death with neither ``lossy`` nor ``wovf`` refutes
it; anything else is UNKNOWN, and the capacity ladder escalates.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.models.core import NIL_ID, KernelSpec, Model
from jepsen_tpu_torch.ops.encode import (RET_INF, PackedHistory,
                                         pack_with_init)

#: Default candidate window and the widest the mask words carry.
WINDOW = 32
MAX_WINDOW = 128

#: Levels per checkpointed segment (env JTPU_SEGMENT_ITERS).
DEFAULT_SEGMENT_ITERS = 1024

#: Max crashed ops per history (four crashed-mask words).
CRASH_MAX = 128

#: Per-level counter columns of the stats lane.
SEARCHSTAT_COLS = ("expanded", "dup", "dominated", "trunc", "frontier")
NSTAT = K.NSTAT

#: (capacity, expand) rungs for narrow histories (window <= 32). On a
#: CUDA device the first rung is (128, 8); on the CPU it is
#: CPU_FIRST_RUNG, as in the JAX package.
CAPACITY_LADDER = ((128, 8), (1024, 64), (4096, 256), (16384, 1024))
CPU_FIRST_RUNG = (32, 4)
#: Expansion-heavy rungs for wide histories (needed window > 32).
WIDE_LADDER = ((512, 512), (4096, 1024), (16384, 4096))

_COLS = K.COLS + ("nr", "ini")


def resolve_device(device=None) -> torch.device:
    """The device a check runs on: CUDA unless the caller asks for the
    CPU. Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "search's plain PyTorch version on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# Host helpers (numpy), copied from the reference so checkpoints interchange
# ---------------------------------------------------------------------------


def _level_budget(n: int, n_cr: int) -> int:
    """Level budget for ``n`` padded required and ``n_cr`` padded crashed
    ops; past it the search reports UNKNOWN."""
    return 2 * (n + n_cr) + 256


def _bucket(n: int, lo: int = 16) -> int:
    """Round n up to a power of two (at least ``lo``)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _suffix_min_inv(inv: np.ndarray, n: int) -> np.ndarray:
    """suffix_min[j] = min(inv[j:]), suffix_min[n] = RET_INF."""
    out = np.full(n + 1, int(RET_INF), dtype=np.int32)
    out[:n] = np.minimum.accumulate(np.asarray(inv[:n])[::-1])[::-1]
    return out


def _split_packed(p: PackedHistory, breq: int, cr: int,
                  kernel: Optional[KernelSpec] = None) -> Optional[dict]:
    """Split a PackedHistory into the padded required section [breq] and
    crashed section [cr] columns (the ``_COLS`` dict). None when the
    history has more crashed ops than ``cr``."""
    nr = p.n_required
    n_cr = p.n - nr
    if n_cr > cr:
        return None

    def pad(a, width, fill):
        out = np.full(width, fill, dtype=np.int32)
        out[:a.shape[0]] = a
        return out

    inf = int(RET_INF)
    inv_req = pad(p.inv[:nr], breq, inf)
    ro = np.zeros(breq, dtype=np.int32)
    if kernel is not None and kernel.readonly is not None:
        for j in range(nr):
            if kernel.readonly(int(p.f[j]), int(p.v1[j]), int(p.v2[j])):
                ro[j] = 1
    sm = _suffix_min_inv(inv_req, breq)
    # fr[j] = 1 iff required op j is forced: no other required op is
    # concurrent with it
    fr = np.zeros(breq, dtype=np.int32)
    if nr:
        idx = np.searchsorted(sm[:nr + 1], p.ret[:nr], side="left")
        fr[:nr] = (idx <= np.arange(nr) + 1).astype(np.int32)
    # cps[j]: previous crashed op with identical (f, v1, v2), or -1
    cps = np.full(cr, -1, dtype=np.int32)
    seen: dict = {}
    for j in range(n_cr):
        key = (int(p.f[nr + j]), int(p.v1[nr + j]), int(p.v2[nr + j]))
        if key in seen:
            cps[j] = seen[key]
        seen[key] = j
    return {
        "f": pad(p.f[:nr], breq, 0),
        "v1": pad(p.v1[:nr], breq, NIL_ID),
        "v2": pad(p.v2[:nr], breq, NIL_ID),
        "ro": ro,
        "fr": fr,
        "inv": inv_req,
        "ret": pad(p.ret[:nr], breq, inf),
        "sm": sm,
        "cf": pad(p.f[nr:], cr, 0),
        "cv1": pad(p.v1[nr:], cr, NIL_ID),
        "cv2": pad(p.v2[nr:], cr, NIL_ID),
        "cinv": pad(p.inv[nr:], cr, inf),
        "cps": cps,
        "nr": np.int32(nr),
        "ini": np.asarray(int(p.init_state) & 0xFFFFFFFF,
                          np.uint32).view(np.int32)[()],
    }


def _window_needed(p: PackedHistory) -> int:
    """Smallest window W such that no candidate ever falls beyond it."""
    nr = p.n_required
    if nr == 0:
        return 0
    sm = _suffix_min_inv(p.inv[:nr], nr)[:nr]
    idx = np.searchsorted(sm, p.ret[:nr], side="left")
    return max(1, int((idx - np.arange(nr)).max()))


def _crash_width(n_cr: int) -> Optional[int]:
    """Padded crashed-section width, or None when over CRASH_MAX."""
    if n_cr == 0:
        return 0
    if n_cr > CRASH_MAX:
        return None
    return _bucket(n_cr, lo=8)


def _check_window(window: int) -> None:
    if window > MAX_WINDOW:
        raise ValueError(
            f"window {window} > {MAX_WINDOW}: wider windows need more mask "
            f"words than the search carries")


def _window_bucket(wneed: int) -> int:
    for w in (32, 64, 128):
        if wneed <= w:
            return w
    return MAX_WINDOW


def _capacity_ladder(device: torch.device):
    """The narrow ladder for a device."""
    if device.type == "cpu":
        return (CPU_FIRST_RUNG,) + CAPACITY_LADDER[1:]
    return CAPACITY_LADDER


def _ladder_for(wneed: int, device: torch.device):
    """(capacity, window, expand) rungs at the window this history needs."""
    w = _window_bucket(wneed)
    if wneed > MAX_WINDOW:
        return tuple((c, w, e) for c, e in WIDE_LADDER[:2])
    if wneed > 32:
        return tuple((c, w, e) for c, e in WIDE_LADDER)
    return tuple((c, w, e) for c, e in _capacity_ladder(device))


def _popcount32_host(a: np.ndarray) -> np.ndarray:
    """Per-element population count of a uint32 array."""
    a = np.asarray(a, np.uint32).copy()
    a = a - ((a >> np.uint32(1)) & np.uint32(0x55555555))
    a = ((a & np.uint32(0x33333333))
         + ((a >> np.uint32(2)) & np.uint32(0x33333333)))
    a = (a + (a >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((a * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int64)


def _carry0_host(capacity: int, window: int, n_cr: int, init_state,
                 n_required: int, stats_rows: int = 0) -> tuple:
    """The initial search carry in the reference's layout: (k, mask,
    cmask, state, alive, done, lossy, wovf, level, best_k, pk, ps, pa
    [, stats])."""
    MW = (window + 31) // 32
    MC = max((n_cr + 31) // 32, 1)
    k0 = np.zeros(capacity, np.int32)
    mask0 = np.zeros((capacity, MW), np.uint32)
    cmask0 = np.zeros((capacity, MC), np.uint32)
    state0 = np.full(capacity, int(np.int32(init_state)), np.int32)
    alive0 = np.arange(capacity) == 0
    carry = (k0, mask0, cmask0, state0, alive0,
             np.bool_(n_required == 0), np.bool_(False), np.bool_(False),
             np.int32(0), np.int32(0),
             k0.copy(), state0.copy(), alive0.copy())
    if stats_rows:
        carry = carry + (np.zeros((stats_rows, NSTAT), np.int32),)
    return carry


def _carry_active(carry, lmax: int) -> bool:
    """More levels are worth running: not done, some row alive, and the
    level budget not exhausted."""
    done, alive, level = carry[5], carry[4], carry[8]
    return (not bool(done)) and bool(np.any(alive)) and int(level) <= lmax


def _summarize_carry(carry) -> tuple:
    """(done, lossy, wovf, best_k, levels, pool) of a final carry; a
    search stopped by its budget with work left is lossy."""
    done, lossy, wovf = bool(carry[5]), bool(carry[6]), bool(carry[7])
    lossy = lossy or (not done and bool(np.any(carry[4])))
    return (done, lossy, wovf, int(carry[9]), int(carry[8]),
            (carry[10], carry[11], carry[12]))


def _result(done: bool, lossy: bool, wovf: bool, best_k: int, levels: int,
            p: Optional[PackedHistory] = None,
            pool: Optional[tuple] = None) -> Dict[str, Any]:
    if done:
        return {"valid": True, "levels": levels, "backend": "gpu"}
    if not (lossy or wovf):
        out = {"valid": False, "levels": levels,
               "max-linearized-prefix": best_k, "backend": "gpu"}
        if p is not None and p.ops and best_k < len(p.ops):
            inv_op = p.ops[best_k][0]
            out["frontier-op"] = inv_op.to_dict() if inv_op else None
        if pool is not None:
            # the last living pool's deepest configs, re-anchored to its
            # own deepest k
            pk, ps, pa = (np.asarray(x) for x in pool)
            live = pa & (pk == (pk * pa).max())
            if live.any():
                pool_k = int((pk * pa).max())
                out["final-states"] = sorted(
                    {int(s) for s in ps[live]})[:16]
                if pool_k != best_k:
                    out["deepest-expanded"] = best_k
                    out["max-linearized-prefix"] = pool_k
                    if p is not None and p.ops and pool_k < len(p.ops):
                        inv_op = p.ops[pool_k][0]
                        out["frontier-op"] = (inv_op.to_dict()
                                              if inv_op else None)
        return out
    return {"valid": UNKNOWN, "levels": levels,
            "error": ("beam truncated the frontier" if lossy
                      else "candidate window exceeded"),
            "capacity-overflow": bool(lossy),
            "window-overflow": bool(wovf),
            "backend": "gpu"}


def _prep_single(p: PackedHistory, kernel: KernelSpec) -> tuple:
    """(cols, None), or (None, result) for the trivially complete and the
    crashed-set-overflow cases."""
    if p.n_required == 0:
        return None, {"valid": True, "levels": 0, "backend": "gpu"}
    cr = _crash_width(p.n - p.n_required)
    cols = (None if cr is None
            else _split_packed(p, _bucket(p.n_required), cr, kernel))
    if cols is None:
        return None, {
            "valid": UNKNOWN, "backend": "gpu",
            "error": f"{p.n - p.n_required} crashed ops exceed the "
                     f"crashed-set width {CRASH_MAX}"}
    return cols, None


def _segment_config(segment_iters: Optional[int]) -> Optional[int]:
    """An explicit argument wins (0 = one segment for the whole budget),
    then JTPU_SEGMENT_ITERS, then the default."""
    if segment_iters is not None:
        return int(segment_iters) or None
    env = os.environ.get("JTPU_SEGMENT_ITERS")
    if env is not None and env.strip():
        try:
            return int(env) or None
        except ValueError:
            raise ValueError(
                f"JTPU_SEGMENT_ITERS must be an integer, got {env!r}")
    return DEFAULT_SEGMENT_ITERS


# ---------------------------------------------------------------------------
# Device state and the level driver
# ---------------------------------------------------------------------------


@dataclass
class Carry:
    """The search carry on the device: the pool, the snapshot of the pool
    the last level expanded (pk, ps, pa), the scalars and the per-level
    counter log. ``interop`` converts it to and from the reference's
    numpy tuple."""

    pool: K.Pool
    pk: torch.Tensor      # int32 [C]
    ps: torch.Tensor      # int32 [C]
    pa: torch.Tensor      # bool [C]
    scal: torch.Tensor    # int32 [8], lanes named in kernels.search
    stats: torch.Tensor   # int32 [LMAX+1, NSTAT]


@dataclass
class Scratch:
    """Per-shape buffers a level writes and reads back: the other pool
    buffer, the per-level accumulators, the rows and the group starts."""

    pool_next: K.Pool
    acc: torch.Tensor     # int32 [9], zero between levels
    rows: torch.Tensor    # int32 [RP, NK]
    g: torch.Tensor       # int32 [RP]
    gagg: torch.Tensor    # int32 [scan blocks]


def empty_pool(shape: K.LevelShape, device) -> K.Pool:
    C, i32 = shape.C, torch.int32
    return K.Pool(k=torch.zeros(C, dtype=i32, device=device),
                  mask=torch.zeros(C, shape.MW, dtype=i32, device=device),
                  cmask=torch.zeros(C, shape.MCX, dtype=i32, device=device),
                  state=torch.zeros(C, dtype=i32, device=device),
                  alive=torch.zeros(C, dtype=torch.bool, device=device))


def empty_carry(shape: K.LevelShape, device) -> Carry:
    C, i32 = shape.C, torch.int32
    return Carry(pool=empty_pool(shape, device),
                 pk=torch.zeros(C, dtype=i32, device=device),
                 ps=torch.zeros(C, dtype=i32, device=device),
                 pa=torch.zeros(C, dtype=torch.bool, device=device),
                 scal=torch.zeros(K.NSCAL, dtype=i32, device=device),
                 stats=torch.zeros(shape.lmax + 1, NSTAT, dtype=i32,
                                   device=device))


def empty_scratch(shape: K.LevelShape, device) -> Scratch:
    i32 = torch.int32
    return Scratch(pool_next=empty_pool(shape, device),
                   acc=torch.zeros(K.NACC, dtype=i32, device=device),
                   rows=torch.zeros(shape.RP, shape.NK, dtype=i32,
                                    device=device),
                   g=torch.zeros(shape.RP, dtype=i32, device=device),
                   gagg=torch.zeros(K.scan_blocks(shape.RP), dtype=i32,
                                    device=device))


class Ops(NamedTuple):
    """The four level steps: the kernel wrappers, or their plain
    versions called directly (which accept CUDA tensors too)."""

    expand: Callable
    sort_rows: Callable
    group_scan: Callable
    dedup_truncate: Callable


KERNELS = Ops(K.expand, K.sort_rows, K.group_scan, K.dedup_truncate)
PLAIN = Ops(K.expand_plain, K.sort_rows_plain,
             lambda rows, scal, g, gagg, shape: K.group_scan_plain(
                 rows, scal, g, shape),
             K.dedup_truncate_plain)


def search_level(cols: dict, carry: Carry, scratch: Scratch,
                 shape: K.LevelShape, nr: int, ops: Ops = KERNELS) -> None:
    """One search level: the four kernels in turn, then the pool buffers
    swap. No host synchronisation on the kernel path; once the search is
    inactive a level changes nothing."""
    ops.expand(cols, carry.pool, carry.scal, scratch.acc, scratch.rows,
               shape, nr)
    ops.sort_rows(scratch.rows, carry.scal, shape)
    ops.group_scan(scratch.rows, carry.scal, scratch.g, scratch.gagg, shape)
    ops.dedup_truncate(scratch.rows, scratch.g, carry.pool,
                       scratch.pool_next, carry.pk, carry.ps, carry.pa,
                       carry.scal, scratch.acc, carry.stats, shape, nr)
    carry.pool, scratch.pool_next = scratch.pool_next, carry.pool


def run_segment(cols: dict, carry: Carry, scratch: Scratch,
                shape: K.LevelShape, nr: int, seg_iters: int,
                ops: Ops = KERNELS) -> None:
    """``seg_iters`` levels back to back; the caller synchronises."""
    for _ in range(seg_iters):
        search_level(cols, carry, scratch, shape, nr, ops)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def check_packed_gpu(p: PackedHistory, kernel: KernelSpec,
                     capacity: Optional[int] = None,
                     window: Optional[int] = WINDOW,
                     expand: Optional[int] = None,
                     segment_iters: Optional[int] = None,
                     device=None) -> Dict[str, Any]:
    """Check one packed history. ``capacity=None`` escalates through the
    ladder for the history's needed window; with an explicit capacity,
    ``expand`` < capacity selects best-first search (None = BFS). Runs in
    checkpointed segments of ``segment_iters`` levels. ``device=None``
    means CUDA."""
    from jepsen_tpu_torch import resilience
    return resilience.supervised_check_packed(
        p, kernel, capacity=capacity, window=window, expand=expand,
        segment_iters=segment_iters, device=resolve_device(device))


def check_history_gpu(history, model: Model,
                      capacity: Optional[int] = None,
                      window: Optional[int] = WINDOW,
                      expand: Optional[int] = None,
                      segment_iters: Optional[int] = None,
                      device=None) -> Optional[Dict[str, Any]]:
    """Gate, pack and check one history. None when the model has no
    integer kernel or an op does not fit its encoding."""
    from jepsen_tpu_torch.analysis.history_lint import gate_history
    if window is not None:
        _check_window(window)
    dev = resolve_device(device)
    gate_history(history, where="the packed device search")
    try:
        pk = pack_with_init(history, model)
    except ValueError:
        return None
    if pk is None:
        return None
    packed, kernel = pk
    return check_packed_gpu(packed, kernel, capacity, window, expand,
                            segment_iters=segment_iters, device=dev)
