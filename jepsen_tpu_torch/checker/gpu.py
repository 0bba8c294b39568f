"""Linearizability search on an NVIDIA GPU: one history, a keyed batch, or
a gang of histories.

Counterpart of ``jepsen_tpu/checker/tpu.py``'s single-history search, its
keyed batch (``check_keyed_tpu``) and its gang (``check_packed_gang``,
the serve daemon's batched call).
A WGL configuration is ``(k, mask, cmask, state)``: ops ``[0, k)`` in
return order are linearized, ``mask`` bit *o* marks op ``k+o`` as
linearized too, ``cmask`` marks taken crashed ops, and ``state`` is the
model state. The search is a best-first pool search: a pool of C
configurations, deepest first; each level expands the top E rows into
successors, merges them with the unexpanded remainder, sorts, kills
duplicates and dominated rows, and keeps the first C. A level is four
hand-written kernels (:mod:`jepsen_tpu_torch.kernels.search`), and a
segment of levels is one CUDA graph: level pairs and the fifth kernel's
``active`` test in a WHILE node, with no host code between levels
(:func:`run_segment`). The host looks at the carry only at segment ends
(:func:`run_batch`, for one history through
:mod:`jepsen_tpu_torch.resilience`). Every device tensor has a
leading key axis: a keyed batch advances all its keys one level per
launch, and one history is a batch of one.

Soundness of the outcomes is the reference's: ``done`` proves
linearizability; pool death with neither ``lossy`` nor ``wovf`` refutes
it; anything else is UNKNOWN, and the capacity ladder escalates.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checker import UNKNOWN, merge_valid
from jepsen_tpu_torch.kernels import cost as kcost
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.obs import metrics as obs_metrics
from jepsen_tpu_torch.models.core import (NIL_ID, KernelSpec, Model,
                                          kernel_spec_for)
from jepsen_tpu_torch.ops.encode import (RET_INF, PackedHistory,
                                         pack_with_init)

#: Default candidate window and the widest the mask words carry.
WINDOW = 32
MAX_WINDOW = 128

#: The longest segment of levels between two host reads (env
#: JTPU_SEGMENT_ITERS).
DEFAULT_SEGMENT_ITERS = 1024

#: Levels in a search's first segment; later segments double.
FIRST_BATCH_SEGMENT = 64

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


# ---------------------------------------------------------------------------
# Telemetry: the reference's device metrics and compile accounting
# (tpu.py:700-928), recorded on the host around a CUDA synchronisation,
# never inside a captured graph. In the port a shape's "compile" is its
# first call in the process: the kernel library's load (and nvcc build,
# counted by ``jtpu_persistent_cache_*``), the buffers' allocation, the
# segment graph's capture, and one execution.
# ---------------------------------------------------------------------------

_DEVICE_SECONDS = obs_metrics.histogram(
    "jtpu_device_call_seconds",
    "wall time of one device call (host-side, around a CUDA "
    "synchronisation), labeled kind=segment|batch|batch-segment and "
    "phase=compile|execute; 'compile' is the shape's first call in this "
    "process: the kernel library's load, the buffers, the segment "
    "graph's capture and one execution",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0))
_LEVELS_TOTAL = obs_metrics.counter(
    "jtpu_search_levels_total",
    "search levels executed on device (per-call/per-segment deltas)")
_SEGMENTS_TOTAL = obs_metrics.counter(
    "jtpu_search_segments_total", "checkpointed device segments run")
_FRONTIER_HWM = obs_metrics.gauge(
    "jtpu_search_frontier_rows_hwm",
    "high-water mark of live pool rows observed at segment boundaries")
_TRANSFER_BYTES = obs_metrics.counter(
    "jtpu_search_transfer_bytes_total",
    "packed-history and checkpoint bytes moved, labeled by direction")
_COMPILE_COLD = obs_metrics.counter(
    "jtpu_compile_cold_total",
    "search shapes first called in this process (the kernel library's "
    "load, the buffers, the graph capture and one execution), labeled "
    "kind")
_COMPILE_HIT = obs_metrics.counter(
    "jtpu_compile_cache_hit_total",
    "device calls at a shape already called in this process (its "
    "buffers and segment graph cached), labeled kind")
_COMPILE_SECONDS = obs_metrics.histogram(
    "jtpu_compile_seconds",
    "wall time of a shape's first call in this process, labeled kind",
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
             120.0, 300.0))

#: Shape keys that have run once in this process: the compile/execute
#: phase separator.
_EXECUTED_SHAPES: set = set()


def note_call_phase(kind: str, phase: str, seconds: float) -> None:
    """Account one device call: the wall-time histogram and the cold
    first call against the cache hit (and the cold call's seconds)."""
    _DEVICE_SECONDS.observe(seconds, kind=kind, phase=phase)
    if phase == "compile":
        _COMPILE_COLD.inc(kind=kind)
        _COMPILE_SECONDS.observe(seconds, kind=kind)
    else:
        _COMPILE_HIT.inc(kind=kind)


def call_phase(key: tuple) -> str:
    """``compile`` for a shape key's first call in this process, else
    ``execute``; decided before the call, and the key is marked run only
    by :func:`mark_executed` after it succeeded (a call that died in its
    first run pays its compile again)."""
    return "execute" if key in _EXECUTED_SHAPES else "compile"


def mark_executed(key: tuple) -> None:
    _EXECUTED_SHAPES.add(key)


def compile_snapshot() -> Dict[str, Any]:
    """A readout of the compile/execute/transfer accounting; diff two
    around a check (:func:`compile_delta`, :func:`compile_line`)."""
    from jepsen_tpu_torch.kernels import build
    return {
        "cold": _COMPILE_COLD.total(),
        "cache-hits": _COMPILE_HIT.total(),
        "persistent-hits": build.PERSISTENT_HIT.total(),
        "persistent-misses": build.PERSISTENT_MISS.total(),
        "compile-s": _COMPILE_SECONDS.total()["sum"],
        "execute-s": _DEVICE_SECONDS.total(phase="execute")["sum"],
        "transfer-bytes": _TRANSFER_BYTES.total(),
    }


def compile_delta(before: Dict[str, Any],
                  after: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """after - before, field by field (after defaults to a fresh
    snapshot)."""
    after = after or compile_snapshot()
    return {k: after[k] - before.get(k, 0) for k in after}


def compile_line(delta: Dict[str, Any],
                 wall_s: Optional[float] = None) -> str:
    """One ``# compile:`` line splitting a check's wall clock into cold
    first calls, execution and transfer; ``persistent-cache`` counts the
    kernel library found built (hit) against built now (miss)."""
    line = (f"# compile: cold={int(delta['cold'])} shape(s) "
            f"{delta['compile-s']:.3f}s | "
            f"cache-hit={int(delta['cache-hits'])} | "
            f"execute={delta['execute-s']:.3f}s | "
            f"transfer={delta['transfer-bytes'] / 1e6:.1f}MB | "
            f"persistent-cache hit={int(delta['persistent-hits'])}"
            f"/miss={int(delta['persistent-misses'])}")
    if wall_s is not None:
        host = max(0.0, wall_s - delta["compile-s"] - delta["execute-s"])
        line += f" | host={host:.3f}s of {wall_s:.3f}s wall"
    return line


def cols_nbytes(cols: dict) -> int:
    """Host-to-device bytes of one (stacked) column set."""
    return int(sum(np.asarray(v).nbytes for v in cols.values()))


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


def crash_bounds(ret: np.ndarray, cinv: np.ndarray) -> np.ndarray:
    """cb[..., i] = searchsorted(ret, cinv[..., i], side="right") per
    history (a leading key axis allowed), int32. ``ret`` is sorted, so the
    reference's crash bound of a row, searchsorted(ret, the least untaken
    cinv, right) (tpu.py:294-306), is min(n, the least untaken cb): the
    ``expand`` kernel reads this column instead of searching ret. A padded
    crashed slot (cinv = RET_INF) gets n."""
    ret, cinv = np.asarray(ret), np.asarray(cinv)
    if ret.ndim == 1:
        return np.searchsorted(ret, cinv, side="right").astype(np.int32)
    return np.stack([crash_bounds(r, c) for r, c in zip(ret, cinv)])


def _split_packed(p: PackedHistory, breq: int, cr: int,
                  kernel: Optional[KernelSpec] = None) -> Optional[dict]:
    """Split a PackedHistory into the padded required section [breq] and
    crashed section [cr] columns (the ``_COLS`` dict: the reference's,
    and ``cb``, :func:`crash_bounds`). None when the history has more
    crashed ops than ``cr``."""
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
    ret_req = pad(p.ret[:nr], breq, inf)
    cinv = pad(p.inv[nr:], cr, inf)
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
        "ret": ret_req,
        "sm": sm,
        "cf": pad(p.f[nr:], cr, 0),
        "cv1": pad(p.v1[nr:], cr, NIL_ID),
        "cv2": pad(p.v2[nr:], cr, NIL_ID),
        "cinv": cinv,
        "cps": cps,
        "cb": crash_bounds(ret_req, cinv),
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


def _summarize_carry(carry) -> tuple:
    """(done, lossy, wovf, best_k, levels, pool) of a final carry; a
    search stopped by its budget with work left is lossy."""
    done, lossy, wovf = bool(carry[5]), bool(carry[6]), bool(carry[7])
    lossy = lossy or (not done and bool(np.any(carry[4])))
    return (done, lossy, wovf, int(carry[9]), int(carry[8]),
            (carry[10], carry[11], carry[12]))


def _reopen_carry(carry, n_required: int):
    """Clear a carry's ``done`` so that a finished search goes on over a
    longer history (the streaming check). ``done`` was set by ``fk >=
    n_required`` against the old required count; a longer stable prefix
    appends required ops after every packed row's return, so the pool,
    masks, states and counters all carry over, and the level count goes
    on from where it was. A host carry (the reference's numpy tuple)
    comes back as a new tuple; a device :class:`Carry` has its ``DONE``
    lane cleared in place and comes back itself."""
    if isinstance(carry, Carry):
        carry.scal[:, K.DONE] = int(n_required == 0)
        return carry
    return tuple(carry[:5]) + (np.bool_(n_required == 0),) + tuple(carry[6:])


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


def _early_result(p: PackedHistory) -> Optional[Dict[str, Any]]:
    """The result of a history the search need not run: trivially complete
    (no required op), or more crashed ops than the crashed-set width."""
    if p.n_required == 0:
        return {"valid": True, "levels": 0, "backend": "gpu"}
    if _crash_width(p.n - p.n_required) is None:
        return {"valid": UNKNOWN, "backend": "gpu",
                "error": f"{p.n - p.n_required} crashed ops exceed the "
                         f"crashed-set width {CRASH_MAX}"}
    return None


def _prep_single(p: PackedHistory, kernel: KernelSpec) -> tuple:
    """(cols, None), or (None, result) for the :func:`_early_result`
    cases."""
    early = _early_result(p)
    if early is not None:
        return None, early
    return _split_packed(p, _bucket(p.n_required),
                         _crash_width(p.n - p.n_required), kernel), None


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


def _segment_schedule(segment_iters: Optional[int], lmax: int) -> tuple:
    """(cap, first) of :func:`run_batch`'s segments: they grow from
    :data:`FIRST_BATCH_SEGMENT` levels up to the configured length, and
    a length of 0 means one segment for the whole level budget."""
    seg = _segment_config(segment_iters)
    if seg is None:
        return lmax + 1, lmax + 1
    return seg, FIRST_BATCH_SEGMENT


# ---------------------------------------------------------------------------
# Device state and the level driver
# ---------------------------------------------------------------------------


@dataclass
class Carry:
    """The search carry of B keys on the device: the pool, the snapshot of
    the pool the last level expanded (pk, ps, pa), the scalars and the
    per-level counter log (None with the stats lane off: tracing off).
    ``interop`` converts it to and from the reference's numpy tuple."""

    pool: K.Pool
    pk: torch.Tensor      # int32 [B, C]
    ps: torch.Tensor      # int32 [B, C]
    pa: torch.Tensor      # bool [B, C]
    scal: torch.Tensor    # int32 [B, 8], lanes named in kernels.search
    stats: Optional[torch.Tensor]   # int32 [B, LMAX+1, NSTAT]


@dataclass
class Scratch:
    """Per-shape buffers a level writes and reads back: the other pool
    buffer, the per-level accumulators, the rows and the group starts;
    and, only where R exceeds one sort tile, the sort's second rows
    buffer for its merge passes."""

    pool_next: K.Pool
    acc: torch.Tensor     # int32 [B, 9], zero between levels
    rows: torch.Tensor    # int32 [B, RP, NK]
    g: torch.Tensor       # int32 [B, RP]; K3's, where it runs
    gagg: torch.Tensor    # int32 [B, scan blocks]
    rows_alt: Optional[torch.Tensor] = None   # int32 [B, RP, NK]


def empty_pool(shape: K.LevelShape, device) -> K.Pool:
    B, C, i32 = shape.B, shape.C, torch.int32
    return K.Pool(k=torch.zeros(B, C, dtype=i32, device=device),
                  mask=torch.zeros(B, C, shape.MW, dtype=i32, device=device),
                  cmask=torch.zeros(B, C, shape.MCX, dtype=i32,
                                    device=device),
                  state=torch.zeros(B, C, dtype=i32, device=device),
                  alive=torch.zeros(B, C, dtype=torch.bool, device=device))


def empty_carry(shape: K.LevelShape, device, stats: bool = True) -> Carry:
    B, C, i32 = shape.B, shape.C, torch.int32
    return Carry(pool=empty_pool(shape, device),
                 pk=torch.zeros(B, C, dtype=i32, device=device),
                 ps=torch.zeros(B, C, dtype=i32, device=device),
                 pa=torch.zeros(B, C, dtype=torch.bool, device=device),
                 scal=torch.zeros(B, K.NSCAL, dtype=i32, device=device),
                 stats=(torch.zeros(B, shape.lmax + 1, NSTAT, dtype=i32,
                                    device=device) if stats else None))


def empty_scratch(shape: K.LevelShape, device) -> Scratch:
    B, i32 = shape.B, torch.int32
    return Scratch(pool_next=empty_pool(shape, device),
                   acc=torch.zeros(B, K.NACC, dtype=i32, device=device),
                   rows=torch.zeros(B, shape.RP, shape.NK, dtype=i32,
                                    device=device),
                   g=torch.zeros(B, shape.RP, dtype=i32, device=device),
                   gagg=torch.zeros(B, K.scan_blocks(shape), dtype=i32,
                                    device=device),
                   rows_alt=(torch.zeros(B, shape.RP, shape.NK, dtype=i32,
                                         device=device)
                             if K.sort_passes(shape) else None))


def _pool_nbytes(shape: K.LevelShape) -> List[int]:
    B, C = shape.B, shape.C
    return [4 * B * C, 4 * B * C * shape.MW, 4 * B * C * shape.MCX,
            4 * B * C, B * C]


def carry_nbytes(shape: K.LevelShape, stats: bool = True) -> List[int]:
    """The bytes of each tensor :func:`empty_carry` allocates, in its
    order."""
    B, C = shape.B, shape.C
    return _pool_nbytes(shape) + [4 * B * C, 4 * B * C, B * C,
                                  4 * B * K.NSCAL] + (
        [4 * B * (shape.lmax + 1) * NSTAT] if stats else [])


def scratch_nbytes(shape: K.LevelShape) -> List[int]:
    """The bytes of each tensor :func:`empty_scratch` allocates, in its
    order (the sort's second rows buffer only where the shape has one)."""
    B, rows = shape.B, 4 * shape.B * shape.RP * shape.NK
    return (_pool_nbytes(shape)
            + [4 * B * K.NACC, rows, 4 * B * shape.RP,
               4 * B * K.scan_blocks(shape)]
            + ([rows] if K.sort_passes(shape) else []))


def state_bytes(shape: K.LevelShape, stats: bool = True) -> int:
    """Device bytes of one shape's carry and scratch (the sort's second
    rows buffer included where the shape has one)."""
    return sum(carry_nbytes(shape, stats)) + sum(scratch_nbytes(shape))


class Ops(NamedTuple):
    """The four level steps and the segment loop's test: the kernel
    wrappers, or their plain versions called directly (which accept CUDA
    tensors too). Both take the same route: ``group_scan`` runs where
    :func:`~jepsen_tpu_torch.kernels.search.group_scan_runs`, else
    ``dedup_truncate`` finds the group starts itself."""

    expand: Callable
    sort_rows: Callable
    group_scan: Callable
    dedup_truncate: Callable
    seg_active: Callable


KERNELS = Ops(K.expand, K.sort_rows, K.group_scan, K.dedup_truncate,
              K.seg_active)
PLAIN = Ops(K.expand_plain,
             lambda rows, scal, shape, rows_alt: K.sort_rows_plain(
                 rows, scal, shape),
             K.group_scan_plain, K.dedup_truncate_plain, K.seg_active_plain)


def search_level(cols: dict, carry: Carry, scratch: Scratch,
                 shape: K.LevelShape, nr: torch.Tensor,
                 ops: Ops = KERNELS) -> None:
    """One search level of every key: the kernels in turn (``group_scan``
    only where :func:`~jepsen_tpu_torch.kernels.search.group_scan_runs`),
    then the pool buffers swap. ``nr`` is each key's required-op count
    (int32 [B] on the device). No host synchronisation on the kernel
    path; once a key is inactive a level changes nothing of it."""
    ops.expand(cols, carry.pool, carry.scal, scratch.acc, scratch.rows,
               shape, nr)
    ops.sort_rows(scratch.rows, carry.scal, shape, scratch.rows_alt)
    if K.group_scan_runs(shape):
        ops.group_scan(scratch.rows, carry.scal, scratch.g, scratch.gagg,
                       shape)
    ops.dedup_truncate(scratch.rows, scratch.g, scratch.gagg, carry.pool,
                       scratch.pool_next, carry.pk, carry.ps, carry.pa,
                       carry.scal, scratch.acc, carry.stats, shape, nr)
    carry.pool, scratch.pool_next = scratch.pool_next, carry.pool


def run_segment(cols: dict, carry: Carry, scratch: Scratch,
                shape: K.LevelShape, nr: torch.Tensor, seg_iters: int,
                ops: Ops = KERNELS) -> tuple:
    """One segment: up to ``seg_iters`` levels in level pairs (an odd
    count is rounded up; a level after every key's search has ended
    changes nothing), stopping after the first pair that leaves no key
    active. With the kernels on CUDA tensors the segment is one launch of
    the shape's :class:`~jepsen_tpu_torch.kernels.search.SegmentGraph`
    and nothing waits for it; otherwise a host loop of the same control
    flow (pairs, then ``ops.seg_active``) runs ``ops``. Returns ``(seg,
    graph)``: the segment's int32 words, whose ``SEG_RUN`` holds the
    levels run once the segment is done, and the graph (None on the host
    loop), for :func:`end_segment`. The count takes the first level as
    run: callers start a segment only on an active search, as the
    previous segment end (or the host carry) showed it."""
    bound = seg_iters + (seg_iters & 1)
    if ops is KERNELS and carry.scal.device.type == "cuda":
        from jepsen_tpu_torch.checker.engine import default_engine
        graph = default_engine().segment_graph(cols, nr, carry, scratch,
                                               shape)
        graph.launch(bound)
        return graph.seg, graph
    seg = torch.tensor([0, bound, 0, 0], dtype=torch.int32,
                       device=carry.scal.device)
    while True:
        search_level(cols, carry, scratch, shape, nr, ops)
        search_level(cols, carry, scratch, shape, nr, ops)
        ops.seg_active(carry.scal, shape.lmax, seg)
        if not int(seg[K.SEG_GO]):
            return seg, None


def run_segment_host(cols: dict, carry: Carry, scratch: Scratch,
                     shape: K.LevelShape, nr: torch.Tensor, seg_iters: int,
                     ops: Ops = KERNELS) -> None:
    """``seg_iters`` levels back to back, each launched from Python (the
    level loop the segment graph replaced; it stays as the route the
    graph is held against, and to step a search level by level); the
    caller synchronises."""
    for _ in range(seg_iters):
        search_level(cols, carry, scratch, shape, nr, ops)


def capture_segment(cols: dict, nr: torch.Tensor, carry: Carry,
                    scratch: Scratch, shape: K.LevelShape
                    ) -> K.SegmentGraph:
    """A segment graph over these buffers, with the pool where the carry
    holds it now."""
    return K.SegmentGraph(cols, nr, carry.pool, scratch.pool_next, carry.pk,
                          carry.ps, carry.pa, carry.scal, scratch.acc,
                          carry.stats, scratch.rows, scratch.rows_alt,
                          scratch.g, scratch.gagg, shape)


def end_segment(carry: Carry, shape: K.LevelShape, seg: torch.Tensor,
                graph: Optional[K.SegmentGraph]) -> tuple:
    """The segment end's one host read: ``(run, live, level, nalive)``,
    the levels the segment ran and each key's ``active`` flag, level and
    live pool rows. A graph's launches are counted here, from ``run``."""
    B = shape.B
    act = K.active(carry.scal, shape.lmax)
    vals = torch.cat((seg[K.SEG_RUN:K.SEG_RUN + 1], act,
                      carry.scal[:, K.LEVEL], carry.scal[:, K.NALIVE])
                     ).tolist()
    run, live = vals[0], vals[1:1 + B]
    level, nalive = vals[1 + B:1 + 2 * B], vals[1 + 2 * B:]
    if graph is not None:
        graph.account(run)
    return run, live, level, nalive


def run_batch(cols: dict, carry: Carry, scratch: Scratch,
              shape: K.LevelShape, seg_iters: int,
              ops: Ops = KERNELS, first: int = FIRST_BATCH_SEGMENT,
              barrier: Optional[Callable[[list, list], bool]] = None
              ) -> list:
    """Segments of levels until no key is active, with one host read at
    each segment end (:func:`end_segment`), the only synchronisation. The
    segments grow from ``first`` levels, doubling up to ``seg_iters``, so
    a search that is decided in a few dozen levels does not run a
    thousand. Returns the levels each segment ran, as counted on the
    device (their sum is the levels the batch ran: the most any key
    advanced). Keys that finish early no-op while the others go on, so
    each key ends where its own search would (the vmapped ``while_loop``
    of the reference). The single-history search is the batch of one.

    ``barrier``, when given, is called at each segment end with the keys'
    ``active`` flags and levels (lists of ints) and says whether to go
    on; it may cancel keys (:func:`cancel_lanes`)."""
    segs = []
    seg = min(first, seg_iters)
    while True:
        words, graph = run_segment(cols, carry, scratch, shape, cols["nr"],
                                   seg, ops)
        run, live, level, _ = end_segment(carry, shape, words, graph)
        segs.append(run)
        if not (any(live) if barrier is None else barrier(live, level)):
            return segs
        seg = min(2 * seg, seg_iters)


def cancel_lanes(carry: Carry, lanes: Sequence[int]) -> None:
    """Stop the searches of keys ``lanes`` at a segment barrier: their
    pool rows die and their live-row count goes to 0. ``active`` (and so
    every kernel) reads the count, so clearing the rows alone would not
    stop a key; with both cleared its later levels change nothing while
    the other keys go on (the reference clears ``alive`` in its host
    carry, whose while-condition reads the rows)."""
    idx = torch.as_tensor(list(lanes), dtype=torch.long,
                          device=carry.scal.device)
    carry.pool.alive[idx] = False
    carry.scal[idx, K.NALIVE] = 0


def _batch_carry0_host(capacity: int, window: int, n_cr: int,
                       inits: Sequence, n_required: Sequence,
                       stats_rows: int) -> tuple:
    """The keyed batch's initial carry: each key's :func:`_carry0_host`
    stacked along a leading key axis (the vmapped reference's layout)."""
    per_key = [_carry0_host(capacity, window, n_cr, ini, nr, stats_rows)
               for ini, nr in zip(inits, n_required)]
    return tuple(np.stack(lane) for lane in zip(*per_key))


class _KeyRow(NamedTuple):
    """A key waiting for a rung: its columns, needed window, the largest
    capacity and window it has tried, forced fraction, crash width and
    the rungs it ran."""

    key: Any
    cols: dict
    wneed: int
    mcap: int
    mwin: int
    ffrac: float
    crw: int
    work: list


def _start_batch(eng, rows: List[dict], shape: K.LevelShape,
                 device) -> tuple:
    """(cols, carry, scratch): the engine's buffers for ``shape`` holding
    the columns of ``rows`` (``_split_packed`` dicts, one per key) and
    their initial carries (with the stats lane while tracing is on); the
    bytes copied up are counted. The caller holds ``eng.lock``."""
    from jepsen_tpu_torch import interop
    stats = obs.enabled()
    carry, scratch = eng.state(shape, device, stats)
    stacked = interop.stack_cols(rows)
    cols = eng.batch_cols(stacked, device)
    host = _batch_carry0_host(
        shape.C, shape.W, shape.CR, [r["ini"] for r in rows],
        [int(r["nr"]) for r in rows],
        stats_rows=shape.lmax + 1 if stats else 0)
    interop.batch_carry_from_numpy(host, device, out=carry)
    scratch.acc.zero_()
    up = cols_nbytes(stacked) + sum(int(np.asarray(x).nbytes) for x in host)
    _TRANSFER_BYTES.inc(up, direction="host-to-device")
    return cols, carry, scratch


def _run_cohort(grp: List[_KeyRow], shape: K.LevelShape, device,
                ops: Ops) -> tuple:
    """One rung of one crash-width cohort: every key of ``grp`` searched
    together. Returns (done, lossy, wovf, best, levels, pools, launched):
    numpy arrays [B], ``pools`` the last living pools (pk, ps, pa) when
    some key was refuted, else None, and the levels the batch ran."""
    from jepsen_tpu_torch.checker.engine import default_engine
    eng = default_engine()
    key = ("batch", shape, obs.enabled())
    phase = call_phase(key)
    with eng.lock, obs.span("checker.device.batch", phase=phase,
                            rung=[shape.C, shape.W, shape.E],
                            keys=shape.B, crash_width=shape.CR,
                            tiebreak=shape.tiebreak):
        t0 = time.perf_counter()
        cols, carry, scratch = _start_batch(eng, [r.cols for r in grp],
                                            shape, device)
        seg, first = _segment_schedule(None, shape.lmax)
        segs = run_batch(cols, carry, scratch, shape, seg, ops, first)
        launched = sum(segs)
        scal = carry.scal.cpu().numpy()
        dt = time.perf_counter() - t0
        done = scal[:, K.DONE] != 0
        wovf = scal[:, K.WOVF] != 0
        # stopped by the level budget with work left: not a refutation
        lossy = (scal[:, K.LOSSY] != 0) | (~done & (scal[:, K.NALIVE] > 0))
        pools = None
        if (~done & ~lossy & ~wovf).any():
            pools = tuple(t.cpu().numpy()
                          for t in (carry.pk, carry.ps, carry.pa))
    mark_executed(key)
    note_call_phase("batch", phase, dt)
    # the keys advance together: the device ran the deepest key's levels
    _LEVELS_TOTAL.inc(launched)
    _SEGMENTS_TOTAL.inc(len(segs))
    _TRANSFER_BYTES.inc(scal.nbytes + (0 if pools is None else sum(
        x.nbytes for x in pools)), direction="device-to-host")
    return (done, lossy, wovf, scal[:, K.BEST], scal[:, K.LEVEL], pools,
            launched)


def _keyed_ladder(ladder: tuple, rows: List[_KeyRow], adaptive: bool,
                  tiebreak0: Optional[str], packed: dict, breq: int,
                  results: dict, device, ops: Ops, model: str,
                  chunk: Optional[Callable[[tuple, int, int], int]] = None,
                  cost_entries: Optional[list] = None) -> list:
    """The keyed batch's escalation loop (``_keyed_ladder`` in the
    reference) for the model named ``model`` (a KernelSpec name): per
    rung, the runnable keys in one batch per crashed-op
    width; keys that overflowed retry on a later rung that grows their
    capacity or window. Fills ``results`` and returns one entry per
    batch run: its rung, crash width, tie-break, keys, largest level
    count, levels run (``levels-launched``) and seconds.
    ``chunk(rung, crw, keys)`` is the most keys one launch takes (default
    ``MAX_KEYS``): the plan gate's byte budget sets it. With tracing on,
    one ``cost`` entry per batch goes into ``cost_entries``."""
    batches = []
    for step, (cap, win, exp) in enumerate(ladder):
        if not rows:
            break
        last_rung = step == len(ladder) - 1
        if len(ladder) > 1 and not last_rung:
            # keys whose needed window exceeds this rung's go on to the
            # next; a dense key (low forced fraction) starts on the dense
            # rung; a retried key skips rungs that grow neither its
            # capacity nor its window
            runnable, deferred = [], []
            for r in rows:
                if adaptive and step == 0 and r.ffrac < 0.5:
                    deferred.append(r)
                elif r.wneed <= win and (cap > r.mcap or win > r.mwin):
                    runnable.append(r)
                else:
                    deferred.append(r)
        else:
            runnable, deferred = rows, []
        if not runnable:
            rows = deferred
            continue
        # the hash tie-break diversifies the first rungs' beam; later
        # rungs, and a single rung unless asked, sort in lex order
        first = step <= (1 if adaptive else 0)
        hash_ok = first and (not last_rung or tiebreak0 is not None)
        tb = (tiebreak0 or "hash") if hash_ok else "lex"
        retry = deferred
        by_cr: Dict[int, list] = {}
        for r in runnable:
            by_cr.setdefault(r.crw, []).append(r)
        # a launch's grid takes at most MAX_KEYS keys, and the byte budget
        # may take fewer: a larger cohort runs in chunks, which changes no
        # key's result
        chunks = []
        for crw, keys in sorted(by_cr.items()):
            size = (K.MAX_KEYS if chunk is None
                    else chunk((cap, win, exp), crw, len(keys)))
            chunks += [(crw, keys[i:i + size])
                       for i in range(0, len(keys), size)]
        for crw, grp in chunks:
            shape = K.LevelShape(C=cap, W=win, E=min(exp or cap, cap),
                                 n=breq, CR=crw, B=len(grp), tiebreak=tb,
                                 model=model)
            t0 = time.perf_counter()
            done, lossy, wovf, best, levels, pools, launched = _run_cohort(
                grp, shape, device, ops)
            batches.append({"rung": (cap, win, exp), "crash-width": crw,
                            "tiebreak": tb, "keys": len(grp),
                            "levels": int(levels.max()),
                            "levels-launched": launched,
                            "seconds": time.perf_counter() - t0})
            if cost_entries is not None and obs.enabled():
                cost_entries.append(kcost.cost_entry(
                    "batch", (cap, win, exp), shape, int(levels.max()),
                    keys=len(grp), crash_width=crw))
            for i, r in enumerate(grp):
                res = _result(bool(done[i]), bool(lossy[i]), bool(wovf[i]),
                              int(best[i]), int(levels[i]), packed[r.key],
                              pool=(None if pools is None
                                    else tuple(x[i] for x in pools)))
                res["rung"] = (cap, win, exp)
                res["crash-width"] = crw
                res["tiebreak"] = tb
                work = r.work + [((cap, win, exp), crw, tb, int(levels[i]))]
                res["work"] = work
                escalatable = bool(lossy[i]) or (bool(wovf[i])
                                                 and win < MAX_WINDOW)
                if (res["valid"] is UNKNOWN and escalatable
                        and not last_rung):
                    retry.append(r._replace(mcap=max(r.mcap, cap),
                                            mwin=max(r.mwin, win),
                                            work=work))
                else:
                    results[r.key] = res
        rows = retry
    return batches


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def check_packed_gpu(p: PackedHistory, kernel: KernelSpec,
                     capacity: Optional[int] = None,
                     window: Optional[int] = WINDOW,
                     expand: Optional[int] = None,
                     segment_iters: Optional[int] = None,
                     device=None,
                     deadline: Optional[float] = None,
                     deadline_s: Optional[float] = None
                     ) -> Dict[str, Any]:
    """Check one packed history. ``capacity=None`` escalates through the
    ladder for the history's needed window; with an explicit capacity,
    ``expand`` < capacity selects best-first search (None = BFS). Runs in
    checkpointed segments of ``segment_iters`` levels. ``device=None``
    means CUDA. Past ``deadline`` (a ``time.monotonic()`` instant) the
    search stops at its next segment barrier with the timeout result.
    ``deadline_s`` is each segment's watchdog: past it the result is
    UNKNOWN with the wedge and the search's ``checkpoint`` (see
    :func:`jepsen_tpu_torch.resilience.supervised_check_packed`)."""
    from jepsen_tpu_torch import resilience
    return resilience.supervised_check_packed(
        p, kernel, capacity=capacity, window=window, expand=expand,
        segment_iters=segment_iters, device=resolve_device(device),
        deadline=deadline, deadline_s=deadline_s)


def check_history_gpu(history, model: Model,
                      capacity: Optional[int] = None,
                      window: Optional[int] = WINDOW,
                      expand: Optional[int] = None,
                      segment_iters: Optional[int] = None,
                      device=None, deadline: Optional[float] = None,
                      deadline_s: Optional[float] = None
                      ) -> Optional[Dict[str, Any]]:
    """Gate, pack and check one history with the model's kernel (see
    :func:`check_packed_gpu`). None when the model has no integer kernel,
    or the history does not fit its word (an op ``f`` it lacks, or a value
    layout its remap cannot place)."""
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
                            segment_iters=segment_iters, device=dev,
                            deadline=deadline, deadline_s=deadline_s)


def check_keyed_gpu(keyed: Dict[Any, Sequence], model: Model,
                    capacity: Optional[int] = None,
                    window: Optional[int] = WINDOW,
                    expand: Optional[int] = None,
                    ladder: Optional[tuple] = None,
                    tiebreak0: Optional[str] = None,
                    device=None, ops: Ops = KERNELS) -> Dict[str, Any]:
    """Check a {key: history} map as batched device searches: every key of
    a rung and crashed-op width advances one level per launch.

    ``capacity=None`` and ``ladder=None`` escalate through the adaptive
    ladder: the slim first rung (dense keys, whose forced fraction is
    below one half, start on the double-expansion rung after it), the
    narrow capacity ladder, then the wide rungs; only keys that
    overflowed re-run. ``ladder=`` pins the rungs; ``capacity=`` one rung.
    ``tiebreak0`` ("lex" or "hash") sets the first rungs' tie-break, and
    on a single rung asks for it. A key whose history is malformed or
    does not encode is UNKNOWN alone, with the ``error``. ``device=None``
    means CUDA; ``ops=PLAIN`` runs the kernels' plain versions instead.
    Besides the per-key ``results``, ``batches`` lists every batch run
    (see :func:`_keyed_ladder`); with tracing on, the top-level ``cost``
    has one entry per batch (one level's work of all its keys, and the
    levels it ran), and ``JTPU_PROF=1`` captures the batches with
    ``torch.profiler``."""
    from jepsen_tpu_torch.analysis import summarize
    from jepsen_tpu_torch.analysis.history_lint import (MalformedHistoryError,
                                                        gate_history)
    from jepsen_tpu_torch.checker import plan
    if window is not None:
        _check_window(window)
    if tiebreak0 not in (None,) + K.TIEBREAKS:
        raise ValueError(f"tiebreak0 must be one of {K.TIEBREAKS}, got "
                         f"{tiebreak0!r}")
    kernel = kernel_spec_for(model)
    if kernel is None:
        raise ValueError(f"model {model!r} has no integer kernel")
    dev = resolve_device(device)
    results: Dict[Any, Dict[str, Any]] = {}
    if not keyed:
        return {"valid": True, "results": results, "backend": "gpu",
                "batches": []}
    packed: Dict[Any, PackedHistory] = {}
    for k, history in keyed.items():
        try:
            gate_history(history, where=f"the keyed device search "
                                        f"(key {k!r})")
            packed[k] = pack_with_init(history, model, kernel)[0]
        except MalformedHistoryError as e:
            results[k] = {"valid": UNKNOWN, "backend": "gpu",
                          "error": str(e), "lint": summarize(e.findings)}
        except ValueError as e:
            results[k] = {"valid": UNKNOWN, "backend": "gpu",
                          "error": str(e)}

    # one padded required width for the batch; the crashed width is per
    # cohort, so one crashy key does not widen the others' levels
    breq = _bucket(max((p.n_required for p in packed.values()),
                       default=1) or 1)
    rows = []
    for key, p in packed.items():
        if p.n_required == 0:
            results[key] = {"valid": True, "levels": 0, "backend": "gpu"}
            continue
        crw = _crash_width(p.n - p.n_required)
        cols = None if crw is None else _split_packed(p, breq, crw, kernel)
        if cols is None:
            results[key] = {
                "valid": UNKNOWN, "backend": "gpu",
                "error": f"{p.n - p.n_required} crashed ops exceed the "
                         f"crashed-set width {CRASH_MAX}"}
            continue
        ffrac = float(cols["fr"][:p.n_required].sum()) / p.n_required
        rows.append(_KeyRow(key, cols, _window_needed(p), 0, 0, ffrac, crw,
                            []))

    if rows:
        from jepsen_tpu_torch import accel
        accel.ensure_usable("check_keyed_gpu", device=dev)
    adaptive = False
    if ladder is not None:
        if capacity is not None or expand is not None:
            raise ValueError(
                "pass either ladder= or capacity=/expand=, not both: an "
                "explicit ladder replaces the whole escalation schedule")
        for _, win, _ in ladder:
            _check_window(win)
    elif capacity is not None:
        _check_window(window or WINDOW)
        ladder = ((capacity, window or WINDOW, expand),)
    else:
        adaptive = True
        ladder = _keyed_auto_ladder(dev)
    out: Dict[str, Any] = {}
    chunk = None
    if rows and plan.gate_enabled():
        # the dims aggregate over the keys: the widest required section,
        # the crashiest key, the widest needed window
        dims = plan.PlanDims(
            n_required=max(packed[r.key].n_required for r in rows),
            n_crashed=max(packed[r.key].n - packed[r.key].n_required
                          for r in rows),
            window_needed=max(r.wneed for r in rows), keys=len(rows))
        ladder, out["plan"] = plan.gate_ladder(
            dims, kernel, ladder, kind="batch",
            explicit=capacity is not None, keys=len(rows),
            where="the keyed device search", device=dev)
        limit = out["plan"]["bytes-limit"]
        if limit is not None:
            def chunk(rung, crw, keys):
                return plan.batch_chunk(plan.Candidate(
                    "batch", *rung, breq, crw, keys=keys), limit)
    cost_entries: list = []
    with obs.profiler.capture():
        batches = _keyed_ladder(ladder, rows, adaptive, tiebreak0, packed,
                                breq, results, dev, ops, kernel.name, chunk,
                                cost_entries)
    if cost_entries:
        # at the top level: a batch's cost belongs to all its keys
        out["cost"] = cost_entries
    return {"valid": merge_valid(r["valid"] for r in results.values()),
            "results": results, "backend": "gpu", "batches": batches, **out}


def _keyed_auto_ladder(device: torch.device) -> tuple:
    """The keyed batch's adaptive schedule: the slim first rung, the dense
    keys' double-expansion rung, the narrow escalations, the wide tail."""
    lad0 = _capacity_ladder(device)
    cap0, exp0 = lad0[0]
    return (((cap0, 32, exp0), (cap0, 32, max(8, exp0 * 2)))
            + tuple((c, 32, e) for c, e in lad0[1:])
            + ((512, 64, 512), (4096, 128, 1024), (16384, 128, 4096)))


# ---------------------------------------------------------------------------
# The gang: independent histories searched as one batch (the serve daemon)
# ---------------------------------------------------------------------------

#: Fault-injection seam of the gang path: when set, called with the gang's
#: packed members before any device work. Raising from it stands for a
#: failure of the whole batched call, which the serve daemon's
#: :func:`jepsen_tpu_torch.resilience.bisect_poison` isolates by splitting
#: the gang and running the halves again. Tests and ``chip_smoke.py`` set
#: and clear it.
_GANG_FAULT: Optional[Callable[[list], None]] = None


def check_packed_gang_gpu(pks: Sequence[PackedHistory], kernel: KernelSpec,
                          deadlines: Optional[Sequence[Optional[float]]]
                          = None,
                          segment_iters: Optional[int] = None,
                          device=None, ops: Ops = KERNELS
                          ) -> List[Dict[str, Any]]:
    """Check a gang of packed single-key histories as one batch: every
    member of a rung advances one level per launch of K1-K4 (the key axis
    is the gang axis), under the lex tie-break.

    Each member's result is the serial segmented search's
    (:func:`check_packed_gpu`): the same ladder (:func:`_ladder_for` at
    its needed window, on ``device``), the same per-key search, the same
    summary, since a key of the batch neither reads nor writes another.
    Members needing different ladders run as separate groups; within a
    group the columns are padded to the largest member's widths, which
    is the member's own when the gang is one shape bucket (the serve
    daemon's gangs are).

    ``deadlines[i]`` is a ``time.monotonic()`` instant for member ``i``
    (None: no deadline). At the first segment barrier past it the
    member's search is cancelled on the device (:func:`cancel_lanes`)
    while the others go on, and it reports the serve timeout shape
    (``":info/timeout"``, ``error-class`` ``"wedge"``,
    ``gang-cancelled``). Gangs always run in segments, since the barrier
    is the cancellation point: ``segment_iters=0`` means the default.

    The carry stays on the device between segments: a barrier reads the
    members' ``active`` flags and levels, and the carry comes to the host
    once, when the rung ends. No OOM shrink happens here: a failed call
    raises, for the caller to bisect. Returns one result per member,
    aligned with ``pks``. ``device=None`` means CUDA."""
    dev = resolve_device(device)
    pks = list(pks)
    if not pks:
        return []
    if _GANG_FAULT is not None:
        _GANG_FAULT(pks)
    from jepsen_tpu_torch import accel
    accel.ensure_usable("check_packed_gang_gpu", device=dev)
    results: List[Optional[Dict[str, Any]]] = [None] * len(pks)
    seg = _segment_config(segment_iters) or DEFAULT_SEGMENT_ITERS
    for ladder, idx in _gang_groups(pks, results, dev).items():
        _gang_ladder(pks, kernel, idx, ladder, seg, deadlines, results, dev,
                     ops)
    return results


def _gang_groups(pks, results, device) -> Dict[tuple, list]:
    """Write the trivial and crashed-set-overflow members' results (the
    early outs of :func:`_prep_single`) into ``results``, and group the
    others by their ladder: a member escalates exactly as it would
    alone."""
    groups: Dict[tuple, list] = {}
    for i, p in enumerate(pks):
        early = _early_result(p)
        if early is not None:
            results[i] = early
        else:
            groups.setdefault(_ladder_for(_window_needed(p), device),
                              []).append(i)
    return groups


def _gang_ladder(pks, kernel, idx, ladder, seg, deadlines, results, device,
                 ops) -> None:
    """Run one group of the gang up its ladder; members still UNKNOWN and
    escalatable after a rung go on to the next, the others' results are
    written into ``results``."""
    from jepsen_tpu_torch.resilience import timeout_result
    breq = max(_bucket(pks[i].n_required) for i in idx)
    crw = max(_crash_width(pks[i].n - pks[i].n_required) for i in idx)
    cols = {i: _split_packed(pks[i], breq, crw, kernel) for i in idx}
    work: Dict[int, list] = {i: [] for i in idx}
    pending = list(idx)
    for cap, win, exp in ladder:
        if not pending:
            return
        shape = K.LevelShape(C=cap, W=win, E=min(exp or cap, cap), n=breq,
                             CR=crw, B=len(pending), model=kernel.name)
        dls = [deadlines[i] if deadlines else None for i in pending]
        host, cancelled = _run_gang_rung([cols[i] for i in pending], dls,
                                         shape, seg, device, ops)
        still = []
        for j, i in enumerate(pending):
            if j in cancelled:
                # a cancelled lane's carry is not summarised: no live rows
                # would read as a refutation
                results[i] = dict(timeout_result(cancelled[j],
                                                 (cap, win, exp)),
                                  **{"gang-cancelled": True})
                continue
            lane = tuple(a[j] for a in host)
            done, lossy, wovf, best, levels, pool = _summarize_carry(lane)
            out = _result(done, lossy, wovf, best, levels, pks[i],
                          pool=pool)
            out["rung"] = (cap, win, exp)
            out["crash-width"] = _crash_width(
                pks[i].n - pks[i].n_required) or 0
            out["tiebreak"] = "lex"
            work[i].append(((cap, win, exp), out["crash-width"], "lex",
                            levels))
            out["work"] = list(work[i])
            out["gang-size"] = len(pending)
            results[i] = out
            if out["valid"] is UNKNOWN and not (
                    wovf and win >= MAX_WINDOW and not lossy):
                still.append(i)
        pending = still


def _run_gang_rung(rows: List[dict], deadlines: list, shape: K.LevelShape,
                   seg: int, device, ops: Ops) -> tuple:
    """One rung of a gang group under the engine's lock: the members'
    carries start on the device, segments run until no member is active,
    and at each barrier the members past their deadline are cancelled.
    Returns the final carry as the reference's vmapped numpy tuple and
    {lane: level} of the cancelled members."""
    from jepsen_tpu_torch import interop
    from jepsen_tpu_torch.checker.engine import default_engine
    eng = default_engine()
    cancelled: Dict[int, int] = {}
    key = ("batch-segment", shape, obs.enabled())
    with eng.lock:
        # each segment is one timed call, ended by the barrier's host read
        clock = {"t0": time.perf_counter(), "phase": call_phase(key)}
        cols, carry, scratch = _start_batch(eng, rows, shape, device)

        def barrier(live: list, level: list) -> bool:
            dt = time.perf_counter() - clock["t0"]
            note_call_phase("batch-segment", clock["phase"], dt)
            mark_executed(key)
            _SEGMENTS_TOTAL.inc()
            clock.update(t0=time.perf_counter(), phase="execute")
            now = time.monotonic()
            late = [j for j, dl in enumerate(deadlines)
                    if live[j] and dl is not None and now >= dl]
            if late:
                cancel_lanes(carry, late)
                cancelled.update((j, level[j]) for j in late)
            return sum(live) > len(late)

        with obs.span("checker.device.batch-segment",
                      rung=[shape.C, shape.W, shape.E], gang=shape.B):
            _LEVELS_TOTAL.inc(sum(run_batch(
                cols, carry, scratch, shape, seg, ops,
                min(FIRST_BATCH_SEGMENT, seg), barrier)))
        host = interop.batch_carry_to_numpy(carry)
        _TRANSFER_BYTES.inc(sum(int(x.nbytes) for x in host),
                            direction="device-to-host")
        return host, cancelled
