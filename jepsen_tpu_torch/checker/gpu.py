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
launch, and one history is a batch of one. One history's pool may also
be sharded over a device mesh (:func:`check_packed_sharded`), a keyed
batch split over a ``keys`` mesh (``check_keyed_gpu(mesh=)``), and a
search or a gang run on the hosts of an elastic fleet
(:mod:`jepsen_tpu_torch.fleet`, :func:`check_packed_gang_fleet`).

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
    merge_runs: Callable = K.merge_runs   # the pool-sharded search's


KERNELS = Ops(K.expand, K.sort_rows, K.group_scan, K.dedup_truncate,
              K.seg_active, K.merge_runs)
PLAIN = Ops(K.expand_plain,
             lambda rows, scal, shape, rows_alt: K.sort_rows_plain(
                 rows, scal, shape),
             K.group_scan_plain, K.dedup_truncate_plain, K.seg_active_plain,
             K.merge_runs_plain)


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
        # copies: on the CPU a view would change with the next cohort
        scal = carry.scal.cpu().numpy().copy()
        dt = time.perf_counter() - t0
        done = scal[:, K.DONE] != 0
        wovf = scal[:, K.WOVF] != 0
        # stopped by the level budget with work left: not a refutation
        lossy = (scal[:, K.LOSSY] != 0) | (~done & (scal[:, K.NALIVE] > 0))
        pools = None
        if (~done & ~lossy & ~wovf).any():
            pools = tuple(t.cpu().numpy().copy()
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


#: The key of a mesh batch's padding rows (trivially complete searches).
_MESH_PAD = object()

def _mesh_chunks(runnable: List[_KeyRow], packed: dict, breq: int,
                 kernel: KernelSpec, devices: List[torch.device]) -> list:
    """A rung's keys laid out over a ``keys`` mesh: one cohort at the
    widest crashed width (each narrower key's columns re-split to it),
    padded to a multiple of the axis with trivially complete rows (a
    copy of the last key's columns with no required op: done at level
    0), and cut into the devices' contiguous shares. Returns ``(crw,
    rows, device)`` per share."""
    wmax = max(r.crw for r in runnable)
    grp = [r if r.crw == wmax else
           r._replace(cols=_split_packed(packed[r.key], breq, wmax, kernel),
                      crw=wmax)
           for r in runnable]
    naxis = len(devices)
    pad = (-len(grp)) % naxis
    if pad:
        last = grp[-1]
        grp = grp + [last._replace(key=_MESH_PAD,
                                   cols=dict(last.cols, nr=np.int32(0)))
                     ] * pad
    per = len(grp) // naxis
    return [(wmax, grp[i * per:(i + 1) * per], d)
            for i, d in enumerate(devices)]


def _keyed_ladder(ladder: tuple, rows: List[_KeyRow], adaptive: bool,
                  tiebreak0: Optional[str], packed: dict, breq: int,
                  results: dict, device, ops: Ops, model: str,
                  chunk: Optional[Callable[[tuple, int, int], int]] = None,
                  cost_entries: Optional[list] = None,
                  mesh_devices: Optional[List[torch.device]] = None,
                  kernel: Optional[KernelSpec] = None,
                  mesh_ranks: Optional[tuple] = None,
                  rank: int = 0) -> list:
    """The keyed batch's escalation loop (``_keyed_ladder`` in the
    reference) for the model named ``model`` (a KernelSpec name): per
    rung, the runnable keys in one batch per crashed-op
    width; keys that overflowed retry on a later rung that grows their
    capacity or window. Fills ``results`` and returns one entry per
    batch run: its rung, crash width, tie-break, keys, largest level
    count, levels run (``levels-launched``) and seconds.
    ``chunk(rung, crw, keys)`` is the most keys one launch takes (default
    ``MAX_KEYS``): the plan gate's byte budget sets it. With tracing on,
    one ``cost`` entry per batch goes into ``cost_entries``. On a mesh
    (``mesh_devices``, with the ``kernel``) a rung's keys run as one
    cohort at the widest
    crashed width, padded with trivially complete rows to a multiple of
    the mesh axis, each device taking its contiguous share, as the
    reference's mesh path lays the batch out; the padding rows report
    nothing. On a mesh across ranks (``mesh_ranks``, each entry's rank;
    this process is ``rank``) a rank runs the shares of its own entries
    and every rank's outputs are gathered (the per-key scalars, and the
    pools of a share where a key is refuted), so that every rank takes
    the same decisions and fills the same results."""
    from jepsen_tpu_torch import parallel
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
        chunks = []
        if mesh_devices is None:
            by_cr: Dict[int, list] = {}
            for r in runnable:
                by_cr.setdefault(r.crw, []).append(r)
            # a launch's grid takes at most MAX_KEYS keys, and the byte
            # budget may take fewer: a larger cohort runs in chunks, which
            # changes no key's result
            for crw, keys in sorted(by_cr.items()):
                size = (K.MAX_KEYS if chunk is None
                        else chunk((cap, win, exp), crw, len(keys)))
                chunks += [(crw, keys[i:i + size], device)
                           for i in range(0, len(keys), size)]
        else:
            chunks = _mesh_chunks(runnable, packed, breq, kernel,
                                  mesh_devices)
        def shape_of(crw, grp):
            return K.LevelShape(C=cap, W=win, E=min(exp or cap, cap),
                                n=breq, CR=crw, B=len(grp), tiebreak=tb,
                                model=model)
        runs = {}
        for ci, (crw, grp, dev_c) in enumerate(chunks):
            if mesh_ranks is not None and mesh_ranks[ci] != rank:
                continue
            t0 = time.perf_counter()
            runs[ci] = _run_cohort(grp, shape_of(crw, grp), dev_c, ops) \
                + (time.perf_counter() - t0,)
        if mesh_ranks is not None:
            for part in parallel.all_gather_object(runs, "all_gather"):
                runs.update(part)
        for ci, (crw, grp, dev_c) in enumerate(chunks):
            shape = shape_of(crw, grp)
            (done, lossy, wovf, best, levels, pools, launched,
             secs) = runs[ci]
            batches.append({"rung": (cap, win, exp), "crash-width": crw,
                            "tiebreak": tb,
                            "keys": sum(r.key is not _MESH_PAD
                                        for r in grp),
                            "levels": int(levels.max()),
                            "levels-launched": launched,
                            "seconds": secs})
            if mesh_devices is not None:
                batches[-1]["device"] = str(dev_c)
            if mesh_ranks is not None:
                batches[-1]["rank"] = mesh_ranks[ci]
            if cost_entries is not None and obs.enabled():
                cost_entries.append(kcost.cost_entry(
                    "batch", (cap, win, exp), shape, int(levels.max()),
                    keys=len(grp), crash_width=crw))
            for i, r in enumerate(grp):
                if r.key is _MESH_PAD:
                    continue
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
    :func:`jepsen_tpu_torch.resilience.supervised_check_packed`).
    ``JTPU_FLEET=N`` (N >= 2) routes the search through the elastic fleet
    over N logical hosts on ``device`` (:mod:`jepsen_tpu_torch.fleet`);
    unset, 0 or 1 leave this path as it is."""
    nfleet = _fleet_hosts()
    if nfleet:
        from jepsen_tpu_torch import fleet as fleet_mod
        return fleet_mod.check_packed_fleet(
            p, kernel, hosts=nfleet, capacity=capacity, window=window,
            expand=expand, segment_iters=segment_iters,
            device=resolve_device(device))
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
                    device=None, ops: Ops = KERNELS,
                    mesh=None) -> Dict[str, Any]:
    """Check a {key: history} map as batched device searches: every key of
    a rung and crashed-op width advances one level per launch. With a
    ``keys`` mesh (:func:`jepsen_tpu_torch.parallel.make_mesh`) each
    rung's keys are split over its devices (see :func:`_keyed_ladder`),
    and ``device`` is the mesh's first device. On a mesh across the ranks
    of a group every rank calls this with the same keys, searches the
    shares of its own entries (``device`` is its first entry's) and
    returns the whole result, with ``"ranks"``.

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
    mesh_devices = None if mesh is None else _mesh_devices(mesh)
    mesh_ranks = None
    if mesh is not None and getattr(mesh, "ranks", ()) \
            and max(mesh.ranks) > 0:
        mesh_ranks = tuple(mesh.ranks)
        from jepsen_tpu_torch import parallel
        parallel.check_ranks(mesh_ranks, max(mesh_ranks) + 1)
        dev = resolve_device(mesh_devices[mesh.local()[0]])
    else:
        dev = resolve_device(device if mesh_devices is None
                             else mesh_devices[0])
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
    with obs.profiler.capture(cuda=dev.type == "cuda"):
        batches = _keyed_ladder(ladder, rows, adaptive, tiebreak0, packed,
                                breq, results, dev, ops, kernel.name, chunk,
                                cost_entries, mesh_devices, kernel,
                                mesh_ranks, getattr(mesh, "rank", 0))
    if cost_entries:
        # at the top level: a batch's cost belongs to all its keys
        out["cost"] = cost_entries
    if mesh_ranks is not None:
        out["ranks"] = max(mesh_ranks) + 1
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

        # phase as the reference's span has it: "compile" on the shape's
        # first call, so that a member's phases attribute the gang's time
        with obs.span("checker.device.batch-segment", phase=clock["phase"],
                      rung=[shape.C, shape.W, shape.E], gang=shape.B):
            _LEVELS_TOTAL.inc(sum(run_batch(
                cols, carry, scratch, shape, seg, ops,
                min(FIRST_BATCH_SEGMENT, seg), barrier)))
        host = interop.batch_carry_to_numpy(carry)
        _TRANSFER_BYTES.inc(sum(int(x.nbytes) for x in host),
                            direction="device-to-host")
        return host, cancelled


# ---------------------------------------------------------------------------
# The pool-sharded search (B8): one history's pool over a device mesh
# ---------------------------------------------------------------------------

#: Mesh axis name for pool-sharded single-history searches.
POOL_AXIS = "pool"

_SHARD_IMBALANCE = obs_metrics.gauge(
    "jtpu_shard_imbalance_ratio",
    "max/mean live pool rows per mesh shard (contiguous blocks of the "
    "pool) of the last pool-sharded search or fleet round; 1.0 is "
    "balanced")


def _shard_balance(pool, naxis: int) -> Optional[Dict[str, Any]]:
    """Per-shard frontier accounting of a pool-sharded search, as the
    reference reports it: each of the ``naxis`` shards is credited with
    ``capacity / naxis`` contiguous rows of the (global, deepest-first)
    pool. Returns ``{"devices", "live-rows", "deepest-k",
    "imbalance-ratio"}`` (max live rows over mean; 1.0 is balanced) and
    sets ``jtpu_shard_imbalance_ratio``; None where the axis does not
    divide the pool."""
    pk, ps, pa = (np.asarray(x) for x in pool)
    cap = int(pa.shape[0])
    if naxis <= 0 or cap % naxis:
        return None
    per = cap // naxis
    live = [int(np.count_nonzero(pa[i * per:(i + 1) * per]))
            for i in range(naxis)]
    deepest = [int(np.max(pk[i * per:(i + 1) * per]
                          * pa[i * per:(i + 1) * per], initial=0))
               for i in range(naxis)]
    mean = sum(live) / naxis
    ratio = round(max(live) / mean, 3) if mean > 0 else 1.0
    _SHARD_IMBALANCE.set(ratio)
    return {"devices": naxis, "live-rows": live, "deepest-k": deepest,
            "imbalance-ratio": ratio}


class _Shard(NamedTuple):
    """One mesh shard's buffers: its slot on the mesh, its device, the
    columns there, its dealt
    pool (C/N rows: its E/N rows of the top E, then its (C-E)/N rows of
    the remainder), scalars, accumulators, and its successor rows with
    the sort's second buffer. ``own`` is False where the shard lies on
    the rank's first device and its pool and rows are views of the
    search's own buffers (nothing is copied); else they are its own, and
    peer copies move them."""

    slot: int
    device: torch.device
    cols: dict
    pool: K.Pool
    scal: torch.Tensor
    acc: torch.Tensor
    rows: torch.Tensor
    rows_alt: torch.Tensor
    own: bool


def _pool_view(pool: K.Pool, a: int, b: int) -> K.Pool:
    return K.Pool(*(t[:, a:b] for t in pool.tensors()))


class ShardedState:
    """The buffers of a pool-sharded search of one history over the
    devices of a mesh (a device may repeat: logical shards). The carry,
    the other pool buffer and the merged rows live on the first device;
    each shard expands and sorts its share of a level where it lies.

    A level (:meth:`level`), the reference's sharded loop body with the
    data flow written out: the pool is dealt into shard order (shard s
    takes rows [sE/N, (s+1)E/N) of the top E and rows [E + s(C-E)/N,
    E + (s+1)(C-E)/N) of the remainder; one gather a column); each shard
    runs K1 ``expand`` at the local shape (C/N, W, E/N) and K2
    ``sort_rows`` on its successor rows, which land in its slot of the
    merged buffer (a view on the first device, a peer copy from another);
    the shards' ``active``, window-overflow and expanded counts reduce
    into the search's scalars; ``merge_runs`` merges the N sorted runs
    into the global order; K3 (on the wide rungs with crashed ops) and
    K4 run on the merged rows at the global shape and write the next
    pool. The union of the shards' rows is the unsharded level's rows and
    the comparator orders whole rows, so the merged rows, and with them
    the level, are the unsharded level's bit for bit.

    On a mesh that spans the ranks of a group (``ranks``, this process's
    ``rank``), the devices are this rank's first device and, for another
    rank's entries, names only. Each rank keeps the whole replicated
    state above on its first device and the buffers of its own shards,
    a contiguous run of L = N / world slots, and runs K1 and K2 for them
    only. One collective a level (:meth:`exchange`) then gives every rank
    every shard's sorted live rows (R / N a shard; each rank writes the
    pad rows after them itself) and its scalar and accumulator rows, and
    every rank runs the reductions, the merge, K3, K4 and K5 on identical
    inputs: every rank holds the same carry, bit for bit, and takes the
    same go-word decision. Under gloo the exchange is staged through
    pinned host buffers made once here; under nccl it gathers the device
    buffers in place."""

    def __init__(self, devices: Sequence[torch.device], cols_np: dict,
                 shape: K.LevelShape, stats: bool,
                 ranks: Sequence[int] = (), rank: int = 0):
        from jepsen_tpu_torch import interop, parallel
        N = len(devices)
        if shape.C % N or shape.E % N:
            raise ValueError(f"the mesh axis ({N}) must divide capacity "
                             f"({shape.C}) and expand ({shape.E})")
        ranks = tuple(ranks) or (0,) * N
        self.world = max(ranks) + 1
        per_rank = parallel.check_ranks(ranks, self.world)
        self.rank = rank
        mine = range(rank * per_rank, (rank + 1) * per_rank)
        self.devices = [torch.device(d) for d in devices]
        lead = self.devices[mine[0]]
        self.lead = lead
        self.shape = shape
        self.local = K.LevelShape(C=shape.C // N, W=shape.W, E=shape.E // N,
                                  n=shape.n, CR=shape.CR, B=1,
                                  tiebreak=shape.tiebreak, model=shape.model)
        rp = self.local.RP
        self.run = max(rp, 256)
        stacked = interop.stack_cols([cols_np])
        by_dev = {}
        for s in mine:
            d = self.devices[s]
            if d not in by_dev:
                by_dev[d] = interop.batch_cols_from_numpy(stacked, d)
        self.cols = by_dev[lead]
        i32 = torch.int32
        self.carry = empty_carry(shape, lead, stats)
        self.pool_next = empty_pool(shape, lead)
        self.dealt = empty_pool(shape, lead)
        self.acc = torch.zeros(1, K.NACC, dtype=i32, device=lead)
        RM = N * self.run
        self.rows = torch.zeros(1, RM, shape.NK, dtype=i32, device=lead)
        self.rows[:, :, 0] = K.INT32_MAX
        self.rows_alt = self.rows.clone()
        self.g = torch.zeros(1, shape.RP, dtype=i32, device=lead)
        self.gagg = torch.zeros(1, K.scan_blocks(shape), dtype=i32,
                                device=lead)
        C, E, Cs, Es = shape.C, shape.E, self.local.C, self.local.E
        rem = Cs - Es
        order = []
        for s in range(N):
            order += list(range(s * Es, (s + 1) * Es))
            order += list(range(E + s * rem, E + (s + 1) * rem))
        self.deal_idx = torch.tensor(order, dtype=torch.long, device=lead)
        # where a run is longer than a shard's rows, the rest of its slot
        # is pad rows, written again each level (the merge passes move
        # live rows through the whole buffer)
        self.pad = (None if self.run == rp else
                    self.rows[:, rp:self.run].clone())
        self.shards: List[_Shard] = []
        for s in mine:
            d = self.devices[s]
            a = s * self.run
            own = d != lead
            if own:
                pool = empty_pool(self.local, d)
                rows = torch.zeros(1, rp, shape.NK, dtype=i32, device=d)
                rows_alt = torch.zeros_like(rows)
            else:
                pool = _pool_view(self.dealt, s * Cs, (s + 1) * Cs)
                rows = self.rows[:, a:a + rp]
                rows_alt = self.rows_alt[:, a:a + rp]
            self.shards.append(_Shard(
                s, d, by_dev[d], pool,
                torch.zeros(1, K.NSCAL, dtype=i32, device=d),
                torch.zeros(1, K.NACC, dtype=i32, device=d),
                rows, rows_alt, own))
        #: the bytes one level's exchange gathers (0 on one process)
        self.exchange_bytes = 0
        #: where set to a list, each exchange appends its (start, end,
        #: the host seconds inside the collective): start and end CUDA
        #: events on the card, ``time.perf_counter`` on the CPU
        self.exchange_log: Optional[list] = None
        if self.world > 1:
            self._exchange_buffers(per_rank)

    def _exchange_buffers(self, per_rank: int) -> None:
        """The exchange's buffers, made once: a rank's block (each of its
        shards' R / N live rows, then its scalars and accumulators) and
        the gathered blocks of every rank, on the first device; under
        gloo with a CUDA device, their pinned host stages too. The tail
        of a slot after the live rows is the pad, written by the rank."""
        from jepsen_tpu_torch import parallel
        R, NK, lead = self.local.R, self.shape.NK, self.lead
        self.blk = R * NK + K.NSCAL + K.NACC
        n = per_rank * self.blk
        i32 = torch.int32
        self.xsend = torch.zeros(n, dtype=i32, device=lead)
        self.xrecv = torch.zeros(self.world * n, dtype=i32, device=lead)
        self.nccl = parallel.backend() == "nccl"
        self.staged = lead.type == "cuda" and not self.nccl
        if self.staged:
            self.hsend = torch.zeros(n, dtype=i32, pin_memory=True)
            self.hrecv = torch.zeros(self.world * n, dtype=i32,
                                     pin_memory=True)
        self.pad_tail = self.rows[:, R:self.run].clone()
        self.exchange_bytes = 4 * self.world * n

    def exchange(self) -> torch.Tensor:
        """The level's collective on a mesh across ranks: every rank's
        block of shard runs and scalar rows gathered on every rank, the
        other ranks' runs written into their slots of the merged buffer
        (each followed by the pad rows). Returns the [N, NSCAL + NACC]
        scalar and accumulator rows of every shard, in mesh order. A
        failed collective raises (see :func:`jepsen_tpu_torch.parallel.
        collective`)."""
        from jepsen_tpu_torch import parallel
        R, NK, blk = self.local.R, self.shape.NK, self.blk
        rows_words = R * NK
        timed = self.exchange_log is not None
        cuda = self.lead.type == "cuda"
        if timed:
            if cuda:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            else:
                t0 = time.perf_counter()
        for i, sh in enumerate(self.shards):
            o = i * blk
            a = sh.slot * self.run
            self.xsend[o:o + rows_words].view(R, NK).copy_(
                self.rows[0, a:a + R])
            self.xsend[o + rows_words:o + rows_words + K.NSCAL].copy_(
                sh.scal[0])
            self.xsend[o + rows_words + K.NSCAL:o + blk].copy_(sh.acc[0])
        if self.staged:
            self.hsend.copy_(self.xsend)    # synchronous: the runs are in
            g0 = time.perf_counter()
            parallel.all_gather_tensor(self.hrecv, self.hsend)
            g1 = time.perf_counter()
            self.xrecv.copy_(self.hrecv, non_blocking=True)
        else:
            g0 = time.perf_counter()
            parallel.all_gather_tensor(self.xrecv, self.xsend)
            g1 = time.perf_counter()
        _TRANSFER_BYTES.inc(4 * (self.xsend.numel() + self.xrecv.numel()),
                            direction="dcn")
        blocks = self.xrecv.view(-1, blk)
        mine = {sh.slot for sh in self.shards}
        for s in range(blocks.shape[0]):
            if s in mine:
                continue
            a = s * self.run
            self.rows[0, a:a + R].copy_(blocks[s, :rows_words].view(R, NK))
            self.rows[:, a + R:a + self.run].copy_(self.pad_tail)
        if timed:
            if cuda:
                ev1 = torch.cuda.Event(enable_timing=True)
                ev1.record()
                self.exchange_log.append((ev0, ev1, g1 - g0))
            else:
                self.exchange_log.append((t0, time.perf_counter(), g1 - g0))
        return blocks[:, rows_words:]

    def level(self, ops: Ops = KERNELS) -> None:
        """One sharded level (see the class docstring)."""
        self.expand_shards(ops)
        self.finish_level(ops)

    def expand_shards(self, ops: Ops = KERNELS) -> None:
        """The level's sharded half: the deal, each shard's K1 and K2
        into its run of the merged buffer, and the reduction of the
        shards' K1 outputs into the search's scalars."""
        shape, local, carry = self.shape, self.local, self.carry
        for src, dst in zip(carry.pool.tensors(), self.dealt.tensors()):
            torch.index_select(src, 1, self.deal_idx, out=dst)
        rp, Cs = local.RP, local.C
        for sh in self.shards:
            s = sh.slot
            if sh.own:
                sh.pool.copy_(_pool_view(self.dealt, s * Cs, (s + 1) * Cs))
            sh.scal.copy_(carry.scal)
            sh.acc.zero_()
            ops.expand(sh.cols, sh.pool, sh.scal, sh.acc, sh.rows, local,
                       sh.cols["nr"])
            ops.sort_rows(sh.rows, sh.scal, local, sh.rows_alt)
            a = s * self.run
            if sh.own:
                self.rows[:, a:a + rp].copy_(sh.rows)
            if self.pad is not None:
                self.rows[:, a + rp:a + self.run].copy_(self.pad)
        if self.world > 1:
            rows = self.exchange()
            scal, acc = rows[:, :K.NSCAL], rows[:, K.NSCAL:]
        else:
            lead = self.lead
            scal = torch.cat([sh.scal.to(lead) for sh in self.shards])
            acc = torch.cat([sh.acc.to(lead) for sh in self.shards])
        carry.scal[:, K.ACT] = scal[0, K.ACT]
        carry.scal[:, K.WOVF] = scal[:, K.WOVF].amax()
        self.acc[:, K.A_EXPANDED] = acc[:, K.A_EXPANDED].sum()

    def finish_level(self, ops: Ops = KERNELS) -> None:
        """The level's global half: ``merge_runs`` over the shards' sorted
        runs, then K3 (where it runs) and K4 at the global shape, and the
        pool buffers swap."""
        shape, carry = self.shape, self.carry
        merged = ops.merge_runs(self.rows, self.rows_alt, carry.scal, shape,
                                len(self.devices) * self.run, self.run)
        rows = merged[:, :shape.RP]
        if K.group_scan_runs(shape):
            ops.group_scan(rows, carry.scal, self.g, self.gagg, shape)
        ops.dedup_truncate(rows, self.g, self.gagg, carry.pool,
                           self.pool_next, carry.pk, carry.ps, carry.pa,
                           carry.scal, self.acc, carry.stats, shape,
                           self.cols["nr"])
        carry.pool, self.pool_next = self.pool_next, carry.pool

    def segment(self, seg_iters: int, ops: Ops = KERNELS) -> tuple:
        """Up to ``seg_iters`` sharded levels (rounded up to even) in
        level pairs, each pair ended by K5 ``seg_active`` and one host
        read of its go word, as :func:`run_segment`'s host loop; returns
        :func:`end_segment`'s ``(run, live, level, nalive)``."""
        bound = seg_iters + (seg_iters & 1)
        seg = torch.tensor([0, bound, 0, 0], dtype=torch.int32,
                           device=self.lead)
        while True:
            self.level(ops)
            self.level(ops)
            ops.seg_active(self.carry.scal, self.shape.lmax, seg)
            if not int(seg[K.SEG_GO]):
                return end_segment(self.carry, self.shape, seg, None)


def _mesh_devices(mesh) -> List[torch.device]:
    """The devices of a mesh's one axis, in order (a device may repeat)."""
    return [torch.device(d) for d in mesh.devices]


def check_packed_sharded(p: PackedHistory, kernel: KernelSpec, mesh,
                         capacity: int = 4096,
                         window: Optional[int] = None,
                         expand: Optional[int] = None,
                         segment_iters: Optional[int] = None,
                         checkpoint_path: Optional[str] = None,
                         on_checkpoint=None, resume=None,
                         ops: Ops = KERNELS) -> Dict[str, Any]:
    """Check ONE packed history with its search pool sharded over the
    devices of ``mesh`` (:func:`jepsen_tpu_torch.parallel.make_mesh` with
    the ``pool`` axis): the devices cooperate on a single search, the
    frontier-parallel search of the reference's ``check_packed_sharded``.
    Each level runs K1 and K2 on every shard's share of the pool and
    merges the shards' sorted rows (:class:`ShardedState`), so verdict,
    ``levels``, ``best_k`` and the carry at every segment end are the
    unsharded :func:`check_packed_gpu`'s at the same (capacity, window,
    expand) under the lex tie-break, bit for bit.

    The mesh axis must divide ``capacity`` and ``expand``; ``window=None``
    takes the history's needed window bucket; ``expand=None`` is about
    capacity / 8 rounded up to the axis (best-first: a sharded search
    exists to go big). The search runs in segments of the supervised
    search's schedule (``segment_iters``, ``JTPU_SEGMENT_ITERS``), a host
    loop of levels. ``checkpoint_path`` / ``on_checkpoint`` save and
    observe a :class:`~jepsen_tpu_torch.resilience.Checkpoint` at each
    segment end; ``resume`` continues one, on a mesh of any axis size
    that divides the carry's capacity (the carry is global state: the
    axis only splits its rows), which the elastic fleet leans on. The
    result is :func:`check_packed_gpu`'s, with ``pool-sharding`` and
    ``shard-balance`` (:func:`_shard_balance`).

    On a mesh across the ranks of a group (:func:`jepsen_tpu_torch.
    parallel.make_mesh` after ``initialize_multihost``) every rank calls
    this with the same arguments; each runs its own shards, the runs are
    exchanged every level (:class:`ShardedState`), every segment end
    checks that the ranks hold the same level and carry, and every rank
    returns the same result, with ``"ranks"``. Rank 0 writes
    ``checkpoint_path``; ``on_checkpoint`` is called on every rank."""
    from jepsen_tpu_torch import accel, interop, parallel, resilience
    from jepsen_tpu_torch.checker import plan as plan_mod
    devices = _mesh_devices(mesh)
    naxis = len(devices)
    ranks = tuple(getattr(mesh, "ranks", ()))
    rank = getattr(mesh, "rank", 0)
    world = max(ranks) + 1 if ranks else 1
    lead = devices[mesh.local()[0]] if world > 1 else devices[0]
    cols_np, early = _prep_single(p, kernel)
    if early is not None:
        early["pool-sharding"] = f"{POOL_AXIS}={naxis}"
        return early
    accel.ensure_usable("check_packed_sharded", device=lead)
    if expand is None:
        per = max(1, capacity // 8)
        expand = max(naxis, -(-per // naxis) * naxis)
    if window is None:
        window = _window_bucket(_window_needed(p))
    _check_window(window)
    plan_entry = None
    if plan_mod.gate_enabled():
        plan_entry = plan_mod.gate_sharded(p, kernel, naxis, capacity,
                                           window, expand, device=lead,
                                           ranks=world)
    if capacity % naxis or expand % naxis:
        raise ValueError(
            f"the mesh axis ({naxis}) must divide capacity ({capacity}) "
            f"and expand ({expand})")
    n, cr_pad = cols_np["f"].shape[0], cols_np["cf"].shape[0]
    lmax = _level_budget(n, cr_pad)
    crw = _crash_width(p.n - p.n_required) or 0
    stats = obs.enabled()
    if resume is not None:
        host = tuple(np.asarray(x) for x in resume.carry)
        if int(host[0].shape[0]) != capacity:
            raise ValueError(
                f"checkpoint capacity {int(host[0].shape[0])} != requested "
                f"{capacity}; re-embed the pool first "
                f"(jepsen_tpu_torch.fleet.repad_pool)")
        seg_idx = int(resume.segment)
    else:
        host = _carry0_host(capacity, window, cr_pad, cols_np["ini"],
                            int(cols_np["nr"]))
        seg_idx = 0
    host = resilience._fit_carry_stats(host, stats, lmax)
    if stats:
        host = resilience._grow_carry_stats(host, lmax)
    shape = K.LevelShape(C=capacity, W=window, E=min(expand, capacity),
                         n=n, CR=cr_pad, model=kernel.name)
    st = ShardedState(devices, cols_np, shape, stats, ranks, rank)
    interop.carry_from_numpy(host, lead, out=st.carry)
    seg, first = _segment_schedule(segment_iters, lmax)
    live = resilience._carry_active(host, lmax)
    level = int(host[8])
    key = ("sharded", shape, naxis, stats)
    seg_levels: list = []
    while live:
        seg_len = min(seg, first << min(seg_idx, 16))
        phase = call_phase(key)
        t0 = time.perf_counter()
        with obs.span("checker.device.sharded", phase=phase,
                      segment=seg_idx, level=level,
                      rung=[capacity, window, expand], axis=naxis):
            _, act, lv, nalive = st.segment(seg_len, ops)
        dt = time.perf_counter() - t0
        mark_executed(key)
        note_call_phase("sharded", phase, dt)
        seg_idx += 1
        seg_levels.append(lv[0] - level)
        _LEVELS_TOTAL.inc(lv[0] - level)
        _SEGMENTS_TOTAL.inc()
        _FRONTIER_HWM.set_max(nalive[0])
        level, live = lv[0], bool(act[0])
        ended = None
        if world > 1:
            ended = interop.carry_to_numpy(st.carry)
            _lockstep(ended, level)
        if checkpoint_path or on_checkpoint is not None:
            cp = resilience.Checkpoint(
                carry=(interop.carry_to_numpy(st.carry) if ended is None
                       else ended),
                rung=(capacity, window, expand), window=window,
                expand_eff=expand, crash_width=crw, segment=seg_idx)
            if checkpoint_path and rank == 0:
                cp.save(checkpoint_path)
            if on_checkpoint is not None:
                on_checkpoint(cp)
    host = interop.carry_to_numpy(st.carry)
    done, lossy, wovf, best, levels, pool = _summarize_carry(host)
    out = _result(done, lossy, wovf, best, levels, p, pool=pool)
    balance = _shard_balance(pool, naxis)
    if balance is not None:
        out["shard-balance"] = balance
    out["pool-sharding"] = f"{POOL_AXIS}={naxis}"
    if world > 1:
        out["ranks"] = world
    out["rung"] = (capacity, window, expand)
    out["crash-width"] = crw
    out["segments"] = seg_idx
    out["segment-iters"] = seg
    out["segment-levels"] = seg_levels
    if plan_entry is not None:
        out["plan"] = plan_entry
    return out


def _carry_crc(host: tuple) -> int:
    """The CRC-32 of a host carry's lanes, in lane order."""
    import zlib
    crc = 0
    for x in host:
        crc = zlib.crc32(np.ascontiguousarray(x).tobytes(), crc)
    return crc


def _lockstep(host: tuple, level: int) -> None:
    """A segment end of a search across ranks: every rank gives its level
    and a CRC-32 of its host carry, and any difference raises. The ranks
    decide their go words alone; this is where a rank that drifted from
    the others shows."""
    from jepsen_tpu_torch import parallel
    seen = parallel.all_gather_object((int(level), _carry_crc(host)),
                                      "all_gather")
    if len(set(seen)) != 1:
        raise RuntimeError(f"the ranks' searches diverged at a segment "
                           f"end: (level, carry CRC-32) by rank {seen}")


def check_history_sharded(history, model: Model, mesh,
                          **kwargs) -> Optional[Dict[str, Any]]:
    """Gate, pack and check one history pool-sharded over ``mesh`` (see
    :func:`check_packed_sharded`). None when the model has no integer
    kernel or the history does not fit its word."""
    from jepsen_tpu_torch.analysis.history_lint import gate_history
    gate_history(history, where="the pool-sharded device search")
    try:
        pk = pack_with_init(history, model)
    except ValueError:
        return None
    if pk is None:
        return None
    packed, kernel = pk
    return check_packed_sharded(packed, kernel, mesh, **kwargs)


# ---------------------------------------------------------------------------
# The fleet's device side: host-carry segments, the pool order, the routes
# ---------------------------------------------------------------------------


def _pool_sort_host(k, mask, cmask, state, alive) -> np.ndarray:
    """The lex order of K2 over pool rows, on the host: the permutation
    that puts them deepest first (a live row keyed MAXK - depth, a dead
    one MAXK + 1 + k, then k, the mask words, state, the crashed-mask
    popcount and words). The elastic fleet (:mod:`jepsen_tpu_torch.
    fleet`) merges its hosts' pool shards with it, so that a merge on the
    host and the device's sort agree on which rows a truncation keeps."""
    k = np.asarray(k, np.int64)
    mask = np.asarray(mask, np.uint32)
    cmask = np.asarray(cmask, np.uint32)
    state = np.asarray(state, np.int64)
    alive = np.asarray(alive, bool)
    MW = mask.shape[1] if mask.ndim == 2 else 1
    MC = cmask.shape[1] if cmask.ndim == 2 else 1
    mask = mask.reshape(k.shape[0], MW)
    cmask = cmask.reshape(k.shape[0], MC)
    depth = k + sum(_popcount32_host(mask[:, w]) for w in range(MW))
    key1 = np.where(alive, np.int64(K.MAXK) - depth, K.MAXK + 1 + k)
    pc = sum(_popcount32_host(cmask[:, w]) for w in range(MC))
    terms = ([key1, k] + [mask[:, w] for w in range(MW)]
             + [state, pc] + [cmask[:, w] for w in range(MC)])
    # np.lexsort's last key is its primary one; the device sort's first
    return np.lexsort(tuple(terms[::-1]))


def segment_from_host(cols: dict, carry: tuple, rung: tuple, seg_iters: int,
                      model: str, device=None, ops: Ops = KERNELS) -> tuple:
    """One segment of up to ``seg_iters`` levels (rounded up to even) of
    a search whose carry is on the host: the reference's ``_jit_segment``
    called on numpy, what a fleet host runs on its pool shard. ``cols``
    is one history's ``_split_packed`` columns and ``carry`` its 13-lane
    carry, or, for a gang, the columns stacked on a leading lane axis
    (:func:`jepsen_tpu_torch.interop.stack_cols`) and the vmapped carry.
    The carry's row count is the capacity; ``rung`` gives the window and
    the expansion. On CUDA it is one launch of the segment graph. Returns
    the advanced carry in the same layout."""
    from jepsen_tpu_torch import interop
    from jepsen_tpu_torch.checker.engine import default_engine
    dev = resolve_device(device)
    batch = np.asarray(carry[5]).ndim > 0
    stacked = cols if batch else interop.stack_cols([cols])
    B = int(np.asarray(stacked["f"]).shape[0])
    C = int(np.asarray(carry[0]).shape[-1])
    _, win, exp = rung
    shape = K.LevelShape(C=C, W=win, E=min(exp or C, C),
                         n=int(np.asarray(stacked["f"]).shape[1]),
                         CR=int(np.asarray(stacked["cf"]).shape[1]), B=B,
                         model=model)
    eng = default_engine()
    with eng.lock:
        stats = len(carry) > 13
        dc, scratch = eng.state(shape, dev, stats)
        dcols = eng.batch_cols(stacked, dev)
        if batch:
            interop.batch_carry_from_numpy(carry, dev, out=dc)
        else:
            interop.carry_from_numpy(carry, dev, out=dc)
        scratch.acc.zero_()
        if any(_lanes_active(carry, shape.lmax, batch)):
            words, graph = run_segment(dcols, dc, scratch, shape,
                                       dcols["nr"], seg_iters, ops)
            end_segment(dc, shape, words, graph)
        out = (interop.batch_carry_to_numpy(dc) if batch
               else interop.carry_to_numpy(dc))
    _TRANSFER_BYTES.inc(cols_nbytes(stacked) + 2 * sum(
        int(np.asarray(x).nbytes) for x in carry), direction="dcn")
    return out


def _lanes_active(carry: tuple, lmax: int, batch: bool) -> List[bool]:
    """Each lane's host ``active``: not done, a live pool row, the level
    budget not spent (one lane for a single carry)."""
    done = np.atleast_1d(np.asarray(carry[5]))
    alive = np.asarray(carry[4]).reshape(done.shape[0], -1)
    level = np.atleast_1d(np.asarray(carry[8]))
    return [not bool(d) and bool(a.any()) and int(lv) <= lmax
            for d, a, lv in zip(done, alive, level)]


def _fleet_hosts() -> int:
    """The JTPU_FLEET opt-in: N >= 2 routes single-history searches
    through the elastic fleet (:mod:`jepsen_tpu_torch.fleet`) over N
    logical hosts. 0, 1, unset or malformed all mean off: the single-host
    path is then untouched."""
    v = os.environ.get("JTPU_FLEET") or ""
    try:
        n = int(v.strip() or "0")
    except ValueError:
        return 0
    return n if n >= 2 else 0


def _fleet_lost_result(lane_levels: int) -> Dict[str, Any]:
    """A gang lane's result when every fleet host is gone: UNKNOWN with
    no error class, so that the serve daemon re-runs it serially instead
    of counting a breaker failure or a poison."""
    return {"valid": UNKNOWN, "backend": "gpu",
            "error": "all fleet hosts lost", "fleet-lost": True,
            "levels": lane_levels}


def check_packed_gang_fleet(pks: Sequence[PackedHistory],
                            kernel: KernelSpec, hosts: Sequence[Any],
                            deadlines: Optional[Sequence[Optional[float]]]
                            = None,
                            segment_iters: Optional[int] = None,
                            on_round: Optional[Callable] = None,
                            max_retries: int = 2,
                            segment_deadline_s: float = 120.0,
                            stats: Optional[Dict[str, int]] = None,
                            trail: Optional[list] = None,
                            straggler: Optional[Any] = None,
                            device=None) -> List[Dict[str, Any]]:
    """:func:`check_packed_gang_gpu` placed on fleet hosts: each segment
    round splits the gang's lanes over the live hosts (contiguous
    chunks), merges the advanced carries back at the barrier, and a lane
    whose host died mid-segment keeps its carry from before the round and
    runs again on the survivors, so no verdict is lost with a host.

    :class:`jepsen_tpu_torch.fleet.HostLostError` and the retryable
    worker failures (:data:`jepsen_tpu_torch.resilience.RETRYABLE`) are
    absorbed here (bounded retries, then the host is lost) and never
    reach the daemon's poison bisection; other failures raise. When every
    host is gone, the lanes still searching answer
    :func:`_fleet_lost_result`. ``on_round(round_idx, hosts)`` is the
    chaos seam; ``stats`` and ``trail`` collect the placer's counters and
    events; ``straggler`` (a :class:`jepsen_tpu_torch.obs.straggler.
    StragglerDetector`) orders the hosts, unflagged first. ``device`` is
    the hosts' device, whose ladder the members climb (None: CUDA). Each
    member's verdict is the gang's, which is the serial search's."""
    pks = list(pks)
    if not pks:
        return []
    if _GANG_FAULT is not None:
        _GANG_FAULT(pks)
    dev = torch.device("cuda" if device is None else device)
    results: List[Optional[Dict[str, Any]]] = [None] * len(pks)
    groups = _gang_groups(pks, results, dev)
    if not groups:
        return results
    seg = _segment_config(segment_iters) or DEFAULT_SEGMENT_ITERS
    for ladder, idx in groups.items():
        _gang_ladder_fleet(pks, kernel, idx, ladder, seg, deadlines,
                           results, hosts, on_round, max_retries,
                           segment_deadline_s, stats, trail, straggler)
    return results


def _gang_ladder_fleet(pks, kernel, idx, ladder, seg, deadlines, results,
                       hosts, on_round, max_retries, segment_deadline_s,
                       stats, trail, straggler=None) -> None:
    """One ladder group of the gang, its lanes split over the fleet's
    hosts each segment round (see :func:`check_packed_gang_fleet`)."""
    from jepsen_tpu_torch import resilience
    from jepsen_tpu_torch.fleet import HostLostError

    def bump(key, n=1):
        if stats is not None:
            stats[key] = stats.get(key, 0) + n

    def note(event, **kw):
        if trail is not None:
            trail.append(dict({"event": event}, **kw))

    breq = max(_bucket(pks[i].n_required) for i in idx)
    crw = max(_crash_width(pks[i].n - pks[i].n_required) for i in idx)
    cols = {i: _split_packed(pks[i], breq, crw, kernel) for i in idx}
    work: Dict[int, list] = {i: [] for i in idx}
    dead: set = set()
    pending = list(idx)
    round_idx = 0
    for cap, win, exp in ladder:
        if not pending:
            return
        rows = [cols[i] for i in pending]
        arrays = {c: np.stack([np.asarray(r[c]) for r in rows])
                  for c in rows[0]}
        cr_pad = int(rows[0]["cf"].shape[0])
        lmax = _level_budget(breq, cr_pad)
        carry_b = tuple(np.stack(lanes) for lanes in zip(*(
            _carry0_host(cap, win, cr_pad, r["ini"], int(r["nr"]))
            for r in rows)))
        lane_live = [True] * len(pending)
        timed_out: set = set()
        fleet_lost = False
        while any(lane_live):
            # a host that died between rounds leaves the mesh before any
            # lane is placed on it
            swept = False
            for h in hosts:
                if id(h) not in dead and not h.alive():
                    dead.add(id(h))
                    swept = True
                    bump("host-losses")
                    note("host-lost", host=getattr(h, "name", "?"),
                         round=round_idx)
            live = [h for h in hosts if id(h) not in dead]
            if not live:
                fleet_lost = True
                break
            if swept:
                bump("remeshes")
                note("remesh", round=round_idx, live=len(live),
                     rung=[cap, win, exp])
            if straggler is not None:
                live = straggler.prefer(live)
            # every pending lane goes out, finished ones too: their levels
            # change nothing, and each host's shard keeps its shape
            nshards = min(len(live), len(pending))
            sels = [s for s in np.array_split(np.arange(len(pending)),
                                              nshards) if s.size]
            new_carry = tuple(np.array(x) for x in carry_b)
            subs = []
            for h, sel in zip(live, sels):
                sub_cols = {c: np.ascontiguousarray(a[sel])
                            for c, a in arrays.items()}
                sub_carry = tuple(np.ascontiguousarray(c[sel])
                                  for c in carry_b)
                h.submit_gang(sub_cols, sub_carry, kernel, seg,
                              (cap, win, exp), round_idx)
                subs.append((h, sel, sub_cols, sub_carry))
            advanced: set = set()
            lost_this_round = False
            for h, sel, sub_cols, sub_carry in subs:
                attempt = 0
                while True:
                    try:
                        out, secs = h.collect_gang(segment_deadline_s)
                        if straggler is not None:
                            from jepsen_tpu_torch.obs import straggler as S
                            straggler.observe_segment(S.host_key(h), secs)
                        for tgt, c in zip(new_carry, out):
                            tgt[sel] = c
                        advanced.update(int(j) for j in sel)
                        break
                    except HostLostError as e:
                        # its lanes keep their carry from before the round
                        # and run again on the survivors
                        dead.add(id(h))
                        lost_this_round = True
                        bump("host-losses")
                        note("host-lost", host=getattr(h, "name", "?"),
                             round=round_idx, error=str(e))
                        break
                    except RuntimeError as e:
                        cls = resilience.classify_failure(e)
                        if cls not in resilience.RETRYABLE:
                            raise
                        if attempt < max_retries and h.alive():
                            attempt += 1
                            bump("dcn-retries")
                            note("host-retry", host=getattr(h, "name", "?"),
                                 round=round_idx, attempt=attempt,
                                 **{"class": cls})
                            h.submit_gang(sub_cols, sub_carry, kernel, seg,
                                          (cap, win, exp), round_idx)
                            continue
                        # a persistently failing interconnect is a lost
                        # host, not a poisoned request
                        dead.add(id(h))
                        lost_this_round = True
                        bump("host-losses")
                        note("host-lost", host=getattr(h, "name", "?"),
                             round=round_idx, error=str(e),
                             **{"class": cls})
                        break
            carry_b = new_carry
            _SEGMENTS_TOTAL.inc()
            bump("rounds")
            if lost_this_round:
                bump("remeshes")
                n_live = sum(1 for h in hosts
                             if id(h) not in dead and h.alive())
                verdict = None
                try:
                    from jepsen_tpu_torch.checker import plan as plan_mod
                    verdict = plan_mod.check_remesh(
                        pks[pending[0]], max(1, n_live), cap, win, exp)
                except Exception:  # noqa: BLE001 -- advisory only
                    verdict = None
                note("remesh", round=round_idx, live=n_live,
                     rung=[cap, win, exp],
                     ok=None if verdict is None else verdict.get("ok"))
            if on_round is not None:
                on_round(round_idx, hosts)
            round_idx += 1
            now = time.monotonic()
            for j, i in enumerate(pending):
                if not lane_live[j]:
                    continue
                # only a lane that advanced this round can have finished
                if j in advanced:
                    lane = tuple(a[j] for a in carry_b)
                    if not resilience._carry_active(lane, lmax):
                        lane_live[j] = False
                        continue
                dl = deadlines[i] if deadlines else None
                if dl is not None and now >= dl:
                    carry_b[4][j, ...] = False
                    lane_live[j] = False
                    timed_out.add(i)
        still = []
        for j, i in enumerate(pending):
            lane = tuple(a[j] for a in carry_b)
            if i in timed_out:
                results[i] = {
                    "valid": UNKNOWN, "error": ":info/timeout",
                    "error-class": "wedge", "backend": "gpu",
                    "levels": int(lane[8]), "rung": (cap, win, exp),
                    "gang-cancelled": True}
                continue
            if fleet_lost and lane_live[j]:
                results[i] = _fleet_lost_result(int(lane[8]))
                continue
            done, lossy, wovf, best, levels, pool = _summarize_carry(lane)
            _LEVELS_TOTAL.inc(levels)
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
            out["fleet"] = True
            results[i] = out
            if out["valid"] is UNKNOWN and not (
                    bool(wovf) and win >= MAX_WINDOW and not bool(lossy)):
                still.append(i)
        if fleet_lost:
            # no host to escalate on: the lanes that finished a rung keep
            # its result (the daemon re-runs the UNKNOWNs serially)
            return
        pending = still
