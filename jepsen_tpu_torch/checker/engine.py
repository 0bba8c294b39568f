"""The per-process cache of device state for the search.

Counterpart of the executable cache in ``jepsen_tpu/checker/engine.py``.
Where the JAX engine caches one compiled program per rung, this one holds
the loaded kernel library and, per search shape (C, W, E, n, CR, keys B,
tie-break, model) and device, the carry and scratch buffers; per (B, n, CR) and
device, the column buffers. A warm check at a cached shape allocates no
device memory. The buffers serve one check at a time: callers hold
:attr:`Engine.lock` while they use them.

For the serve daemon it also names the shape bucket a history lands in
(:meth:`Engine.bucket_key`) and warms a bucket ahead of its requests
(:meth:`Engine.warm`): there is nothing to compile, so warming builds the
kernel library and allocates each rung's buffers. Warm buckets are kept
in LRU order up to ``JTPU_ENGINE_MAX_BUCKETS`` (0: no bound) and, as the
reference's warm accounting does (``jepsen_tpu/checker/engine.py:304-397``),
up to a byte budget of their records' plan footprints
(``JTPU_ENGINE_BYTES_BUDGET``, :meth:`Engine.set_max_warm_bytes`) and
above a device headroom (:meth:`Engine.evict_below_headroom`); evicting a
bucket frees its buffers. The reference's engine counters count the
buffers allocated and found (``jtpu_engine_builds_total``,
``jtpu_engine_cache_hits_total``), the warming and the evictions.

It also caches the segment graphs (:class:`~jepsen_tpu_torch.kernels.
search.SegmentGraph`), keyed by the shape and the device pointers each
holds: the carry and scratch, the columns, and the graph's own segment
words. A graph is destroyed before any buffer it points to is dropped:
when the state or the columns it uses leave their cache, and when its
bucket is evicted.

Once a CUDA segment has wedged (:mod:`jepsen_tpu_torch.accel` holds the
record), the engine hands out no CUDA state, columns or graphs again: the
card may never come back. The buffers and graphs the wedged segment's
abandoned worker still holds leave the caches (:meth:`Engine.abandon`)
and are kept, never freed nor handed out, until the record is cleared
after that worker has ended (``accel._reset_for_tests``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import torch

from jepsen_tpu_torch import accel
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.obs import metrics as obs_metrics
from jepsen_tpu_torch.obs import trace as obs_trace

log = logging.getLogger("jepsen.engine")

_WARMED_SHAPES = obs_metrics.counter(
    "jtpu_engine_warmed_shapes_total",
    "search shapes warmed ahead of time by an Engine (the kernel "
    "library loaded and the shape's buffers allocated)")
_WARM_SECONDS = obs_metrics.counter(
    "jtpu_engine_warm_seconds_total",
    "wall seconds spent in ahead-of-time Engine warming")
_ENGINE_BUILDS = obs_metrics.counter(
    "jtpu_engine_builds_total",
    "search-state buffers an Engine allocated (first use of a shape)")
_ENGINE_HITS = obs_metrics.counter(
    "jtpu_engine_cache_hits_total",
    "Engine search-state cache hits (a shape's buffers found allocated)")
_ENGINE_EVICTIONS = obs_metrics.counter(
    "jtpu_engine_evictions_total",
    "warm shape buckets LRU-evicted past the max-warm-buckets cap "
    "(JTPU_ENGINE_MAX_BUCKETS / --engine-max-buckets)")


class Engine:
    #: shapes (and column shapes) kept before the oldest is dropped
    MAX_ENTRIES = 16

    def __init__(self, max_warm_buckets: Optional[int] = None,
                 max_warm_bytes: Optional[int] = None):
        self.lock = threading.Lock()
        self.lib = None
        self._states: "OrderedDict[tuple, Tuple[G.Carry, G.Scratch]]" = \
            OrderedDict()
        self._cols: "OrderedDict[tuple, dict]" = OrderedDict()
        #: bucket -> warm record, stalest first; guarded by _meta, so that
        #: a status read does not wait for a search holding ``lock``
        self._meta = threading.Lock()
        self._warm: "OrderedDict[tuple, Dict[str, Any]]" = OrderedDict()
        self.max_warm_buckets = (_env_max_warm_buckets()
                                 if max_warm_buckets is None
                                 else max(0, int(max_warm_buckets)))
        self.max_warm_bytes = (_env_max_warm_bytes()
                               if max_warm_bytes is None
                               else max(0, int(max_warm_bytes)))
        self.evictions = 0
        #: segment graphs by (shape, device pointers), stalest first
        self._graphs: "OrderedDict[tuple, K.SegmentGraph]" = OrderedDict()
        self._glock = threading.RLock()

    def _cached(self, cache: OrderedDict, key: tuple, build):
        hit = cache.get(key)
        if hit is not None:
            cache.move_to_end(key)
            return hit
        cache[key] = hit = build()
        while len(cache) > self.MAX_ENTRIES:
            self._drop_graphs(cache.popitem(last=False)[1])
        return hit

    def segment_graph(self, cols: dict, nr: torch.Tensor, carry: G.Carry,
                      scratch: G.Scratch,
                      shape: K.LevelShape) -> K.SegmentGraph:
        """The segment graph over these buffers, captured at first use.
        The key holds every pointer the graph would hold, the pool's
        buffer among them, so a hit is a graph over exactly these
        buffers, and whether K4 writes the stats lane."""
        _refuse_if_wedged(carry.scal.device)
        key = (shape, str(carry.scal.device), carry.stats is not None, tuple(
            t.data_ptr() for t in _tensors(cols, nr, carry, scratch)))
        with self._glock:
            hit = self._graphs.get(key)
            if hit is not None:
                self._graphs.move_to_end(key)
                return hit
            self._graphs[key] = hit = G.capture_segment(cols, nr, carry,
                                                        scratch, shape)
            while len(self._graphs) > self.MAX_ENTRIES:
                self._graphs.popitem(last=False)[1].destroy()
            return hit

    def _drop_graphs(self, entry) -> None:
        """Destroy every segment graph that points into ``entry``, a
        (carry, scratch) pair or a column dict about to be dropped."""
        if isinstance(entry, dict):
            doomed = {t.data_ptr() for t in entry.values()}
        else:
            doomed = {t.data_ptr() for t in _tensors({}, None, *entry)}
        with self._glock:
            for key in [k for k, g in self._graphs.items()
                        if g.ptrs() & doomed]:
                self._graphs.pop(key).destroy()

    def state(self, shape: K.LevelShape, device: torch.device,
              stats: bool = True) -> Tuple[G.Carry, G.Scratch]:
        """Carry and scratch buffers for one search shape, the carry with
        the stats lane or without it (``stats``; a segment graph over
        either is cached apart, since their pointers differ). On a CUDA
        device the kernel library is built and loaded first; a failure
        raises, and so does an allocation the device cannot hold, and a
        CUDA device once a segment has wedged."""
        _refuse_if_wedged(device)
        if device.type == "cuda" and self.lib is None:
            from jepsen_tpu_torch.kernels import build
            self.lib = build.load()
        key = (shape, str(device), bool(stats))
        if key in self._states:
            _ENGINE_HITS.inc()
        else:
            _ENGINE_BUILDS.inc()
        return self._cached(self._states, key,
                            lambda: self._alloc(shape, device, stats))

    def _alloc(self, shape: K.LevelShape, device: torch.device,
               stats: bool = True):
        try:
            return (G.empty_carry(shape, device, stats),
                    G.empty_scratch(shape, device))
        except torch.OutOfMemoryError as e:
            raise MemoryError(
                f"the search state of {shape.B} keys at rung (C={shape.C}, "
                f"W={shape.W}, E={shape.E}), n={shape.n}, CR={shape.CR} "
                f"needs {G.state_bytes(shape, stats)} bytes on {device}"
            ) from e

    def batch_cols(self, cols_np: dict, device: torch.device,
                   copy: bool = True) -> dict:
        """A batch's stacked columns copied into this engine's buffers for
        their shape; with ``copy=False`` the buffers only, for the caller
        to fill (``interop.batch_cols_from_numpy(..., out=)``)."""
        from jepsen_tpu_torch import interop
        _refuse_if_wedged(device)
        B, n, cr = cols_np["f"].shape + cols_np["cf"].shape[1:]

        def dims(c):
            if c == "nr":
                return (B,)
            return (B, n + 1 if c == "sm" else n if c in K.COLS[:8] else cr)

        bufs = self._cached(self._cols, ((B, n), (B, cr), str(device)),
                            lambda: {c: torch.empty(dims(c), dtype=torch.int32,
                                                    device=device)
                                     for c in interop.DEVICE_COLS})
        if copy:
            interop.batch_cols_from_numpy(cols_np, device, out=bufs)
        return bufs

    def cols(self, cols_np: dict, device: torch.device) -> dict:
        """One history's columns, as a batch of one."""
        from jepsen_tpu_torch import interop
        return self.batch_cols(interop.stack_cols([cols_np]), device)

    def abandon(self, shape: K.LevelShape, device: torch.device,
                cols: dict) -> None:
        """Take the state of ``shape`` on ``device``, the columns ``cols``
        and every segment graph over them out of the caches, for good: a
        wedged segment's worker still holds them. They are kept, neither
        freed nor handed out, until :func:`release_abandoned`. The caller
        holds ``lock``."""
        held = [self._cols.pop(k) for k, v in list(self._cols.items())
                if v is cols]
        doomed = {t.data_ptr() for t in cols.values()}
        for stats in (True, False):
            state = self._states.pop((shape, str(device), stats), None)
            if state is not None:
                held.append(state)
                doomed |= {t.data_ptr() for t in _tensors({}, None, *state)}
        with self._glock:
            for key in [k for k, g in self._graphs.items()
                        if g.ptrs() & doomed]:
                held.append(self._graphs.pop(key))
        with _ABANDONED_LOCK:
            _ABANDONED.extend(held)


    # -- shape buckets and warm state ---------------------------------------

    @staticmethod
    def bucket_key(p, kernel=None) -> tuple:
        """The padded-shape bucket a packed history lands in: (kernel
        name, required-op bucket, crash width, window bucket). Histories
        of one bucket run on the same buffers at every rung. A history
        with more crashed ops than the crashed-set width has crash width
        -1 (it never reaches the device)."""
        nr = max(int(p.n_required), 1)
        crw = G._crash_width(p.n - p.n_required)
        wb = (G._window_bucket(max(G._window_needed(p), 1))
              if p.n_required else 32)
        kname = getattr(kernel, "name", None) or "kernel"
        return (str(kname), G._bucket(nr), -1 if crw is None else crw, wb)

    def warm(self, p, kernel, rungs: Optional[int] = None,
             device=None) -> Dict[str, Any]:
        """Make this history's bucket warm: load the kernel library (on a
        CUDA device) and allocate the column buffers and, for each of the
        first ``rungs`` rungs of its ladder (all when None), the carry and
        scratch buffers of a single search. Idempotent per bucket; a warm
        bucket moves to the newest end of the LRU order. Returns
        ``{"bucket", "shapes", "bytes", "seconds", "already-warm"}``:
        ``bytes`` is the footprint of the buffers it allocated, the port's
        own carry and scratch of each shape as the plan prices them
        (:func:`jepsen_tpu_torch.checker.gpu.state_bytes`), what the byte
        budget counts. ``device=None`` means CUDA."""
        dev = G.resolve_device(device)
        bucket = self.bucket_key(p, kernel)
        with self.lock:
            with self._meta:
                rec = self._warm.get(bucket)
                if rec is not None:
                    self._warm.move_to_end(bucket)
                    return dict(rec, bucket=bucket,
                                **{"already-warm": True})
            from jepsen_tpu_torch import obs
            stats = obs.enabled()
            t0 = time.perf_counter()
            shapes, nbytes = 0, 0
            crw = bucket[2]
            with obs_trace.span("engine.warm", bucket=list(bucket),
                                phase="compile") as sp:
                if crw >= 0 and p.n_required:
                    cols = G._split_packed(p, bucket[1], crw, kernel)
                    self.cols(cols, dev)
                    ladder = G._ladder_for(G._window_needed(p), dev)
                    for cap, win, exp in ladder[:rungs] if rungs else ladder:
                        shape = K.LevelShape(C=cap, W=win,
                                             E=min(exp or cap, cap),
                                             n=bucket[1], CR=crw,
                                             model=kernel.name)
                        self.state(shape, dev, stats)
                        shapes += 1
                        nbytes += G.state_bytes(shape, stats)
                sp.set(shapes=shapes)
            _WARMED_SHAPES.inc(shapes)
            rec = {"shapes": shapes, "bytes": nbytes,
                   "seconds": time.perf_counter() - t0, "ts": time.time(),
                   "device": str(dev)}
            _WARM_SECONDS.inc(rec["seconds"])
            with self._meta:
                self._warm[bucket] = rec
                victims = self._trim_warm_locked()
            self._free(victims)
        return dict(rec, bucket=bucket, **{"already-warm": False})

    def warm_info(self, bucket: tuple) -> Optional[Dict[str, Any]]:
        """A bucket's warm record (``{"shapes", "bytes", "seconds",
        "ts", "device"}``), or None when it is not warm."""
        with self._meta:
            rec = self._warm.get(bucket)
            return dict(rec) if rec else None

    def warm_bytes(self) -> int:
        """The warm buckets' claim: the sum of their records' ``bytes``."""
        with self._meta:
            return self._warm_bytes_locked()

    def _warm_bytes_locked(self) -> int:
        return sum(int(r.get("bytes") or 0) for r in self._warm.values())

    def warm_buckets(self) -> list:
        """The warm buckets, stalest (the next to be evicted) first."""
        with self._meta:
            return list(self._warm)

    def set_max_warm_buckets(self, n: int) -> None:
        """Bound the warm buckets (0: no bound); shrinking below the
        current count evicts the stalest at once."""
        with self.lock:
            with self._meta:
                self.max_warm_buckets = max(0, int(n))
                victims = self._trim_warm_locked()
            self._free(victims)

    def set_max_warm_bytes(self, n: int) -> None:
        """Bound the warm buckets' claim in bytes (0: no bound;
        ``JTPU_ENGINE_BYTES_BUDGET``): the stalest are evicted while the
        sum of their records' ``bytes`` is over it, the newest kept."""
        with self.lock:
            with self._meta:
                self.max_warm_bytes = max(0, int(n))
                victims = self._trim_warm_locked()
            self._free(victims)

    def evict_below_headroom(self, min_ratio: float, poll=None) -> int:
        """Evict the stalest warm buckets while the device's headroom
        (:func:`jepsen_tpu_torch.obs.devices.headroom_ratio`, or
        ``poll()``) is below ``min_ratio``, freeing their buffers; the
        newest is kept, and a poll that answers None (the CPU) or raises
        evicts nothing. Returns the buckets evicted."""
        if poll is None:
            from jepsen_tpu_torch.obs import devices as obs_devices
            poll = obs_devices.headroom_ratio
        evicted = 0
        while True:
            try:
                ratio = poll()
            except Exception:  # noqa: BLE001 -- the gauge is advisory
                return evicted
            if ratio is None or ratio >= min_ratio:
                return evicted
            with self.lock:
                with self._meta:
                    if len(self._warm) <= 1:
                        return evicted
                    victims = [self._evict_one_locked(
                        f"headroom {ratio:.3f} < {min_ratio:.3f}")]
                self._free(victims)
            evicted += 1

    def _evict_one_locked(self, why: str) -> tuple:
        victim = self._warm.popitem(last=False)
        self.evictions += 1
        _ENGINE_EVICTIONS.inc()
        log.info("engine: evicted warm bucket %s (%s)", victim[0], why)
        return victim

    def _trim_warm_locked(self) -> list:
        """Drop the stalest warm records past the bucket bound, then while
        their bytes are over the byte budget, always keeping the newest
        (caller holds ``_meta``); returns the dropped (bucket, record)
        pairs."""
        victims = []
        while 0 < self.max_warm_buckets < len(self._warm):
            victims.append(self._evict_one_locked(
                f"cap {self.max_warm_buckets}"))
        while (self.max_warm_bytes > 0 and len(self._warm) > 1
               and self._warm_bytes_locked() > self.max_warm_bytes):
            victims.append(self._evict_one_locked(
                f"bytes budget {self.max_warm_bytes}"))
        return victims

    def _free(self, victims: list) -> None:
        """Release every buffer of the evicted buckets: the search states
        of their shapes at any batch size, and the column buffers of their
        widths (caller holds ``lock``)."""
        for (kname, breq, crw, wb), rec in victims:
            dev = rec["device"]
            for key in [k for k in self._states
                        if k[1] == dev and (k[0].model, k[0].n, k[0].CR,
                                            k[0].W) == (kname, breq, crw,
                                                        wb)]:
                self._drop_graphs(self._states.pop(key))
            for key in [k for k in self._cols
                        if k[2] == dev and (k[0][1], k[1][1]) == (breq,
                                                                  crw)]:
                self._drop_graphs(self._cols.pop(key))
        if victims and torch.cuda.is_available():
            torch.cuda.empty_cache()


def _tensors(cols: dict, nr: Optional[torch.Tensor], carry: G.Carry,
             scratch: G.Scratch) -> list:
    """The buffers a segment graph over these would point to."""
    out = [cols[c] for c in K.COLS if c in cols]
    if nr is not None:
        out.append(nr)
    out += list(carry.pool.tensors()) + list(scratch.pool_next.tensors())
    out += [carry.pk, carry.ps, carry.pa, carry.scal, carry.stats,
            scratch.acc, scratch.rows, scratch.g, scratch.gagg,
            scratch.rows_alt]
    return [t for t in out if t is not None]


def _env_max_warm_buckets() -> int:
    """JTPU_ENGINE_MAX_BUCKETS: the most warm buckets an engine keeps (LRU
    past it); 0, absent or malformed: no bound."""
    try:
        return max(0, int(os.environ.get("JTPU_ENGINE_MAX_BUCKETS") or "0"))
    except ValueError:
        return 0


def _env_max_warm_bytes() -> int:
    """JTPU_ENGINE_BYTES_BUDGET: the warm buckets' byte budget; 0, absent
    or malformed: no bound."""
    try:
        return max(0, int(os.environ.get("JTPU_ENGINE_BYTES_BUDGET") or "0"))
    except ValueError:
        return 0


def _refuse_if_wedged(device) -> None:
    if accel.runtime_wedged(device):
        raise accel.WedgeError(
            "a device segment wedged earlier in this process; the engine "
            "hands out no CUDA state until the record is cleared")


#: what wedged segments' workers hold (:meth:`Engine.abandon`)
_ABANDONED: list = []
_ABANDONED_LOCK = threading.Lock()


def release_abandoned() -> None:
    """Let go of the buffers and graphs that wedged segments left behind;
    only once their workers have ended (``accel._reset_for_tests``)."""
    with _ABANDONED_LOCK:
        held = list(_ABANDONED)
        _ABANDONED.clear()
    for item in held:
        if isinstance(item, K.SegmentGraph):
            item.destroy()


_DEFAULT: Optional[Engine] = None
_DEFAULT_LOCK = threading.Lock()


def default_engine() -> Engine:
    """The process-wide engine, made at first use."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = Engine()
        return _DEFAULT
