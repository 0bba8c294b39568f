"""Elastic fleet scheduling: a search that survives losing a host,
rebalances a straggler's rows and admits a late host.

Counterpart of ``jepsen_tpu/fleet.py``. A fleet search runs ONE packed
history over N logical hosts. The global search state is the ordinary
checkpoint carry (:func:`jepsen_tpu_torch.checker.gpu._carry0_host`: a
pool of configurations sorted deepest first); each host owns
``capacity / N`` contiguous pool rows. Each round:

1. **split**: the global pool is cut into per-host slices (contiguous
   blocks, or dealt round-robin when stealing, below);
2. **shard segments**: every host advances its slice ``segment_iters``
   levels through the port's ordinary single-history segment at the
   per-host capacity (:func:`jepsen_tpu_torch.checker.gpu.
   segment_from_host`: the segment graph of K1-K5 on CUDA), a
   sub-search whose unexpanded rows are its backtrack stack;
3. **merge barrier**: the supervisor merges the slices with the device
   sort's own lex order (:func:`~jepsen_tpu_torch.checker.gpu.
   _pool_sort_host`), drops exact duplicates and truncates to the fleet
   capacity (``lossy`` if a live row fell off, the single pool's
   soundness contract). The barrier is the safe point of every elastic
   operation below.

A completion found by any shard is a true witness; fleet-wide pool death
refutes only if no shard went lossy and no window overflowed; anything
else is UNKNOWN and the ladder escalates. So a decided verdict is the
single host's.

At the merge barrier:

* **host loss**: a dead or wedged host (stale heartbeat, dead process, a
  segment that never came back) loses only its in-flight segment: its
  slice merges back unchanged, :func:`jepsen_tpu_torch.checker.plan.
  check_remesh` validates the smaller mesh, the pool is re-padded and
  the search goes on (a ``remesh-to-N-hosts`` trail event);
* **work stealing**: when ``jtpu_shard_imbalance_ratio`` (max/mean live
  rows a shard) stays above ``JTPU_FLEET_IMBALANCE_MAX`` for
  ``JTPU_FLEET_IMBALANCE_LEVELS`` rounds, or the straggler detector
  flags a host, the next split deals the live rows round-robin
  (``steal-rebalance``);
* **join**: a late host is admitted iff the grown mesh's footprint fits
  the byte budget (``join-admitted-N-hosts`` / ``join-rejected``).

Interconnect faults classify as :data:`jepsen_tpu_torch.resilience.DCN`:
bounded, jittered retries, apart from OOM and wedges (which remove the
host).

Hosts are :class:`LocalHost` (in-process, on its own device: the tests'
logical hosts) or :class:`ProcHost` (a worker process, ``python -m
jepsen_tpu_torch.fleet worker DIR``, with a file protocol and a
heartbeat; it takes its device from the host directory's
``config.json``, CUDA by default, and imports no suite module). On one
card every worker shares ``cuda:0``: the fleet's algorithm, kernels and
process protocol run as they would across cards, but no byte crosses
between cards.

Kill switch: ``JTPU_FLEET`` unset, 0 or 1 leaves every single-host path
as it is (the hook in ``check_packed_gpu`` is not taken). Knobs:
``JTPU_FLEET=N``, ``JTPU_FLEET_IMBALANCE_MAX``,
``JTPU_FLEET_IMBALANCE_LEVELS``, ``JTPU_FLEET_STEAL``,
``JTPU_FLEET_DEAD_S``, ``JTPU_FLEET_HEARTBEAT_S``,
``JTPU_FLEET_SEGMENT_DEADLINE_S``.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import accel, obs, resilience
from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.models.core import KERNELS, KernelSpec
from jepsen_tpu_torch.obs import federation as obs_federation
from jepsen_tpu_torch.obs import metrics as obs_metrics
from jepsen_tpu_torch.obs import observatory as obs_observatory
from jepsen_tpu_torch.obs import straggler as obs_straggler
from jepsen_tpu_torch.obs import trace as obs_trace
from jepsen_tpu_torch.ops.encode import PackedHistory
from jepsen_tpu_torch.resilience import (CARRY_FIELDS, Checkpoint,
                                         RetryPolicy, classify_failure)

log = logging.getLogger("jepsen.fleet")

#: The per-host heartbeat artifact (lives next to the observatory's
#: progress.json in a worker's host dir; obs/fleet.py renders its age).
HEARTBEAT_NAME = "heartbeat.json"

_HOSTS_GAUGE = obs_metrics.gauge(
    "jtpu_fleet_hosts", "live hosts in the elastic fleet mesh")
_REMESH_TOTAL = obs_metrics.counter(
    "jtpu_fleet_remesh_total",
    "fleet re-mesh events (host loss or admitted join re-deriving the "
    "mesh axis at a merge barrier)")
_STEAL_TOTAL = obs_metrics.counter(
    "jtpu_fleet_steal_total",
    "work-stealing rebalances (live frontier rows dealt round-robin "
    "across shards after sustained imbalance)")
_JOIN_TOTAL = obs_metrics.counter(
    "jtpu_fleet_join_total",
    "fleet join admissions, labeled outcome=admitted|rejected")
_HOST_LOST_TOTAL = obs_metrics.counter(
    "jtpu_fleet_host_lost_total",
    "fleet hosts removed from the mesh (dead pid, stale heartbeat, "
    "wedged segment, OOM), labeled class and host — per-host series "
    "so the tsdb layer can chart which hosts keep dying")
_DCN_RETRY_TOTAL = obs_metrics.counter(
    "jtpu_fleet_dcn_retries_total",
    "per-host shard segments retried on DCN/transient faults before "
    "the host was declared lost")
_ROUNDS_TOTAL = obs_metrics.counter(
    "jtpu_fleet_rounds_total",
    "fleet rounds executed (split -> shard segments -> merge barrier)")


class HostLostError(Exception):
    """A fleet host stopped participating: dead process, stale
    heartbeat, vanished artifact dir, or a shard segment that never
    came back within its deadline."""


# ---------------------------------------------------------------------------
# Env knobs
# ---------------------------------------------------------------------------


def fleet_hosts_env() -> int:
    """JTPU_FLEET=N (N>=2) — the fleet opt-in; anything else is off."""
    return G._fleet_hosts()


def enabled() -> bool:
    return fleet_hosts_env() >= 2


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return int(v)
    except ValueError:
        return default


@dataclass
class FleetPolicy:
    """Fleet supervision knobs (env-tunable, JTPU_FLEET_*)."""

    #: imbalance ratio (max/mean live rows per shard) above which a
    #: round counts toward the steal streak
    imbalance_max: float = field(default_factory=lambda: _env_float(
        "JTPU_FLEET_IMBALANCE_MAX", 1.5))
    #: consecutive over-threshold rounds before a steal fires
    imbalance_rounds: int = field(default_factory=lambda: _env_int(
        "JTPU_FLEET_IMBALANCE_LEVELS", 2))
    #: work stealing on/off (JTPU_FLEET_STEAL=0 disables)
    steal: bool = field(default_factory=lambda: os.environ.get(
        "JTPU_FLEET_STEAL", "1").strip() != "0")
    #: heartbeat staleness after which a worker host is presumed dead
    dead_after_s: float = field(default_factory=lambda: _env_float(
        "JTPU_FLEET_DEAD_S", 10.0))
    #: per-shard-segment collect deadline (worker hosts; covers the
    #: worker's first segment: the torch import, the kernel library's
    #: load and the graph's capture)
    segment_deadline_s: float = field(default_factory=lambda: _env_float(
        "JTPU_FLEET_SEGMENT_DEADLINE_S", 120.0))
    #: DCN/transient retry budget per host per round
    retry: RetryPolicy = field(default_factory=RetryPolicy)


# ---------------------------------------------------------------------------
# Pool surgery (all host-side numpy, all at the merge barrier)
# ---------------------------------------------------------------------------


def _pool_of(carry: tuple) -> tuple:
    """(k, mask, cmask, state, alive) — the carry's pool columns."""
    return tuple(np.asarray(x) for x in carry[:5])


def merge_pool(parts: Sequence[tuple], capacity: int
               ) -> Tuple[tuple, bool]:
    """Merge per-shard pools back into one global pool of exactly
    ``capacity`` rows: concatenate, sort with the device's own lex
    order (deepest-first, invalid rows sunk), drop exact duplicates,
    compact live rows to the prefix, pad/truncate. Returns
    ``(pool, dropped)`` — ``dropped`` is True iff a LIVE unique row
    fell past ``capacity`` (the search is lossy from here on)."""
    k = np.concatenate([np.asarray(p[0]) for p in parts])
    mask = np.concatenate([np.asarray(p[1]) for p in parts])
    cmask = np.concatenate([np.asarray(p[2]) for p in parts])
    state = np.concatenate([np.asarray(p[3]) for p in parts])
    alive = np.concatenate([np.asarray(p[4]) for p in parts])
    perm = G._pool_sort_host(k, mask, cmask, state, alive)
    k, mask, cmask, state, alive = (k[perm], mask[perm], cmask[perm],
                                    state[perm], alive[perm])
    # exact dedup: the sort groups equal configs adjacently
    if k.shape[0] > 1:
        eq = ((k[1:] == k[:-1]) & (state[1:] == state[:-1])
              & np.all(mask[1:] == mask[:-1], axis=-1)
              & np.all(cmask[1:] == cmask[:-1], axis=-1))
        dup = np.concatenate([[False], eq & alive[1:] & alive[:-1]])
        alive = alive & ~dup
    # compact: live rows first (stable keeps the deepest-first order)
    order = np.argsort(~alive, kind="stable")
    k, mask, cmask, state, alive = (k[order], mask[order], cmask[order],
                                    state[order], alive[order])
    dropped = bool(np.any(alive[capacity:]))
    pool = (k, mask, cmask, state, alive)
    if k.shape[0] > capacity:
        pool = tuple(a[:capacity] for a in pool)
    elif k.shape[0] < capacity:
        pool, _ = repad_pool(pool, capacity)
    return tuple(np.ascontiguousarray(a) for a in pool), dropped


def repad_pool(pool: tuple, capacity: int) -> Tuple[tuple, bool]:
    """Re-embed a pool into ``capacity`` rows. Growing appends dead
    rows; shrinking keeps the deepest-first prefix (the caller merged
    first, so the prefix is the best frontier) and reports whether a
    live row was dropped."""
    k, mask, cmask, state, alive = (np.asarray(x) for x in pool)
    cap0 = int(k.shape[0])
    if capacity == cap0:
        return (k, mask, cmask, state, alive), False
    if capacity > cap0:
        pad = capacity - cap0

        def grow(a):
            fill = np.zeros((pad,) + a.shape[1:], a.dtype)
            return np.concatenate([a, fill])

        return ((grow(k), grow(mask), grow(cmask), grow(state),
                 grow(alive)), False)
    dropped = bool(np.any(alive[capacity:]))
    return tuple(a[:capacity] for a in
                 (k, mask, cmask, state, alive)), dropped


def split_pool(pool: tuple, naxis: int,
               interleave: bool = False) -> List[tuple]:
    """Cut a global pool into ``naxis`` per-host shard slices
    (``capacity`` must divide). Contiguous blocks by default — the
    device shard layout, zero row movement. ``interleave=True`` DEALS
    the live rows round-robin across shards (dead rows fill the rest):
    the work-stealing redistribution, paid only when the imbalance
    gauge says a straggler is bounding the fleet."""
    k = np.asarray(pool[0])
    cap = int(k.shape[0])
    naxis = max(int(naxis), 1)
    if cap % naxis:
        raise ValueError(f"capacity {cap} not divisible by {naxis}")
    per = cap // naxis
    if not interleave:
        return [tuple(np.ascontiguousarray(a[s * per:(s + 1) * per])
                      for a in pool) for s in range(naxis)]
    alive = np.asarray(pool[4], bool)
    live_idx = np.flatnonzero(alive)
    dead_idx = np.flatnonzero(~alive)
    rows: List[List[int]] = [[] for _ in range(naxis)]
    for i, idx in enumerate(live_idx):
        rows[i % naxis].append(int(idx))
    di = 0
    for s in range(naxis):
        need = per - len(rows[s])
        rows[s].extend(int(x) for x in dead_idx[di:di + need])
        di += need
    return [tuple(np.ascontiguousarray(a[np.asarray(rows[s], np.int64)])
                  for a in pool) for s in range(naxis)]


def shard_imbalance(pool: tuple, naxis: int
                    ) -> Tuple[float, List[int]]:
    """Straggler accounting over contiguous shard blocks: max/mean
    live rows per shard (1.0 = balanced; ``naxis`` = one shard holds
    everything). Mirrors _shard_balance's definition so the fleet and
    the sharded device path report the same gauge."""
    alive = np.asarray(pool[4], bool)
    cap = int(alive.shape[0])
    naxis = max(int(naxis), 1)
    per = max(cap // naxis, 1)
    live = [int(np.count_nonzero(alive[s * per:(s + 1) * per]))
            for s in range(naxis)]
    mean = sum(live) / naxis
    ratio = round(max(live) / mean, 3) if mean > 0 else 1.0
    return ratio, live


def shard_carry(slice_pool: tuple, level: int, best: int) -> tuple:
    """A per-host sub-carry wrapping one shard slice: the slice rows,
    fresh done/lossy/wovf flags (merged by OR at the barrier), and the
    global level/best seeds so the in-device budget math agrees with
    the supervisor's."""
    k, mask, cmask, state, alive = (np.ascontiguousarray(x)
                                    for x in slice_pool)
    return (k, mask, cmask, state, alive,
            np.bool_(False), np.bool_(False), np.bool_(False),
            np.int32(level), np.int32(best),
            k.copy(), state.copy(), alive.copy())


# ---------------------------------------------------------------------------
# Carry (de)serialization — the worker wire format
# ---------------------------------------------------------------------------


def save_carry(path: str, carry: tuple, **meta: Any) -> None:
    """Atomic npz write of a carry plus metadata (the Checkpoint
    format's array layout, tmp+replace like every artifact in this
    repo). Metadata values are integers (None -> -1) or strings (the
    request's distributed trace id rides here, as the cols artifact's
    ``kernel`` name already does). The tmp name is dot-prefixed so a
    directory scan for ``req_*.npz`` / ``resp_*.npz`` can never
    observe it half-written."""
    arrays = {f"carry_{n}": np.asarray(v)
              for n, v in zip(CARRY_FIELDS, carry)}
    marrays = {f"meta_{k}": (np.bytes_(v.encode())
                             if isinstance(v, str)
                             else np.int64(-1 if v is None else v))
               for k, v in meta.items()}
    tmp = os.path.join(os.path.dirname(path) or ".",
                       f".tmp.{os.path.basename(path)}.{os.getpid()}")
    np.savez(tmp, **arrays, **marrays)
    # np.savez appends .npz to a suffix-less tmp name
    os.replace(tmp if os.path.exists(tmp) else tmp + ".npz", path)


def _meta_value(arr) -> Any:
    """One ``meta_*`` npz entry back to int or str."""
    a = np.asarray(arr)
    if a.dtype.kind in ("S", "U"):
        v = a.item()
        return v.decode() if isinstance(v, bytes) else str(v)
    return int(a)


def load_carry(path: str) -> Tuple[tuple, Dict[str, Any]]:
    """Read a carry written by :func:`save_carry`; scalar slots are
    normalized to numpy scalars, as the search writes them. A gang
    (batched) carry keeps its ``(G,)``-shaped flag/level lanes — only
    the dtypes are pinned, since ``np.bool_`` on an array would be a
    shape change (and an ambiguity error for G > 1)."""
    with np.load(path) as z:
        carry = tuple(z[f"carry_{n}"] for n in CARRY_FIELDS)
        meta = {k[len("meta_"):]: _meta_value(z[k])
                for k in z.files if k.startswith("meta_")}
    if np.asarray(carry[5]).ndim:
        carry = (carry[:5]
                 + tuple(np.asarray(carry[i], dtype=np.bool_)
                         for i in (5, 6, 7))
                 + tuple(np.asarray(carry[i], dtype=np.int32)
                         for i in (8, 9))
                 + carry[10:])
    else:
        carry = (carry[:5]
                 + (np.bool_(carry[5]), np.bool_(carry[6]),
                    np.bool_(carry[7]), np.int32(carry[8]),
                    np.int32(carry[9]))
                 + carry[10:])
    return carry, meta


def save_gang_request(path: str, cols: Dict[str, Any], carry: tuple,
                      kernel_name: str, **meta: Any) -> None:
    """Atomic npz write of a GANG shard request: the stacked columns
    (``(G, ...)`` per ``_split_packed`` name), the batched carry and the
    kernel name travel together (a gang's columns differ per request, so
    the worker cannot load them once at admission as it does
    ``cols.npz``)."""
    arrays = {f"col_{n}": np.asarray(a) for n, a in cols.items()}
    arrays.update({f"carry_{n}": np.asarray(v)
                   for n, v in zip(CARRY_FIELDS, carry)})
    marrays = {f"meta_{k}": (np.bytes_(v.encode())
                             if isinstance(v, str)
                             else np.int64(-1 if v is None else v))
               for k, v in meta.items()}
    tmp = os.path.join(os.path.dirname(path) or ".",
                       f".tmp.{os.path.basename(path)}.{os.getpid()}")
    np.savez(tmp, kernel=np.bytes_(kernel_name.encode()),
             **arrays, **marrays)
    os.replace(tmp if os.path.exists(tmp) else tmp + ".npz", path)


def load_gang_request(path: str
                      ) -> Tuple[Dict[str, Any], tuple, str, Dict[str, Any]]:
    """Read a gang shard request written by :func:`save_gang_request`:
    ``(cols, carry, kernel_name, meta)``, the carry's ``(G,)`` flag and
    level lanes dtype-pinned as :func:`load_carry` pins them."""
    with np.load(path) as z:
        cols = {k[len("col_"):]: z[k] for k in z.files
                if k.startswith("col_")}
        carry = tuple(z[f"carry_{n}"] for n in CARRY_FIELDS)
        kname = bytes(z["kernel"]).decode()
        meta = {k[len("meta_"):]: _meta_value(z[k])
                for k in z.files if k.startswith("meta_")}
    carry = (carry[:5]
             + tuple(np.asarray(carry[i], dtype=np.bool_)
                     for i in (5, 6, 7))
             + tuple(np.asarray(carry[i], dtype=np.int32)
                     for i in (8, 9))
             + carry[10:])
    return cols, carry, kname, meta


def kernel_by_name(name: str) -> KernelSpec:
    """The KernelSpec of a registry name: how a worker process finds the
    model of the columns it was sent."""
    for k in KERNELS:
        if k.name == name:
            return k
    raise ValueError(f"no kernel named {name!r}")


def _exp_meta(meta: Dict[str, Any]) -> Optional[int]:
    exp = meta.get("expand")
    return None if exp is None or exp < 0 else exp


# ---------------------------------------------------------------------------
# Hosts
# ---------------------------------------------------------------------------


class LocalHost:
    """An in-process fleet host: runs its shard segments as direct calls
    on its ``device`` (None: CUDA; the tests pass ``"cpu"``), the
    logical hosts the tests drive. ``chaos`` is the fault seam: a
    callable invoked with a context dict before each segment; raising
    from it stands for that failure on this host. :meth:`kill` stands
    for an abrupt host loss."""

    kind = "local"

    def __init__(self, name: str,
                 chaos: Optional[Callable[[Dict[str, Any]], None]] = None,
                 device=None):
        self.name = name
        self.chaos = chaos
        self.device = device
        self.state = "new"
        self._killed = False
        self._pending: Optional[tuple] = None

    def start(self, cols: Optional[dict] = None,
              kernel: Optional[KernelSpec] = None,
              model_name: Optional[str] = None) -> None:
        """``cols``/``kernel`` may be ``None`` for a serve-fleet host:
        gang requests ship their own columns per submission."""
        self._cols = cols
        self._kernel = kernel
        self.state = "live"

    def stop(self) -> None:
        self.state = "dead"

    def kill(self) -> None:
        """Stand for an abrupt host loss (the SIGKILL analogue)."""
        self._killed = True

    def alive(self) -> bool:
        return not self._killed and self.state == "live"

    def submit(self, carry: tuple, seg_iters: int, rung: tuple,
               round_idx: int) -> None:
        self._pending = (carry, seg_iters, rung, round_idx)

    def collect(self, deadline_s: float) -> Tuple[tuple, float]:
        if self._killed:
            raise HostLostError(f"host {self.name} is gone")
        carry, seg_iters, (cap, win, exp), round_idx = self._pending
        ctx = {"host": self.name, "round": round_idx,
               "rung": (cap, win, exp), "level": int(carry[8])}
        if self.chaos is not None:
            self.chaos(ctx)
        key = ("fleet-segment", self._kernel.name, cap, win, exp,
               self._cols["f"].shape[0], self._cols["cf"].shape[0])
        phase = G.call_phase(key)
        t0 = time.perf_counter()
        with obs.span("checker.segment", host=self.name, phase=phase,
                      round=round_idx, rung=[cap, win, exp],
                      seg_iters=seg_iters):
            out = G.segment_from_host(self._cols, carry, (cap, win, exp),
                                      seg_iters, self._kernel.name,
                                      self.device)
        G.mark_executed(key)
        return out, time.perf_counter() - t0

    # -- gang shards (serve fleet placement) --------------------------------

    def submit_gang(self, cols: Dict[str, Any], carry: tuple,
                    kernel: KernelSpec, seg_iters: int, rung: tuple,
                    round_idx: int) -> None:
        """Submit a slice of a gang: ``cols`` are the stacked ``(G,
        ...)`` columns of this host's lanes, ``carry`` their batched
        carry."""
        self._gang_pending = (cols, carry, kernel, seg_iters, rung,
                              round_idx)

    def collect_gang(self, deadline_s: float) -> Tuple[tuple, float]:
        if self._killed:
            raise HostLostError(f"host {self.name} is gone")
        cols, carry, kernel, seg_iters, (cap, win, exp), round_idx = \
            self._gang_pending
        ctx = {"host": self.name, "round": round_idx,
               "rung": (cap, win, exp),
               "gang": int(np.asarray(cols["f"]).shape[0])}
        if self.chaos is not None:
            self.chaos(ctx)
        key = ("fleet-gang", kernel.name, cap, win, exp, ctx["gang"],
               tuple(np.asarray(cols["f"]).shape))
        phase = G.call_phase(key)
        t0 = time.perf_counter()
        with obs.span("checker.segment", host=self.name, phase=phase,
                      round=round_idx, rung=[cap, win, exp],
                      seg_iters=seg_iters, gang=ctx["gang"]):
            out = G.segment_from_host(cols, carry, (cap, win, exp),
                                      seg_iters, kernel.name, self.device)
        G.mark_executed(key)
        return out, time.perf_counter() - t0


#: A host directory's worker configuration (its device).
CONFIG_NAME = "config.json"


class ProcHost:
    """A fleet host backed by a worker process (``python -m
    jepsen_tpu_torch.fleet worker DIR``): the ``fleet-host-kill``
    scenario's hosts, and the shape of a remote host agent.

    File protocol inside ``host_dir`` (every write tmp+replace):

    * ``config.json``: the worker's device (``device``, CUDA by default;
      the tests write ``cpu``), written at start;
    * ``cols.npz``: the packed columns and the kernel name (once, at
      admission);
    * ``req_N.npz`` / ``resp_N.npz``: shard-segment request and response
      carries; ``resp_N.err`` carries a worker-side failure as text
      (``greq_N`` / ``gresp_N`` for gang slices);
    * ``heartbeat.json``: the worker's liveness beacon
      (:data:`HEARTBEAT_NAME`; ``watch --fleet`` renders its age);
    * ``stop``: the leader asks the worker to exit.
    """

    kind = "proc"

    def __init__(self, name: str, host_dir: str, spawn: bool = True,
                 python: Optional[str] = None,
                 dead_after_s: float = 10.0, device: str = "cuda"):
        self.name = name
        self.dir = host_dir
        self.spawn = spawn
        self.python = python or sys.executable
        self.dead_after_s = dead_after_s
        self.device = str(device)
        self.state = "new"
        self.proc: Optional[subprocess.Popen] = None
        self._req_n = 0
        self._await: Optional[int] = None
        self._started = 0.0

    # -- lifecycle ----------------------------------------------------------

    def start(self, cols: Optional[dict] = None,
              kernel: Optional[KernelSpec] = None,
              model_name: Optional[str] = None) -> None:
        os.makedirs(self.dir, exist_ok=True)
        tmp = os.path.join(self.dir, f".config.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump({"device": self.device}, f)
        os.replace(tmp, os.path.join(self.dir, CONFIG_NAME))
        if cols is not None and kernel is not None:
            arrays = {f"col_{c}": np.asarray(v) for c, v in cols.items()}
            tmp = os.path.join(self.dir, f"cols.tmp.{os.getpid()}")
            np.savez(tmp, kernel=np.bytes_(kernel.name.encode()), **arrays)
            os.replace(tmp if os.path.exists(tmp) else tmp + ".npz",
                       os.path.join(self.dir, "cols.npz"))
        if self.spawn and self.proc is None:
            # the worker imports THIS package whatever the leader's cwd;
            # its output lands in the host dir for a post-mortem
            import jepsen_tpu_torch as _pkg
            env = dict(os.environ)
            root = os.path.dirname(os.path.dirname(
                os.path.abspath(_pkg.__file__)))
            env["PYTHONPATH"] = root + (
                os.pathsep + env["PYTHONPATH"]
                if env.get("PYTHONPATH") else "")
            self._log = open(os.path.join(self.dir, "worker.log"), "ab")
            self.proc = subprocess.Popen(
                [self.python, "-m", "jepsen_tpu_torch.fleet", "worker",
                 self.dir],
                stdout=self._log, stderr=self._log, env=env)
        self._started = time.monotonic()
        self.state = "live"

    def stop(self) -> None:
        try:
            with open(os.path.join(self.dir, "stop"), "w") as f:
                f.write("stop")
        except OSError:
            pass
        if self.proc is not None:
            try:
                self.proc.terminate()
                self.proc.wait(timeout=5)
            except Exception:  # noqa: BLE001 — best-effort teardown
                try:
                    self.proc.kill()
                except Exception:  # noqa: BLE001
                    pass
        log_f = getattr(self, "_log", None)
        if log_f is not None:
            try:
                log_f.close()
            except OSError:
                pass
        self.state = "dead"

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def alive(self, in_flight: bool = False) -> bool:
        """``in_flight=True`` (a shard segment is outstanding) trusts
        the collect deadline to catch wedges and only checks the pid:
        a loaded worker mid-compile can beat late without being dead,
        and declaring it so would burn its shard's progress for
        nothing. Between rounds the worker is idle and MUST beat, so
        heartbeat staleness applies."""
        if self.state != "live":
            return False
        if self.proc is not None and self.proc.poll() is not None:
            return False
        if in_flight:
            return True
        hb = read_heartbeat(self.dir)
        if hb is None:
            # no beacon yet: grant the startup grace (the torch import)
            return time.monotonic() - self._started < max(
                self.dead_after_s, 30.0)
        return time.time() - float(hb.get("ts", 0)) <= self.dead_after_s

    # -- shard segments -----------------------------------------------------

    def submit(self, carry: tuple, seg_iters: int, rung: tuple,
               round_idx: int) -> None:
        self._req_n += 1
        cap, win, exp = rung
        meta: Dict[str, Any] = dict(seg_iters=seg_iters, capacity=cap,
                                    window=win, expand=exp,
                                    round=round_idx)
        if obs_trace.enabled():
            # propagate the ambient request trace across the process
            # boundary: the worker's segment spans join the same trace
            trace_id, _ = obs_trace.current_context()
            if trace_id:
                meta["trace"] = trace_id
        save_carry(os.path.join(self.dir, f"req_{self._req_n}.npz"),
                   carry, **meta)
        self._await = self._req_n

    def collect(self, deadline_s: float) -> Tuple[tuple, float]:
        n = self._await
        if n is None:
            raise HostLostError(f"host {self.name}: nothing submitted")
        return self._collect_file(f"resp_{n}.npz", f"resp_{n}.err",
                                  deadline_s)

    def _collect_file(self, resp_name: str, err_name: str,
                      deadline_s: float) -> Tuple[tuple, float]:
        resp = os.path.join(self.dir, resp_name)
        errf = os.path.join(self.dir, err_name)
        t0 = time.perf_counter()
        t_end = time.monotonic() + deadline_s
        while True:
            if os.path.exists(resp):
                carry, _ = load_carry(resp)
                return carry, time.perf_counter() - t0
            if os.path.exists(errf):
                with open(errf, errors="replace") as f:
                    raise RuntimeError(f.read().strip()
                                       or "worker segment failed")
            if not self.alive(in_flight=True):
                raise HostLostError(
                    f"host {self.name} died mid-segment (pid "
                    f"{self.pid}, dir {self.dir})")
            if time.monotonic() > t_end:
                raise HostLostError(
                    f"host {self.name}: shard segment exceeded its "
                    f"{deadline_s:.1f}s deadline")
            time.sleep(0.02)

    # -- gang shards (serve fleet placement) --------------------------------

    def submit_gang(self, cols: Dict[str, Any], carry: tuple,
                    kernel: KernelSpec, seg_iters: int, rung: tuple,
                    round_idx: int) -> None:
        """Ship a gang slice (stacked ``(G, ...)`` columns + batched
        carry + kernel name in ONE ``greq_N.npz``) to the worker. Gang
        requests share the ``req_N`` numbering so the worker answers
        both kinds strictly in submission order."""
        self._req_n += 1
        cap, win, exp = rung
        meta: Dict[str, Any] = dict(seg_iters=seg_iters, capacity=cap,
                                    window=win, expand=exp,
                                    round=round_idx)
        if obs_trace.enabled():
            trace_id, _ = obs_trace.current_context()
            if trace_id:
                meta["trace"] = trace_id
        save_gang_request(
            os.path.join(self.dir, f"greq_{self._req_n}.npz"),
            cols, carry, kernel.name, **meta)
        self._gawait = self._req_n

    def collect_gang(self, deadline_s: float) -> Tuple[tuple, float]:
        n = getattr(self, "_gawait", None)
        if n is None:
            raise HostLostError(f"host {self.name}: nothing submitted")
        return self._collect_file(f"gresp_{n}.npz", f"gresp_{n}.err",
                                  deadline_s)


# ---------------------------------------------------------------------------
# Heartbeats (worker side + leader probes; obs/fleet.py reads the file)
# ---------------------------------------------------------------------------


def write_heartbeat(host_dir: str, state: str = "idle",
                    round_idx: Optional[int] = None) -> None:
    doc = {"ts": time.time(), "pid": os.getpid(), "state": state}
    if round_idx is not None:
        doc["round"] = int(round_idx)
    tmp = os.path.join(host_dir, f".hb.tmp.{os.getpid()}")
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, os.path.join(host_dir, HEARTBEAT_NAME))
    except OSError:
        pass


def read_heartbeat(host_dir: str) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(host_dir, HEARTBEAT_NAME)) as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


def _worker_device(host_dir: str) -> str:
    """The device a worker searches on: ``config.json``'s ``device``,
    else CUDA."""
    try:
        with open(os.path.join(host_dir, CONFIG_NAME)) as f:
            return str(json.load(f).get("device") or "cuda")
    except (OSError, ValueError, AttributeError):
        return "cuda"


def _relay_error(host_dir: str, name: str, e: BaseException) -> None:
    """A worker-side failure, as text in ``name``, for the leader."""
    tmp = os.path.join(host_dir, f".err.tmp.{os.getpid()}")
    try:
        with open(tmp, "w") as f:
            f.write(f"{type(e).__name__}: {e}")
        os.replace(tmp, os.path.join(host_dir, name))
    except OSError:
        pass


def worker_main(host_dir: str) -> int:
    """The fleet worker loop (``python -m jepsen_tpu_torch.fleet worker
    DIR``): beacon a heartbeat, load the packed columns when the leader
    ships them, answer ``req_N`` shard segments and ``greq_N`` gang
    slices in order, on the host directory's device, until ``stop``.

    The heartbeat beats on its own daemon thread, so it goes on through a
    long segment (a first call builds the kernels and captures a graph):
    a wedged segment beats but never answers, which the leader's collect
    deadline catches; a killed worker stops beating at once."""
    beat_s = _env_float("JTPU_FLEET_HEARTBEAT_S", 0.25)
    os.makedirs(host_dir, exist_ok=True)
    device = _worker_device(host_dir)
    host = os.path.basename(host_dir) or host_dir
    state = {"state": "idle", "round": None}
    stop_beat = threading.Event()

    def beat_loop():
        while not stop_beat.wait(beat_s):
            write_heartbeat(host_dir, state=state["state"],
                            round_idx=state["round"])

    write_heartbeat(host_dir)
    threading.Thread(target=beat_loop, daemon=True,
                     name="jtpu-fleet-heartbeat").start()
    if obs_trace.enabled():
        # the worker's own trace artifact: its segment spans carry the
        # request trace ids the leader ships in the request's meta; the
        # sync event aligns this process's clock with the leader's
        obs_trace.tracer().attach(
            os.path.join(host_dir, obs_trace.TRACE_NAME))
        obs_trace.sync_event()
    exporter = None
    if obs_federation.enabled():
        # the host's live telemetry: registry deltas and the span tail,
        # appended to telemetry.frames for the leader to federate
        exporter = obs_federation.FrameExporter(host_dir)
        exporter.start()
    # chaos seam: JTPU_CHAOS_SLOW_HOST="<host-dir-basename>:<seconds>"
    # stalls THIS worker before every segment (the straggler scenario)
    slow_s = 0.0
    spec = os.environ.get("JTPU_CHAOS_SLOW_HOST", "")
    if ":" in spec:
        who, _, secs = spec.partition(":")
        if who == host:
            try:
                slow_s = max(0.0, float(secs))
            except ValueError:
                slow_s = 0.0
    cols = None
    kname = None
    done: set = set()
    while True:
        if os.path.exists(os.path.join(host_dir, "stop")):
            stop_beat.set()
            if exporter is not None:
                exporter.stop()
            obs_trace.tracer().detach()
            return 0
        reqs = []
        for f in os.listdir(host_dir):
            if not f.endswith(".npz"):
                continue
            if f.startswith("req_"):
                kind, stem = "seg", f[len("req_"):-len(".npz")]
            elif f.startswith("greq_"):
                kind, stem = "gang", f[len("greq_"):-len(".npz")]
            else:
                continue
            try:
                reqs.append((int(stem), kind))
            except ValueError:
                continue  # a tmp or foreign file must never kill the host
        pending = [r for r in sorted(reqs) if r not in done]
        if not pending:
            time.sleep(0.02)
            continue
        n, kind = pending[0]
        if kind == "seg" and cols is None:
            cpath = os.path.join(host_dir, "cols.npz")
            if not os.path.exists(cpath):
                time.sleep(0.02)
                continue
            with np.load(cpath) as z:
                kname = bytes(z["kernel"]).decode()
                cols = {k[len("col_"):]: z[k] for k in z.files
                        if k.startswith("col_")}
            # scalar columns round-trip as 0-d arrays
            cols["nr"] = np.int32(cols["nr"])
            cols["ini"] = np.int32(cols["ini"])
        prefix = "g" if kind == "gang" else ""
        try:
            if kind == "gang":
                scols, carry, model, meta = load_gang_request(
                    os.path.join(host_dir, f"greq_{n}.npz"))
                g = int(np.asarray(scols["f"]).shape[0])
                key = ("fleet-gang", model, meta["capacity"],
                       meta["window"], _exp_meta(meta), g,
                       tuple(np.asarray(scols["f"]).shape))
                extra = {"gang": g}
            else:
                carry, meta = load_carry(
                    os.path.join(host_dir, f"req_{n}.npz"))
                scols, model = cols, kname
                key = ("fleet-segment", model, meta["capacity"],
                       meta["window"], _exp_meta(meta),
                       cols["f"].shape[0], cols["cf"].shape[0])
                extra = {}
            state["state"], state["round"] = "segment", meta.get("round")
            obs_trace.set_context(meta.get("trace") or None)
            if slow_s:
                time.sleep(slow_s)
            exp = _exp_meta(meta)
            # the phase rides on the span: the federated straggler feed
            # skips a shape's first (compile) segment
            phase = G.call_phase(key)
            with obs.span("checker.segment", host=host, phase=phase,
                          round=meta.get("round"),
                          rung=[meta["capacity"], meta["window"], exp],
                          seg_iters=meta["seg_iters"], **extra):
                out = G.segment_from_host(
                    scols, carry, (meta["capacity"], meta["window"], exp),
                    meta["seg_iters"], model, device)
            G.mark_executed(key)
            save_carry(os.path.join(host_dir, f"{prefix}resp_{n}.npz"),
                       out, **extra)
        except Exception as e:  # noqa: BLE001 -- relayed to the leader
            _relay_error(host_dir, f"{prefix}resp_{n}.err", e)
        done.add((n, kind))
        obs_trace.clear_context()
        state["state"], state["round"] = "idle", None
        write_heartbeat(host_dir)


# ---------------------------------------------------------------------------
# The elastic fleet supervisor
# ---------------------------------------------------------------------------


class ElasticFleet:
    """Supervise one packed-history search over an elastic N-host mesh
    (module docstring has the model). ``on_round`` is the chaos seam:
    called as ``on_round(round_idx, fleet)`` after every merge barrier
    — tests and tools/chaos_matrix.py kill hosts or request joins from
    it."""

    def __init__(self, hosts: Sequence[Any],
                 policy: Optional[FleetPolicy] = None,
                 on_round: Optional[Callable[[int, "ElasticFleet"],
                                             None]] = None,
                 device=None):
        if not hosts:
            raise ValueError("an elastic fleet needs at least one host")
        self.hosts: List[Any] = list(hosts)
        #: the hosts' device: its ladder and byte budget plan the search
        self.device = torch.device("cuda" if device is None else device)
        self.policy = policy or FleetPolicy()
        self.on_round = on_round
        self._lock = threading.Lock()
        self._joins: List[Any] = []
        self.trail: List[Dict[str, Any]] = []
        self.stats = {"remesh-count": 0, "steal-count": 0,
                      "hosts-lost": 0, "hosts-joined": 0,
                      "peak-imbalance": 1.0, "rounds": 0}
        # the straggler observatory: fed per-segment wall time at the
        # collect barrier and heartbeat ages at the merge barrier; a
        # flagged host forces the next work-steal re-deal. Gated so
        # JTPU_FEDERATE=0 keeps the score gauge unregistered.
        self.straggler = obs_straggler.StragglerDetector() \
            if obs_federation.enabled() else None

    # -- elasticity API -----------------------------------------------------

    def request_join(self, host: Any) -> None:
        """Queue a late-arriving host; it is admitted (or rejected by
        the plan footprint check) at the next merge barrier."""
        with self._lock:
            self._joins.append(host)

    def live_hosts(self) -> List[Any]:
        return [h for h in self.hosts if h.state == "live"]

    # -- the run ------------------------------------------------------------

    def run(self, p: PackedHistory, kernel: KernelSpec,
            capacity: Optional[int] = None,
            window: Optional[int] = None,
            expand: Optional[int] = None,
            segment_iters: Optional[int] = None,
            resume: Optional[Checkpoint] = None,
            checkpoint_path: Optional[str] = None,
            on_checkpoint: Optional[Callable[[Checkpoint], None]] = None
            ) -> Dict[str, Any]:
        try:
            out = self._run(p, kernel, capacity=capacity, window=window,
                            expand=expand, segment_iters=segment_iters,
                            resume=resume,
                            checkpoint_path=checkpoint_path,
                            on_checkpoint=on_checkpoint)
        except BaseException:
            obs_observatory.finish(valid="error")
            self._stop_hosts()
            raise
        obs_observatory.finish(valid=out.get("valid"),
                               levels=out.get("levels"))
        self._stop_hosts()
        return out

    def _stop_hosts(self) -> None:
        for h in self.hosts:
            try:
                h.stop()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass

    def _run(self, p: PackedHistory, kernel: KernelSpec,
             capacity: Optional[int], window: Optional[int],
             expand: Optional[int], segment_iters: Optional[int],
             resume: Optional[Checkpoint],
             checkpoint_path: Optional[str],
             on_checkpoint: Optional[Callable[[Checkpoint], None]]
             ) -> Dict[str, Any]:
        from jepsen_tpu_torch.checker import plan as plan_mod
        if window is not None:
            G._check_window(window)
        seg = (segment_iters or G._segment_config(None)
               or G.DEFAULT_SEGMENT_ITERS)
        cols, early = G._prep_single(p, kernel)
        if early is not None:
            early["fleet"] = self._fleet_entry()
            return early
        dev = self.device
        accel.ensure_usable("fleet", device=dev)
        policy = self.policy
        if capacity is not None:
            G._check_window(window or G.WINDOW)
            ladder = ((capacity, window or G.WINDOW, expand),)
        else:
            ladder = G._ladder_for(G._window_needed(p), dev)
        plan_entry = None
        if plan_mod.gate_enabled():
            ladder, plan_entry = plan_mod.gate_ladder(
                p, kernel, ladder, kind="segment",
                explicit=capacity is not None,
                where="the elastic fleet search", device=dev)
        dims = plan_mod.PlanDims.from_packed(p)
        crw = G._crash_width(p.n - p.n_required) or 0
        cr_pad = cols["cf"].shape[0]
        lmax = G._level_budget(cols["f"].shape[0], cr_pad)
        if resume is not None:
            idx = next((i for i, r in enumerate(ladder)
                        if tuple(r) == tuple(resume.rung)), None)
            ladder = ((tuple(resume.rung),) + tuple(ladder)
                      if idx is None else ladder[idx:])
        # start the initial mesh
        model_name = kernel.name
        for h in self.hosts:
            if h.state == "new":
                h.start(cols, kernel, model_name)
        _HOSTS_GAUGE.set(len(self.live_hosts()))
        out: Dict[str, Any] = {}
        work: list = []
        device_s = {"compile": 0.0, "execute": 0.0}
        seg_levels: list = []
        frontier_hwm = 0
        transfer_bytes = 0
        compiled_shapes: set = set()
        for cap_req, win, exp in ladder:
            live = self.live_hosts()
            if not live:
                return {"valid": UNKNOWN, "backend": "gpu",
                        "error": "all fleet hosts lost",
                        "attempts": list(self.trail),
                        "fleet": self._fleet_entry()}
            cap = plan_mod.pad_for_axis(cap_req, len(live))
            remesh = plan_mod.check_remesh(dims, len(live), cap, win,
                                           exp, device=self.device)
            self._trail("remesh-check", rung=(cap, win, exp),
                        naxis=len(live), ok=remesh["ok"],
                        rules=sorted({i["rule"]
                                      for i in remesh["issues"]}))
            if resume is not None and \
                    tuple(resume.rung) == (cap_req, win, exp):
                pool, dropped = repad_pool(resume.carry[:5], cap)
                carry = (pool
                         + (np.bool_(resume.carry[5]),
                            np.bool_(bool(resume.carry[6]) or dropped),
                            np.bool_(resume.carry[7]),
                            np.int32(resume.carry[8]),
                            np.int32(resume.carry[9]))
                         + tuple(np.asarray(x)
                                 for x in resume.carry[10:]))
                round_idx = int(resume.segment)
                resume = None
            else:
                carry = G._carry0_host(cap, win, cr_pad, cols["ini"],
                                       int(cols["nr"]))
                round_idx = 0
            obs_observatory.begin(
                level_budget=lmax, rung=(cap, win, exp),
                segment_iters=seg,
                backend=f"fleet-{len(live)}")
            streak = 0
            steal_next = False
            abort: Optional[str] = None
            while resilience._carry_active(carry, lmax):
                live = self.live_hosts()
                # heartbeat sweep BEFORE dispatch: a host that died
                # between rounds must not be handed a shard
                stale = [h for h in live if not h.alive()]
                for h in stale:
                    self._host_lost(h, round_idx, "heartbeat",
                                    "stale heartbeat / dead process")
                if stale:
                    live = self.live_hosts()
                    if live:
                        self._remesh(round_idx, dims, cap, win, exp)
                if not live:
                    abort = "all fleet hosts lost"
                    break
                naxis = len(live)
                pool = _pool_of(carry)
                if pool[0].shape[0] % naxis:
                    cap = plan_mod.pad_for_axis(pool[0].shape[0], naxis)
                    pool, _ = repad_pool(pool, cap)
                per = pool[0].shape[0] // naxis
                exp_per = (None if exp is None
                           else max(1, min(-(-exp // naxis), per)))
                if steal_next:
                    before, _ = shard_imbalance(pool, naxis)
                    slices = split_pool(pool, naxis, interleave=True)
                    lives = [int(np.count_nonzero(s[4]))
                             for s in slices]
                    mean = sum(lives) / naxis
                    after = (round(max(lives) / mean, 3)
                             if mean > 0 else 1.0)
                    self._trail("steal", round=round_idx,
                                outcome="steal-rebalance",
                                imbalance_before=before,
                                imbalance_after=after,
                                live_rows=lives)
                    _STEAL_TOTAL.inc()
                    self.stats["steal-count"] += 1
                    steal_next = False
                else:
                    slices = split_pool(pool, naxis)
                lvl0 = int(carry[8])
                best0 = int(carry[9])
                subs = [shard_carry(s, lvl0, best0) for s in slices]
                active = [bool(np.any(s[4])) for s in slices]
                rung_per = (per, win, exp_per)
                t_round = time.perf_counter()
                outs: List[tuple] = []
                phase_compile = False
                shape_key = (per, win, exp_per, cols["f"].shape[0],
                             cr_pad)
                if shape_key not in compiled_shapes:
                    phase_compile = True
                    compiled_shapes.add(shape_key)
                lost_before = self.stats["hosts-lost"]
                with obs.span("fleet.round", round=round_idx,
                              hosts=naxis, level=lvl0,
                              rung=[per, win, exp_per]):
                    for h, sub, act in zip(live, subs, active):
                        if act:
                            h.submit(sub, seg, rung_per, round_idx)
                    for h, sub, act in zip(live, subs, active):
                        if not act:
                            outs.append(sub)
                            continue
                        outs.append(self._collect_host(
                            h, sub, round_idx, rung_per, seg))
                if self.stats["hosts-lost"] > lost_before \
                        and self.live_hosts():
                    # a host fell mid-round: its input slice merges
                    # back unchanged below; re-derive the smaller mesh
                    # for the NEXT split (the merge barrier is the
                    # safe point — nothing is re-dispatched mid-round;
                    # an empty mesh aborts at the next loop top)
                    self._remesh(round_idx, dims, cap, win, exp)
                round_wall = time.perf_counter() - t_round
                # merge barrier: shard pools -> the next global pool
                done = any(bool(o[5]) for o in outs)
                lossy = bool(carry[6]) or any(bool(o[6]) for o in outs)
                wovf = bool(carry[7]) or any(bool(o[7]) for o in outs)
                lvl1 = max([int(o[8]) for o in outs] + [lvl0])
                best = max([int(o[9]) for o in outs] + [best0])
                mpool, dropped = merge_pool(
                    [tuple(o[i] for i in range(5)) for o in outs], cap)
                lossy = lossy or dropped
                prev = (np.asarray(pool[0]), np.asarray(pool[3]),
                        np.asarray(pool[4]))
                carry = (mpool
                         + (np.bool_(done), np.bool_(lossy),
                            np.bool_(wovf), np.int32(lvl1),
                            np.int32(best))
                         + prev)
                round_idx += 1
                _ROUNDS_TOTAL.inc()
                self.stats["rounds"] += 1
                phase = "compile" if phase_compile else "execute"
                device_s[phase] += round_wall
                G.note_call_phase("fleet", phase, round_wall)
                seg_levels.append(lvl1 - lvl0)
                alive_n = int(np.count_nonzero(mpool[4]))
                frontier_hwm = max(frontier_hwm, alive_n)
                G._LEVELS_TOTAL.inc(lvl1 - lvl0)
                G._FRONTIER_HWM.set_max(alive_n)
                shard_b = sum(sum(int(np.asarray(x).nbytes)
                                  for x in s) for s in slices)
                G._TRANSFER_BYTES.inc(2 * shard_b, direction="dcn")
                transfer_bytes += 2 * shard_b
                # straggler accounting on the NEXT round's contiguous
                # layout — the signal the steal decision keys on
                ratio, live_rows = shard_imbalance(mpool, naxis)
                G._SHARD_IMBALANCE.set(ratio)
                self.stats["peak-imbalance"] = max(
                    self.stats["peak-imbalance"], ratio)
                if (policy.steal and naxis > 1
                        and ratio > policy.imbalance_max
                        and alive_n >= naxis):
                    streak += 1
                    if streak >= policy.imbalance_rounds:
                        steal_next = True
                        streak = 0
                else:
                    streak = 0
                if self.straggler is not None:
                    # straggler observatory: heartbeat ages join the
                    # segment-time EWMAs, and a NEWLY flagged host
                    # forces the next re-deal without waiting out the
                    # row-imbalance streak — wall-clock skew is a
                    # straggler signal even when rows are balanced
                    for h in self.live_hosts():
                        hd = getattr(h, "dir", None)
                        hb = read_heartbeat(hd) if hd else None
                        if hb is not None:
                            self.straggler.observe_heartbeat(
                                obs_straggler.host_key(h),
                                max(0.0, time.time()
                                    - float(hb.get("ts", 0.0))))
                    newly = self.straggler.poll_new()
                    if newly:
                        scores = self.straggler.scores()
                        for hn in sorted(newly):
                            # round_idx already advanced at the merge
                            # barrier above — stamp the round whose
                            # segments triggered the flag, matching
                            # the workers' span numbering
                            self._trail("straggler-flagged",
                                        round=round_idx - 1, host=hn,
                                        score=scores.get(hn),
                                        outcome="steal-requested")
                        if policy.steal and naxis > 1 \
                                and alive_n >= naxis:
                            steal_next = True
                obs_observatory.publish(
                    level=lvl1, frontier=alive_n, segments=round_idx,
                    seg_seconds=round_wall, levels_delta=lvl1 - lvl0,
                    expansions=(lvl1 - lvl0)
                    * min((exp_per or per), per) * naxis,
                    rung=(cap, win, exp), backend=f"fleet-{naxis}",
                    warmup=phase == "compile", imbalance=ratio,
                    fleet={"hosts": naxis,
                           "remeshes": self.stats["remesh-count"],
                           "steals": self.stats["steal-count"]})
                if checkpoint_path or on_checkpoint is not None:
                    cp = Checkpoint(carry=carry,
                                    rung=(cap_req, win, exp),
                                    window=win, expand_eff=exp,
                                    crash_width=crw, segment=round_idx)
                    if checkpoint_path:
                        cp.save(checkpoint_path)
                    if on_checkpoint is not None:
                        on_checkpoint(cp)
                if self.on_round is not None:
                    self.on_round(round_idx, self)
                # join admissions at the merge barrier
                self._admit_joins(round_idx, dims, cap, win, exp, cols,
                                  kernel, model_name)
            done, lossy, wovf, best, levels, fpool = \
                G._summarize_carry(carry)
            rung_eff = (cap, win, exp)
            self._trail("rung-aborted" if abort else "rung-complete",
                        rung=rung_eff, rounds=round_idx, levels=levels)
            if abort is not None:
                out = {"valid": UNKNOWN, "backend": "gpu",
                       "levels": levels, "error": abort}
            else:
                out = G._result(done, lossy, wovf, best, levels, p,
                                pool=fpool)
            out["rung"] = rung_eff
            if rung_eff != (cap_req, win, exp):
                out["rung-requested"] = (cap_req, win, exp)
            out["crash-width"] = crw
            out["tiebreak"] = "lex"
            work.append((rung_eff, crw, "lex", levels))
            out["work"] = list(work)
            if plan_entry is not None:
                out["plan"] = plan_entry
            out["segments"] = round_idx
            out["segment-iters"] = seg
            out["attempts"] = list(self.trail)
            out["device-s"] = {k: round(v, 6)
                               for k, v in device_s.items()}
            out["segment-levels"] = list(seg_levels)
            out["frontier-hwm"] = frontier_hwm
            out["transfer-bytes"] = transfer_bytes
            out["fleet"] = self._fleet_entry()
            if out["valid"] is not UNKNOWN:
                return out
            if abort is not None:
                return out
            if bool(wovf) and win >= G.MAX_WINDOW and not bool(lossy):
                return out
        return out

    # -- supervision internals ----------------------------------------------

    def _collect_host(self, h, sub: tuple, round_idx: int,
                      rung_per: tuple, seg: int) -> tuple:
        """Collect one host's shard segment with the DCN-aware retry
        policy: DCN/transient faults resubmit with jittered backoff
        (classified apart from OOM/wedge); anything else — or an
        exhausted budget — removes the host from the mesh, and its
        dispatched input slice merges back unchanged (no frontier rows
        are ever lost with the host)."""
        policy = self.policy
        attempts = 0
        while True:
            try:
                out, secs = h.collect(policy.segment_deadline_s)
                if self.straggler is not None:
                    self.straggler.observe_segment(
                        obs_straggler.host_key(h), secs)
                return out
            except HostLostError as e:
                self._host_lost(h, round_idx, "host-lost", str(e))
                return sub
            except Exception as e:  # noqa: BLE001 — classified below
                cls = classify_failure(e)
                if cls in (resilience.DCN, resilience.TRANSIENT) \
                        and attempts < policy.retry.max_retries:
                    attempts += 1
                    delay = policy.retry.delay(attempts)
                    _DCN_RETRY_TOTAL.inc()
                    self._trail("host-retry", round=round_idx,
                                host=h.name, **{"class": cls},
                                outcome=f"retry-{attempts}",
                                backoff_s=round(delay, 3),
                                error=f"{type(e).__name__}: {e}")
                    log.warning(
                        "fleet host %s %s fault (%s); resubmitting its "
                        "shard in %.2fs", h.name, cls, e, delay)
                    time.sleep(delay)
                    h.submit(sub, seg, rung_per, round_idx)
                    continue
                self._host_lost(h, round_idx, cls,
                                f"{type(e).__name__}: {e}")
                return sub

    def _host_lost(self, h, round_idx: int, cls: str,
                   err: str) -> None:
        """Record one host's removal (the caller re-meshes at the next
        safe point — the merge barrier)."""
        if h.state == "dead":
            return
        h.state = "dead"
        _HOST_LOST_TOTAL.inc(**{"class": cls, "host": h.name})
        if self.straggler is not None:
            # a dead host must not skew the survivors' medians
            self.straggler.forget(obs_straggler.host_key(h))
        self.stats["hosts-lost"] += 1
        # wall_ns dates the loss for flight-recorder dumps, whose span
        # timestamps are otherwise process-monotonic
        self._trail("host-lost", round=round_idx, host=h.name,
                    **{"class": cls}, outcome="host-removed", error=err,
                    wall_ns=time.time_ns())
        log.warning("fleet host %s lost (%s): %s; surviving hosts "
                    "re-mesh at the barrier", h.name, cls, err)

    def _remesh(self, round_idx: int, dims, cap: int,
                win: int, exp) -> None:
        from jepsen_tpu_torch.checker import plan as plan_mod
        live = self.live_hosts()
        n = len(live)
        rm = plan_mod.check_remesh(dims, n, cap, win, exp,
                                   device=self.device)
        _REMESH_TOTAL.inc()
        _HOSTS_GAUGE.set(n)
        self.stats["remesh-count"] += 1
        self._trail("remesh", round=round_idx,
                    outcome=f"remesh-to-{n}-hosts",
                    hosts=[h.name for h in live],
                    capacity=rm["capacity"], ok=rm["ok"],
                    rules=sorted({i["rule"] for i in rm["issues"]}))
        log.warning("fleet re-meshed to %s host(s): %s", n,
                    [h.name for h in live])

    def _admit_joins(self, round_idx: int, dims, cap: int, win: int,
                     exp, cols: dict, kernel, model_name: str) -> None:
        from jepsen_tpu_torch.checker import plan as plan_mod
        with self._lock:
            pending, self._joins = self._joins, []
        for h in pending:
            n_after = len(self.live_hosts()) + 1
            rm = plan_mod.check_remesh(dims, n_after, cap, win, exp,
                                       device=self.device)
            if not rm["ok"]:
                rules = sorted({i["rule"] for i in rm["issues"]
                                if i["severity"] == "error"})
                _JOIN_TOTAL.inc(outcome="rejected")
                self._trail("join", round=round_idx, host=h.name,
                            outcome="join-rejected", rules=rules,
                            per_device_bytes=rm["per-device-bytes"],
                            bytes_limit=rm["bytes-limit"])
                log.warning(
                    "fleet join of %s rejected (%s): per-device "
                    "footprint %s B vs limit %s B", h.name, rules,
                    rm["per-device-bytes"], rm["bytes-limit"])
                continue
            h.start(cols, kernel, model_name)
            if h not in self.hosts:
                self.hosts.append(h)
            _JOIN_TOTAL.inc(outcome="admitted")
            self.stats["hosts-joined"] += 1
            self._trail("join", round=round_idx, host=h.name,
                        outcome=f"join-admitted-{n_after}-hosts",
                        per_device_bytes=rm["per-device-bytes"],
                        bytes_limit=rm["bytes-limit"])
            self._remesh(round_idx, dims, cap, win, exp)

    def _trail(self, event: str, **kw: Any) -> None:
        self.trail.append({"event": event, **kw})

    def _fleet_entry(self) -> Dict[str, Any]:
        return {"hosts": [h.name for h in self.hosts],
                "live": [h.name for h in self.live_hosts()],
                **self.stats}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def check_packed_fleet(p: PackedHistory, kernel: KernelSpec,
                       hosts: Any = None,
                       policy: Optional[FleetPolicy] = None,
                       on_round: Optional[Callable] = None,
                       device=None, **kwargs: Any) -> Dict[str, Any]:
    """Check one packed history under the elastic fleet scheduler.
    ``hosts`` is an int (that many in-process :class:`LocalHost`s on
    ``device``: logical hosts) or a sequence of host objects (e.g.
    :class:`ProcHost` workers). ``device`` (None: CUDA) is the hosts'
    device, whose ladder and byte budget plan the search. Remaining
    kwargs are :meth:`ElasticFleet.run`'s. The ``JTPU_FLEET=N`` hook in
    ``check_packed_gpu`` dispatches here."""
    if hosts is None:
        hosts = fleet_hosts_env() or 2
    if isinstance(hosts, int):
        hosts = [LocalHost(f"host{i}", device=device)
                 for i in range(max(hosts, 1))]
    fleet = ElasticFleet(hosts, policy=policy, on_round=on_round,
                         device=device)
    return fleet.run(p, kernel, **kwargs)


def check_history_fleet(history, model, hosts: Any = None,
                        **kwargs: Any) -> Optional[Dict[str, Any]]:
    """Gate, pack and check one history under the fleet (see
    :func:`check_packed_fleet`); None when the model has no integer
    kernel or the history does not fit its word."""
    from jepsen_tpu_torch.analysis.history_lint import gate_history
    from jepsen_tpu_torch.ops.encode import pack_with_init
    gate_history(history, where="the elastic fleet search")
    try:
        pk = pack_with_init(history, model)
    except ValueError:
        return None
    if pk is None:
        return None
    packed, kernel = pk
    return check_packed_fleet(packed, kernel, hosts=hosts, **kwargs)


def _main(argv: Sequence[str]) -> int:
    if len(argv) >= 2 and argv[0] == "worker":
        return worker_main(argv[1])
    print("usage: python -m jepsen_tpu_torch.fleet worker HOST_DIR",
          file=sys.stderr)
    return 2


if __name__ == "__main__":  # pragma: no cover -- subprocess entry
    sys.exit(_main(sys.argv[1:]))
