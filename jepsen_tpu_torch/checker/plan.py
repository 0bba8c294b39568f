"""The pre-search plan gate: prove a search plan encodes, fits and has a
kernel before any device state is allocated.

Counterpart of ``jepsen_tpu/checker/plan.py``. Everything a search will
allocate follows from a history's dimensions (:class:`PlanDims`): the
padded widths (``gpu._bucket``, ``gpu._crash_width``), the escalation
rungs (``gpu._ladder_for``, the keyed batch's adaptive ladder), and so
each rung's :class:`~jepsen_tpu_torch.kernels.search.LevelShape`. This
module checks them ahead of time:

* **enumeration** (:func:`enumerate_candidates`): the rungs a check would
  run, each bound to its padded widths, under the reference's labels;
* **footprint** (:func:`footprint`): the bytes of the port's own buffers
  for a candidate, exactly what ``Engine.state`` and ``Engine.cols``
  allocate (the carry and scratch of ``gpu.empty_carry`` and
  ``gpu.empty_scratch``, and the device columns), and what the CUDA
  caching allocator charges for them. The reference prices a model of its
  XLA buffers instead, so the two packages' byte counts differ;
* **rules** (:func:`check_dims`, :func:`check_candidate`): the int32
  encoding bounds of ``ops/encode.py`` and ``csrc/search.cu``, the
  crashed-set and window widths, and the footprint against the byte
  budget (:func:`plan_bytes_limit`), as ``PLAN-*`` issues;
* **shape check** (:func:`trace_candidate`): the level shape is one the
  kernels take. The reference runs ``jax.eval_shape``; here nothing is
  allocated or launched;
* **the gate** (:func:`gate_ladder`, :func:`seed_rung`): the supervised
  search and the keyed batch drop the rungs that cannot run, raise
  :class:`~jepsen_tpu_torch.analysis.plan_lint.PlanRejectedError` when
  none can (an explicit rung that fails at once), attach the ``plan``
  entry to their results, and the supervised search starts a rung's pool
  at the largest halving whose footprint fits the budget.

Without a byte budget (the CPU, unless ``JTPU_PLAN_BYTES_LIMIT`` pins one)
``PLAN-OOM`` cannot fire. Kill switch: ``JTPU_PLAN_GATE=0``.

The pool-sharded search (``gpu.check_packed_sharded``) is planned as the
``sharded`` kind over a mesh axis: the axis must divide the capacity and
the expansion (``PLAN-SHARD-INDIVISIBLE``), a shard's expansion below
:data:`SHARD_MIN_EXPAND_ROWS` rows is the straggler regime
(``PLAN-SHARD-SKEW``), and the busiest device's buffers
(``per-device-bytes``: the first device's, which holds the carry and the
merged rows) meet the budget. :func:`gate_sharded` gates one such plan,
:func:`check_remesh` a fleet's new mesh without raising.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from jepsen_tpu_torch.analysis.history_lint import ERROR, NOTE, WARNING
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.kernels import cost as kcost
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.ops.encode import RET_INF, PackedHistory

#: K2's sort key base (``MAXK`` in csrc/search.cu): a valid row's key1 is
#: MAXK - depth, an invalid row's MAXK + 1 + k, and both must order before
#: the pad rows' PAD_KEY = INT32_MAX. The reference's bound on the padded
#: width (breq + MAX_WINDOW < MAXK) implies MAXK + 1 + k < PAD_KEY, so the
#: port keeps it.
MAXK = K.MAXK
INT32_MAX = K.INT32_MAX

#: the bytes the CUDA caching allocator rounds each block up to
ALLOC_BLOCK = 512

#: Rows of a shard's slice of the expansion below which a pool-sharded
#: search is straggler-bound: the global sort concentrates the live
#: frontier on one shard while the others idle (the reference's bound).
SHARD_MIN_EXPAND_ROWS = 8

KINDS = ("single", "segment", "batch", "sharded")


# ---------------------------------------------------------------------------
# Dimensions and candidates
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlanDims:
    """The history dimensions a plan depends on. ``n_events`` is the raw
    history's event count, which bounds the event indices the packed
    encoding stores; None estimates it as ``2 * (n_required +
    n_crashed)``."""

    n_required: int
    n_crashed: int = 0
    window_needed: int = 1
    n_events: Optional[int] = None
    keys: int = 1

    @classmethod
    def from_packed(cls, p: PackedHistory,
                    window_needed: Optional[int] = None) -> "PlanDims":
        """The dims of a packed history (``window_needed`` when the caller
        has it already)."""
        nr = p.n_required
        if window_needed is None:
            window_needed = G._window_needed(p) if nr else 0
        ev = 0
        if p.n:
            finite = p.ret[p.ret != RET_INF]
            ev = int(max(int(p.inv.max(initial=0)),
                         int(finite.max(initial=0)))) + 1
        return cls(n_required=nr, n_crashed=p.n - nr,
                   window_needed=max(window_needed, 1), n_events=ev)

    @classmethod
    def from_history(cls, history, model) -> Optional["PlanDims"]:
        """Pack and measure; None when the model has no word kernel."""
        from jepsen_tpu_torch.ops.encode import pack_with_init
        pk = pack_with_init(history, model)
        return None if pk is None else cls.from_packed(pk[0])

    def events(self) -> int:
        if self.n_events is not None:
            return int(self.n_events)
        return 2 * (self.n_required + self.n_crashed)

    def to_dict(self) -> Dict[str, Any]:
        return {"n-required": self.n_required,
                "n-crashed": self.n_crashed,
                "window-needed": self.window_needed,
                "n-events": self.events(), "keys": self.keys}


@dataclass(frozen=True)
class Candidate:
    """One search shape a check could run: a ladder rung bound to its
    padded widths. ``kind`` is single (one segment for the whole
    budget), segment (the supervised search), batch (the keyed batch)
    or sharded (one search's pool over ``mesh_axis`` shards)."""

    kind: str
    capacity: int
    window: int
    expand: Optional[int]
    breq: int                 # padded required-section width
    crw: int                  # padded crashed-section width
    keys: int = 1
    tiebreak: str = "lex"
    mesh_axis: Optional[int] = None
    ranks: int = 1            # the processes a sharded mesh spans

    @property
    def expand_eff(self) -> int:
        return min(self.expand or self.capacity, self.capacity)

    @property
    def rung(self) -> tuple:
        return (self.capacity, self.window, self.expand)

    def label(self) -> str:
        exp = self.expand if self.expand is not None else "all"
        base = (f"{self.kind} {self.capacity}/{self.window}/{exp} "
                f"@{self.breq}+{self.crw}")
        if self.keys > 1:
            base += f" x{self.keys}"
        if self.mesh_axis:
            base += f" {G.POOL_AXIS}={self.mesh_axis}"
        if self.ranks > 1:
            base += f" ranks={self.ranks}"
        return base

    def shape(self, model: str = "cas-register",
              keys: Optional[int] = None) -> K.LevelShape:
        """The level shape the engine allocates for this candidate, with
        ``keys`` keys (default: its own, up to the most one launch takes;
        a larger keyed batch runs in chunks)."""
        return K.LevelShape(C=self.capacity, W=self.window,
                            E=self.expand_eff, n=self.breq, CR=self.crw,
                            B=keys or min(self.keys, K.MAX_KEYS),
                            tiebreak=self.tiebreak, model=model)


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def enumerate_candidates(dims: PlanDims,
                         capacity: Optional[int] = None,
                         window: Optional[int] = None,
                         expand: Optional[int] = None,
                         kinds: Optional[Sequence[str]] = None,
                         device=None,
                         mesh_axis: Optional[int] = None) -> List[Candidate]:
    """The candidates a check of these dims could run on ``device`` (None:
    CUDA), cheapest first within each kind: the pinned rung when
    ``capacity`` is given, else the escalation ladder at the needed
    window. ``kinds`` defaults to (single, segment) for one key and
    (batch,) for keyed dims, and sharded besides with a ``mesh_axis``
    (``check_packed_sharded``'s defaults: capacity 4,096, the needed
    window's bucket, an expansion of about capacity / 8 rounded up to
    the axis)."""
    nr = max(dims.n_required, 1)
    breq = G._bucket(nr)
    crw = G._crash_width(dims.n_crashed)
    if crw is None:
        return []  # crashed-set overflow: a dims-level finding, no plans
    if kinds is None:
        kinds = ("batch",) if dims.keys > 1 else ("single", "segment")
        if mesh_axis:
            kinds = tuple(kinds) + ("sharded",)
    dev = _device(device)
    if capacity is not None:
        ladder = ((capacity, window or G.WINDOW, expand),)
    else:
        ladder = G._ladder_for(max(dims.window_needed, 1), dev)
    out: List[Candidate] = []
    for kind in kinds:
        if kind in ("single", "segment"):
            out += [Candidate(kind, cap, win, exp, breq, crw)
                    for cap, win, exp in ladder]
        elif kind == "batch":
            klad = (ladder if capacity is not None
                    else G._keyed_auto_ladder(dev))
            for step, (cap, win, exp) in enumerate(klad):
                # the first two rungs of the adaptive ladder sort under
                # the hash tie-break (check_keyed_gpu)
                first = capacity is None and step <= 1
                out.append(Candidate("batch", cap, win, exp, breq, crw,
                                     keys=dims.keys,
                                     tiebreak="hash" if first else "lex"))
        elif kind == "sharded":
            naxis = int(mesh_axis or 1)
            cap = capacity if capacity is not None else 4096
            win = window or G._window_bucket(max(dims.window_needed, 1))
            exp = expand
            if exp is None:
                per = max(1, cap // 8)
                exp = max(naxis, -(-per // naxis) * naxis)
            out.append(Candidate("sharded", cap, win, exp, breq, crw,
                                 mesh_axis=naxis))
        else:
            raise ValueError(f"plan kind {kind!r}: the port plans {KINDS}")
    return out


# ---------------------------------------------------------------------------
# Footprint
# ---------------------------------------------------------------------------


def _cols_each(breq: int, crw: int, keys: int = 1) -> List[int]:
    """The bytes of each device column of a batch: seven int32 [breq]
    columns, the suffix minimum [breq + 1], six int32 [crw] crashed columns
    (the crash bounds ``cb`` among them) and ``nr``."""
    return ([4 * keys * breq] * 7 + [4 * keys * (breq + 1)]
            + [4 * keys * crw] * 6 + [4 * keys])


def cols_nbytes(breq: int, crw: int, keys: int = 1) -> int:
    """Device bytes of the columns of ``keys`` histories (``Engine.cols``,
    ``Engine.batch_cols``)."""
    return sum(_cols_each(breq, crw, keys))


def _allocated(sizes: Sequence[int]) -> int:
    """What the CUDA caching allocator charges for tensors of these sizes:
    each nonempty one a block rounded up to ALLOC_BLOCK bytes."""
    return sum(-(-n // ALLOC_BLOCK) * ALLOC_BLOCK for n in sizes if n)


def footprint(cand: Candidate) -> Dict[str, int]:
    """The device bytes of one candidate, by component: the columns, the
    carry (``gpu.empty_carry``) and the scratch (``gpu.empty_scratch``),
    their sum ``total-bytes`` (what the tensors hold), and
    ``allocated-bytes``, what ``torch.cuda.memory_allocated`` grows by
    when a fresh engine allocates them."""
    if cand.mesh_axis:
        return _sharded_footprint(cand)
    # every buffer is linear in the keys: one key's, times the keys
    one = cand.shape(keys=1)
    cols = _cols_each(cand.breq, cand.crw, cand.keys)
    carry = [n * cand.keys for n in G.carry_nbytes(one)]
    scratch = [n * cand.keys for n in G.scratch_nbytes(one)]
    return {"cols-bytes": sum(cols), "carry-bytes": sum(carry),
            "scratch-bytes": sum(scratch),
            "total-bytes": sum(cols) + sum(carry) + sum(scratch),
            "allocated-bytes": _allocated(cols + carry + scratch)}


def _sharded_footprint(cand: Candidate) -> Dict[str, int]:
    """The device bytes of a pool-sharded candidate
    (``gpu.ShardedState``). The first device holds the columns, the carry,
    the other pool buffer and the dealt pool, the merged rows and their
    second buffer (a run of at least 256 rows a shard), K3's g and gagg,
    and every shard's scalars and accumulators: ``per-device-bytes``, the
    busiest device's. A shard on another device holds the columns, its
    dealt pool, its rows and their second buffer, and its scalars:
    ``shard-bytes``. ``total-bytes`` is their sum over a mesh of distinct
    devices; on one device (logical shards) the first device's bytes are
    the whole.

    On a mesh across ``ranks`` processes the bytes are one rank's: the
    replicated state above on its first device, with its own L = N /
    ranks shards' scalars and the level's exchange buffers (its block and
    every rank's, R / N rows and the scalar rows a shard), and its shards
    on other devices. The pinned host stages of a gloo exchange are not
    device bytes."""
    N = cand.mesh_axis
    L = N // cand.ranks if cand.ranks > 1 else N
    shape = cand.shape()
    local = K.LevelShape(C=cand.capacity // N, W=cand.window,
                         E=max(cand.expand_eff // N, 1), n=cand.breq,
                         CR=cand.crw)
    run = max(local.RP, 256)
    cols = _cols_each(cand.breq, cand.crw)
    pool = G._pool_nbytes(shape)
    rows = 4 * N * run * shape.NK
    small = [4 * K.NSCAL, 4 * K.NACC]
    lead = (cols + G.carry_nbytes(shape) + pool + pool
            + [4 * K.NACC, rows, rows, 4 * shape.RP,
               4 * K.scan_blocks(shape)] + small * L)
    if cand.ranks > 1:
        block = 4 * L * (local.R * local.NK + K.NSCAL + K.NACC)
        lead += [block, cand.ranks * block]
    shard = (cols + G._pool_nbytes(local)
             + [4 * local.RP * local.NK] * 2 + small)
    return {"cols-bytes": sum(cols),
            "carry-bytes": sum(G.carry_nbytes(shape)),
            "scratch-bytes": sum(lead) - sum(cols)
            - sum(G.carry_nbytes(shape)),
            "per-device-bytes": sum(lead), "shard-bytes": sum(shard),
            "total-bytes": sum(lead) + (L - 1) * sum(shard),
            "allocated-bytes": _allocated(lead)}


def batch_chunk(cand: Candidate, bytes_limit: Optional[int]) -> int:
    """The most keys of the batch ``cand`` one launch takes: at most
    ``MAX_KEYS``, and under a byte budget the most whose footprint fits
    it, at least one (every buffer is linear in the keys)."""
    most = min(cand.keys, K.MAX_KEYS)
    if bytes_limit is None:
        return most
    one = footprint(replace(cand, keys=1))["total-bytes"]
    return max(1, min(most, bytes_limit // one))


def plan_bytes_limit(device=None) -> Optional[int]:
    """The byte budget: ``JTPU_PLAN_BYTES_LIMIT`` when set, else the total
    memory of ``device`` (None: CUDA) as ``torch.cuda.mem_get_info``
    reports it, else None (the CPU, or no CUDA device), which leaves the
    footprint check off."""
    v = os.environ.get("JTPU_PLAN_BYTES_LIMIT")
    if v:
        try:
            return int(v)
        except ValueError:
            pass
    dev = _device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.mem_get_info(dev)[1])


def request_footprint(dims: PlanDims, device=None) -> Optional[int]:
    """Device bytes a single search of these dims allocates on its first
    rung on ``device`` (None: CUDA): the serve daemon's admission unit.
    None when the history never reaches the device (crashed-set
    overflow)."""
    cands = enumerate_candidates(dims, kinds=("segment",), device=device)
    return footprint(cands[0])["total-bytes"] if cands else None


def gang_footprint(dims: PlanDims, size: int,
                   device=None, hosts: int = 1) -> Optional[int]:
    """Device bytes of a gang of ``size`` members of these dims: a gang
    stacks every column and every carry and scratch row on its leading
    axis, so its bytes are linear in its members. Over ``hosts`` fleet
    hosts, the widest host's share, ceil(size / hosts) members."""
    if size < 1:
        return None
    fp = request_footprint(dims, device)
    lanes = -(-int(size) // max(1, int(hosts)))
    return None if fp is None else fp * lanes


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlanIssue:
    rule: str
    severity: str
    message: str
    label: str = ""           # candidate label, "" for dims-level issues

    def to_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "severity": self.severity,
                "message": self.message, "label": self.label}


def check_dims(dims: PlanDims) -> List[PlanIssue]:
    """Dims-level safety: the int32 encoding bounds and the crashed-set
    width, whatever the rung."""
    issues: List[PlanIssue] = []
    ev = dims.events()
    if ev >= int(RET_INF):
        issues.append(PlanIssue(
            "PLAN-INT32-OVERFLOW", ERROR,
            f"{ev} history events: event indices reach the RET_INF "
            f"sentinel ({int(RET_INF)}) — inv/ret columns would "
            f"silently alias crashed ops"))
    nr = dims.n_required
    breq = G._bucket(nr) if nr else 0
    if nr and breq + G.MAX_WINDOW >= MAXK:
        issues.append(PlanIssue(
            "PLAN-INT32-OVERFLOW", ERROR,
            f"padded required width {breq}: the merge-sort key "
            f"MAXK+1+k ({MAXK}+1+k) leaves int32 — the pool ordering "
            f"would invert"))
    # the level counter and the stats lane run to the budget of the
    # padded widths (LevelShape.lmax), a little past the reference's
    # budget of the unpadded counts
    crw = G._crash_width(dims.n_crashed) or 0
    budget = G._level_budget(breq, crw)
    if budget > INT32_MAX:
        issues.append(PlanIssue(
            "PLAN-INT32-OVERFLOW", ERROR,
            f"level budget {budget} does not fit the int32 level "
            f"counter"))
    if dims.n_crashed > G.CRASH_MAX:
        issues.append(PlanIssue(
            "PLAN-CRASH-WIDTH", ERROR,
            f"{dims.n_crashed} crashed ops exceed the crashed-set width "
            f"{G.CRASH_MAX} (the device path would answer UNKNOWN after "
            f"packing; route to the native engine)"))
    if dims.window_needed > G.MAX_WINDOW:
        issues.append(PlanIssue(
            "PLAN-WINDOW-UNBOUNDED", WARNING,
            f"needed candidate window {dims.window_needed} exceeds "
            f"MAX_WINDOW {G.MAX_WINDOW}: overflow is inevitable, so the "
            f"device search can only hunt a witness, never refute"))
    return issues


def check_candidate(cand: Candidate, dims: PlanDims,
                    bytes_limit: Optional[int],
                    fp: Optional[Dict[str, int]] = None) -> List[PlanIssue]:
    """Candidate-level safety: the window bound, the mesh divisibility and
    skew of a sharded candidate, and the footprint (``fp`` when the caller
    has it; a sharded candidate's busiest device) against the byte
    budget."""
    issues: List[PlanIssue] = []
    lbl = cand.label()
    if cand.window > G.MAX_WINDOW:
        issues.append(PlanIssue(
            "PLAN-WINDOW", ERROR,
            f"window {cand.window} > MAX_WINDOW {G.MAX_WINDOW}: the search "
            f"carries at most {G.MAX_WINDOW // 32} mask words", lbl))
    if cand.expand is not None and cand.expand > cand.capacity:
        issues.append(PlanIssue(
            "PLAN-EXPAND-CLAMPED", NOTE,
            f"expand {cand.expand} exceeds capacity {cand.capacity}; the "
            f"search clamps it to the pool size", lbl))
    if cand.mesh_axis:
        naxis = cand.mesh_axis
        if naxis % cand.ranks:
            issues.append(PlanIssue(
                "PLAN-SHARD-INDIVISIBLE", ERROR,
                f"mesh axis {naxis} over {cand.ranks} ranks: every rank "
                f"must hold the same number of shards", lbl))
        if cand.capacity % naxis or cand.expand_eff % naxis:
            issues.append(PlanIssue(
                "PLAN-SHARD-INDIVISIBLE", ERROR,
                f"mesh axis {naxis} must divide capacity {cand.capacity} "
                f"and expand {cand.expand_eff} — the pool rows cannot be "
                f"split evenly over the shards", lbl))
        else:
            per = cand.expand_eff // naxis
            if per < SHARD_MIN_EXPAND_ROWS:
                issues.append(PlanIssue(
                    "PLAN-SHARD-SKEW", WARNING,
                    f"{per} expansion row(s) per device (expand "
                    f"{cand.expand_eff} over {naxis} shards): below "
                    f"{SHARD_MIN_EXPAND_ROWS} rows the global sort "
                    f"concentrates the live frontier on one shard and the "
                    f"others idle (straggler regime)", lbl))
    if bytes_limit is not None:
        fp = fp or footprint(cand)
        need = fp.get("per-device-bytes", fp["total-bytes"])
        if need > bytes_limit:
            issues.append(PlanIssue(
                "PLAN-OOM", ERROR,
                f"predicted working set {need} B exceeds the "
                f"device bytes-limit {bytes_limit} B (carry "
                f"{fp['carry-bytes']} B + scratch {fp['scratch-bytes']} B "
                f"+ columns {fp['cols-bytes']} B) — the allocator would "
                f"fail and the pool halve; reject or shrink ahead of "
                f"time", lbl))
    return issues


# ---------------------------------------------------------------------------
# Shape check (allocates nothing, launches nothing)
# ---------------------------------------------------------------------------

def trace_candidate(cand: Candidate, kernel) -> Dict[str, Any]:
    """Check that the kernels take this candidate's level shape: K1 has an
    instantiation for the kernel's model, the window and the crashed set
    fit the mask words, and K2's tile and merge passes are defined (a
    keyed batch past one launch's keys runs in chunks). Returns ``{"ok",
    "error", "cost"}``; ``cost`` is one level's ``{"flops",
    "bytes-accessed"}`` from the cost model
    (:func:`jepsen_tpu_torch.kernels.cost.per_level`), None where the
    shape is refused."""
    try:
        if cand.window > G.MAX_WINDOW or cand.crw > G.CRASH_MAX:
            raise ValueError(f"W = {cand.window}, CR = {cand.crw}: the "
                             f"mask words hold {G.MAX_WINDOW}")
        shape = cand.shape(getattr(kernel, "name", None))
        if K.tile_rows(shape) < 1:
            raise ValueError(f"a row of {shape.NK} words leaves no sort "
                             f"tile in {K.SMEM_MAX} B of shared memory")
        K.sort_passes(shape)
    except ValueError as e:
        return {"ok": False, "error": f"{type(e).__name__}: {e}",
                "cost": None}
    return {"ok": True, "error": None, "cost": kcost.per_level(shape)}


# ---------------------------------------------------------------------------
# The analyzer
# ---------------------------------------------------------------------------


def _row(cand: Candidate, issues: List[PlanIssue], bad: bool,
         fp: Dict[str, int]) -> Dict[str, Any]:
    return {"label": cand.label(), "kind": cand.kind,
            "rung": list(cand.rung), "breq": cand.breq,
            "crash-width": cand.crw, "footprint": fp,
            "status": "rejected" if bad else "ok",
            "issues": [i.to_dict() for i in issues]}


def analyze(dims: PlanDims, kernel=None,
            capacity: Optional[int] = None,
            window: Optional[int] = None,
            expand: Optional[int] = None,
            bytes_limit: Optional[int] = None,
            use_device_limit: bool = True,
            trace: bool = False,
            kinds: Optional[Sequence[str]] = None,
            device=None,
            mesh_axis: Optional[int] = None) -> Dict[str, Any]:
    """Verify every candidate of these dims on ``device`` (None: CUDA):
    the rules always, and with ``trace=True`` (and a ``kernel``) the shape
    check. Returns the plan report::

        {"dims": {...}, "bytes-limit": int|None,
         "issues": [{rule, severity, message, label}],
         "candidates": [{"label", "kind", "rung", "breq", "crash-width",
                         "footprint": {...}, "status": "ok"|"rejected",
                         "issues": [...], "traced": bool,
                         "cost": {"flops", "bytes-accessed"}}],
         "selected": label|None}

    ``selected`` is the first candidate with no error: enumeration is
    cheapest first, so it is the cheapest valid plan."""
    limit = bytes_limit
    if limit is None and use_device_limit:
        limit = plan_bytes_limit(device)
    dims_issues = check_dims(dims)
    cands = enumerate_candidates(dims, capacity=capacity, window=window,
                                 expand=expand, kinds=kinds, device=device,
                                 mesh_axis=mesh_axis)
    issues: List[PlanIssue] = list(dims_issues)
    dims_fatal = any(i.severity == ERROR for i in dims_issues)
    rows: List[Dict[str, Any]] = []
    selected = None
    for cand in cands:
        fp = footprint(cand)
        ci = check_candidate(cand, dims, limit, fp)
        traced = ccost = None
        if trace and kernel is not None and not dims_fatal \
                and not any(i.severity == ERROR for i in ci):
            tr = trace_candidate(cand, kernel)
            traced, ccost = tr["ok"], tr["cost"]
            if not tr["ok"]:
                ci = ci + [PlanIssue(
                    "PLAN-TRACE", ERROR,
                    f"no kernel takes the level shape: {tr['error']}",
                    cand.label())]
        issues.extend(ci)
        bad = dims_fatal or any(i.severity == ERROR for i in ci)
        row = _row(cand, ci, bad, fp)
        if traced is not None:
            row["traced"] = traced
        if ccost:
            row["cost"] = ccost
        rows.append(row)
        if selected is None and not bad:
            selected = cand.label()
    return {"dims": dims.to_dict(), "bytes-limit": limit,
            "issues": [i.to_dict() for i in issues],
            "candidates": rows, "selected": selected}


def summary_line(history, model, device=None) -> str:
    """One ``# plan:`` line: the candidate count, the cheapest valid plan,
    its footprint and the byte budget, or the rejection rules. A ``{key:
    history}`` map is planned as the keyed batch, over its widest key.
    Arithmetic only; never raises."""
    try:
        if isinstance(history, dict):
            dims = _keyed_dims(history, model)
        else:
            dims = PlanDims.from_history(history, model)
        if dims is None:
            return "# plan: no integer kernel (object search; unplanned)"
        rep = analyze(dims, device=device)
        if rep["selected"] is None:
            rules = sorted({i["rule"] for i in rep["issues"]
                            if i["severity"] == ERROR})
            return ("# plan: REJECTED " + " ".join(rules)
                    + f" over {len(rep['candidates'])} candidate(s)")
        sel = next(c for c in rep["candidates"]
                   if c["label"] == rep["selected"])
        fp = sel["footprint"]["total-bytes"]
        lim = rep["bytes-limit"]
        rejected = sum(1 for c in rep["candidates"]
                       if c["status"] == "rejected")
        return (f"# plan: {len(rep['candidates'])} candidate(s), "
                f"{rejected} rejected, cheapest {rep['selected']}, "
                f"predicted {fp / 1e6:.2f} MB, "
                f"limit {'n/a' if lim is None else f'{lim / 1e6:.1f} MB'}")
    except Exception as e:  # noqa: BLE001 -- a summary must never break a run
        return f"# plan: unavailable ({type(e).__name__}: {e})"


def _keyed_dims(keyed: Dict[Any, Any], model) -> Optional[PlanDims]:
    """The keyed batch's dims: each width the widest key's, ``keys`` the
    key count (as :func:`check_keyed_gpu` plans its batch)."""
    per = [PlanDims.from_history(h, model) for h in keyed.values()]
    if not per or any(d is None for d in per):
        return None
    return PlanDims(n_required=max(d.n_required for d in per),
                    n_crashed=max(d.n_crashed for d in per),
                    window_needed=max(d.window_needed for d in per),
                    n_events=max(d.events() for d in per), keys=len(per))


# ---------------------------------------------------------------------------
# The pre-search gate
# ---------------------------------------------------------------------------


def gate_enabled() -> bool:
    """The pre-search plan gate, off only with JTPU_PLAN_GATE=0."""
    return os.environ.get("JTPU_PLAN_GATE", "").strip() != "0"


def _reject(report: Dict[str, Any], where: str):
    from jepsen_tpu_torch.analysis.plan_lint import (PlanRejectedError,
                                                     findings_from_report)
    findings = findings_from_report(report)
    errs = sorted({f.rule for f in findings if f.severity == ERROR})
    raise PlanRejectedError(
        f"search plan rejected before {where}: " + " ".join(errs),
        findings=findings, report=report)


def _entry(report: Dict[str, Any]) -> Dict[str, Any]:
    """The ``plan`` entry of a result: the selected plan, the byte budget
    and every rejected candidate with its rules."""
    rejected = [{"label": c["label"], "rung": c["rung"],
                 "rules": sorted({i["rule"] for i in c["issues"]
                                  if i["severity"] == ERROR})}
                for c in report["candidates"] if c["status"] == "rejected"]
    sel = next((c for c in report["candidates"]
                if c["label"] == report["selected"]), None)
    entry = {"selected": report["selected"],
             "bytes-limit": report["bytes-limit"], "rejected": rejected}
    if sel is not None:
        entry["predicted-bytes"] = sel["footprint"]["total-bytes"]
    return entry


def gate_ladder(p, kernel, ladder: tuple, kind: str, explicit: bool,
                keys: int = 1, derate: bool = False,
                where: str = "the device search", device=None
                ) -> Tuple[tuple, Dict[str, Any]]:
    """Gate an escalation ladder before any device state is allocated.

    Returns ``(ladder, plan_entry)``: the rungs that pass, cheapest first,
    and the result's ``plan`` entry. Raises :class:`~jepsen_tpu_torch.
    analysis.plan_lint.PlanRejectedError` when no rung passes, and at once
    on a dims-level error or an explicit rung that fails.

    ``derate=True`` (the supervised search's own ladder) keeps a rung
    whose only error is its footprint: :func:`seed_rung` starts its pool
    smaller. Such a rung is rejected only if even an 8-row pool cannot
    fit. A keyed batch's own rung whose only error is its footprint at
    every key is kept where one key fits: the keys it runs go in chunks
    that fit (:func:`batch_chunk`), and a later rung runs only the keys
    the earlier ones left. ``p`` is a :class:`PackedHistory` or, for the
    keyed batch (whose dims aggregate over its keys), a
    :class:`PlanDims`; ``device`` (None: CUDA) sets the byte budget."""
    dims = p if isinstance(p, PlanDims) else PlanDims.from_packed(p)
    if keys > 1 and dims.keys != keys:
        dims = PlanDims(dims.n_required, dims.n_crashed,
                        dims.window_needed, dims.n_events, keys=keys)
    limit = plan_bytes_limit(device)
    breq = G._bucket(max(dims.n_required, 1))
    crw = G._crash_width(dims.n_crashed)
    report: Dict[str, Any] = {"dims": dims.to_dict(),
                              "bytes-limit": limit, "issues": [],
                              "candidates": [], "selected": None}
    dims_issues = check_dims(dims)
    report["issues"] = [i.to_dict() for i in dims_issues]
    if any(i.severity == ERROR for i in dims_issues) or crw is None:
        _reject(report, where)
    kept: list = []
    for cap, win, exp in ladder:
        cand = Candidate(kind, cap, win, exp, breq, crw, keys=keys)
        fp = footprint(cand)
        ci = check_candidate(cand, dims, limit, fp)
        errors = [i for i in ci if i.severity == ERROR]
        bad = bool(errors)
        if bad and derate and not explicit and all(
                i.rule == "PLAN-OOM" for i in errors):
            # the supervised search seeds this rung's pool down to fit;
            # reject only if even the smallest seedable pool cannot. Its
            # expansion halves with it (seed_rung): the port's rows buffers
            # scale with E, so an 8-row pool at the rung's E would be
            # priced above pools the seeding does reach
            fcap, fexp = _halved(cap, exp, 8)
            floor = Candidate(kind, fcap, win, fexp, breq, crw, keys=keys)
            if not any(i.severity == ERROR
                       for i in check_candidate(floor, dims, limit)):
                bad = False
                ci = ci + [PlanIssue(
                    "PLAN-SEEDED", NOTE,
                    "footprint exceeds the limit at full capacity; the "
                    "supervised search seeds a smaller initial pool",
                    cand.label())]
        elif bad and kind == "batch" and not explicit and keys > 1 and all(
                i.rule == "PLAN-OOM" for i in errors) and not any(
                i.severity == ERROR for i in check_candidate(
                    replace(cand, keys=1), dims, limit)):
            bad = False
            ci = ci + [PlanIssue(
                "PLAN-CHUNKED", NOTE,
                f"footprint exceeds the limit at {keys} keys; the keys this "
                f"rung runs go in chunks of at most "
                f"{batch_chunk(cand, limit)}", cand.label())]
        report["candidates"].append(_row(cand, ci, bad, fp))
        report["issues"].extend(i.to_dict() for i in ci)
        if not bad:
            kept.append((cap, win, exp))
            if report["selected"] is None:
                report["selected"] = cand.label()
    if not kept:
        _reject(report, where)
    return tuple(kept), _entry(report)


def gate_sharded(p: PackedHistory, kernel, naxis: int, capacity: int,
                 window: int, expand: int,
                 where: str = "the pool-sharded device search",
                 device=None, ranks: int = 1) -> Dict[str, Any]:
    """Gate the one plan of a pool-sharded search (mesh divisibility,
    skew, footprint, widths) over ``ranks`` processes, its footprint one
    rank's. Raises :class:`~jepsen_tpu_torch.analysis.
    plan_lint.PlanRejectedError` on any error; returns the ``plan`` entry
    otherwise."""
    dims = PlanDims.from_packed(p)
    limit = plan_bytes_limit(device)
    crw = G._crash_width(dims.n_crashed)
    report: Dict[str, Any] = {"dims": dims.to_dict(),
                              "bytes-limit": limit, "issues": [],
                              "candidates": [], "selected": None}
    dims_issues = check_dims(dims)
    report["issues"] = [i.to_dict() for i in dims_issues]
    if any(i.severity == ERROR for i in dims_issues) or crw is None:
        _reject(report, where)
    cand = Candidate("sharded", capacity, window, expand,
                     G._bucket(max(dims.n_required, 1)), crw,
                     mesh_axis=naxis, ranks=ranks)
    fp = footprint(cand)
    ci = check_candidate(cand, dims, limit, fp)
    bad = any(i.severity == ERROR for i in ci)
    report["candidates"].append(_row(cand, ci, bad, fp))
    report["issues"].extend(i.to_dict() for i in ci)
    if bad:
        _reject(report, where)
    report["selected"] = cand.label()
    return _entry(report)


def pad_for_axis(n: int, naxis: int) -> int:
    """The least value >= ``n`` that the mesh axis divides: how the elastic
    fleet re-pads a pool when its mesh changes (always up: padding adds
    dead rows, truncating would drop live ones)."""
    naxis = max(int(naxis), 1)
    return -(-int(n) // naxis) * naxis


def check_remesh(p, naxis: int, capacity: int, window: int,
                 expand: Optional[int],
                 bytes_limit: Optional[int] = None,
                 device=None) -> Dict[str, Any]:
    """Validate a new mesh axis for the elastic fleet
    (:mod:`jepsen_tpu_torch.fleet`): the ``PLAN-SHARD-INDIVISIBLE``,
    ``PLAN-SHARD-SKEW`` and ``PLAN-OOM`` rules at the capacity and
    expansion padded up so that the axis divides them
    (:func:`pad_for_axis`). Never raises: a host loss or a join must be
    informed, not aborted, by it. Returns ``{"ok", "naxis", "capacity",
    "expand", "per-device-bytes", "bytes-limit", "issues"}``; ``ok`` is
    False only on an error (a skew warning degrades a mesh that keeps the
    search alive, it does not refuse it). ``p`` is a PackedHistory or a
    PlanDims."""
    dims = p if isinstance(p, PlanDims) else PlanDims.from_packed(p)
    naxis = max(int(naxis), 1)
    cap = pad_for_axis(capacity, naxis)
    exp = None if expand is None else pad_for_axis(expand, naxis)
    limit = (bytes_limit if bytes_limit is not None
             else plan_bytes_limit(device))
    crw = G._crash_width(dims.n_crashed)
    if crw is None:
        return {"ok": False, "naxis": naxis, "capacity": cap,
                "expand": exp, "per-device-bytes": None,
                "bytes-limit": limit,
                "issues": [PlanIssue(
                    "PLAN-CRASH-WIDTH", ERROR,
                    f"{dims.n_crashed} crashed ops exceed the crashed-set "
                    f"width {G.CRASH_MAX}").to_dict()]}
    cand = Candidate("sharded", cap, window, exp,
                     G._bucket(max(dims.n_required, 1)), crw,
                     mesh_axis=naxis)
    issues = check_candidate(cand, dims, limit)
    fp = footprint(cand)
    return {"ok": not any(i.severity == ERROR for i in issues),
            "naxis": naxis, "capacity": cap, "expand": exp,
            "per-device-bytes": fp["per-device-bytes"],
            "bytes-limit": limit,
            "issues": [i.to_dict() for i in issues]}


def seed_rung(capacity: int, window: int, expand: Optional[int],
              breq: int, crw: int, floor: int, kind: str = "segment",
              device=None) -> Tuple[int, Optional[int], int, Optional[int]]:
    """A supervised rung's starting pool: halve the capacity (and the
    expansion with it, as the OOM path does) until the footprint fits the
    byte budget or the policy's floor is reached. Returns ``(capacity,
    expand, predicted_bytes, limit)``, unchanged when no budget is known
    or the rung fits."""
    limit = plan_bytes_limit(device)

    def predict(cap: int, exp: Optional[int]) -> int:
        return footprint(Candidate(kind, cap, window, exp, breq,
                                   crw))["total-bytes"]

    cap, exp = capacity, expand
    pred = predict(cap, exp)
    if limit is None:
        return cap, exp, pred, None
    while pred > limit and cap // 2 >= floor:
        cap, exp = _halved(cap, exp, cap // 2)
        pred = predict(cap, exp)
    return cap, exp, pred, limit


def _halved(cap: int, exp: Optional[int], floor: int
            ) -> Tuple[int, Optional[int]]:
    """The pool halved down to ``floor`` rows (at least), its expansion
    halved with it, as the OOM path halves them."""
    while cap // 2 >= floor:
        cap //= 2
        if isinstance(exp, int):
            exp = max(1, min(exp // 2, cap))
    return cap, exp
