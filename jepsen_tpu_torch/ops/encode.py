"""Columnar history encoding: the device search's input format.

A history is compiled once, on the host, into int32 columns sorted by
return index: f-code, value ids v1/v2, invocation and return event
indices (RET_INF for crashed ops) and process. Pairing follows knossos:
an ok completion's value back-fills a read, 'fail' pairs are dropped, and
'info' pairs stay pending forever. A kernel's hooks then fit the values
into its word: ``encode_op`` splits each op's value, ``drop_crashed``
drops crashed ops that can never be linearized, and ``remap`` then
``validate`` rewrite and check the packed columns (either may raise
ValueError: the history does not fit the word). Counterpart of
``jepsen_tpu.ops.encode``: single-history packing, a keyed map's packed
and stacked columns, and the append-mode :class:`StreamPacker` of the
streaming check.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.models.core import (F_READ, NIL_ID, KernelSpec,
                                          kernel_spec_for)

#: Return index of an operation that never returned: +infinity in int32.
RET_INF = np.int32(2**31 - 1)


@dataclass
class PackedHistory:
    """Columnar encoding of one history, sorted by (return, invocation).

    ``n_required`` ops have a finite return and must be linearized; the
    rest are crashed ops that may be. ``value_table`` maps interned ids
    back to values for reports.
    """

    f: np.ndarray        # int32[n] f-codes
    v1: np.ndarray       # int32[n]
    v2: np.ndarray       # int32[n]
    inv: np.ndarray      # int32[n] invocation event index
    ret: np.ndarray      # int32[n] return event index or RET_INF
    process: np.ndarray  # int32[n]
    n_required: int
    init_state: int
    value_table: List[Any] = field(default_factory=list)
    ops: List[Tuple[Optional[Op], Optional[Op]]] = field(default_factory=list)

    @property
    def n(self) -> int:
        return int(self.f.shape[0])

    def max_concurrency(self) -> int:
        """The most ops pending at any event index (a crashed op stays
        pending): the window the device search needs."""
        events = sorted(
            [(int(i), 1) for i in self.inv]
            + [(int(r), -1) for r in self.ret if int(r) != int(RET_INF)])
        cur = peak = 0
        for _, d in events:
            cur += d
            peak = max(peak, cur)
        return peak

    def pad_to(self, n: int) -> "PackedHistory":
        """The columns right-padded to length n with filler ops that are
        never candidates (``inv`` = RET_INF)."""
        k = n - self.n
        if k < 0:
            raise ValueError(f"cannot pad {self.n} down to {n}")
        if k == 0:
            return self

        def pad(a, fill):
            return np.concatenate([a, np.full(k, fill, dtype=a.dtype)])

        return PackedHistory(
            f=pad(self.f, 0), v1=pad(self.v1, NIL_ID), v2=pad(self.v2, NIL_ID),
            inv=pad(self.inv, RET_INF), ret=pad(self.ret, RET_INF),
            process=pad(self.process, -1), n_required=self.n_required,
            init_state=self.init_state, value_table=self.value_table,
            ops=self.ops)


class _Interner:
    def __init__(self):
        self.table: Dict[Any, int] = {}
        self.values: List[Any] = []

    def id(self, v: Any) -> int:
        if v is None:
            return int(NIL_ID)
        key = v if isinstance(v, (int, str, bool, float, tuple)) else repr(v)
        i = self.table.get(key)
        if i is None:
            i = len(self.values)
            self.table[key] = i
            self.values.append(v)
        return i


def _op_values(f_code: int, f: Any, inv_value: Any, ok_value: Any,
               intern: _Interner) -> Tuple[int, int]:
    """Split an op's value into (v1, v2) interned ids: cas carries
    (old, new), reads use the completion value, writes the invocation's."""
    if f == "cas":
        if inv_value is None:
            return int(NIL_ID), int(NIL_ID)
        old, new = inv_value
        return intern.id(old), intern.id(new)
    if f_code == F_READ or f == "read":
        return (intern.id(ok_value if ok_value is not None else inv_value),
                int(NIL_ID))
    return intern.id(inv_value), int(NIL_ID)


def _encoder(kernel: KernelSpec, intern: _Interner):
    """The kernel's op-value encoder: ``(fc, f, inv_value, ok_value) ->
    (v1, v2)``, interning values in ``intern``."""
    if kernel.encode_op is not None:
        def encode(fc, f, inv_value, ok_value):
            return kernel.encode_op(fc, f, inv_value, ok_value, intern.id)
    else:
        def encode(fc, f, inv_value, ok_value):
            return _op_values(fc, f, inv_value, ok_value, intern)
    return encode


def _dropped(kernel: KernelSpec, fc: int, inv_value: Any) -> bool:
    """Whether a crashed op is dropped: a crashed read, or a crashed op the
    model can never linearize, constrains nothing."""
    return fc == F_READ or (kernel.drop_crashed is not None
                            and kernel.drop_crashed(fc, inv_value))


def pack_history(history: Sequence[Op], kernel: KernelSpec,
                 intern: Optional[_Interner] = None,
                 init_state: Optional[int] = None) -> PackedHistory:
    """Compile a raw single-key history into a PackedHistory: number the
    events, pair invocations with completions per process, drop failed
    pairs, crashed reads and the crashed ops the kernel drops, encode the
    values, sort by (ret, inv), then run the kernel's remap and validate.
    Raises ValueError for an op ``f`` the kernel does not support, or a
    history its word cannot hold."""
    intern = intern or _Interner()
    encode = _encoder(kernel, intern)
    pending: Dict[Any, Tuple[int, Op]] = {}
    rows = []  # (inv_idx, ret_idx, f, v1, v2, process, inv_op, comp_op)
    for ev, o in enumerate(history):
        if o.is_invoke:
            pending[o.process] = (ev, o)
        elif o.process in pending:
            inv_ev, inv_op = pending.pop(o.process)
            if o.is_fail:
                continue
            fc = kernel.f_codes.get(inv_op.f)
            if fc is None:
                raise ValueError(
                    f"op f={inv_op.f!r} not supported by model "
                    f"{kernel.name!r} (codes: {sorted(kernel.f_codes)})")
            if o.is_info:
                if _dropped(kernel, fc, inv_op.value):
                    continue
                v1, v2 = encode(fc, inv_op.f, inv_op.value, None)
                rows.append((inv_ev, int(RET_INF), fc, v1, v2,
                             inv_op.process, inv_op, o))
            else:
                v1, v2 = encode(fc, inv_op.f, inv_op.value, o.value)
                rows.append((inv_ev, ev, fc, v1, v2, inv_op.process,
                             inv_op, o))
    # invocations with no completion at all are crashed, like 'info'
    for inv_ev, inv_op in pending.values():
        fc = kernel.f_codes.get(inv_op.f)
        if fc is None or _dropped(kernel, fc, inv_op.value):
            continue
        v1, v2 = encode(fc, inv_op.f, inv_op.value, None)
        rows.append((inv_ev, int(RET_INF), fc, v1, v2, inv_op.process,
                     inv_op, None))
    rows.sort(key=lambda r: (r[1], r[0]))
    procs: Dict[Any, int] = {}
    proc_col = [procs.setdefault(r[5], len(procs)) for r in rows]

    def col(i):
        return np.asarray([r[i] for r in rows], dtype=np.int32)

    packed = PackedHistory(
        f=col(2), v1=col(3), v2=col(4), inv=col(0), ret=col(1),
        process=np.asarray(proc_col, dtype=np.int32),
        n_required=sum(1 for r in rows if r[1] != int(RET_INF)),
        init_state=(kernel.init_state if init_state is None
                    else init_state),
        value_table=intern.values,
        ops=[(r[6], r[7]) for r in rows],
    )
    if kernel.remap is not None:
        kernel.remap(packed)
    if kernel.validate is not None:
        kernel.validate(packed)
    return packed


def pack_keyed_histories(keyed: Dict[Any, Sequence[Op]],
                         kernel: KernelSpec) -> Tuple[list, dict]:
    """A ``{key: history}`` map packed key by key, and the packed columns
    padded to the longest and stacked: ``f``, ``v1``, ``v2``, ``inv``,
    ``ret`` int32[K, n_max], ``n_required`` and ``init_state`` int32[K],
    and ``keys`` in the map's order."""
    keys = list(keyed)
    packed = [pack_history(keyed[k], kernel) for k in keys]
    n_max = max((p.n for p in packed), default=0)
    padded = [p.pad_to(n_max) for p in packed]
    batch = {c: (np.stack([getattr(p, c) for p in padded]) if padded
                 else np.zeros((0, 0), np.int32))
             for c in ("f", "v1", "v2", "inv", "ret")}
    batch["n_required"] = np.asarray([p.n_required for p in padded],
                                     np.int32)
    batch["init_state"] = np.asarray([p.init_state for p in padded],
                                     np.int32)
    batch["keys"] = keys
    return packed, batch


def pack_with_init(history: Sequence[Op], model,
                   kernel: Optional[KernelSpec] = None
                   ) -> Optional[Tuple[PackedHistory, KernelSpec]]:
    """Pack a history with the initial state taken from a model instance.
    None when the model has no integer kernel; ValueError on unsupported
    op f's and on histories the kernel's word cannot hold."""
    kernel = kernel or kernel_spec_for(model)
    if kernel is None:
        return None
    intern = _Interner()
    init = (kernel.pack_init(model, intern.id)
            if kernel.pack_init is not None else kernel.init_state)
    return pack_history(history, kernel, intern, init_state=init), kernel


class StreamPacker:
    """Append-mode packer for the streaming check: ops are fed one chunk
    at a time, and at any barrier :meth:`stable_packed` is the packed
    encoding of the current *stable prefix*, the longest event prefix in
    which every invoked op also completed.

    No op spans a stable prefix's end, so every required op of a longer
    stable prefix sorts after every required op of a shorter one (old
    returns < watermark <= new invocations): the longer prefix's columns
    extend the shorter one's, and the search carry carries over
    (:func:`jepsen_tpu_torch.checker.gpu._reopen_carry`). The walk is
    :func:`pack_history`'s, one event at a time, so :meth:`close` gives
    arrays identical to ``pack_history`` over the same ops, remap and
    validate included.

    A crashed ('info') op pins the watermark for good: it stays pending,
    so no later prefix is complete, and everything after the first crash
    is checked at close.
    """

    def __init__(self, kernel: KernelSpec,
                 init_state: Optional[int] = None,
                 intern: Optional[_Interner] = None):
        self.kernel = kernel
        self.intern = intern or _Interner()
        self.init_state = (kernel.init_state if init_state is None
                           else init_state)
        self._encode = _encoder(kernel, self.intern)
        self._ev = 0
        self._pending: Dict[Any, Tuple[int, Op]] = {}
        self._rows: list = []       # completed rows, in (ret, inv) order
        self._crashed: list = []    # info rows, in info-event order
        self._procs: Dict[Any, int] = {}
        self._proc_col: List[int] = []
        self._watermark = 0         # events in the stable prefix
        self._watermark_rows = 0    # len(_rows) at the watermark
        self._forever_open = 0      # crashed ops: they pin the watermark
        self._closed = False
        self._final: Optional[PackedHistory] = None

    @property
    def n_events(self) -> int:
        return self._ev

    @property
    def watermark(self) -> int:
        """Events in the stable prefix (never decreases)."""
        return self._watermark

    @property
    def stable_required(self) -> int:
        """Required ops of the stable prefix: the ``nr`` the online search
        advances to."""
        return self._watermark_rows

    @property
    def online_ok(self) -> bool:
        """Whether the stable prefix may be checked online: a kernel with a
        global remap (the queues' and the set's value slots) recolours on
        every extension, so its packing is final only at close."""
        return self.kernel.remap is None

    def feed(self, op: Op) -> None:
        """One event: :func:`pack_history`'s walk, incrementally."""
        if self._closed:
            raise ValueError("stream packer is closed")
        kernel = self.kernel
        ev = self._ev
        self._ev += 1
        if op.is_invoke:
            self._pending[op.process] = (ev, op)
        elif op.process in self._pending:
            inv_ev, inv_op = self._pending.pop(op.process)
            if not op.is_fail:
                fc = kernel.f_codes.get(inv_op.f)
                if fc is None:
                    raise ValueError(
                        f"op f={inv_op.f!r} not supported by model "
                        f"{kernel.name!r} (codes: {sorted(kernel.f_codes)})")
                if op.is_info:
                    if not _dropped(kernel, fc, inv_op.value):
                        v1, v2 = self._encode(fc, inv_op.f, inv_op.value,
                                              None)
                        self._crashed.append(
                            (inv_ev, int(RET_INF), fc, v1, v2,
                             inv_op.process, inv_op, op))
                        self._forever_open += 1
                else:
                    # ok completions arrive in return order
                    v1, v2 = self._encode(fc, inv_op.f, inv_op.value,
                                          op.value)
                    self._rows.append((inv_ev, ev, fc, v1, v2,
                                       inv_op.process, inv_op, op))
                    self._proc_col.append(
                        self._procs.setdefault(inv_op.process,
                                               len(self._procs)))
        # the boundary after this event is stable iff no op spans it
        if not self._pending and not self._forever_open:
            self._watermark = self._ev
            self._watermark_rows = len(self._rows)

    def feed_ops(self, ops: Sequence[Any]) -> None:
        for o in ops:
            self.feed(o if isinstance(o, Op) else Op.from_dict(o))

    def _packed(self, rows: list, proc_col: list,
                n_required: int) -> PackedHistory:
        def col(i):
            return np.asarray([r[i] for r in rows], dtype=np.int32)

        return PackedHistory(
            f=col(2), v1=col(3), v2=col(4), inv=col(0), ret=col(1),
            process=np.asarray(proc_col, dtype=np.int32),
            n_required=n_required, init_state=self.init_state,
            value_table=self.intern.values,
            ops=[(r[6], r[7]) for r in rows])

    def stable_packed(self) -> PackedHistory:
        """The packed stable prefix: required ops only, array-identical to
        ``pack_history`` over the watermark's events. Raises ValueError for
        a remap kernel (see :attr:`online_ok`), or when the kernel's
        validate refuses the prefix."""
        if not self.online_ok:
            raise ValueError(
                f"kernel {self.kernel.name!r} remaps value slots "
                f"globally; the stable prefix cannot be packed online")
        k = self._watermark_rows
        p = self._packed(self._rows[:k], self._proc_col[:k], k)
        if self.kernel.validate is not None:
            self.kernel.validate(p)
        return p

    def close(self) -> PackedHistory:
        """Seal the stream: dangling invocations become crashed ops, the
        crashed rows follow the completed ones in (ret, inv) order, and the
        kernel's remap and validate run, as in :func:`pack_history` over
        the whole op sequence."""
        if self._final is not None:
            return self._final
        self._closed = True
        kernel = self.kernel
        for inv_ev, inv_op in self._pending.values():
            fc = kernel.f_codes.get(inv_op.f)
            if fc is None or _dropped(kernel, fc, inv_op.value):
                continue
            v1, v2 = self._encode(fc, inv_op.f, inv_op.value, None)
            self._crashed.append((inv_ev, int(RET_INF), fc, v1, v2,
                                  inv_op.process, inv_op, None))
        self._crashed.sort(key=lambda r: (r[1], r[0]))
        proc_col = list(self._proc_col) + [
            self._procs.setdefault(r[5], len(self._procs))
            for r in self._crashed]
        packed = self._packed(self._rows + self._crashed, proc_col,
                              len(self._rows))
        if kernel.remap is not None:
            kernel.remap(packed)
        if kernel.validate is not None:
            kernel.validate(packed)
        self._final = packed
        return packed
