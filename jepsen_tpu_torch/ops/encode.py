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
``jepsen_tpu.ops.encode`` (single-history packing only).
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
    if kernel.encode_op is not None:
        def encode(fc, f, inv_value, ok_value):
            return kernel.encode_op(fc, f, inv_value, ok_value, intern.id)
    else:
        def encode(fc, f, inv_value, ok_value):
            return _op_values(fc, f, inv_value, ok_value, intern)

    def dropped(fc, inv_value) -> bool:
        # a crashed read, or a crashed op the model can never linearize,
        # constrains nothing
        return fc == F_READ or (kernel.drop_crashed is not None
                                and kernel.drop_crashed(fc, inv_value))
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
                if dropped(fc, inv_op.value):
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
        if fc is None or dropped(fc, inv_op.value):
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
