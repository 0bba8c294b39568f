"""Stepped-datatype models and their integer kernels.

A model is an immutable value with ``step(op) -> model'``; stepping with an
operation the datatype cannot have performed yields :class:`Inconsistent`.
Models whose state fits in a machine word also carry a :class:`KernelSpec`:
a branchless integer transition ``step(state, f, v1, v2) -> (state', ok)``
with the host hooks that compile a history into that word. Every model
family of the reference has one: the CAS register, the mutex, the no-op,
the grow-only set, the unordered queue and the FIFO queue. Each step
exists three times: over numpy (the host search; the reference's own
arithmetic), over torch tensors (the device search's plain version) and as
a CUDA device function in ``csrc/search.cu``; the three agree bit for bit,
also on the state of a step that fails. Counterpart of
``jepsen_tpu.models.core``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from jepsen_tpu_torch.history import Op


class Model:
    """Immutable stepped model. Subclasses implement step()."""

    def step(self, op: Op) -> "Model":
        raise NotImplementedError

    def readonly_op(self, op: Op) -> bool:
        """True iff stepping ``op`` can never change the state, at any
        state where it succeeds; drives the object search's pure-op
        closure."""
        return False

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self), tuple(sorted(self.__dict__.items(),
                                              key=lambda kv: kv[0]))))


class Inconsistent(Model):
    """Terminal model state: the op sequence is not consistent with the
    datatype."""

    def __init__(self, msg: str):
        self.msg = msg

    def step(self, op: Op) -> "Model":
        return self

    def __repr__(self):
        return f"Inconsistent({self.msg!r})"

    def __eq__(self, other):
        return isinstance(other, Inconsistent)

    def __hash__(self):
        return hash(Inconsistent)


def inconsistent(msg: str) -> Inconsistent:
    return Inconsistent(msg)


def is_inconsistent(m: Any) -> bool:
    return isinstance(m, Inconsistent)


class NoOp(Model):
    """A model which considers any operation valid."""

    def step(self, op: Op) -> Model:
        return self

    def readonly_op(self, op: Op) -> bool:
        return True

    def __repr__(self):
        return "NoOp"


class CASRegister(Model):
    """A register supporting read / write / cas.

    - write v     -> value := v
    - cas (o, n)  -> if value == o then value := n else inconsistent
    - read v      -> consistent iff v is None (don't-care) or v == value
    """

    __slots__ = ("value",)

    def __init__(self, value: Any = None):
        self.value = value

    def step(self, op: Op) -> Model:
        f, v = op.f, op.value
        if f == "write":
            return CASRegister(v)
        if f == "cas":
            if v is None:
                return inconsistent("cas with nil value")
            old, new = v
            if self.value == old:
                return CASRegister(new)
            return inconsistent(f"can't CAS {self.value} from {old} to {new}")
        if f == "read":
            if v is None or v == self.value:
                return self
            return inconsistent(f"can't read {v} from register {self.value}")
        return inconsistent(f"unknown op f={f}")

    def readonly_op(self, op: Op) -> bool:
        if op.f == "read":
            return True
        if op.f == "cas" and op.value is not None:
            old, new = op.value
            return old == new
        return False

    def __eq__(self, other):
        return isinstance(other, CASRegister) and self.value == other.value

    def __hash__(self):
        return hash(("CASRegister", self.value))

    def __repr__(self):
        return f"CASRegister({self.value!r})"


class Mutex(Model):
    """A single mutex: acquire/release."""

    __slots__ = ("locked",)

    def __init__(self, locked: bool = False):
        self.locked = locked

    def step(self, op: Op) -> Model:
        if op.f == "acquire":
            if self.locked:
                return inconsistent("cannot acquire a locked mutex")
            return Mutex(True)
        if op.f == "release":
            if not self.locked:
                return inconsistent("cannot release a free mutex")
            return Mutex(False)
        return inconsistent(f"unknown op f={op.f}")

    def __eq__(self, other):
        return isinstance(other, Mutex) and self.locked == other.locked

    def __hash__(self):
        return hash(("Mutex", self.locked))

    def __repr__(self):
        return f"Mutex(locked={self.locked})"


class SetModel(Model):
    """A grow-only set with add / read."""

    __slots__ = ("items",)

    def __init__(self, items: frozenset = frozenset()):
        self.items = frozenset(items)

    def step(self, op: Op) -> Model:
        if op.f == "add":
            return SetModel(self.items | {op.value})
        if op.f == "read":
            if op.value is None or set(op.value) == set(self.items):
                return self
            return inconsistent(
                f"can't read {op.value} from set {sorted(self.items)}")
        return inconsistent(f"unknown op f={op.f}")

    def readonly_op(self, op: Op) -> bool:
        return op.f == "read"

    def __eq__(self, other):
        return isinstance(other, SetModel) and self.items == other.items

    def __hash__(self):
        return hash(("SetModel", self.items))

    def __repr__(self):
        return f"SetModel({sorted(self.items)!r})"


class UnorderedQueue(Model):
    """A queue which does not order its pending elements: dequeue may
    return any enqueued-but-not-dequeued element."""

    __slots__ = ("pending",)

    def __init__(self, pending: Tuple = ()):
        self.pending = tuple(pending)

    def step(self, op: Op) -> Model:
        if op.f == "enqueue":
            return UnorderedQueue(self.pending + (op.value,))
        if op.f == "dequeue":
            if op.value in self.pending:
                p = list(self.pending)
                p.remove(op.value)
                return UnorderedQueue(tuple(p))
            return inconsistent(f"can't dequeue {op.value}")
        return inconsistent(f"unknown op f={op.f}")

    def __eq__(self, other):
        return (isinstance(other, UnorderedQueue)
                and sorted(map(repr, self.pending))
                == sorted(map(repr, other.pending)))

    def __hash__(self):
        return hash(("UnorderedQueue", tuple(sorted(map(repr, self.pending)))))

    def __repr__(self):
        return f"UnorderedQueue({list(self.pending)!r})"


class FIFOQueue(Model):
    """A strictly-ordered queue."""

    __slots__ = ("queue",)

    def __init__(self, queue: Tuple = ()):
        self.queue = tuple(queue)

    def step(self, op: Op) -> Model:
        if op.f == "enqueue":
            return FIFOQueue(self.queue + (op.value,))
        if op.f == "dequeue":
            if not self.queue:
                return inconsistent("can't dequeue from empty queue")
            head, rest = self.queue[0], self.queue[1:]
            if head == op.value:
                return FIFOQueue(rest)
            return inconsistent(f"expected {head}, dequeued {op.value}")
        return inconsistent(f"unknown op f={op.f}")

    def __eq__(self, other):
        return isinstance(other, FIFOQueue) and self.queue == other.queue

    def __hash__(self):
        return hash(("FIFOQueue", self.queue))

    def __repr__(self):
        return f"FIFOQueue({list(self.queue)!r})"


def noop() -> NoOp:
    return NoOp()


def cas_register(value: Any = None) -> CASRegister:
    return CASRegister(value)


def register(value: Any = None) -> CASRegister:
    return CASRegister(value)


def mutex() -> Mutex:
    return Mutex()


def set_model() -> SetModel:
    return SetModel()


def unordered_queue() -> UnorderedQueue:
    return UnorderedQueue()


def fifo_queue() -> FIFOQueue:
    return FIFOQueue()


# f-codes shared by the encoder and the kernels.
F_READ = 0
F_WRITE = 1
F_CAS = 2
F_ACQUIRE = 3
F_RELEASE = 4
F_ADD = 5
F_ENQUEUE = 6
F_DEQUEUE = 7

#: Interned id for None / "don't care" values.
NIL_ID = -1


@dataclass(frozen=True)
class KernelSpec:
    """Branchless integer semantics of a model.

    ``step`` takes numpy scalars or arrays, ``step_torch`` tensors; both
    return (state', ok), with state' unspecified where ok is False (the
    search drops those successors, but the two versions and the CUDA
    device function still agree there).
    """

    name: str
    init_state: int
    step: Callable          # numpy (state, f, v1, v2) -> (state', ok)
    step_torch: Callable    # torch (state, f, v1, v2) -> (state', ok)
    f_codes: dict           # op.f -> int code
    #: Map a model instance to its packed initial state, given an
    #: interner fn (value -> id).
    pack_init: Optional[Callable] = None
    #: (f_code, f, inv_value, ok_value, intern_fn) -> (v1, v2); may raise
    #: ValueError when a value does not fit the word. None = the default
    #: interning (``ops.encode._op_values``).
    encode_op: Optional[Callable] = None
    #: (PackedHistory) -> None after packing: raises ValueError when the
    #: history breaks a capacity invariant of the word.
    validate: Optional[Callable] = None
    #: (PackedHistory) -> None after packing, before ``validate``: rewrites
    #: the value-id columns, ``init_state`` and ``value_table`` into the
    #: word's layout; raises ValueError when they cannot fit.
    remap: Optional[Callable] = None
    #: Host predicate (f_code, v1, v2) -> bool: True iff the op can never
    #: change the state where it succeeds (drives the pure-op closure).
    readonly: Optional[Callable] = None
    #: (state, value_table) -> str, for counterexample reports.
    describe_state: Optional[Callable] = None
    #: (f_code, inv_value) -> bool: True iff a crashed op of this shape can
    #: never be linearized (a nil-value dequeue), so packing drops it.
    drop_crashed: Optional[Callable] = None


# ---------------------------------------------------------------------------
# The steps: numpy (the reference's arithmetic) and their torch twins. The
# twins select with torch.where where the reference multiplies by
# ``1 - bool``, which torch refuses; int32 sums wrap in both.
# ---------------------------------------------------------------------------


def cas_register_step(state, f, v1, v2):
    """The register step over numpy values."""
    state, f, v1, v2 = (np.asarray(x) for x in (state, f, v1, v2))
    is_write = f == F_WRITE
    cas_ok = state == v1
    take_cas = (f == F_CAS) & cas_ok
    ok = ((f == F_READ) & ((v1 == NIL_ID) | cas_ok)) | is_write | take_cas
    return np.where(take_cas, v2, np.where(is_write, v1, state)), ok


def cas_register_step_torch(state, f, v1, v2):
    """The register step over int32 tensors (broadcasting)."""
    is_write = f == F_WRITE
    cas_ok = state == v1
    take_cas = (f == F_CAS) & cas_ok
    ok = ((f == F_READ) & ((v1 == NIL_ID) | cas_ok)) | is_write | take_cas
    return torch.where(take_cas, v2, torch.where(is_write, v1, state)), ok


def mutex_step(state, f, v1, v2):
    """Mutex: state 1 is locked; acquire needs 0, release needs 1."""
    is_acq = f == F_ACQUIRE
    is_rel = f == F_RELEASE
    ok = (is_acq & (state == 0)) | (is_rel & (state == 1))
    state1 = state * (1 - is_acq) + is_acq  # acquire -> 1
    state2 = state1 * (1 - is_rel)          # release -> 0
    return state2, ok


def mutex_step_torch(state, f, v1, v2):
    is_acq = f == F_ACQUIRE
    is_rel = f == F_RELEASE
    ok = (is_acq & (state == 0)) | (is_rel & (state == 1))
    return torch.where(is_acq, 1, torch.where(is_rel, 0, state)), ok


def noop_step(state, f, v1, v2):
    """Every op succeeds and changes nothing; the state broadcasts to the
    op grid's shape like every other step's."""
    return state + f * 0, (f == f)


def noop_step_torch(state, f, v1, v2):
    s2 = state + f * 0
    return s2, torch.ones_like(s2, dtype=torch.bool)


# --- grow-only set: state = count fields and OR bits in <= 30 bits ---------
#
# add's v1 is a UNIT word (one class-count increment, or one idempotent
# bit) and v2 selects count mode (1: state + unit) or OR mode; read's v1
# is the whole read set as a full target word (or NIL_ID for a don't-care
# read), so consistency is one integer compare. _set_remap compiles the
# elements into read-signature classes: elements contained in exactly the
# same reads are interchangeable, so a class needs only a count field.

SET_MAX_IDS = 31          # state bits 0..30: the word stays positive
SET_IMPOSSIBLE_BIT = 30   # reserved: reads of never-added elements


def set_step(state, f, v1, v2):
    is_add = f == F_ADD
    is_read = f == F_READ
    read_ok = (v1 == NIL_ID) | (state == v1)
    ok = is_add | (is_read & read_ok)
    unit = v1 * is_add * (v1 >= 0)
    plus = is_add & (v2 == 1)
    state2 = (state + unit) * plus + (state | unit) * (1 - plus)
    return state2, ok


def set_step_torch(state, f, v1, v2):
    is_add = f == F_ADD
    is_read = f == F_READ
    ok = is_add | (is_read & ((v1 == NIL_ID) | (state == v1)))
    unit = torch.where(is_add & (v1 >= 0), v1, 0)
    plus = is_add & (v2 == 1)
    return torch.where(plus, state + unit, state | unit), ok


def _set_encode(f_code, f, inv_value, ok_value, intern):
    if f_code == F_ADD:
        if inv_value is None:
            raise ValueError("set kernel: nil add value")
        # unbounded interning; _set_remap builds the word layout
        return intern(inv_value), NIL_ID
    # read: the observed set (the completion value) is one table entry
    val = ok_value if ok_value is not None else inv_value
    if val is None:
        return NIL_ID, NIL_ID
    return intern(tuple(sorted(map(repr, val)))), NIL_ID


def _set_pack_init(model, intern):
    # provisional bitmask over the initial elements' ids (interned first,
    # so 0..k-1); _set_remap re-keys it into the field layout
    m = 0
    for i, e in enumerate(sorted(model.items, key=repr)):
        if intern(e) >= SET_MAX_IDS:
            raise ValueError(
                f"set kernel: more than {SET_MAX_IDS} initial elements")
        m |= 1 << i
    return m


def _set_remap(packed):
    """Compile element ids into the read-signature-class word layout.

    Two elements whose membership agrees on every observed read are
    interchangeable, so only the count of a class's added members matters;
    every add op (and initial member) contributes once (elements added
    more than once get idempotent OR bits instead), so a count field of
    width bit_length(|class|) never overflows. A read of an element never
    added carries the reserved impossible bit, which no add sets. Raises
    ValueError when the layout exceeds the word."""
    from collections import defaultdict

    init = int(packed.init_state)
    table = packed.value_table
    add_rows = defaultdict(list)      # elem id -> row indices
    read_rows = []                    # (row, set-of-element-keys)
    for j in range(packed.n):
        v = int(packed.v1[j])
        if v < 0:
            continue
        if int(packed.f[j]) == F_ADD:
            add_rows[v].append(j)
        else:
            read_rows.append((j, frozenset(table[v])))
    init_ids = [i for i in range(SET_MAX_IDS) if (init >> i) & 1]
    elems = sorted(set(add_rows) | set(init_ids))
    sig = {}
    for e in elems:
        ek = repr(table[e]) if e < len(table) else repr(e)
        sig[e] = frozenset(j for j, obs in read_rows if ek in obs)
    or_tier = [e for e in elems
               if len(add_rows.get(e, ())) + (e in init_ids) > 1]
    count_classes = defaultdict(list)
    for e in elems:
        if e in or_tier:
            continue
        count_classes[sig[e]].append(e)
    # layout: count fields first, then OR bits; bit 30 reserved
    layout = {}                       # elem id -> (offset, width, mode)
    fields = []                       # (offset, mask, label)
    off = 0
    for s, members in sorted(count_classes.items(),
                             key=lambda kv: sorted(kv[1])):
        width = max(1, (len(members)).bit_length())
        for e in members:
            layout[e] = (off, width, 1)
        fields.append((off, (1 << width) - 1,
                       "|".join(str(table[e]) if e < len(table) else
                                str(e) for e in sorted(members))))
        off += width
    for e in or_tier:
        layout[e] = (off, 1, 0)
        fields.append((off, 1, str(table[e]) if e < len(table)
                       else str(e)))
        off += 1
    if off > SET_IMPOSSIBLE_BIT:
        raise ValueError(
            f"set kernel: field layout needs {off} bits > "
            f"{SET_IMPOSSIBLE_BIT} available")
    for e, rows in add_rows.items():
        o, w, mode = layout[e]
        for j in rows:
            packed.v1[j] = 1 << o
            packed.v2[j] = mode
    elem_by_key = {}
    for e in elems:
        elem_by_key[repr(table[e]) if e < len(table) else repr(e)] = e
    for j, obs in read_rows:
        target = 0
        impossible = False
        seen_classes = set()
        for ek in obs:
            e = elem_by_key.get(ek)
            if e is None:
                impossible = True     # read of a never-added element
                continue
            o, w, mode = layout[e]
            if mode == 1:
                seen_classes.add((o, w))
            else:
                target |= 1 << o
        for (o, w) in seen_classes:
            members = [x for x, (xo, xw, xm) in layout.items()
                       if xo == o and xm == 1]
            target |= len(members) << o
        if impossible:
            target |= 1 << SET_IMPOSSIBLE_BIT
        packed.v1[j] = target
    new_init = 0
    for e in init_ids:
        o, w, mode = layout[e]
        if mode == 1:
            new_init += 1 << o
        else:
            new_init |= 1 << o
    packed.init_state = new_init
    packed.value_table = fields


# --- unordered queue: state = per-value pending-count fields ---------------
#
# v1 is the value's field bit offset and v2 its count mask (after
# _uqueue_remap); v2 == 0 marks a sink enqueue (a value never dequeued),
# which succeeds and changes nothing.

UQUEUE_MAX_IDS = 8
UQUEUE_MAX_COUNT = 15
#: Usable state bits (the int32 sign bit is left clear by construction).
UQUEUE_STATE_BITS = 31


def uqueue_step(state, f, v1, v2):
    is_enq = f == F_ENQUEUE
    is_deq = f == F_DEQUEUE
    sh = v1 * (v1 >= 0)
    unit = (state * 0 + 1) << sh
    cnt = (state >> sh) & v2
    deq_ok = is_deq & (v1 >= 0) & (cnt > 0)
    ok = is_enq | deq_ok
    state2 = state + unit * (is_enq & (v2 > 0)) - unit * deq_ok
    return state2, ok


def uqueue_step_torch(state, f, v1, v2):
    is_enq = f == F_ENQUEUE
    is_deq = f == F_DEQUEUE
    sh = torch.where(v1 >= 0, v1, 0)
    unit = (state * 0 + 1) << sh
    cnt = (state >> sh) & v2
    deq_ok = is_deq & (v1 >= 0) & (cnt > 0)
    ok = is_enq | deq_ok
    return (state + torch.where(is_enq & (v2 > 0), unit, 0)
            - torch.where(deq_ok, unit, 0)), ok


def _uqueue_encode(f_code, f, inv_value, ok_value, intern):
    val = (ok_value if (f_code == F_DEQUEUE and ok_value is not None)
           else inv_value)
    if val is None:
        # a crashed dequeue whose element is unknowable: the word cannot
        # say "some element"
        raise ValueError("queue kernel: nil op value")
    # unbounded interning; _uqueue_remap colors the ids onto fields
    return intern(val), NIL_ID


def _uqueue_pack_init(model, intern):
    s = 0
    for v in model.pending:
        if v is None:
            raise ValueError("queue kernel: nil pending value")
        i = intern(v)
        if i >= UQUEUE_MAX_IDS:
            raise ValueError(
                f"queue kernel: more than {UQUEUE_MAX_IDS} distinct values")
        if ((s >> (4 * i)) & 15) >= UQUEUE_MAX_COUNT:
            raise ValueError("queue kernel: initial pending count overflow")
        s += 1 << (4 * i)
    return s


def _uqueue_remap(packed):
    """Value-symmetry bit-field packing. Two values whose event spans are
    disjoint are never pending together, so they may share a count field
    (greedy interval coloring); a value enqueued at most once needs a 1-bit
    field, <= 3 pendings 2 bits, <= 15 4 bits; a value never dequeued is a
    sink and needs no field. Ops become (v1 = field offset, v2 = count
    mask). Raises ValueError when a count or the word overflows. Mutates
    ``v1``/``v2``, ``init_state`` and ``value_table`` (per-field
    (offset, mask, label) triples)."""
    from jepsen_tpu_torch.ops.encode import RET_INF as _INF
    inf = int(_INF)
    init = int(packed.init_state)
    info = {}  # id -> [start, end, bound(init+enq), deq]
    for i in range(UQUEUE_MAX_IDS):
        c = (init >> (4 * i)) & 15
        if c:
            info[i] = [-1, -1, c, 0]
    for j in range(packed.n):
        v = int(packed.v1[j])
        if v < 0:
            continue
        inv_e, ret_e = int(packed.inv[j]), int(packed.ret[j])
        rec = info.setdefault(v, [inv_e, -1, 0, 0])
        rec[0] = min(rec[0], inv_e)
        rec[1] = max(rec[1], ret_e)
        if int(packed.f[j]) == F_ENQUEUE:
            rec[2] += 1
        else:
            rec[3] += 1
    classes = {1: [], 2: [], 4: []}
    sinks = set()
    for v, rec in sorted(info.items(), key=lambda kv: kv[1][0]):
        if rec[3] == 0:
            sinks.add(v)       # never dequeued: no op reads its count
            continue
        if rec[2] > rec[3]:
            rec[1] = inf       # can stay pending forever
        b = rec[2]
        if b > UQUEUE_MAX_COUNT:
            raise ValueError(
                f"queue kernel: more than {UQUEUE_MAX_COUNT} simultaneous "
                f"pendings of one value would overflow the count field")
        classes[1 if b <= 1 else 2 if b <= 3 else 4].append((v, rec))
    field_slot = {}       # id -> (width, slot index within its class)
    n_slots = {}
    labels = {}           # (width, slot) -> [labels]
    for w, vals in classes.items():
        free_at = []      # per slot: last event index occupying it
        for v, rec in vals:
            for s, fa in enumerate(free_at):
                if fa < rec[0]:
                    free_at[s] = rec[1]
                    break
            else:
                s = len(free_at)
                free_at.append(rec[1])
            field_slot[v] = (w, s)
            val = (packed.value_table[v]
                   if 0 <= v < len(packed.value_table) else v)
            labels.setdefault((w, s), []).append(repr(val))
        n_slots[w] = len(free_at)
    if sum(w * n for w, n in n_slots.items()) > UQUEUE_STATE_BITS:
        raise ValueError(
            f"queue kernel: {sum(n_slots.values())} simultaneously-live "
            f"values need more than {UQUEUE_STATE_BITS} state bits")
    base = {}
    off = 0
    for w in (1, 2, 4):
        base[w] = off
        off += w * n_slots[w]
    field_of = {v: (base[w] + w * s, (1 << w) - 1)
                for v, (w, s) in field_slot.items()}
    for j in range(packed.n):
        v = int(packed.v1[j])
        if v >= 0:
            o, m = field_of.get(v, (0, 0))    # sinks: v1=0, v2=0
            packed.v1[j] = o
            packed.v2[j] = m
    new_init = 0
    for i in range(UQUEUE_MAX_IDS):
        c = (init >> (4 * i)) & 15
        if c and i not in sinks:
            new_init += c << field_of[i][0]
    packed.init_state = new_init
    packed.value_table = [
        (base[w] + w * s, (1 << w) - 1, "|".join(ls))
        for (w, s), ls in sorted(labels.items())]


# --- FIFO queue: state = a 7-slot x 4-bit ring word ------------------------
#
# Nibble 0 is the head; enqueue writes its id at the first empty nibble,
# dequeue succeeds only when nibble 0 equals its id and shifts the word
# down. Id 0 marks an empty slot, so live ids are 1..15; 7 slots keep the
# word in 28 bits. _fifo_remap colors ids over disjoint event spans and
# checks that the queue's depth never exceeds the ring.

FIFO_SLOTS = 7
FIFO_MAX_IDS = 15


def fifo_step(state, f, v1, v2):
    is_enq = f == F_ENQUEUE
    is_deq = f == F_DEQUEUE
    # per-nibble occupancy flags at bits 0, 4, 8, ...: nibble nonzero
    occ = (state | (state >> 1) | (state >> 2) | (state >> 3))
    length = state * 0
    for i in range(FIFO_SLOTS):
        length = length + ((occ >> (4 * i)) & 1)
    enq_ok = is_enq & (length < FIFO_SLOTS)
    deq_ok = is_deq & (v1 > 0) & ((state & 15) == v1)
    ok = enq_ok | deq_ok
    state_enq = state | (v1 << (4 * (length % FIFO_SLOTS) * is_enq))
    state2 = (state_enq * enq_ok
              + (state >> 4) * deq_ok
              + state * (1 - enq_ok - deq_ok))
    return state2, ok


def fifo_step_torch(state, f, v1, v2):
    is_enq = f == F_ENQUEUE
    is_deq = f == F_DEQUEUE
    occ = state | (state >> 1) | (state >> 2) | (state >> 3)
    length = state * 0
    for i in range(FIFO_SLOTS):
        length = length + ((occ >> (4 * i)) & 1)
    enq_ok = is_enq & (length < FIFO_SLOTS)
    deq_ok = is_deq & (v1 > 0) & ((state & 15) == v1)
    # where enq_ok holds, length < 7, so the shift is 4 * length < 28
    state_enq = state | (v1 << (4 * (length % FIFO_SLOTS)))
    return (torch.where(enq_ok, state_enq,
                        torch.where(deq_ok, state >> 4, state)),
            enq_ok | deq_ok)


def _fifo_encode(f_code, f, inv_value, ok_value, intern):
    val = (ok_value if (f_code == F_DEQUEUE and ok_value is not None)
           else inv_value)
    if val is None:
        raise ValueError("fifo kernel: nil op value")
    # unbounded interning; _fifo_remap colors the ids afterwards
    return intern(val), NIL_ID


def _fifo_pack_init(model, intern):
    s = 0
    if len(model.queue) > FIFO_SLOTS:
        raise ValueError(
            f"fifo kernel: more than {FIFO_SLOTS} initial elements")
    for i, v in enumerate(model.queue):
        if v is None:
            raise ValueError("fifo kernel: nil initial value")
        s |= (intern(v) + 1) << (4 * i)   # provisional; remap re-keys
    return s


def _fifo_remap(packed):
    """Interval id coloring and depth validation for the FIFO ring: two
    values with disjoint event spans may share a 4-bit id, and the most
    pairwise-overlapping spans bound the ring's depth on every search
    path. Raises ValueError when more than FIFO_MAX_IDS values are live
    at once or the depth can exceed FIFO_SLOTS. A never-dequeued value
    still holds its place in the ring (no sinks)."""
    from jepsen_tpu_torch.ops.encode import RET_INF as _INF
    inf = int(_INF)
    init = int(packed.init_state)
    info = {}   # id -> [start, end, enq, deq]
    for i in range(FIFO_SLOTS):
        nib = (init >> (4 * i)) & 15
        if nib:
            rec = info.setdefault(nib - 1, [-1, -1, 0, 0])
            rec[2] += 1             # each instance occupies a slot
    for j in range(packed.n):
        v = int(packed.v1[j])
        if v < 0:
            continue
        inv_e, ret_e = int(packed.inv[j]), int(packed.ret[j])
        rec = info.setdefault(v, [inv_e, -1, 0, 0])
        rec[0] = min(rec[0], inv_e)
        rec[1] = max(rec[1], ret_e)
        if int(packed.f[j]) == F_ENQUEUE:
            rec[2] += 1
        else:
            rec[3] += 1
    events = []
    for v, rec in info.items():
        if rec[2] > rec[3]:
            rec[1] = inf            # may stay pending forever
        events.append((rec[0], rec[2]))
        if rec[1] != inf:
            events.append((rec[1], -rec[2]))
    depth = cur = 0
    for _, d in sorted(events):
        cur += d
        depth = max(depth, cur)
    if depth > FIFO_SLOTS:
        raise ValueError(
            f"fifo kernel: queue depth can reach {depth} > {FIFO_SLOTS} "
            f"ring slots")
    id_of = {}
    free_at = [-2] * FIFO_MAX_IDS
    labels = {}
    for v, rec in sorted(info.items(), key=lambda kv: kv[1][0]):
        for s in range(FIFO_MAX_IDS):
            if free_at[s] < rec[0]:
                id_of[v] = s + 1    # ids are 1-based; 0 = empty
                free_at[s] = rec[1]
                val = (packed.value_table[v]
                       if 0 <= v < len(packed.value_table) else v)
                labels.setdefault(s + 1, []).append(repr(val))
                break
        else:
            raise ValueError(
                f"fifo kernel: more than {FIFO_MAX_IDS} simultaneously-"
                f"live values")
    for j in range(packed.n):
        v = int(packed.v1[j])
        if v >= 0:
            packed.v1[j] = id_of[v]
    new_init = 0
    for i in range(FIFO_SLOTS):
        nib = (init >> (4 * i)) & 15
        if nib:
            new_init |= id_of[nib - 1] << (4 * i)
    packed.init_state = new_init
    packed.value_table = [
        "|".join(labels.get(i, [])) for i in range(FIFO_MAX_IDS + 1)]


# ---------------------------------------------------------------------------
# Counterexample rendering
# ---------------------------------------------------------------------------


def _register_describe(state, values):
    if state == NIL_ID:
        return "nil"
    return repr(values[state]) if 0 <= state < len(values) else str(state)


def _mutex_describe(state, values):
    return "locked" if state else "free"


def _set_describe(state, values):
    # after _set_remap, value_table holds (offset, mask, label) fields
    parts = []
    for entry in values:
        if not (isinstance(entry, tuple) and len(entry) == 3):
            return f"state={int(state):#x}"
        off, mask, label = entry
        c = (int(state) >> off) & mask
        if c:
            parts.append(f"{label}" if mask == 1
                         else f"{label}:{c}/{mask}")
    return "{" + ", ".join(parts) + "}"


def _uqueue_describe(state, values):
    # after _uqueue_remap, value_table holds (offset, mask, label) fields
    parts = []
    for entry in values:
        if not (isinstance(entry, tuple) and len(entry) == 3):
            return f"state={state:#x}"
        off, mask, label = entry
        c = (int(state) >> off) & mask
        if c:
            parts.append(f"{label}x{c}" if c > 1 else str(label))
    return "pending{" + ", ".join(parts) + "}"


def _fifo_describe(state, values):
    parts = []
    s = int(state)
    for i in range(FIFO_SLOTS):
        nib = (s >> (4 * i)) & 15
        if not nib:
            break
        label = (values[nib] if nib < len(values) and values[nib]
                 else f"id{nib}")
        parts.append(str(label))
    return "queue[" + ", ".join(parts) + "]"


class _EveryOp(dict):
    """The f-codes of a model that accepts every op: each f, whatever it
    is, gets code F_READ (the op reads nothing of the state, and like a
    crashed read a crashed op constrains nothing)."""

    def get(self, key, default=None):
        return F_READ


CAS_REGISTER_KERNEL = KernelSpec(
    name="cas-register",
    init_state=NIL_ID,
    step=cas_register_step,
    step_torch=cas_register_step_torch,
    f_codes={"read": F_READ, "write": F_WRITE, "cas": F_CAS},
    pack_init=lambda m, intern: (NIL_ID if m.value is None
                                 else intern(m.value)),
    readonly=lambda f, v1, v2: (f == F_READ
                                or (f == F_CAS and v1 == v2)),
    describe_state=_register_describe,
)

MUTEX_KERNEL = KernelSpec(
    name="mutex",
    init_state=0,
    step=mutex_step,
    step_torch=mutex_step_torch,
    f_codes={"acquire": F_ACQUIRE, "release": F_RELEASE},
    pack_init=lambda m, intern: int(m.locked),
    describe_state=_mutex_describe,
)

#: The reference's no-op kernel has no f-codes, so every history with an
#: op leaves its device search for the object search. Here every op packs,
#: with nil values (the step reads none), and the history stays on the
#: device; the verdict is the object search's (always valid).
NOOP_KERNEL = KernelSpec(
    name="noop",
    init_state=0,
    step=noop_step,
    step_torch=noop_step_torch,
    f_codes=_EveryOp(),
    encode_op=lambda fc, f, inv_value, ok_value, intern: (NIL_ID, NIL_ID),
    readonly=lambda f, v1, v2: True,
)

SET_KERNEL = KernelSpec(
    name="set",
    init_state=0,
    step=set_step,
    step_torch=set_step_torch,
    f_codes={"add": F_ADD, "read": F_READ},
    pack_init=_set_pack_init,
    encode_op=_set_encode,
    remap=_set_remap,
    readonly=lambda f, v1, v2: f == F_READ,
    describe_state=_set_describe,
)

UNORDERED_QUEUE_KERNEL = KernelSpec(
    name="unordered-queue",
    init_state=0,
    step=uqueue_step,
    step_torch=uqueue_step_torch,
    f_codes={"enqueue": F_ENQUEUE, "dequeue": F_DEQUEUE},
    pack_init=_uqueue_pack_init,
    encode_op=_uqueue_encode,
    remap=_uqueue_remap,
    # sink enqueues (v2 == 0: the value is never dequeued) succeed and
    # change nothing at any state
    readonly=lambda f, v1, v2: f == F_ENQUEUE and v2 == 0,
    describe_state=_uqueue_describe,
    drop_crashed=lambda fc, inv_value: (fc == F_DEQUEUE
                                        and inv_value is None),
)

FIFO_QUEUE_KERNEL = KernelSpec(
    name="fifo-queue",
    init_state=0,
    step=fifo_step,
    step_torch=fifo_step_torch,
    f_codes={"enqueue": F_ENQUEUE, "dequeue": F_DEQUEUE},
    pack_init=_fifo_pack_init,
    encode_op=_fifo_encode,
    remap=_fifo_remap,
    describe_state=_fifo_describe,
    drop_crashed=lambda fc, inv_value: (fc == F_DEQUEUE
                                        and inv_value is None),
)

#: every kernel, in the order of their model codes in ``csrc/search.cu``
KERNELS = (CAS_REGISTER_KERNEL, MUTEX_KERNEL, NOOP_KERNEL, SET_KERNEL,
           UNORDERED_QUEUE_KERNEL, FIFO_QUEUE_KERNEL)


def kernel_spec_for(model: Model) -> Optional[KernelSpec]:
    """The integer KernelSpec for a model instance, or None for a model
    with no word encoding. A history that exceeds its kernel's capacity
    raises ValueError when packed (the object search takes it)."""
    if isinstance(model, CASRegister):
        return CAS_REGISTER_KERNEL
    if isinstance(model, Mutex):
        return MUTEX_KERNEL
    if isinstance(model, NoOp):
        return NOOP_KERNEL
    if isinstance(model, SetModel):
        return SET_KERNEL
    if isinstance(model, UnorderedQueue):
        return UNORDERED_QUEUE_KERNEL
    if isinstance(model, FIFOQueue):
        return FIFO_QUEUE_KERNEL
    return None
