"""History simulators for tests and the chip smoke run.

Counterparts of ``simulate_register_history``, ``corrupt_one_read`` and
``wide_history`` in ``jepsen_tpu.testing``, and of the JAX package's test
fixtures ``random_set_history``, ``random_queue_history``,
``unique_queue_history`` and ``random_fifo_history``: each draws from a
``random.Random`` built from the ``seed`` it is given (or takes one), so
the same seed yields the same history as the JAX package's copy.
``crash_writes``, ``far_write_history`` and the three full-size
simulators of the other models (``simulate_mutex_history``,
``simulate_queue_history``, ``simulate_set_history``) are the port's own.

The in-process fake backend of ``core.run`` is a copy of the reference's:
``noop_test``, a complete test map that does nothing, and ``AtomDB`` and
``AtomClient`` over a lock-guarded ``SharedRegister``, which ``atom_test``
puts together into a runnable CAS-register test. So are the in-memory
backends the workload checkers are held against, each correct or, with
``broken=True``, deliberately broken: ``FlakyClient``, ``SharedBank`` and
``BankClient``, ``SharedMonotonic`` and ``MonotonicClient``, ``SharedKV``
and ``SequentialClient``, ``G2Client``, ``SharedQueue`` and
``QueueClient``.
"""

from __future__ import annotations

import collections
import random
import threading
import time
from typing import Any, Optional

from jepsen_tpu_torch import client as client_ns
from jepsen_tpu_torch import db as db_ns
from jepsen_tpu_torch import os as os_ns
from jepsen_tpu_torch.history import History, Op


def noop_test() -> dict:
    """A test map that does nothing: the skeleton other tests merge
    over."""
    return {
        "name": "noop",
        "nodes": ["n1", "n2", "n3", "n4", "n5"],
        "concurrency": 5,
        "os": os_ns.noop(),
        "db": db_ns.noop(),
        "client": client_ns.noop(),
        "nemesis": None,
        "generator": None,
        "checker": None,
        "ssh": {"mode": "dummy"},
    }


class SharedRegister:
    """A lock-guarded register with an atomic cas: the 'database'."""

    def __init__(self, value: Any = None):
        self._value = value
        self._lock = threading.Lock()

    def read(self):
        with self._lock:
            return self._value

    def write(self, v):
        with self._lock:
            self._value = v

    def cas(self, old, new) -> bool:
        with self._lock:
            if self._value == old:
                self._value = new
                return True
            return False


class AtomDB(db_ns.DB):
    """A DB whose state is an in-memory register; setup resets it."""

    def __init__(self, register: Optional[SharedRegister] = None):
        self.register = register or SharedRegister()

    def setup(self, test, node):
        self.register.write(None)

    def teardown(self, test, node):
        self.register.write(None)


class AtomClient(client_ns.Client):
    """A client of the shared register: linearizable by construction."""

    def __init__(self, register: SharedRegister):
        self.register = register

    def open(self, test, node):
        return AtomClient(self.register)

    def invoke(self, test, op: Op) -> Op:
        if op.f == "read":
            return op.replace(type="ok", value=self.register.read())
        if op.f == "write":
            self.register.write(op.value)
            return op.replace(type="ok")
        if op.f == "cas":
            old, new = op.value
            ok = self.register.cas(old, new)
            return op.replace(type="ok" if ok else "fail")
        raise ValueError(f"unknown op {op.f!r}")


class FlakyClient(AtomClient):
    """An AtomClient that sometimes times out after applying (or not
    applying) the op: indeterminate ``info`` completions, for tests of
    process reincarnation and of the checkers' crashed-op semantics."""

    def __init__(self, register: SharedRegister, flake_p: float = 0.1,
                 seed: Optional[int] = None):
        super().__init__(register)
        self.flake_p = flake_p
        self.rng = random.Random(seed)

    def open(self, test, node):
        return FlakyClient(self.register, self.flake_p,
                           self.rng.randrange(2**31))

    def invoke(self, test, op: Op) -> Op:
        if self.rng.random() < self.flake_p:
            # maybe apply, then time out
            if self.rng.random() < 0.5 and op.f != "read":
                super().invoke(test, op)
            raise TimeoutError("simulated client timeout")
        return super().invoke(test, op)


class SharedBank:
    """Lock-guarded accounts for the bank workload: transfers are atomic
    and refuse overdrafts (what a serializable SQL transaction gives)."""

    def __init__(self, n: int = 5, per_account: int = 10):
        self.n = n
        self.total = n * per_account
        self.balances = [per_account] * n
        self._lock = threading.Lock()

    def read(self):
        with self._lock:
            return list(self.balances)

    def transfer(self, frm: int, to: int, amount: int) -> bool:
        with self._lock:
            if self.balances[frm] < amount:
                return False
            self.balances[frm] -= amount
            self.balances[to] += amount
            return True


class BankClient(client_ns.Client):
    """A client of a SharedBank; ``broken=True`` loses the credit half of
    every third transfer, so that reads show a wrong total."""

    def __init__(self, bank: SharedBank, broken: bool = False):
        self.bank = bank
        self.broken = broken
        self._n = 0

    def open(self, test, node):
        return BankClient(self.bank, self.broken)

    def invoke(self, test, op: Op) -> Op:
        if op.f == "read":
            return op.replace(type="ok", value=self.bank.read())
        if op.f == "transfer":
            v = op.value
            if self.broken:
                self._n += 1
                if self._n % 3 == 0:  # lose the credit half of the txn
                    with self.bank._lock:
                        self.bank.balances[v["from"]] -= v["amount"]
                    return op.replace(type="ok")
            ok = self.bank.transfer(v["from"], v["to"], v["amount"])
            return op.replace(type="ok" if ok else "fail")
        raise ValueError(f"unknown op {op.f!r}")


class SharedMonotonic:
    """A monotonic-insert table: an add assigns (val, sts) under one lock,
    so that value order and timestamp order agree."""

    def __init__(self):
        self.rows = []
        self._lock = threading.Lock()
        self._next = 0
        self._sts = 0

    def add(self, proc, node, skew: int = 0):
        with self._lock:
            val = self._next
            self._next += 1
            self._sts += 1
            self.rows.append({"val": val, "sts": self._sts + skew,
                              "proc": proc, "node": node, "tb": 0})
            return val

    def read(self):
        with self._lock:
            return sorted(self.rows, key=lambda r: r["sts"])


class MonotonicClient(client_ns.Client):
    """A client of a SharedMonotonic; ``broken=True`` skews timestamps so
    that timestamp order disagrees with value order."""

    def __init__(self, table: SharedMonotonic, broken: bool = False):
        self.table = table
        self.broken = broken

    def open(self, test, node):
        c = MonotonicClient(self.table, self.broken)
        c.node = node
        return c

    def invoke(self, test, op: Op) -> Op:
        if op.f == "add":
            skew = (-3 if self.broken and self.table._next % 5 == 4 else 0)
            val = self.table.add(op.process, getattr(self, "node", None),
                                 skew)
            return op.replace(type="ok", value=val)
        if op.f == "read":
            return op.replace(type="ok", value=self.table.read())
        raise ValueError(f"unknown op {op.f!r}")


class SharedKV:
    """A flat lock-guarded key-value namespace for the sequential
    workload."""

    def __init__(self):
        self.data = {}
        self._lock = threading.Lock()

    def put(self, k, v=True):
        with self._lock:
            self.data[k] = v

    def get(self, k):
        with self._lock:
            return self.data.get(k)


class SequentialClient(client_ns.Client):
    """Writes insert subkeys in client order; reads probe them in reverse.
    ``broken=True`` writes the subkeys in reverse order, so that a
    concurrent reader can see a later subkey without an earlier one (a
    trailing nil)."""

    def __init__(self, kv: SharedKV, broken: bool = False):
        self.kv = kv
        self.broken = broken

    def open(self, test, node):
        return SequentialClient(self.kv, self.broken)

    def invoke(self, test, op: Op) -> Op:
        from jepsen_tpu_torch.suites.workloads import subkeys
        key_count = test.get("key-count", 5)
        ks = subkeys(key_count, op.value)
        if op.f == "write":
            if self.broken:
                for k in reversed(ks):
                    self.kv.put(k)
                    time.sleep(0.001)  # widen the visibility window
            else:
                for k in ks:
                    self.kv.put(k)
            return op.replace(type="ok")
        if op.f == "read":
            vals = [k if self.kv.get(k) else None for k in reversed(ks)]
            return op.replace(type="ok", value=(op.value, vals))
        raise ValueError(f"unknown op {op.f!r}")


class G2Client(client_ns.Client):
    """A predicate read and an insert over two tables. Under one global
    transaction lock the G2 anomaly is impossible; ``broken=True`` drops
    the lock, so that both inserts of a key can succeed."""

    def __init__(self, broken: bool = False, state=None, lock=None):
        self.broken = broken
        self.state = state if state is not None else {}
        self.lock = lock or threading.Lock()

    def open(self, test, node):
        return G2Client(self.broken, self.state, self.lock)

    def _txn(self, k, a_id, b_id):
        a = self.state.setdefault("a", {})
        b = self.state.setdefault("b", {})
        if any(row["key"] == k for row in a.values()) or \
           any(row["key"] == k for row in b.values()):
            return False
        if a_id is not None:
            a[a_id] = {"key": k, "value": 30}
        else:
            b[b_id] = {"key": k, "value": 30}
        return True

    def invoke(self, test, op: Op) -> Op:
        k, (a_id, b_id) = op.value.key, op.value.value
        if self.broken:
            ok1 = not any(row["key"] == k
                          for row in self.state.setdefault("a", {}).values())
            ok2 = not any(row["key"] == k
                          for row in self.state.setdefault("b", {}).values())
            time.sleep(0.001)  # widen the race window
            if ok1 and ok2:
                tbl = self.state["a"] if a_id is not None else self.state["b"]
                tbl[a_id if a_id is not None else b_id] = {"key": k,
                                                           "value": 30}
                return op.replace(type="ok")
            return op.replace(type="fail")
        with self.lock:
            ok = self._txn(k, a_id, b_id)
        return op.replace(type="ok" if ok else "fail")


class SharedQueue:
    """A lock-guarded FIFO for the queue workloads."""

    def __init__(self):
        self.q = collections.deque()
        self._lock = threading.Lock()

    def enqueue(self, v):
        with self._lock:
            self.q.append(v)

    def dequeue(self):
        with self._lock:
            return self.q.popleft() if self.q else None


class QueueClient(client_ns.Client):
    """A client of a SharedQueue; ``broken=True`` drops every fourth
    enqueue after acknowledging it (lost messages)."""

    def __init__(self, queue: SharedQueue, broken: bool = False):
        self.queue = queue
        self.broken = broken
        self._n = 0

    def open(self, test, node):
        return QueueClient(self.queue, self.broken)

    def invoke(self, test, op: Op) -> Op:
        if op.f == "enqueue":
            self._n += 1
            if self.broken and self._n % 4 == 0:
                return op.replace(type="ok")  # acked but dropped
            self.queue.enqueue(op.value)
            return op.replace(type="ok")
        if op.f in ("dequeue", "drain"):
            v = self.queue.dequeue()
            if v is None:
                return op.replace(type="fail")
            return op.replace(type="ok", value=v)
        raise ValueError(f"unknown op {op.f!r}")


def atom_test(register: Optional[SharedRegister] = None, **overrides) -> dict:
    """A runnable in-memory CAS-register test: ``noop_test`` over an
    ``AtomDB`` and ``AtomClient``, with the ``CASRegister`` model."""
    from jepsen_tpu_torch.models import CASRegister
    reg = register or SharedRegister()
    test = noop_test()
    test.update({
        "name": "atom-cas",
        "db": AtomDB(reg),
        "client": AtomClient(reg),
        "model": CASRegister(),
    })
    test.update(overrides)
    return test


def simulate_register_history(n_ops: int, n_procs: int = 5, n_vals: int = 8,
                              seed: int = 0, cas_p: float = 0.2,
                              crash_p: float = 0.0,
                              overlap_p: float = 0.6) -> History:
    """A concurrent CAS-register history, linearizable by construction:
    each op takes effect at a random commit instant between its
    invocation and completion. ``crash_p`` turns completions into 'info'
    (the crashed process is replaced by ``p + n_procs``); a low
    ``overlap_p`` gives mostly sequential, staggered histories."""
    rng = random.Random(seed)
    h = History()
    value = None
    free = list(range(n_procs))
    in_flight = []  # [process, op, committed?]
    invoked = 0
    t = 0
    while invoked < n_ops or in_flight:
        can_invoke = free and invoked < n_ops
        if can_invoke and (not in_flight or rng.random() < overlap_p):
            p = free.pop(rng.randrange(len(free)))
            r = rng.random()
            if r < cas_p:
                f, v = "cas", (rng.randrange(n_vals), rng.randrange(n_vals))
            elif r < cas_p + (1 - cas_p) / 2:
                f, v = "write", rng.randrange(n_vals)
            else:
                f, v = "read", None
            h.append(Op(type="invoke", f=f, value=v, process=p, time=t))
            in_flight.append([p, h[-1], False])
            invoked += 1
        else:
            entry = rng.choice(in_flight)
            p, inv_op, committed = entry
            if not committed:
                if inv_op.f == "write":
                    value = inv_op.value
                    entry[2] = ("ok", inv_op.value)
                elif inv_op.f == "cas":
                    old, new = inv_op.value
                    if value == old:
                        value = new
                        entry[2] = ("ok", inv_op.value)
                    else:
                        entry[2] = ("fail", inv_op.value)
                else:
                    entry[2] = ("ok", value)
                # complete immediately half the time, else stay in flight
                if rng.random() >= 0.5:
                    continue
            typ, val = entry[2]
            in_flight.remove(entry)
            if crash_p and rng.random() < crash_p:
                h.append(Op(type="info", f=inv_op.f, value=inv_op.value,
                            process=p, time=t))
                free.append(p + n_procs)
            else:
                h.append(Op(type=typ, f=inv_op.f, value=val, process=p,
                            time=t))
                free.append(p)
        t += 1
    return h


def corrupt_one_read(history, rng: random.Random, bogus=99) -> History:
    """Flip one random ok-read completion to a bogus value; identity when
    the sampled row is not a corruptible read."""
    rows = list(history)
    if rows:
        i = rng.randrange(len(rows))
        o = rows[i]
        if o.type == "ok" and o.f == "read" and o.value is not None:
            rows[i] = o.replace(value=bogus)
    return History.of(rows)


def crash_writes(history, count: int) -> History:
    """The history with its first ``count`` ok writes reported as 'info'
    instead: a write that took effect may be reported as crashed, so the
    history stays linearizable and gains crashed ops."""
    rows = list(history)
    for i in [i for i, o in enumerate(rows)
              if o.type == "ok" and o.f == "write"][:count]:
        rows[i] = rows[i].replace(type="info")
    return History(rows)


def wide_history(n_procs=100, rounds=2, write_frac=0.12, seed=0,
                 corrupt=False) -> History:
    """Rounds of ``n_procs`` fully overlapping register ops: every op of a
    round is invoked before any completes, so the search needs a window of
    about ``n_procs`` offsets. Linearizable unless ``corrupt``, which sets
    the last ok read to a never-written value."""
    rng = random.Random(seed)
    h = History()
    value = None
    t = 0
    nextv = 0
    for _ in range(rounds):
        ops = []
        for p in range(n_procs):
            if rng.random() < write_frac:
                f, v = "write", nextv
                nextv += 1
            else:
                f, v = "read", None
            h.append(Op(type="invoke", f=f, value=v, process=p, time=t))
            t += 1
            ops.append((p, f, v))
        rng.shuffle(ops)                   # commit order
        comps = []
        for p, f, v in ops:
            if f == "write":
                value = v
                comps.append((p, "ok", f, v))
            else:
                comps.append((p, "ok", f, value))
        rng.shuffle(comps)                 # return order, independent
        for p, typ, f, v in comps:
            h.append(Op(type=typ, f=f, value=v, process=p, time=t))
            t += 1
    if corrupt:
        rows = list(h)
        for i in range(len(rows) - 1, -1, -1):
            o = rows[i]
            if o.type == "ok" and o.f == "read":
                rows[i] = o.replace(value=10**6)
                break
        h = History.of(rows)
    return h


def far_write_history(offset: int = 130, read_value=7) -> History:
    """A register history whose first op to return is a read of a value
    that only a write ``offset`` ops later in return order can have
    written: the write is invoked before the read returns and returns
    after ``offset - 1`` sequential reads of its value. Past an offset of
    128 the device search cannot reach the write (its window holds 128
    offsets) and answers UNKNOWN at once, while the host searches take it.
    Linearizable when ``read_value`` is 7, the written value; with another
    value the first read is refuted."""
    rows = [Op(type="invoke", f="read", value=None, process=0, time=0),
            Op(type="invoke", f="write", value=7, process=1, time=1),
            Op(type="ok", f="read", value=read_value, process=0, time=2)]
    t = 3
    for _ in range(offset - 1):
        rows.append(Op(type="invoke", f="read", value=None, process=2,
                       time=t))
        rows.append(Op(type="ok", f="read", value=7, process=2, time=t + 1))
        t += 2
    rows.append(Op(type="ok", f="write", value=7, process=1, time=t))
    return History(rows)


def keyed_history(histories: dict) -> History:
    """One ``[k v]`` history from per-key histories, as an independent-key
    test records it: every op's value wrapped as ``KV(k, value)``, each
    key's processes offset into a range of their own, and the keys' ops
    interleaved by time."""
    from jepsen_tpu_torch.independent import KV
    events = []
    for n, (k, h) in enumerate(histories.items()):
        events += [(o.time, n, j, k, o) for j, o in enumerate(h)]
    events.sort(key=lambda e: e[:3])
    out = History()
    for i, (_, n, _, k, o) in enumerate(events):
        p = o.process + 1000 * (n + 1) if isinstance(o.process, int) \
            else o.process
        out.append(Op(o.type, o.f, KV(k, o.value), p, o.time, i, o.error,
                      o.extra))
    return out


# ---------------------------------------------------------------------------
# The other model families
# ---------------------------------------------------------------------------


def random_set_history(rng, n_procs=3, n_ops=8, n_vals=4, crash_p=0.1,
                       corrupt_p=0.3) -> History:
    """Random concurrent grow-only-set history. Reads return a snapshot of
    the elements applied so far, randomly corrupted with corrupt_p."""
    h = History()
    free = list(range(n_procs))
    open_ops = {}
    applied = set()
    ops_left = n_ops
    t = 0
    while (ops_left > 0 and free) or open_ops:
        if free and ops_left > 0 and (not open_ops or rng.random() < 0.5):
            p = rng.choice(free)
            free.remove(p)
            ops_left -= 1
            if rng.random() < 0.6:
                op = Op(type="invoke", f="add", value=rng.randrange(n_vals),
                        process=p, time=t)
            else:
                op = Op(type="invoke", f="read", value=None, process=p,
                        time=t)
            h.append(op)
            open_ops[p] = op
        else:
            p = rng.choice(list(open_ops))
            inv = open_ops.pop(p)
            r = rng.random()
            if r < crash_p and inv.f == "add":
                h.append(Op(type="info", f=inv.f, value=inv.value,
                            process=p, time=t))
            else:
                if inv.f == "add":
                    applied.add(inv.value)
                    h.append(Op(type="ok", f="add", value=inv.value,
                                process=p, time=t))
                else:
                    snap = set(applied)
                    if rng.random() < corrupt_p:
                        flip = rng.randrange(n_vals)
                        snap ^= {flip}
                    h.append(Op(type="ok", f="read", value=sorted(snap),
                                process=p, time=t))
                free.append(p)
        t += 1
    return h


def random_queue_history(rng, n_procs=3, n_ops=8, n_vals=4, crash_p=0.1,
                         corrupt_p=0.2) -> History:
    """Random concurrent unordered-queue history: enqueues of small values,
    dequeues of a pending (or, with corrupt_p, arbitrary) value."""
    h = History()
    free = list(range(n_procs))
    open_ops = {}
    pending = collections.Counter()
    ops_left = n_ops
    t = 0
    while (ops_left > 0 and free) or open_ops:
        if free and ops_left > 0 and (not open_ops or rng.random() < 0.5):
            p = rng.choice(free)
            free.remove(p)
            ops_left -= 1
            if rng.random() < 0.6 or not +pending:
                op = Op(type="invoke", f="enqueue",
                        value=rng.randrange(n_vals), process=p, time=t)
            else:
                op = Op(type="invoke", f="dequeue", value=None, process=p,
                        time=t)
            h.append(op)
            open_ops[p] = op
        else:
            p = rng.choice(list(open_ops))
            inv = open_ops.pop(p)
            r = rng.random()
            if r < crash_p and inv.f == "enqueue":
                h.append(Op(type="info", f=inv.f, value=inv.value,
                            process=p, time=t))
            else:
                if inv.f == "enqueue":
                    pending[inv.value] += 1
                    h.append(Op(type="ok", f="enqueue", value=inv.value,
                                process=p, time=t))
                else:
                    live = sorted(v for v, c in pending.items() if c > 0)
                    if live and rng.random() >= corrupt_p:
                        v = rng.choice(live)
                        pending[v] -= 1
                    else:
                        v = rng.randrange(n_vals)
                    h.append(Op(type="ok", f="dequeue", value=v,
                                process=p, time=t))
                free.append(p)
        t += 1
    return h


def unique_queue_history(n_ops=200, n_procs=5, seed=1,
                         corrupt=False) -> History:
    """Unique sequential enqueue values, dequeues of a random pending
    value. Linearizable by construction (a dequeue returns a value whose
    enqueue completed; empty-queue dequeues fail) unless ``corrupt``,
    which sets the last ok dequeue to a never-enqueued value."""
    rng = random.Random(seed)
    h = History()
    free = list(range(n_procs))
    open_ops = {}
    pending = []
    nextv = done = t = 0
    while done < n_ops or open_ops:
        if free and done < n_ops and (not open_ops or rng.random() < 0.55):
            p = free.pop(rng.randrange(len(free)))
            if rng.random() < 0.55 or not pending:
                op = Op(type="invoke", f="enqueue", value=nextv, process=p,
                        time=t)
                nextv += 1
            else:
                op = Op(type="invoke", f="dequeue", value=None, process=p,
                        time=t)
            h.append(op)
            open_ops[p] = op
            done += 1
        else:
            p = rng.choice(list(open_ops))
            inv = open_ops.pop(p)
            if inv.f == "enqueue":
                pending.append(inv.value)
                h.append(Op(type="ok", f="enqueue", value=inv.value,
                            process=p, time=t))
            else:
                if pending:
                    v = pending.pop(rng.randrange(len(pending)))
                    h.append(Op(type="ok", f="dequeue", value=v,
                                process=p, time=t))
                else:
                    h.append(Op(type="fail", f="dequeue", value=None,
                                process=p, time=t))
            free.append(p)
        t += 1
    if corrupt:
        rows = list(h)
        for i in range(len(rows) - 1, -1, -1):
            if rows[i].type == "ok" and rows[i].f == "dequeue":
                rows[i] = rows[i].replace(value=10**7)
                break
        h = History.of(rows)
    return h


def random_fifo_history(rng, n_procs=3, n_ops=10, corrupt_p=0.25,
                        crash_p=0.12) -> History:
    """Random concurrent FIFO history: unique enqueue values; dequeues
    usually pop the true head, sometimes an out-of-order or bogus value,
    and some enqueues crash."""
    h = History()
    free = list(range(n_procs))
    open_ops = {}
    q = []
    nextv = done = t = 0
    while done < n_ops or open_ops:
        if free and done < n_ops and (not open_ops or rng.random() < 0.5):
            p = free.pop(rng.randrange(len(free)))
            if rng.random() < 0.55 or not q:
                op = Op(type="invoke", f="enqueue", value=nextv, process=p,
                        time=t)
                nextv += 1
            else:
                op = Op(type="invoke", f="dequeue", value=None, process=p,
                        time=t)
            h.append(op)
            open_ops[p] = op
            done += 1
        else:
            p = rng.choice(list(open_ops))
            inv = open_ops.pop(p)
            if inv.f == "enqueue":
                if rng.random() < crash_p:
                    h.append(Op(type="info", f="enqueue", value=inv.value,
                                process=p, time=t))
                    free.append(p)
                    t += 1
                    continue
                q.append(inv.value)
                h.append(Op(type="ok", f="enqueue", value=inv.value,
                            process=p, time=t))
            else:
                if q and rng.random() >= corrupt_p:
                    v = q.pop(0)
                elif q and rng.random() < 0.5:
                    v = q.pop(rng.randrange(len(q)))
                else:
                    v = 999
                h.append(Op(type="ok", f="dequeue", value=v, process=p,
                            time=t))
            free.append(p)
        t += 1
    return h


def _run_clients(n_ops, n_procs, rng, overlap_p, next_op, commit,
                 crash_p=0.0, on_crash=None) -> History:
    """The event loop the simulators share: ``n_procs`` clients, each with
    one op in flight at a time. ``next_op(p)`` gives a free client's next
    (f, value); each op takes effect at a random instant between its
    invocation and its completion, where ``commit(p, f, value)`` applies
    it and returns the completion's (type, value). With ``crash_p`` a
    completion is reported as 'info' instead, and the client goes on as a
    new process (``on_crash(old, new, op)``)."""
    h = History()
    free = list(range(n_procs))
    in_flight = []  # [process, op, completion or None]
    invoked = t = 0
    fresh = n_procs
    while invoked < n_ops or in_flight:
        can_invoke = free and invoked < n_ops
        if can_invoke and (not in_flight or rng.random() < overlap_p):
            p = free.pop(rng.randrange(len(free)))
            f, v = next_op(p)
            h.append(Op(type="invoke", f=f, value=v, process=p, time=t))
            in_flight.append([p, h[-1], None])
            invoked += 1
        else:
            entry = rng.choice(in_flight)
            p, inv_op, done = entry
            if done is None:
                entry[2] = commit(p, inv_op.f, inv_op.value)
                if rng.random() >= 0.5:   # complete later
                    t += 1
                    continue
            typ, val = entry[2]
            in_flight.remove(entry)
            if crash_p and rng.random() < crash_p:
                h.append(Op(type="info", f=inv_op.f, value=inv_op.value,
                            process=p, time=t))
                fresh += 1
                if on_crash is not None:
                    on_crash(p, fresh, inv_op)
                free.append(fresh)
            else:
                h.append(Op(type=typ, f=inv_op.f, value=val, process=p,
                            time=t))
                free.append(p)
        t += 1
    return h


def simulate_mutex_history(n_ops: int, n_procs: int = 5, seed: int = 0,
                           crash_p: float = 0.0,
                           overlap_p: float = 0.6) -> History:
    """A lock shared by ``n_procs`` clients, one per node, each looping
    acquire / release (a try-lock: an acquire of a held lock fails).
    Linearizable by construction. A crashed client's successor process
    holds the lock if it did, and releases it next."""
    rng = random.Random(seed)
    state = {"holder": None}
    holds = collections.defaultdict(bool)

    def next_op(p):
        return ("release" if holds[p] else "acquire"), None

    def commit(p, f, v):
        if f == "release":
            state["holder"] = None
            holds[p] = False
            return "ok", None
        if state["holder"] is None:
            state["holder"] = p
            holds[p] = True
            return "ok", None
        return "fail", None

    def on_crash(old, new, op):
        holds[new] = holds.pop(old, False)
        if state["holder"] == old:
            state["holder"] = new

    return _run_clients(n_ops, n_procs, rng, overlap_p, next_op, commit,
                        crash_p, on_crash)


def simulate_queue_history(n_ops: int, n_procs: int = 5, seed: int = 0,
                           backlog: int = 8, fifo: bool = True,
                           overlap_p: float = 0.6) -> History:
    """A queue of unique values (0, 1, 2, ...) under ``n_procs`` clients
    that enqueue and dequeue; consumers keep up, so at most ``backlog``
    enqueued values are not yet dequeued. A dequeue takes the oldest
    pending value (``fifo``) or any pending value (an unordered queue's
    delivery); on an empty queue it fails. Linearizable by construction,
    for FIFOQueue when ``fifo`` and for UnorderedQueue always."""
    rng = random.Random(seed)
    queue: list = []
    state = {"next": 0, "open": 0}   # next value; enqueued, not dequeued

    def next_op(p):
        if state["open"] >= backlog or (state["open"] and
                                        rng.random() < 0.5):
            return "dequeue", None
        state["open"] += 1
        state["next"] += 1
        return "enqueue", state["next"] - 1

    def commit(p, f, v):
        if f == "enqueue":
            queue.append(v)
            return "ok", v
        if not queue:
            return "fail", None
        state["open"] -= 1
        return "ok", queue.pop(0 if fifo else rng.randrange(len(queue)))

    return _run_clients(n_ops, n_procs, rng, overlap_p, next_op, commit)


def simulate_set_history(n_adds: int, n_procs: int = 5, seed: int = 0,
                         crash_p: float = 0.0, overlap_p: float = 0.6,
                         lost_p: float = 0.5) -> History:
    """``n_adds`` adds of unique elements (0, 1, 2, ...) from ``n_procs``
    clients, then one final read of the whole set, as a sets workload
    ends. A crashed add's effect is lost with probability ``lost_p`` and
    took effect otherwise; the read sees the adds that took effect.
    Linearizable by construction."""
    rng = random.Random(seed)
    applied = set()
    counter = iter(range(n_adds))

    def next_op(p):
        return "add", next(counter)

    def commit(p, f, v):
        applied.add(v)
        return "ok", v

    def on_crash(old, new, op):
        # no read runs before the final one, so an add that crashed may as
        # well never have taken effect
        if rng.random() < lost_p:
            applied.discard(op.value)

    h = _run_clients(n_adds, n_procs, rng, overlap_p, next_op, commit,
                     crash_p, on_crash)
    t = h[-1].time + 1 if h else 0
    h.append(Op(type="invoke", f="read", value=None, process=0, time=t))
    h.append(Op(type="ok", f="read", value=sorted(applied), process=0,
                time=t + 1))
    return h


def corrupt_model_history(history, family: str) -> History:
    """A copy of a simulated history that its model refutes: for the
    register, the first ok read returns a value never written; for a
    queue, the first ok dequeue returns a value never enqueued; for the
    set, the
    final read misses an element whose add completed; for the mutex, the
    ok release at the middle is dropped (its invocation and completion),
    so a later acquire finds the lock held. (A bogus dequeue deep in a
    queue history stalls the pool search at that op while its beam walks
    the earlier interleavings: the level budget runs out first, on the
    reference as here.)"""
    rows = list(history)
    mid = len(rows) // 2
    if family == "cas-register":
        i = next(i for i in range(len(rows))
                 if rows[i].type == "ok" and rows[i].f == "read"
                 and rows[i].value is not None)
        rows[i] = rows[i].replace(value=10**7)
        return History(rows)
    if family in ("unordered-queue", "fifo-queue"):
        i = next(i for i in range(len(rows))
                 if rows[i].type == "ok" and rows[i].f == "dequeue")
        rows[i] = rows[i].replace(value=10**7)
        return History(rows)
    if family == "set":
        i = max(i for i, o in enumerate(rows)
                if o.type == "ok" and o.f == "read")
        done = {o.value for o in rows if o.type == "ok" and o.f == "add"}
        gone = min(v for v in rows[i].value if v in done)
        rows[i] = rows[i].replace(value=[v for v in rows[i].value
                                         if v != gone])
        return History(rows)
    if family == "mutex":
        done = next(i for i in range(mid, len(rows))
                    if rows[i].type == "ok" and rows[i].f == "release")
        p = rows[done].process
        inv = max(i for i in range(done) if rows[i].process == p
                  and rows[i].type == "invoke")
        return History([o for i, o in enumerate(rows)
                        if i not in (inv, done)])
    raise ValueError(f"no corruption for {family!r}")
