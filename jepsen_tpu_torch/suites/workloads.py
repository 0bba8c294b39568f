"""The workload library: generators and checkers that the suites share.

The port's copy of ``jepsen_tpu.suites.workloads``. Its semantics come
from the reference's suites:
- register r/w/cas ops: etcd.clj:144-146
- bank transfers: cockroach bank.clj:92-143
- monotonic inserts: cockroach monotonic.clj:163-246
- sequential consistency: cockroach sequential.clj
- G2 anti-dependency cycles: jepsen adya.clj:12-83

The generators draw from the module-level ``random``, as the
reference's do. The checkers read the history in the order it is
given; the port's ``core`` records it in op-time order.
"""

from __future__ import annotations

import itertools
import random
import threading
from collections import Counter as MultiSet
from typing import Any, Dict, List, Optional, Sequence

from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import independent
from jepsen_tpu_torch.checker import UNKNOWN, Checker
from jepsen_tpu_torch.util import integer_interval_set_str

# ---------------------------------------------------------------------------
# Register ops
# ---------------------------------------------------------------------------


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randrange(5), random.randrange(5))}


def register_gen():
    """The canonical mixed register workload."""
    return gen.mix([r, w, cas])


# ---------------------------------------------------------------------------
# Bank
# ---------------------------------------------------------------------------


def bank_read(test, process):
    """Read every account's balance."""
    return {"type": "invoke", "f": "read", "value": None}


def bank_transfer(n: int, max_amount: int = 5):
    """Random transfers between n accounts."""
    def op(test, process):
        return {"type": "invoke", "f": "transfer",
                "value": {"from": random.randrange(n),
                          "to": random.randrange(n),
                          "amount": 1 + random.randrange(max_amount)}}
    return op


def bank_diff_transfer(n: int, max_amount: int = 5):
    """Transfers between different accounts only."""
    return gen.gen(bank_transfer(n, max_amount)).filter(
        lambda op: op.value["from"] != op.value["to"])


class BankChecker(Checker):
    """Every read must show n non-negative balances summing to total."""

    def __init__(self, n: int, total: int):
        self.n = n
        self.total = total

    def check(self, test, history, opts=None):
        bad_reads = []
        for op in history:
            if not (op.is_ok and op.f == "read"):
                continue
            balances = op.value
            if balances is None:
                continue
            if len(balances) != self.n:
                bad_reads.append({"type": "wrong-n", "expected": self.n,
                                  "found": len(balances),
                                  "op": op.to_dict()})
            elif sum(balances) != self.total:
                bad_reads.append({"type": "wrong-total",
                                  "expected": self.total,
                                  "found": sum(balances),
                                  "op": op.to_dict()})
            elif any(b < 0 for b in balances):
                bad_reads.append({"type": "negative-value",
                                  "found": list(balances),
                                  "op": op.to_dict()})
        return {"valid": not bad_reads, "bad-reads": bad_reads}


def bank_checker(n: int, total: int) -> BankChecker:
    return BankChecker(n, total)


# ---------------------------------------------------------------------------
# Monotonic
# ---------------------------------------------------------------------------


def _non_monotonic(rows: Sequence[dict], field: str, strict: bool):
    """Adjacent pairs where ``field`` fails to increase: strict=True flags
    x' <= x, strict=False flags x' < x."""
    bad = []
    for a, b in zip(rows, rows[1:]):
        x, y = a.get(field), b.get(field)
        if x is None or y is None:
            continue
        if (y <= x) if strict else (y < x):
            bad.append((a, b))
    return bad


def _non_monotonic_by(rows, group_field, field, strict):
    groups: Dict[Any, List[dict]] = {}
    for row in rows:
        groups.setdefault(row.get(group_field), []).append(row)
    return {k: _non_monotonic(v, field, strict)
            for k, v in sorted(groups.items(), key=lambda kv: repr(kv[0]))}


class MonotonicChecker(Checker):
    """Timestamps and values must proceed monotonically; no lost,
    duplicate or revived records.

    Ok ``add`` ops carry value = record id (int); the last ok ``read``
    carries value = [{'val': id, 'sts': ts, 'proc': p, 'node': n, 'tb':
    t}, ...] in the database's scan order.
    """

    def __init__(self, linearizable: bool = False,
                 global_order: bool = True):
        self.linearizable = linearizable
        self.global_order = global_order

    def check(self, test, history, opts=None):
        adds, fails, infos = [], set(), set()
        final_read = None
        for op in history:
            if op.f == "add":
                if op.is_ok:
                    adds.append(op.value)
                elif op.is_fail:
                    fails.add(op.value)
                elif op.is_info:
                    infos.add(op.value)
            elif op.f == "read" and op.is_ok and op.value is not None:
                final_read = op.value
        if final_read is None:
            return {"valid": UNKNOWN, "error": "Set was never read"}

        rows = list(final_read)
        off_order_stss = _non_monotonic(rows, "sts", strict=True)
        off_order_vals = _non_monotonic(rows, "val", strict=False)
        per_process = _non_monotonic_by(rows, "proc", "val", False)
        per_node = _non_monotonic_by(rows, "node", "val", False)
        per_table = _non_monotonic_by(rows, "tb", "val", False)

        vals = [row.get("val") for row in rows]
        freq = MultiSet(vals)
        dups = {v for v, c in freq.items() if c > 1}
        final_set = set(vals)
        added = set(adds)
        lost = added - final_set
        revived = final_set & fails
        recovered = final_set & infos

        valid = (not lost and not dups and not revived
                 and not off_order_stss
                 and (not self.global_order or not off_order_vals)
                 and all(not v for v in per_process.values())
                 and (not self.linearizable or not off_order_vals))
        return {
            "valid": bool(valid),
            "revived": integer_interval_set_str(sorted(revived)),
            "recovered": integer_interval_set_str(sorted(recovered)),
            "lost": integer_interval_set_str(sorted(lost)),
            "duplicates": sorted(dups),
            "order-by-errors": off_order_stss,
            "value-reorders": off_order_vals,
            "value-reorders-per-process": per_process,
            "value-reorders-per-node": per_node,
            "value-reorders-per-table": per_table,
        }


def monotonic_checker(**kw) -> MonotonicChecker:
    return MonotonicChecker(**kw)


# ---------------------------------------------------------------------------
# Sequential consistency
# ---------------------------------------------------------------------------


def subkeys(key_count: int, k) -> List[str]:
    """The subkeys written for key k, in client order."""
    return [f"{k}_{i}" for i in range(key_count)]


def trailing_nil(coll: Sequence) -> bool:
    """A nil after a non-nil element: the reader saw a later write
    without an earlier one."""
    it = itertools.dropwhile(lambda x: x is None, coll)
    return any(x is None for x in it)


class SequentialChecker(Checker):
    """Reads return subkey lists in reverse write order; a trailing nil
    means that a later write was visible without an earlier one."""

    def check(self, test, history, opts=None):
        key_count = test.get("key-count")
        assert isinstance(key_count, int), "test needs int key-count"
        reads = [op.value for op in history
                 if op.is_ok and op.f == "read" and op.value is not None]
        none = [v for v in reads if all(x is None for x in v[1])]
        some = [v for v in reads if any(x is None for x in v[1])]
        bad = [v for v in reads if trailing_nil(v[1])]
        all_ = [v for v in reads
                if list(v[1]) == list(reversed(subkeys(key_count, v[0])))]
        return {"valid": not bad,
                "all-count": len(all_), "some-count": len(some),
                "none-count": len(none), "bad-count": len(bad),
                "bad": bad}


def sequential_writes(last_written: list, lock: threading.Lock):
    """Sequential integer keys; the most recent 2n live in
    ``last_written``."""
    counter = itertools.count()

    def op(test, process):
        k = next(counter)
        with lock:
            last_written.pop(0)
            last_written.append(k)
        return {"type": "invoke", "f": "write", "value": k}
    return op


def sequential_reads(last_written: list, lock: threading.Lock):
    """Read a key chosen at random among those written recently."""
    def op(test, process):
        with lock:
            k = random.choice(last_written)
        return {"type": "invoke", "f": "read", "value": k}
    return gen.gen(op).filter(lambda o: o.value is not None)


def sequential_gen(n: int):
    """n writer threads reserved; every other thread reads."""
    last_written: List[Optional[int]] = [None] * (2 * n)
    lock = threading.Lock()
    return gen.reserve(n, sequential_writes(last_written, lock),
                       sequential_reads(last_written, lock))


# ---------------------------------------------------------------------------
# Adya G2
# ---------------------------------------------------------------------------


def g2_gen():
    """Two inserts a key: one transaction holds an a-id, the other a b-id;
    two threads a key, through the concurrent generator."""
    ids = itertools.count(1)
    lock = threading.Lock()

    def fgen(k):
        def a(test, process):
            with lock:
                i = next(ids)
            return {"type": "invoke", "f": "insert", "value": (None, i)}

        def b(test, process):
            with lock:
                i = next(ids)
            return {"type": "invoke", "f": "insert", "value": (i, None)}
        return gen.seq([gen.once(a), gen.once(b)])

    return independent.concurrent_generator(2, itertools.count(), fgen)


class G2Checker(Checker):
    """At most one insert may succeed per key."""

    def check(self, test, history, opts=None):
        keys: Dict[Any, int] = {}
        for op in history:
            if op.f != "insert" or not independent.is_tuple(op.value):
                continue
            k = op.value.key
            if op.is_ok:
                keys[k] = keys.get(k, 0) + 1
            else:
                keys.setdefault(k, 0)
        illegal = {k: c for k, c in sorted(keys.items(), key=lambda kv:
                                           repr(kv[0])) if c > 1}
        inserted = sum(1 for c in keys.values() if c > 0)
        return {"valid": not illegal,
                "key-count": len(keys),
                "legal-count": inserted - len(illegal),
                "illegal-count": len(illegal),
                "illegal": illegal}


def g2_checker() -> G2Checker:
    return G2Checker()
