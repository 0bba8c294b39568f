"""Fold checkers: set, counter, queue, total-queue, unique-ids.

The port's copy of ``jepsen_tpu.checker.basic`` (itself a rebuild of the
linear-scan checkers of jepsen.checker). Each is one pass over the
history on the host; the search-based linearizability checker is the
device's work. Result keys and renderings are the reference's.
"""

from __future__ import annotations

from collections import Counter as Multiset
from typing import Any, Dict

from jepsen_tpu_torch.checker import Checker
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models.core import Model, is_inconsistent
from jepsen_tpu_torch.util import integer_interval_set_str


def _hashable(v):
    try:
        hash(v)
        return v
    except TypeError:
        return repr(v)


class SetChecker(Checker):
    """A set of unique elements: ``add``s, then a final ``read``.

    - lost: elements definitely added (ok) that the final read misses:
      always illegal.
    - unexpected: elements present that were never attempted: illegal.
    - recovered: elements whose add was indeterminate but which showed
      up: fine, informative.
    """

    def check(self, test, history: History, opts=None) -> Dict[str, Any]:
        attempts = set()
        adds = set()
        final_read = None
        for o in history:
            if o.f == "add" and o.is_invoke:
                attempts.add(_hashable(o.value))
            elif o.f == "add" and o.is_ok:
                adds.add(_hashable(o.value))
            elif o.f == "read" and o.is_ok:
                final_read = set(map(_hashable, o.value))
        if final_read is None:
            return {"valid": "unknown",
                    "error": "Set was never read"}
        lost = adds - final_read
        unexpected = final_read - attempts
        recovered = (final_read & attempts) - adds
        return {
            "valid": not lost and not unexpected,
            "lost": _render(lost),
            "recovered": _render(recovered),
            "ok": _render(final_read & adds),
            "unexpected": _render(unexpected),
            "attempt-count": len(attempts),
            "ok-count": len(final_read & adds),
            "lost-count": len(lost),
            "unexpected-count": len(unexpected),
            "recovered-count": len(recovered),
        }


def _render(s):
    """An element set, compactly: interval notation for ints, else sorted
    by ``repr``."""
    if s and all(isinstance(x, int) and not isinstance(x, bool) for x in s):
        return integer_interval_set_str(s)
    return sorted(s, key=repr)


def expand_queue_drain_ops(history: History) -> History:
    """Expand ok ``drain`` ops whose value is a collection of dequeued
    elements into one synthetic dequeue pair per element, so that the
    queue accounting below counts each element. Non-ok drains observe
    nothing and are dropped."""
    out = History()
    for o in history:
        if o.f != "drain":
            out.append(o)
            continue
        if o.is_ok and isinstance(o.value, (list, tuple, set)):
            for v in o.value:
                out.append(o.replace(type="invoke", f="dequeue", value=v))
                out.append(o.replace(type="ok", f="dequeue", value=v))
    return out


class QueueChecker(Checker):
    """Every dequeue must come from somewhere: every attempted enqueue
    (invoke) may have succeeded, and every ok dequeue must be explained
    by the model (typically an ``UnorderedQueue``), stepped on the
    host."""

    def __init__(self, model: Model):
        self.model = model

    def check(self, test, history: History, opts=None) -> Dict[str, Any]:
        m = self.model
        history = expand_queue_drain_ops(history)
        for o in history:
            step_op = None
            if o.f == "enqueue" and o.is_invoke:
                step_op = o
            elif o.f == "dequeue" and o.is_ok:
                step_op = o
            if step_op is not None:
                m2 = m.step(step_op)
                if is_inconsistent(m2):
                    return {"valid": False,
                            "error": m2.msg,
                            "final-queue": repr(m)}
                m = m2
        return {"valid": True, "final-queue": repr(m)}


class TotalQueue(Checker):
    """What goes in must come out: multiset matching of enqueues and
    dequeues.

    - lost: ok-enqueued but never dequeued: always illegal.
    - unexpected: dequeued but never attempted: illegal.
    - duplicated: dequeued more times than attempted: illegal.
    - recovered: an indeterminate enqueue that was dequeued: fine.
    """

    def check(self, test, history: History, opts=None) -> Dict[str, Any]:
        history = expand_queue_drain_ops(history)
        attempts: Multiset = Multiset()
        enqueues: Multiset = Multiset()
        dequeues: Multiset = Multiset()
        for o in history:
            if o.f == "enqueue" and o.is_invoke:
                attempts[_hashable(o.value)] += 1
            elif o.f == "enqueue" and o.is_ok:
                enqueues[_hashable(o.value)] += 1
            elif o.f == "dequeue" and o.is_ok:
                dequeues[_hashable(o.value)] += 1
        lost = enqueues - dequeues
        unexpected = Multiset({k: v for k, v in dequeues.items()
                               if k not in attempts})
        duplicated = Multiset({k: v for k, v in
                               (dequeues - attempts).items()
                               if k in attempts})
        recovered = dequeues & (attempts - enqueues)
        return {
            "valid": not lost and not unexpected and not duplicated,
            "lost": _render(set(lost)),
            "unexpected": _render(set(unexpected)),
            "duplicated": _render(set(duplicated)),
            "recovered": _render(set(recovered)),
            "attempt-count": sum(attempts.values()),
            "acknowledged-count": sum(enqueues.values()),
            "ok-count": sum((dequeues & enqueues).values()),
            "lost-count": sum(lost.values()),
            "unexpected-count": sum(unexpected.values()),
            "duplicated-count": sum(duplicated.values()),
            "recovered-count": sum(recovered.values()),
        }


class UniqueIds(Checker):
    """Every ok-returned value must be distinct."""

    def check(self, test, history: History, opts=None) -> Dict[str, Any]:
        counts: Multiset = Multiset()
        attempted = 0
        for o in history:
            if o.is_invoke:
                attempted += 1
            elif o.is_ok:
                counts[_hashable(o.value)] += 1
        dups = {k: v for k, v in counts.items() if v > 1}
        return {
            "valid": not dups,
            "attempted-count": attempted,
            "acknowledged-count": sum(counts.values()),
            "duplicated-count": len(dups),
            "duplicated": dups,
            "range": _value_range(counts),
        }


def _value_range(counts):
    """[min, max] of the ids when they are numbers, else by ``repr``."""
    if not counts:
        return None
    try:
        return [min(counts), max(counts)]
    except TypeError:
        return [min(counts, key=repr), max(counts, key=repr)]


class Counter(Checker):
    """A counter of increments and decrements: each read must land inside
    the window of values possible while it was open, given which adds
    are known and which merely possible.

    The fold keeps [lower, upper] bounds:
      invoke add v: the possible side grows (upper += v if v > 0, else
                    lower += v)
      ok add v:     the definite side catches up
      fail add v:   known not applied: the possible growth is undone
    """

    def check(self, test, history: History, opts=None) -> Dict[str, Any]:
        lower = 0
        upper = 0
        open_reads: Dict[Any, list] = {}  # process -> [min_lower, max_upper]
        reads = []
        errors = []
        for o in history:
            if o.f == "add":
                v = o.value or 0
                if o.is_invoke:
                    if v > 0:
                        upper += v
                    else:
                        lower += v
                elif o.is_ok:
                    if v > 0:
                        lower += v
                    else:
                        upper += v
                elif o.is_fail:
                    if v > 0:
                        upper -= v
                    else:
                        lower -= v
                for w in open_reads.values():
                    w[0] = min(w[0], lower)
                    w[1] = max(w[1], upper)
            elif o.f == "read":
                if o.is_invoke:
                    open_reads[o.process] = [lower, upper]
                elif o.is_ok:
                    w = open_reads.pop(o.process, [lower, upper])
                    lo = min(w[0], lower)
                    hi = max(w[1], upper)
                    reads.append((lo, o.value, hi))
                    if not lo <= o.value <= hi:
                        errors.append((lo, o.value, hi))
                else:
                    open_reads.pop(o.process, None)
        return {
            "valid": not errors,
            "reads": reads,
            "errors": errors,
        }


def set_checker() -> SetChecker:
    return SetChecker()


def counter() -> Counter:
    return Counter()


def queue(model: Model) -> QueueChecker:
    return QueueChecker(model)


def total_queue() -> TotalQueue:
    return TotalQueue()


def unique_ids() -> UniqueIds:
    return UniqueIds()
