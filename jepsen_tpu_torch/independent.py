"""Independent keys: one history over many registers, checked per key.

Counterpart of ``jepsen_tpu.independent`` (itself a rebuild of
jepsen.independent). Linearizability checking is exponential
in history length, so a test runs a *map* of keys to registers: op values
are ``[k v]`` tuples (:class:`KV`), and the checker splits the history
per key and checks each subhistory on its own. When the inner checker is
the port's :class:`~jepsen_tpu_torch.checker.wgl.LinearizableChecker`
with ``backend="gpu"`` and its model has an integer kernel, every key is
searched in one batch on the device
(:func:`~jepsen_tpu_torch.checker.gpu.check_keyed_gpu`); keys the batch
cannot settle are checked again one by one through the inner checker.

The generators wrap each op's value in its key:
:class:`SequentialGenerator` runs one key at a time,
:class:`ConcurrentGenerator` n threads a key with several keys in
flight.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.checker import UNKNOWN, Checker, check_safe, merge_valid
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.util import real_pmap

#: Subdirectory of the store dir for per-key results.
DIR = "independent"


class KV:
    """A key/value tuple in an op's value. A type of its own, not a Python
    tuple, so that op values that are tuples (cas pairs) are never taken
    for keyed values."""

    __slots__ = ("key", "value")

    def __init__(self, key, value):
        self.key = key
        self.value = value

    def __iter__(self):
        return iter((self.key, self.value))

    def __eq__(self, other):
        return (isinstance(other, KV) and self.key == other.key
                and self.value == other.value)

    def __hash__(self):
        return hash((KV, self.key, self.value))

    def __repr__(self):
        return f"[{self.key!r} {self.value!r}]"


def tuple_(k, v) -> KV:
    return KV(k, v)


def is_tuple(v) -> bool:
    return isinstance(v, KV)


class SequentialGenerator(gen.Generator):
    """One key at a time: ops of ``fgen(k1)`` until it is exhausted, then
    of ``fgen(k2)``, each value wrapped as ``[k v]``."""

    def __init__(self, keys: Iterable, fgen: Callable[[Any], Any]):
        self.fgen = fgen
        self._lock = threading.Lock()
        self._keys = iter(keys)
        self._gen: Optional[gen.Generator] = None
        self._done = False
        self._advance()

    def _advance(self) -> bool:
        try:
            k = next(self._keys)
        except StopIteration:
            self._gen = None
            self._done = True
            return False
        self._key = k
        self._gen = gen.gen(self.fgen(k))
        return True

    def op(self, test, process):
        while True:
            with self._lock:
                if self._done:
                    return None
                g, k = self._gen, self._key
            o = g.op(test, process)
            if o is not None:
                return o.replace(value=KV(k, o.value))
            with self._lock:
                if self._gen is g:  # else another thread advanced it
                    if not self._advance():
                        return None


class ConcurrentGenerator(gen.Generator):
    """n threads a key, ``thread_count // n`` keys in flight at once. The
    worker threads are split into contiguous groups of n; each group runs
    one key's generator with the thread scope bound to the group (so that
    barrier-style combinators synchronise within a key, not across keys).
    A group whose generator is exhausted takes the next key; out of keys,
    its workers retire. The nemesis never draws from it."""

    def __init__(self, n: int, keys: Iterable, fgen: Callable[[Any], Any]):
        assert n > 0 and int(n) == n
        self.n = int(n)
        self.fgen = fgen
        self._keys = iter(keys)
        self._lock = threading.Lock()
        self._state: Optional[dict] = None

    def _init_state(self, test):
        threads = sorted(t for t in (gen.current_threads()
                                     or gen.all_threads(test))
                         if isinstance(t, int))
        thread_count = len(threads)
        assert threads == list(range(thread_count)), (
            f"expected integer threads 0..{thread_count - 1}, got {threads}")
        assert test.get("concurrency") == thread_count, (
            f"expected test concurrency ({test.get('concurrency')}) to equal "
            f"the number of integer threads ({thread_count})")
        group_size = self.n
        group_count = thread_count // group_size
        assert group_size <= thread_count, (
            f"with {thread_count} worker threads, this concurrent-generator "
            f"cannot run a key with {group_size} threads; raise concurrency "
            f"to at least {group_size}")
        assert thread_count == group_size * group_count, (
            f"{thread_count} threads cannot be split into groups of "
            f"{group_size}; make concurrency a multiple of {group_size}")
        active = []
        for _ in range(group_count):
            try:
                k = next(self._keys)
                active.append((k, gen.gen(self.fgen(k))))
            except StopIteration:
                active.append(None)
        self._state = {
            "active": active,
            "group_threads": [frozenset(threads[g * group_size:
                                                (g + 1) * group_size])
                              for g in range(group_count)],
            "group_size": group_size,
        }

    def op(self, test, process):
        with self._lock:
            if self._state is None:
                self._init_state(test)
            s = self._state
        thread = gen.process_to_thread(process, test)
        assert isinstance(thread, int), (
            f"only worker threads with numeric ids can draw from a "
            f"concurrent-generator; got a request from {thread!r}")
        group = thread // s["group_size"]
        while True:
            with self._lock:
                pair = s["active"][group]
            if pair is None:
                return None  # out of keys: this group's workers retire
            k, g = pair
            with gen.threads_bound(s["group_threads"][group]):
                o = g.op(test, process)
            if o is not None:
                return o.replace(value=KV(k, o.value))
            with self._lock:
                if s["active"][group] is pair:  # one thread advances
                    try:
                        nk = next(self._keys)
                        s["active"][group] = (nk, gen.gen(self.fgen(nk)))
                    except StopIteration:
                        s["active"][group] = None


def sequential_generator(keys, fgen) -> SequentialGenerator:
    return SequentialGenerator(keys, fgen)


def concurrent_generator(n, keys, fgen) -> ConcurrentGenerator:
    return ConcurrentGenerator(n, keys, fgen)


def _with_value(o: Op, value) -> Op:
    """``o`` with another value (``Op.replace`` without its per-call
    field introspection, for histories of a million ops)."""
    return Op(o.type, o.f, value, o.process, o.time, o.index, o.error,
              o.extra)


def history_keys(history: Sequence[Op]) -> set:
    """The keys of the ``[k v]`` op values in a history."""
    return {o.value.key for o in history if is_tuple(o.value)}


def subhistory(k, history: Sequence[Op]) -> History:
    """The ops of key ``k`` with their values unwrapped, and every op
    without a key (nemesis, logging), which lands in every subhistory."""
    out = History()
    for o in history:
        v = o.value
        if not is_tuple(v):
            out.append(o)
        elif v.key == k:
            out.append(_with_value(o, v.value))
    return out


def subhistories(history: Sequence[Op]) -> Dict[Any, History]:
    """Every key's :func:`subhistory`, in one pass over the history, by
    key in ``repr`` order."""
    ks = sorted(history_keys(history), key=repr)
    out = {k: History() for k in ks}
    for o in history:
        v = o.value
        if not is_tuple(v):
            for h in out.values():
                h.append(o)
        else:
            out[v.key].append(_with_value(o, v.value))
    return out


class IndependentChecker(Checker):
    """Lift a checker over plain values to one over ``[k v]`` histories:
    valid iff the inner checker holds for every key's subhistory; per-key
    results under ``results``, the invalid keys under ``failures``."""

    def __init__(self, inner: Checker):
        self.inner = inner

    def _try_gpu_batch(self, test, keyed: Dict[Any, History]):
        """The keyed batch on the device, or None when the inner checker
        is not the port's device linearizability checker over a model
        with an integer kernel. A device fault raises."""
        from jepsen_tpu_torch.checker.gpu import check_keyed_gpu
        from jepsen_tpu_torch.checker.wgl import LinearizableChecker
        from jepsen_tpu_torch.models.core import kernel_spec_for
        inner = self.inner
        if not isinstance(inner, LinearizableChecker):
            return None
        if inner.backend != "gpu":
            return None
        model = inner.model or test.get("model")
        if model is None or kernel_spec_for(model) is None:
            return None
        return check_keyed_gpu(keyed, model, device=inner.device)

    def check(self, test, history, opts=None):
        opts = opts or {}
        keyed = subhistories(history)
        ks = list(keyed)

        results: Dict[Any, dict] = {}
        batch = self._try_gpu_batch(test, keyed)
        if batch is not None:
            for k, r in batch["results"].items():
                if r.get("valid") is UNKNOWN:
                    # the inner checker settles what the batch could not
                    r = check_safe(self.inner, test, keyed[k],
                                   {**opts, "history-key": k})
                results[k] = r
        else:
            def check_one(k):
                return check_safe(self.inner, test, keyed[k],
                                  {**opts, "history-key": k})
            for k, r in zip(ks, real_pmap(check_one, ks)):
                results[k] = r

        self._write_artifacts(test, keyed, results, opts)
        # an unknown key is not a failure: only refuted keys are
        failures = [k for k, r in results.items()
                    if r.get("valid") is False]
        return {
            "valid": merge_valid(r.get("valid", UNKNOWN)
                                 for r in results.values()),
            "results": results,
            "failures": failures,
        }

    def _write_artifacts(self, test, keyed, results, opts: Optional[dict]):
        """Per key, ``results.json`` and ``history.jsonl`` under
        ``<store-dir>/[<subdirectory>/]independent/<k>/``."""
        store_dir = test.get("store-dir")
        if not store_dir or not isinstance(store_dir, str):
            return
        sub = opts.get("subdirectory", []) if opts else []
        for k, r in results.items():
            d = os.path.join(store_dir, *map(str, sub), DIR, str(k))
            try:
                os.makedirs(d, exist_ok=True)
                with open(os.path.join(d, "results.json"), "w") as f:
                    json.dump(r, f, indent=2, default=repr)
                with open(os.path.join(d, "history.jsonl"), "w") as f:
                    for o in keyed[k]:
                        f.write(json.dumps(o.to_dict(), default=repr) + "\n")
            except OSError:
                pass


def checker(inner: Checker) -> IndependentChecker:
    return IndependentChecker(inner)
