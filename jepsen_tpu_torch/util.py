"""Host utilities. Counterpart of ``jepsen_tpu.util``: parallel map,
majority and minority math, relative time in nanoseconds, sleeps,
timeouts, retries, interval-set and prefix helpers, lazy atoms and
exponential draws."""

from __future__ import annotations

import threading
import time as _time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Any, Callable, Iterable, Sequence


def majority(n: int) -> int:
    """Smallest integer strictly greater than half of n: the size of a
    majority quorum of n nodes."""
    return n // 2 + 1


def minority(n: int) -> int:
    """Largest number of nodes that is not a majority of n."""
    return (n - 1) // 2


def real_pmap(f: Callable, coll: Iterable) -> list:
    """Parallel map over ``coll`` with one thread per element, results in
    order. The first exception raised propagates to the caller."""
    items = list(coll)
    if not items:
        return []
    if len(items) == 1:
        return [f(items[0])]
    with ThreadPoolExecutor(max_workers=len(items)) as pool:
        return list(pool.map(f, items))


def fcatch(f: Callable) -> Callable:
    """Wrap f so an exception it raises is returned instead."""

    def wrapper(*args, **kwargs):
        try:
            return f(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - by design
            return e

    return wrapper


# ---------------------------------------------------------------------------
# Time. Op times are nanoseconds relative to a per-test origin;
# time.monotonic_ns is the linear clock.
# ---------------------------------------------------------------------------

_GLOBAL_ORIGIN: list = [None]  # origin shared across threads


def linear_time_nanos() -> int:
    """A linear time source in nanoseconds."""
    return _time.monotonic_ns()


@contextmanager
def with_relative_time():
    """Bind a new origin for :func:`relative_time_nanos` within this
    block. The origin is global: worker threads spawned inside the block
    share it."""
    prev = _GLOBAL_ORIGIN[0]
    _GLOBAL_ORIGIN[0] = linear_time_nanos()
    try:
        yield
    finally:
        _GLOBAL_ORIGIN[0] = prev


def relative_time_nanos() -> int:
    """Nanoseconds since the most recent :func:`with_relative_time`
    origin."""
    origin = _GLOBAL_ORIGIN[0]
    if origin is None:
        origin = _GLOBAL_ORIGIN[0] = linear_time_nanos()
    return linear_time_nanos() - origin


def sleep(dt_seconds: float) -> None:
    """Sleep dt seconds; a non-positive dt returns at once."""
    if dt_seconds > 0:
        _time.sleep(dt_seconds)


def sleep_nanos(dt: int) -> None:
    """Sleep dt nanoseconds; a non-positive dt returns at once."""
    if dt > 0:
        _time.sleep(dt / 1e9)


class Timeout(Exception):
    pass


def timeout(ms: float, timeout_val: Any, f: Callable, *args):
    """Run f in a separate thread; if it does not finish within ms
    milliseconds, return timeout_val. The thread is abandoned, not
    killed: f itself must be interruptible for a hard cleanup."""
    result: list = []
    error: list = []

    def run():
        try:
            result.append(f(*args))
        except Exception as e:  # noqa: BLE001
            error.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(ms / 1000.0)
    if t.is_alive():
        return timeout_val
    if error:
        raise error[0]
    return result[0]


def retry(dt_seconds: float, f: Callable, *args, retries: int | None = None):
    """Call f; on an exception sleep dt seconds and call it again.
    ``retries=None`` retries forever."""
    attempt = 0
    while True:
        try:
            return f(*args)
        except Exception:  # noqa: BLE001
            attempt += 1
            if retries is not None and attempt > retries:
                raise
            sleep(dt_seconds)


def name_or_str(x: Any) -> str:
    """``x``'s ``__name__``, else its string."""
    return getattr(x, "__name__", None) or str(x)


def integer_interval_set_str(xs: Iterable[int]) -> str:
    """Render a set of integers as compact intervals: ``#{1..3 5}``."""
    xs = sorted(set(xs))
    parts = []
    i = 0
    while i < len(xs):
        j = i
        while j + 1 < len(xs) and xs[j + 1] == xs[j] + 1:
            j += 1
        if j == i:
            parts.append(str(xs[i]))
        else:
            parts.append(f"{xs[i]}..{xs[j]}")
        i = j + 1
    return "#{" + " ".join(parts) + "}"


def longest_common_prefix(strings: Sequence[Sequence]) -> Sequence:
    """The longest common prefix of a collection of sequences."""
    if not strings:
        return []
    first = strings[0]
    out = 0
    for i in range(min(len(x) for x in strings)):
        if any(x[i] != first[i] for x in strings):
            break
        out = i + 1
    return first[:out]


def drop_common_proper_prefix(strings: Sequence[Sequence]) -> list:
    """Each sequence without the longest common proper prefix: at least
    one element of each stays."""
    p = len(longest_common_prefix(strings))
    if strings and p and p == min(len(x) for x in strings):
        p -= 1
    return [x[p:] for x in strings]


def chunk_vec(n: int, v: Sequence) -> list:
    """Partition v into chunks of size n."""
    return [v[i:i + n] for i in range(0, len(v), n)]


class LazyAtom:
    """A thread-safe mutable reference with deref/swap/reset, whose
    initial value ``init_fn`` computes on first use, at most once."""

    def __init__(self, init_fn: Callable[[], Any]):
        self._init_fn = init_fn
        self._lock = threading.RLock()
        self._set = False
        self._value = None

    def _ensure(self):
        if not self._set:
            with self._lock:
                if not self._set:
                    self._value = self._init_fn()
                    self._set = True

    def deref(self):
        self._ensure()
        return self._value

    def swap(self, f: Callable, *args):
        with self._lock:
            self._ensure()
            self._value = f(self._value, *args)
            return self._value

    def reset(self, v):
        with self._lock:
            self._set = True
            self._value = v
            return v


class Atom(LazyAtom):
    """A thread-safe mutable reference with deref/swap/reset."""

    def __init__(self, value: Any = None):
        super().__init__(lambda: value)


def rand_exp(mean: float, rng=None) -> float:
    """An exponentially distributed draw of the given mean, from ``rng``
    (a ``random.Random``; default: the module's generator)."""
    import math
    import random
    return -mean * math.log(1.0 - (rng or random).random())
