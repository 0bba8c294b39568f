"""Host utilities. Counterpart of the parts of ``jepsen_tpu.util`` the
port needs."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable


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
