"""Per-tenant usage metering: the billing-grade view of serving.

A copy of the reference's ``jepsen_tpu/obs/usage.py``: the same fields,
the same rounding, the same totals document.

Every finished request already carries a phase breakdown (queue /
coalesce / compile / device / verdict seconds) and lands a ``done``
record in the serve WAL. This module folds those into per-tenant
running totals — device-seconds, ops checked, transfer bytes,
gang-lane share, wall seconds, request count — with one invariant:
**the meter records exactly the usage document written into the WAL
``done`` record**, so :func:`from_wal` over the journal reproduces the
live totals to the digit, and a SIGKILL'd daemon's restart replays the
meter back to consistency from the same records the dedup/replay path
already reads. Exposed as ``GET /usage?tenant=`` and ``python -m
jepsen_tpu_torch usage``.

No thread of its own and no persistence of its own: the WAL *is* the
ledger; this is its always-warm materialized view.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

#: The additive usage fields (everything except the request count).
FIELDS = ("ops", "device-s", "bytes", "lane-share", "seconds")


def _zero() -> Dict[str, float]:
    doc = {f: 0.0 for f in FIELDS}
    doc["requests"] = 0
    return doc


class UsageMeter:
    """Per-tenant additive totals. One lock; `record` is called once
    per finished request (off the per-op hot path)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: Dict[str, Dict[str, float]] = {}

    def record(self, tenant: str, usage: Dict[str, Any]) -> None:
        """Fold one request's usage doc (the exact dict written to the
        WAL ``done`` record) into the tenant's totals."""
        tenant = str(tenant or "anon")
        with self._lock:
            t = self._tenants.setdefault(tenant, _zero())
            t["requests"] += 1
            for f in FIELDS:
                v = usage.get(f)
                if isinstance(v, (int, float)):
                    t[f] += float(v)

    def totals(self, tenant: Optional[str] = None) -> Dict[str, Any]:
        """``{tenant: {field: total}}`` (one tenant, or all), plus a
        cross-tenant ``total`` rollup. Floats are rounded to 9 places —
        the same quantum the per-request docs carry, so replayed sums
        match byte-for-byte."""
        with self._lock:
            tenants = {t: dict(doc) for t, doc in self._tenants.items()
                       if tenant is None or t == tenant}
        rollup = _zero()
        for doc in tenants.values():
            rollup["requests"] += doc["requests"]
            for f in FIELDS:
                rollup[f] += doc[f]
        for doc in list(tenants.values()) + [rollup]:
            for f in FIELDS:
                doc[f] = round(doc[f], 9)
            doc["requests"] = int(doc["requests"])
        return {"tenants": tenants, "total": rollup}

    def top(self) -> Optional[Tuple[str, float]]:
        """``(tenant, device-seconds)`` for the biggest consumer —
        the watch line's ``usage`` bit."""
        best = None
        with self._lock:
            for t, doc in self._tenants.items():
                if best is None or doc["device-s"] > best[1]:
                    best = (t, doc["device-s"])
        if best is None:
            return None
        return best[0], round(best[1], 9)


def replay(meter: UsageMeter, records: List[dict]) -> int:
    """Fold every WAL ``done`` record carrying a usage doc into the
    meter (restart replay). Returns the count folded."""
    n = 0
    for rec in records:
        if rec.get("event") != "done":
            continue
        usage = rec.get("usage")
        if isinstance(usage, dict):
            meter.record(rec.get("tenant", "anon"), usage)
            n += 1
    return n


def from_wal(path: str) -> Dict[str, Any]:
    """Tenant totals recomputed straight from a serve WAL — the
    reconciliation oracle (`totals()` must equal this exactly)."""
    from jepsen_tpu_torch import journal
    records, _stats = journal.read_json_records(path)
    meter = UsageMeter()
    replay(meter, records)
    return meter.totals()
