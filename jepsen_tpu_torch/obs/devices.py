"""Device memory headroom at segment barriers.

Counterpart of ``poll``, ``headroom_ratio`` and ``headroom_threshold`` in
``jepsen_tpu/obs/devices.py``. The supervised search reads the headroom
ratio, min over devices of ``(limit - in_use) / limit``, at each segment
barrier and halves its pool before the allocator fails when the ratio
drops below ``JTPU_HEADROOM_MIN`` (:mod:`jepsen_tpu_torch.resilience`).

On a CUDA device the limit is the card's total memory and the bytes in
use are what the card reports taken (``torch.cuda.mem_get_info``: the
total less the free bytes, whoever holds them, the pages PyTorch's
allocator keeps cached included); the peak is the most the allocator
has reserved (``torch.cuda.memory_stats``). Only devices this process
uses are polled, so a poll creates no CUDA context. Without CUDA every
function answers ``[]`` or None, and the pre-shrink is inert, as the
reference's is on its CPU backend. The gauges are not ported.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import torch

#: Default pre-emptive pool-halving threshold (see headroom_threshold).
DEFAULT_HEADROOM_MIN = 0.05


def _devices(device=None) -> List[int]:
    """The CUDA devices to poll: ``device`` alone when it is one (none
    when it is the CPU), else those this process holds memory on and the
    current one; [] without CUDA."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    if device is not None:
        dev = torch.device(device)
        if dev.type != "cuda":
            return []
        return [torch.cuda.current_device() if dev.index is None
                else dev.index]
    devs = {torch.cuda.current_device()}
    devs.update(d for d in range(torch.cuda.device_count())
                if torch.cuda.memory_reserved(d) > 0)
    return sorted(devs)


def poll(device=None) -> List[Dict[str, Any]]:
    """One row per polled device (``device``, or every device this
    process uses): ``{"device", "bytes-in-use", "bytes-limit",
    "peak-bytes-in-use", "headroom"}``. Empty on the CPU."""
    rows: List[Dict[str, Any]] = []
    for d in _devices(device):
        free, total = torch.cuda.mem_get_info(d)
        in_use = int(total) - int(free)
        peak = torch.cuda.memory_stats(d).get("reserved_bytes.all.peak")
        rows.append({"device": f"cuda:{d}", "bytes-in-use": in_use,
                     "bytes-limit": int(total), "peak-bytes-in-use": peak,
                     "headroom": max(0.0, (total - in_use) / total)})
    return rows


def headroom_ratio(rows: Optional[List[Dict[str, Any]]] = None,
                   device=None) -> Optional[float]:
    """Min over devices of (limit - in_use) / limit, from ``rows`` or, by
    default, from the free memory of ``device`` (every device this process
    uses when None) alone: ``torch.cuda.memory_stats``, which builds the
    allocator's whole report, is left out of the supervisor's poll at
    each segment barrier. None when no device reports (the pre-emptive
    halving is then inert)."""
    if rows is None:
        heads = []
        for d in _devices(device):
            free, total = torch.cuda.mem_get_info(d)
            heads.append(free / total)
    else:
        heads = [r["headroom"] for r in rows
                 if r.get("headroom") is not None]
    return min(heads) if heads else None


def headroom_threshold() -> float:
    """The pre-emptive pool-halving threshold (JTPU_HEADROOM_MIN, default
    0.05). <= 0 disables pre-emptive halving."""
    v = os.environ.get("JTPU_HEADROOM_MIN")
    if not v:
        return DEFAULT_HEADROOM_MIN
    try:
        return float(v)
    except ValueError:
        return DEFAULT_HEADROOM_MIN
