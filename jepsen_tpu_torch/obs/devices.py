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
reference's is on its CPU backend.

:func:`poll` publishes the reference's per-device gauges
(``jtpu_device_bytes_in_use``, ``_bytes_limit``, ``_peak_bytes_in_use``)
and :func:`headroom_ratio` its ``jtpu_device_headroom_ratio``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import torch

from jepsen_tpu_torch.obs import metrics as obs_metrics

_BYTES_IN_USE = obs_metrics.gauge(
    "jtpu_device_bytes_in_use",
    "allocator bytes currently in use, per device (backends exposing "
    "memory_stats only)")
_BYTES_LIMIT = obs_metrics.gauge(
    "jtpu_device_bytes_limit",
    "allocator byte limit, per device")
_BYTES_PEAK = obs_metrics.gauge(
    "jtpu_device_peak_bytes_in_use",
    "allocator peak bytes in use, per device")
_HEADROOM = obs_metrics.gauge(
    "jtpu_device_headroom_ratio",
    "min over devices of (limit - in_use)/limit; absent when no "
    "backend device exposes memory stats")

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


def memory_stats(device) -> Optional[Dict[str, Any]]:
    """The allocator's report for one device (``torch.cuda.memory_stats``)
    with the card's ``free`` and ``total`` bytes (``mem_get_info``)
    added; None on the CPU, without CUDA, or on a device this process
    has not initialised."""
    idx = _devices(device if device is not None else "cuda")
    if not idx:
        return None
    ms = dict(torch.cuda.memory_stats(idx[0]))
    ms["free"], ms["total"] = (int(x) for x in torch.cuda.mem_get_info(idx[0]))
    return ms


def poll(device=None) -> List[Dict[str, Any]]:
    """One row per polled device (``device``, or every device this
    process uses): ``{"device", "bytes-in-use", "bytes-limit",
    "peak-bytes-in-use", "headroom"}``, each published to its gauge.
    Empty on the CPU."""
    rows: List[Dict[str, Any]] = []
    for d in _devices(device):
        ms = memory_stats(f"cuda:{d}")
        total = ms["total"]
        in_use = total - ms["free"]
        peak = ms.get("reserved_bytes.all.peak")
        label = f"cuda:{d}"
        _BYTES_IN_USE.set(float(in_use), device=label)
        _BYTES_LIMIT.set(float(total), device=label)
        if peak is not None:
            _BYTES_PEAK.set(float(peak), device=label)
        rows.append({"device": label, "bytes-in-use": in_use,
                     "bytes-limit": total, "peak-bytes-in-use": peak,
                     "headroom": max(0.0, (total - in_use) / total)})
    return rows


def headroom_ratio(rows: Optional[List[Dict[str, Any]]] = None,
                   device=None) -> Optional[float]:
    """Min over devices of (limit - in_use) / limit, from ``rows`` or, by
    default, from the free memory of ``device`` (every device this process
    uses when None) alone: ``torch.cuda.memory_stats``, which builds the
    allocator's whole report, is left out of the supervisor's poll at
    each segment barrier. Publishes ``jtpu_device_headroom_ratio``; None
    when no device reports (the pre-emptive halving is then inert)."""
    if rows is None:
        heads = []
        for d in _devices(device):
            free, total = torch.cuda.mem_get_info(d)
            heads.append(free / total)
    else:
        heads = [r["headroom"] for r in rows
                 if r.get("headroom") is not None]
    if not heads:
        return None
    h = min(heads)
    _HEADROOM.set(h)
    return h


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
