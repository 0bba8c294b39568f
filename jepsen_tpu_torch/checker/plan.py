"""Admission pricing for the serve daemon: a request's device footprint.

Counterpart of the parts of ``jepsen_tpu/checker/plan.py`` that the serve
daemon's admission control uses: ``PlanDims``, ``request_footprint``,
``gang_footprint`` and ``plan_bytes_limit``. The reference prices a model
of the XLA buffers of its search; this module prices the port's own
buffers, exactly: the carry and scratch of the first rung the search
would run (:func:`jepsen_tpu_torch.checker.gpu.state_bytes`) plus the
device columns. The full plan gate (every rung, the pool seeding) is not
ported.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch

from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.ops.encode import PackedHistory


@dataclass(frozen=True)
class PlanDims:
    """The dimensions of a history that the search's shape derives from."""

    n_required: int
    n_crashed: int = 0
    window_needed: int = 1

    @classmethod
    def from_packed(cls, p: PackedHistory) -> "PlanDims":
        nr = p.n_required
        return cls(n_required=nr, n_crashed=p.n - nr,
                   window_needed=max(G._window_needed(p) if nr else 0, 1))

    @classmethod
    def from_history(cls, history, model) -> Optional["PlanDims"]:
        """Pack and measure; None when the model has no word kernel."""
        from jepsen_tpu_torch.ops.encode import pack_with_init
        pk = pack_with_init(history, model)
        return None if pk is None else cls.from_packed(pk[0])


def cols_nbytes(breq: int, crw: int) -> int:
    """Device bytes of one history's columns: seven int32 [breq] columns,
    the suffix minimum [breq + 1], six int32 [crw] crashed columns (the
    crash bounds ``cb`` among them) and ``nr``."""
    return 4 * (7 * breq + (breq + 1) + 6 * crw + 1)


def request_footprint(dims: PlanDims, device=None) -> Optional[int]:
    """Device bytes a single search of these dims allocates on its first
    rung on ``device`` (None: CUDA): the carry and scratch
    (:func:`jepsen_tpu_torch.checker.gpu.state_bytes`) and the columns.
    None when the history never reaches the device (crashed-set
    overflow)."""
    crw = G._crash_width(dims.n_crashed)
    if crw is None:
        return None
    breq = G._bucket(max(dims.n_required, 1))
    dev = torch.device("cuda" if device is None else device)
    cap, win, exp = G._ladder_for(max(dims.window_needed, 1), dev)[0]
    shape = K.LevelShape(C=cap, W=win, E=min(exp or cap, cap), n=breq,
                         CR=crw)
    return G.state_bytes(shape) + cols_nbytes(breq, crw)


def gang_footprint(dims: PlanDims, size: int,
                   device=None) -> Optional[int]:
    """Device bytes of a gang of ``size`` members of these dims: a gang
    stacks every column and every carry and scratch row on its leading
    axis, so its bytes are linear in its members."""
    if size < 1:
        return None
    fp = request_footprint(dims, device)
    return None if fp is None else fp * int(size)


def plan_bytes_limit(device=None) -> Optional[int]:
    """The admission byte budget: ``JTPU_PLAN_BYTES_LIMIT`` when set, else
    the total memory of ``device`` (None: CUDA) as
    ``torch.cuda.mem_get_info`` reports it, else None (the CPU, or no
    CUDA device), which leaves the footprint check off."""
    v = os.environ.get("JTPU_PLAN_BYTES_LIMIT")
    if v:
        try:
            return int(v)
        except ValueError:
            pass
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.mem_get_info(dev)[1])
