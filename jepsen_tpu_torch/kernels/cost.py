"""The work one search level does, as a function of its shape alone.

Counterpart of the reference's per-executable cost model
(``tpu._cost_analysis`` and ``_shape_cost``, ``jepsen_tpu/checker/
tpu.py:871-911``), which asks XLA for the flops and bytes of a compiled
while body. The port has no compiler to ask, so it counts the level's
work itself, stage by stage: the bytes each stage must move (each of its
inputs read once, each of its outputs written once) and the integer
operations it does on them.

The stages are the level's steps, not its kernels, so a redesign of a
kernel, or a step folded into another kernel's launch, leaves the model
as it is:

* ``expand``: the E expanded rows' successors and the remainder into the
  R merge rows (K1);
* ``sort``: the R rows sorted (K2);
* ``group_starts``: each row's group start, a scan over the comparator
  words (K3 on the wide rungs, inside K4 on the narrow ones; none at
  CR = 0, where no row can dominate another);
* ``dedup``: duplicates and dominated rows killed, the first C kept, the
  level's scalars and counter row written (K4).

Every term reads :class:`~jepsen_tpu_torch.kernels.search.LevelShape`
only, except the column entries the expanded rows' windows touch:
``touched`` (over the batch) is the live state's count where the caller
has it (``chip_smoke.py``'s bounds), else each key's E rows are taken to
span one window, ``min(n, E + W - 1)`` entries. The ``cost`` entries of
the results (:func:`cost_entry`) use the shape alone.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

#: the stages of a level, in order
STAGES = ("expand", "sort", "group_starts", "dedup")

#: levels one iteration of the segment graph's WHILE node runs
UNROLL = 2


def touched_entries(shape) -> int:
    """The column entries the expanded rows' windows touch, over the
    batch, from the shape alone: one window of each key's E rows."""
    return shape.B * min(shape.n, shape.E + shape.W - 1)


def level_cost(shape, touched: Optional[int] = None
               ) -> Dict[str, Tuple[int, int]]:
    """``{stage: (bytes, ops)}`` of one level at ``shape`` over all its
    keys; ``touched`` the column entries read (default
    :func:`touched_entries`)."""
    B, C, E, W, R, NK, MW, MCX, CR = (shape.B, shape.C, shape.E, shape.W,
                                      shape.R, shape.NK, shape.MW,
                                      shape.MCX, shape.CR)
    if touched is None:
        touched = touched_entries(shape)
    pool_b = C * (4 * (2 + MW + MCX) + 1)
    # five words a touched entry (f, v1, v2, ro, inv), the crashed
    # columns, and ret and sm per expanded row
    cols_b = touched * 4 * 5 + B * (CR * 4 * 5 + E * 4 * 2)
    hash_ops = R * (3 * MW + 8) if shape.tiebreak == "hash" else 0
    starts = (B * (R * (3 + MW) * 4 + R * 4), B * R * (3 + MW)) if CR \
        else (0, 0)
    return {
        "expand": (B * (pool_b + shape.RP * NK * 4) + cols_b,
                   B * E * (W + CR) * 24),
        "sort": (B * 2 * R * NK * 4,
                 B * (R * max(1, int(np.log2(R))) * NK + hash_ops)),
        "group_starts": starts,
        "dedup": (B * (R * NK * 4 + (R * 4 if CR else 0) + pool_b
                       + C * (4 * (4 + MW + MCX) + 2)),
                  B * R * (NK + (8 * (3 + MW + MCX) if CR else 0))),
    }


def level_total(shape, touched: Optional[int] = None) -> Tuple[int, int]:
    """(bytes, ops) of one level: the sum of its stages."""
    terms = level_cost(shape, touched).values()
    return sum(b for b, _ in terms), sum(o for _, o in terms)


def per_level(shape) -> Dict[str, float]:
    """The reference's cost-model keys for one level at ``shape``:
    ``{"flops", "bytes-accessed"}``, ``flops`` holding the integer
    operations."""
    nbytes, ops = level_total(shape)
    return {"flops": float(ops), "bytes-accessed": float(nbytes)}


def cost_entry(kind: str, rung, shape, levels: int, **extra) -> Dict:
    """One entry of a result's ``cost`` list, in the reference's keys:
    ``kind``, ``rung`` (the effective rung, its expansion None for a
    breadth-first search), ``unroll``, ``levels`` (run at this shape),
    ``flops`` and ``bytes-accessed`` (one level's)."""
    return dict(kind=kind, rung=list(rung),
                unroll=UNROLL, **extra, levels=int(levels),
                **per_level(shape))
