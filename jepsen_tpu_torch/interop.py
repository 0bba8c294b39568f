"""Moving the search's state between numpy and the device.

The reference keeps its columns and its carry as numpy arrays at every
host boundary: the ``_COLS`` dict from ``_split_packed`` and the carry
tuple ``(k, mask, cmask, state, alive, done, lossy, wovf, level, best_k,
pk, ps, pa[, stats])`` with uint32 mask words. Its keyed batch stacks
both along a leading key axis (``np.stack`` of the columns; the vmapped
carry has that axis on every lane, scalars included). These functions
convert both layouts to the port's device tensors, which always carry
the key axis (a single history is a batch of one), and back, so a
checkpoint taken by one package resumes in the other and the tests can
run both searches from the same inputs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from jepsen_tpu_torch.checker.gpu import Carry, crash_bounds
from jepsen_tpu_torch.kernels import search as K

#: the columns that go to the device: the kernel columns and ``nr``
DEVICE_COLS = K.COLS + ("nr",)


def stack_cols(cols: Sequence[dict]) -> dict:
    """The keyed batch's columns: each key's ``_split_packed`` dict stacked
    along a leading key axis, in the reference's lane order."""
    return {c: np.stack([np.asarray(r[c]) for r in cols])
            for c in cols[0]}


def batch_cols_from_numpy(cols: dict, device,
                          out: Optional[dict] = None) -> dict:
    """Device copies (int32) of a batch's stacked columns: the kernel
    columns [B, width] and ``nr`` [B]. Columns from the reference's
    ``_split_packed`` lack ``cb``; it is computed from their ``ret`` and
    ``cinv`` (``checker.gpu.crash_bounds``). With ``out``, copies into its
    tensors."""
    if "cb" not in cols:
        cols = dict(cols, cb=crash_bounds(cols["ret"], cols["cinv"]))
    res = {} if out is None else out
    for c in DEVICE_COLS:
        a = torch.from_numpy(np.ascontiguousarray(cols[c], np.int32))
        if out is None:
            res[c] = a.to(device)
        else:
            res[c].copy_(a)
    return res


def cols_from_numpy(cols: dict, device, out: Optional[dict] = None) -> dict:
    """One history's columns as a batch of one (see
    :func:`batch_cols_from_numpy`)."""
    return batch_cols_from_numpy(
        {c: np.asarray(cols[c])[None] for c in DEVICE_COLS if c in cols},
        device, out)


def _i32(a) -> torch.Tensor:
    """A numpy array (uint32 words allowed) as an int32 tensor."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, np.int32))


def _bool(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, bool))


def batch_carry_from_numpy(carry: tuple, device,
                           out: Optional[Carry] = None) -> Carry:
    """The reference's vmapped carry (a leading key axis on every lane),
    13 lanes, or 14 with the stats lane, as a device :class:`Carry`
    (``stats`` None without it). With ``out``, copies into its tensors;
    ``out`` and ``carry`` have the stats lane both or neither."""
    if len(carry) not in (13, 14):
        raise ValueError(f"expected the 13-lane carry, or 14 with its "
                         f"stats lane, got {len(carry)} lanes")
    (k, mask, cmask, state, alive, done, lossy, wovf, level, best, pk, ps,
     pa) = (np.asarray(x) for x in carry[:13])
    stats = np.asarray(carry[13]) if len(carry) == 14 else None
    scal = np.zeros((k.shape[0], K.NSCAL), np.int32)
    scal[:, K.DONE], scal[:, K.LOSSY], scal[:, K.WOVF] = done, lossy, wovf
    scal[:, K.LEVEL], scal[:, K.BEST] = level, best
    scal[:, K.NALIVE] = np.count_nonzero(alive, axis=1)
    src = Carry(pool=K.Pool(k=_i32(k), mask=_i32(mask), cmask=_i32(cmask),
                            state=_i32(state), alive=_bool(alive)),
                pk=_i32(pk), ps=_i32(ps), pa=_bool(pa),
                scal=torch.from_numpy(scal),
                stats=None if stats is None else _i32(stats))
    if out is None:
        return Carry(pool=K.Pool(*(t.to(device) for t in src.pool.tensors())),
                     pk=src.pk.to(device), ps=src.ps.to(device),
                     pa=src.pa.to(device), scal=src.scal.to(device),
                     stats=None if stats is None else src.stats.to(device))
    if (out.stats is None) != (src.stats is None):
        raise ValueError("the carry and the device buffers disagree on the "
                         "stats lane")
    out.pool.copy_(src.pool)
    for dst, t in ((out.pk, src.pk), (out.ps, src.ps), (out.pa, src.pa),
                   (out.scal, src.scal), (out.stats, src.stats)):
        if t is not None:
            dst.copy_(t)
    return out


def carry_from_numpy(carry: tuple, device,
                     out: Optional[Carry] = None) -> Carry:
    """One history's carry (13 lanes, or 14 with the stats lane) as a
    device :class:`Carry` of one key."""
    return batch_carry_from_numpy(tuple(np.asarray(x)[None] for x in carry),
                                  device, out)


def batch_carry_to_numpy(carry: Carry) -> tuple:
    """A device :class:`Carry` as the reference's vmapped numpy tuple (a
    leading key axis on every lane): 14 lanes, or the reference's 13
    without the stats lane. The arrays are copies, on the CPU too: a
    checkpoint does not change with the search after it."""
    def host(t):
        return t.to("cpu", copy=True).numpy()

    scal = host(carry.scal)
    p = carry.pool
    return (host(p.k), host(p.mask).view(np.uint32),
            host(p.cmask).view(np.uint32), host(p.state), host(p.alive),
            scal[:, K.DONE] != 0, scal[:, K.LOSSY] != 0,
            scal[:, K.WOVF] != 0, scal[:, K.LEVEL].copy(),
            scal[:, K.BEST].copy(), host(carry.pk), host(carry.ps),
            host(carry.pa)) + (() if carry.stats is None
                               else (host(carry.stats),))


def carry_to_numpy(carry: Carry) -> tuple:
    """A device :class:`Carry` of one key as the reference's numpy tuple
    (14 lanes with the stats lane, else 13)."""
    if carry.scal.shape[0] != 1:
        raise ValueError(f"carry_to_numpy takes one key, got "
                         f"{carry.scal.shape[0]}; use batch_carry_to_numpy")
    return tuple(x[0] for x in batch_carry_to_numpy(carry))
