"""Moving the search's state between numpy and the device.

The reference keeps its columns and its carry as numpy arrays at every
host boundary: the ``_COLS`` dict from ``_split_packed`` and the carry
tuple ``(k, mask, cmask, state, alive, done, lossy, wovf, level, best_k,
pk, ps, pa[, stats])`` with uint32 mask words. These functions convert
both to the port's device tensors and back, so a checkpoint taken by one
package resumes in the other and the tests can run both searches from
the same inputs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from jepsen_tpu_torch.checker.gpu import Carry
from jepsen_tpu_torch.kernels import search as K


def cols_from_numpy(cols: dict, device, out: Optional[dict] = None) -> dict:
    """Device copies of the 13 column arrays (int32), plus ``nr`` and
    ``ini`` as Python ints. With ``out``, copies into its tensors."""
    res = {} if out is None else out
    for c in K.COLS:
        a = torch.from_numpy(np.array(cols[c], np.int32))
        if out is None:
            res[c] = a.to(device)
        else:
            res[c].copy_(a)
    res["nr"] = int(cols["nr"])
    res["ini"] = int(cols["ini"])
    return res


def _i32(a) -> torch.Tensor:
    """A numpy array (uint32 words allowed) as an int32 tensor."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, np.int32))


def carry_from_numpy(carry: tuple, device,
                     out: Optional[Carry] = None) -> Carry:
    """The reference's 14-lane carry as a device :class:`Carry`. With
    ``out``, copies into its tensors."""
    if len(carry) != 14:
        raise ValueError(f"expected the 14-lane carry with its stats lane, "
                         f"got {len(carry)} lanes")
    (k, mask, cmask, state, alive, done, lossy, wovf, level, best, pk, ps,
     pa, stats) = carry
    scal = np.zeros(K.NSCAL, np.int32)
    scal[K.DONE], scal[K.LOSSY], scal[K.WOVF] = (bool(done), bool(lossy),
                                                 bool(wovf))
    scal[K.LEVEL], scal[K.BEST] = int(level), int(best)
    scal[K.NALIVE] = int(np.count_nonzero(alive))
    src = Carry(pool=K.Pool(k=_i32(k), mask=_i32(mask), cmask=_i32(cmask),
                            state=_i32(state), alive=_bool(alive)),
                pk=_i32(pk), ps=_i32(ps), pa=_bool(pa),
                scal=torch.from_numpy(scal), stats=_i32(stats))
    if out is None:
        return Carry(pool=K.Pool(*(t.to(device) for t in src.pool.tensors())),
                     pk=src.pk.to(device), ps=src.ps.to(device),
                     pa=src.pa.to(device), scal=src.scal.to(device),
                     stats=src.stats.to(device))
    out.pool.copy_(src.pool)
    for dst, t in ((out.pk, src.pk), (out.ps, src.ps), (out.pa, src.pa),
                   (out.scal, src.scal), (out.stats, src.stats)):
        dst.copy_(t)
    return out


def _bool(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, bool))


def carry_to_numpy(carry: Carry) -> tuple:
    """A device :class:`Carry` as the reference's 14-lane numpy tuple."""
    def host(t):
        return t.cpu().numpy()

    scal = host(carry.scal)
    p = carry.pool
    return (host(p.k), host(p.mask).view(np.uint32),
            host(p.cmask).view(np.uint32), host(p.state), host(p.alive),
            np.bool_(scal[K.DONE]), np.bool_(scal[K.LOSSY]),
            np.bool_(scal[K.WOVF]), np.int32(scal[K.LEVEL]),
            np.int32(scal[K.BEST]), host(carry.pk), host(carry.ps),
            host(carry.pa), host(carry.stats))
