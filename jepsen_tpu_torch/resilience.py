"""The checkpointed segment loop of the single-history search.

Counterpart of the segment loop of ``supervised_check_packed`` in
``jepsen_tpu/resilience.py``. Each rung runs in bounded segments of
levels; inside a segment the carry stays on the device and the kernels
test ``active`` there, so the host launches a segment's levels without
waiting. At each segment end the carry is copied to the host in the
reference's numpy layout (the checkpoint), and the host decides whether
another segment is worth running. Verdicts and level counts equal an
unsegmented run's, because an inactive level changes nothing.

The reference's watchdog, CPU fallback, OOM shrink and fault injection
are not part of this slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from jepsen_tpu_torch import interop
from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.checker.engine import default_engine
from jepsen_tpu_torch.kernels.search import LevelShape
from jepsen_tpu_torch.models.core import KernelSpec
from jepsen_tpu_torch.ops.encode import PackedHistory


def supervised_check_packed(p: PackedHistory, kernel: KernelSpec,
                            capacity: Optional[int] = None,
                            window: Optional[int] = None,
                            expand: Optional[int] = None,
                            segment_iters: Optional[int] = None,
                            device: Optional[torch.device] = None,
                            ops: G.Ops = G.KERNELS) -> Dict[str, Any]:
    """Check one packed history rung by rung, in checkpointed segments
    (see :func:`jepsen_tpu_torch.checker.gpu.check_packed_gpu`).
    ``ops=gpu.PLAIN`` runs the kernels' plain versions instead, on any
    device: the reference a run on the card is held against."""
    dev = G.resolve_device(device)
    if window is not None:
        G._check_window(window)
    cols_np, early = G._prep_single(p, kernel)
    if early is not None:
        return early
    if capacity is not None:
        G._check_window(window or G.WINDOW)
        ladder = ((capacity, window or G.WINDOW, expand),)
    else:
        ladder = G._ladder_for(G._window_needed(p), dev)
    crw = G._crash_width(p.n - p.n_required) or 0
    n, cr_pad = cols_np["f"].shape[0], cols_np["cf"].shape[0]
    nr = int(cols_np["nr"])
    lmax = G._level_budget(n, cr_pad)
    seg = G._segment_config(segment_iters) or lmax + 1
    eng = default_engine()
    work: list = []
    out: Dict[str, Any] = {}
    with eng.lock:
        cols = eng.cols(cols_np, dev)
        for cap, win, exp in ladder:
            shape = LevelShape(C=cap, W=win, E=min(exp or cap, cap), n=n,
                               CR=cr_pad)
            carry, scratch = eng.state(shape, dev)
            host = G._carry0_host(cap, win, cr_pad, cols_np["ini"], nr,
                                  stats_rows=lmax + 1)
            interop.carry_from_numpy(host, dev, out=carry)
            scratch.acc.zero_()
            segments = 0
            while G._carry_active(host, lmax):
                G.run_segment(cols, carry, scratch, shape, nr, seg, ops)
                host = interop.carry_to_numpy(carry)   # waits for the device
                segments += 1
            done, lossy, wovf, best, levels, pool = G._summarize_carry(host)
            out = G._result(done, lossy, wovf, best, levels, p, pool=pool)
            out["rung"] = (cap, win, exp)
            out["best-k"] = best
            out["crash-width"] = crw
            out["tiebreak"] = "lex"
            work.append(((cap, win, exp), crw, "lex", levels))
            out["work"] = list(work)
            out["segments"] = segments
            out["segment-iters"] = seg
            out["searchstats"] = dict(zip(
                G.SEARCHSTAT_COLS,
                (int(x) for x in np.asarray(host[13])[:levels].sum(0))))
            if out["valid"] is not UNKNOWN:
                return out
            if wovf and win >= G.MAX_WINDOW and not lossy:
                return out  # a bigger pool won't fix a window overflow
    return out
