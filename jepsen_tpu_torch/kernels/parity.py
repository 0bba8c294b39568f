"""Holding the kernels against their plain versions on one search state.

:class:`Level` sets up the search of one history, or of a keyed batch,
at one rung and tie-break on a device, advances it with the kernels, and
then walks one level stage by stage:
each kernel and its plain version run from identical copies of that
stage's inputs and their outputs are compared exactly (integer state:
tolerance 0). ``chip_smoke.py`` and the card-only tests use it.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import torch

from jepsen_tpu_torch import interop
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.kernels import search as K


def max_abs_err(xs: List[torch.Tensor], ys: List[torch.Tensor]) -> int:
    """The largest absolute difference between paired integer tensors."""
    err = 0
    for x, y in zip(xs, ys, strict=True):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise ValueError(f"{x.shape}/{x.dtype} vs {y.shape}/{y.dtype}")
        if x.numel():
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64))
                               .abs().max()))
    return err


def copy_state(carry: G.Carry, scratch: G.Scratch
               ) -> Tuple[G.Carry, G.Scratch]:
    """Independent copies of a carry and its scratch buffers."""
    return (G.Carry(pool=K.Pool(*(t.clone() for t in carry.pool.tensors())),
                    pk=carry.pk.clone(), ps=carry.ps.clone(),
                    pa=carry.pa.clone(), scal=carry.scal.clone(),
                    stats=carry.stats.clone()),
            G.Scratch(pool_next=K.Pool(*(t.clone() for t in
                                         scratch.pool_next.tensors())),
                      acc=scratch.acc.clone(), rows=scratch.rows.clone(),
                      g=scratch.g.clone(), gagg=scratch.gagg.clone(),
                      rows_alt=(None if scratch.rows_alt is None
                                else scratch.rows_alt.clone())))


class Level:
    """The search of one history's ``_split_packed`` columns, or of a
    list of them padded to one width (a keyed batch), at one rung
    (capacity, window, expand), tie-break and model (a KernelSpec name) on
    ``device``."""

    def __init__(self, cols_np, rung: tuple, device, tiebreak: str = "lex",
                 model: str = "cas-register"):
        batch = cols_np if isinstance(cols_np, list) else [cols_np]
        C, W, E = rung
        n, cr = batch[0]["f"].shape[0], batch[0]["cf"].shape[0]
        self.shape = K.LevelShape(C, W, min(E or C, C), n, cr, B=len(batch),
                                  tiebreak=tiebreak, model=model)
        self.cols = interop.batch_cols_from_numpy(interop.stack_cols(batch),
                                                  device)
        self.nr = self.cols["nr"]
        self.carry = interop.batch_carry_from_numpy(
            G._batch_carry0_host(C, W, cr, [c["ini"] for c in batch],
                                 [int(c["nr"]) for c in batch],
                                 stats_rows=self.shape.lmax + 1), device)
        self.scratch = G.empty_scratch(self.shape, device)

    def advance(self, levels: int) -> int:
        """Run ``levels`` levels with the kernels, one launch of each a
        level (:func:`~jepsen_tpu_torch.checker.gpu.run_segment_host`);
        return the live pool rows of the keys not yet done (0 once every
        search is over)."""
        G.run_segment_host(self.cols, self.carry, self.scratch, self.shape,
                           self.nr, levels)
        scal = self.carry.scal.cpu()
        return int(scal[:, K.NALIVE][scal[:, K.DONE] == 0].sum())

    def stages(self):
        """(name, kernel call, plain call, outputs) for each kernel; each
        call takes a (carry, scratch) holding that kernel's inputs."""
        cols, shape, nr = self.cols, self.shape, self.nr

        def k1(impl):
            return lambda c, s: impl(cols, c.pool, c.scal, s.acc, s.rows,
                                     shape, nr)

        def k4(impl):
            return lambda c, s: impl(s.rows, s.g, c.pool, s.pool_next, c.pk,
                                     c.ps, c.pa, c.scal, s.acc, c.stats,
                                     shape, nr)
        return [
            ("expand", k1(K.expand), k1(K.expand_plain),
             lambda c, s: [c.scal, s.acc, s.rows]),
            ("sort_rows",
             lambda c, s: K.sort_rows(s.rows, c.scal, shape, s.rows_alt),
             lambda c, s: K.sort_rows_plain(s.rows, c.scal, shape),
             lambda c, s: [s.rows]),
            ("group_scan",
             lambda c, s: K.group_scan(s.rows, c.scal, s.g, s.gagg, shape),
             lambda c, s: K.group_scan_plain(s.rows, c.scal, s.g, shape),
             lambda c, s: [s.g]),
            ("dedup_truncate", k4(K.dedup_truncate),
             k4(K.dedup_truncate_plain),
             lambda c, s: list(s.pool_next.tensors())
             + [c.pk, c.ps, c.pa, c.scal, s.acc, c.stats]),
        ]

    def walk(self) -> Iterator[tuple]:
        """One level from the current state, stage by stage: yields
        (name, kernel call, plain call, inputs, max_abs_err), where inputs
        is the (carry, scratch) both calls started from. The next stage
        starts from the plain version's outputs."""
        state = copy_state(self.carry, self.scratch)
        for name, kern, plain, outputs in self.stages():
            ck, sk = copy_state(*state)
            cp, sp = copy_state(*state)
            kern(ck, sk)
            plain(cp, sp)
            yield (name, kern, plain, state,
                   max_abs_err(outputs(ck, sk), outputs(cp, sp)))
            state = (cp, sp)
