"""Holding the kernels against their plain versions on one search state.

:class:`Level` sets up the search of one history, or of a keyed batch,
at one rung and tie-break on a device, advances it with the kernels, and
then walks one level stage by stage:
each kernel and its plain version run from identical copies of that
stage's inputs and their outputs are compared exactly (integer state:
tolerance 0). ``chip_smoke.py`` and the card-only tests use it.
"""

from __future__ import annotations

import copy
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import interop
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.kernels import search as K


def max_abs_err(xs: List[torch.Tensor], ys: List[torch.Tensor]) -> int:
    """The largest absolute difference between paired integer tensors
    (a pair of Nones, an absent optional buffer, agrees)."""
    err = 0
    for x, y in zip(xs, ys, strict=True):
        if x is None and y is None:
            continue
        if x is None or y is None:
            raise ValueError("one output is absent, the other not")
        if x.shape != y.shape or x.dtype != y.dtype:
            raise ValueError(f"{x.shape}/{x.dtype} vs {y.shape}/{y.dtype}")
        if x.numel():
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64))
                               .abs().max()))
    return err


def grouped_rows(shape: K.LevelShape, seed: int) -> np.ndarray:
    """Rows [B, RP, NK] for K3 and K4, drawn from ``seed`` with numpy: each
    key's R live rows in runs of one (key1, k, mask, state), among them
    runs longer than a scan block (SCAN_ROWS) and than a stripe of K4's
    block, each run's crashed masks sparse and in ascending popcount (as
    the sort leaves them) so that its first rows cover later ones; the last
    rows of each key invalid, then K1's pad tail."""
    rng = np.random.default_rng(seed)
    B, R, MW, MCX, CR = shape.B, shape.R, shape.MW, shape.MCX, shape.CR
    rows = np.zeros((B, shape.RP, shape.NK), np.int64)
    rows[:, :, 0] = K.INT32_MAX
    for b in range(B):
        i, live = 0, R - int(rng.integers(0, max(1, R // 20)))
        while i < R:
            n = min(R - i, int(rng.choice([1, 2, 9, 40, 700, 1500])))
            k = int(rng.integers(0, 256))
            run = rows[b, i:i + n]
            run[:, 0] = K.MAXK - int(rng.integers(0, 64))
            run[:, 1] = k
            run[:, 2:2 + MW] = rng.integers(0, 2**32, MW)
            run[:, 2 + MW] = int(rng.integers(-1, 9))
            bits = rng.random((n, 32 * MCX)) < 0.06
            bits[:, CR:] = False
            words = (bits.reshape(n, MCX, 32).astype(np.int64)
                     << np.arange(32)).sum(-1)
            pc = bits.sum(1)
            order = np.lexsort(tuple(words[:, w] for w in
                                     reversed(range(MCX))) + (pc,))
            run[:, 3 + MW] = pc[order]
            run[:, 4 + MW:] = words[order]
            i += n
        tail = rows[b, live:R]
        tail[:, 0] = K.MAXK + 1 + tail[:, 1]
    return np.where(rows >= 2**31, rows - 2**32, rows).astype(np.int32)



def copy_state(carry: G.Carry, scratch: G.Scratch
               ) -> Tuple[G.Carry, G.Scratch]:
    """Independent copies of a carry and its scratch buffers."""
    return (G.Carry(pool=K.Pool(*(t.clone() for t in carry.pool.tensors())),
                    pk=carry.pk.clone(), ps=carry.ps.clone(),
                    pa=carry.pa.clone(), scal=carry.scal.clone(),
                    stats=(None if carry.stats is None
                           else carry.stats.clone())),
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

    def without_stats(self) -> "Level":
        """This state with the stats lane off: the carry without its
        counter rows, which K4 then does not write (tracing off)."""
        other = copy.copy(self)
        c, s = copy_state(self.carry, self.scratch)
        c.stats = None
        other.carry, other.scratch = c, s
        return other

    @classmethod
    def random(cls, shape: K.LevelShape, seed: int, device,
               inactive: Sequence[int] = (), forced: float = 0.8,
               lag: int = 24) -> "Level":
        """A search state of ``shape`` drawn from ``seed`` with numpy, not
        reached by a search: each key's columns are a random history's
        (f, v1 and v2 drawn over every model's codes, ret sorted, a share
        ``forced`` of the ops forced, some crashed slots padded) with
        ``cb`` computed from them, and its pool C rows drawn with repeats
        from C / 4 random configurations (any mask and crashed-mask bits,
        bit 0 included), so that a level meets duplicates, dominated rows,
        long forced runs and overflowing windows. Each op is invoked 1 to
        ``lag`` - 1 time units before it returns, returns lying about 8
        apart: past 8 W every op of a row's window is concurrent with its
        frontier, and so are the ops after it. The keys in ``inactive``
        are done."""
        rng = np.random.default_rng(seed)
        B, C, W, n, CR = shape.B, shape.C, shape.W, shape.n, shape.CR
        inf = K.RET_INF
        cols = {c: [] for c in K.COLS + ("nr",)}
        for _ in range(B):
            nr = int(rng.integers(n // 2, n + 1))
            ret = np.full(n, inf, np.int64)
            ret[:nr] = np.sort(rng.integers(4, 8 * n, nr))
            inv = np.full(n, inf, np.int64)
            inv[:nr] = np.maximum(0, ret[:nr] - rng.integers(1, lag, nr))
            ncr = int(rng.integers(0, CR + 1))
            cinv = np.full(CR, inf, np.int64)
            cinv[:ncr] = rng.integers(0, 8 * n, ncr)
            cps = np.full(CR, -1, np.int64)
            for i in range(1, ncr):
                if rng.random() < 0.3:
                    cps[i] = rng.integers(0, i)
            one = {"f": rng.integers(0, 8, n), "v1": rng.integers(-1, 9, n),
                   "v2": rng.integers(-1, 9, n),
                   "ro": rng.random(n) < 0.3, "fr": rng.random(n) < forced,
                   "inv": inv, "ret": ret,
                   "sm": G._suffix_min_inv(inv.astype(np.int32), n),
                   "cf": rng.integers(0, 8, CR),
                   "cv1": rng.integers(-1, 9, CR),
                   "cv2": rng.integers(-1, 9, CR), "cinv": cinv, "cps": cps,
                   "cb": G.crash_bounds(ret, cinv), "nr": nr}
            for c in cols:
                cols[c].append(np.asarray(one[c]).astype(np.int32))
        lv = cls.__new__(cls)
        lv.shape = shape
        lv.cols = interop.batch_cols_from_numpy(
            {c: np.stack(v) for c, v in cols.items()}, device)
        lv.nr = lv.cols["nr"]

        distinct = max(1, C // 4)
        pick = rng.integers(0, distinct, (B, C))
        k = rng.integers(0, n + 1, (B, distinct))
        mbits = rng.random((B, distinct, 32 * shape.MW)) < 0.15
        mbits[..., W:] = False
        cbits = rng.random((B, distinct, 32 * shape.MCX)) < 0.3
        cbits[..., CR:] = False
        state = rng.integers(-1, 9, (B, distinct))
        alive = rng.random((B, C)) < 0.8

        def pack(bits):
            w = bits.reshape(*bits.shape[:-1], -1, 32).astype(np.uint64)
            return (w << np.arange(32, dtype=np.uint64)).sum(-1).astype(
                np.uint32).view(np.int32)

        def take(x):
            return np.take_along_axis(
                x, pick.reshape(B, C, *([1] * (x.ndim - 2))), axis=1)
        pool = K.Pool(
            k=torch.from_numpy(take(k).astype(np.int32)),
            mask=torch.from_numpy(take(pack(mbits))),
            cmask=torch.from_numpy(take(pack(cbits))),
            state=torch.from_numpy(take(state).astype(np.int32)),
            alive=torch.from_numpy(alive))
        scal = np.zeros((B, K.NSCAL), np.int32)
        scal[:, K.LEVEL] = rng.integers(0, 8, B)
        scal[:, K.NALIVE] = alive.sum(1)
        scal[list(inactive), K.DONE] = 1
        carry = G.empty_carry(shape, device)
        for dst, src in zip(carry.pool.tensors(), pool.tensors()):
            dst.copy_(src)
        carry.scal.copy_(torch.from_numpy(scal))
        lv.carry = carry
        lv.scratch = G.empty_scratch(shape, device)
        return lv

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
        """(name, kernel call, plain call, outputs) for each kernel a level
        at this shape launches (``group_scan`` only where
        :func:`~jepsen_tpu_torch.kernels.search.group_scan_runs`; else the
        kernel ``dedup_truncate`` finds the group starts itself, and is
        held against the plain versions of both); each call takes a
        (carry, scratch) holding that kernel's inputs."""
        cols, shape, nr = self.cols, self.shape, self.nr

        def k1(impl):
            return lambda c, s: impl(cols, c.pool, c.scal, s.acc, s.rows,
                                     shape, nr)

        def k3(impl):
            return lambda c, s: impl(s.rows, c.scal, s.g, s.gagg, shape)

        scan = [("group_scan", k3(K.group_scan), k3(K.group_scan_plain),
                 lambda c, s: [s.g, s.gagg])]
        return [
            ("expand", k1(K.expand), k1(K.expand_plain),
             lambda c, s: [c.scal, s.acc, s.rows]),
            ("sort_rows",
             lambda c, s: K.sort_rows(s.rows, c.scal, shape, s.rows_alt),
             lambda c, s: K.sort_rows_plain(s.rows, c.scal, shape),
             lambda c, s: [s.rows]),
        ] + (scan if K.group_scan_runs(shape) else []) + [
            ("dedup_truncate", self.dedup_call(K.dedup_truncate),
             self.dedup_call(K.dedup_truncate_plain),
             lambda c, s: list(s.pool_next.tensors())
             + [c.pk, c.ps, c.pa, c.scal, s.acc, c.stats]),
        ]

    def dedup_call(self, impl, seg=None):
        """``impl`` (``dedup_truncate`` or its plain version) as a call on
        a (carry, scratch); with ``seg``, ending a level pair in it."""
        shape, nr = self.shape, self.nr
        return lambda c, s: impl(s.rows, s.g, s.gagg, c.pool, s.pool_next,
                                 c.pk, c.ps, c.pa, c.scal, s.acc, c.stats,
                                 shape, nr, seg)

    def dedup_inputs(self) -> tuple:
        """The inputs of this state's next ``dedup_truncate``: a copy of
        the state after the level's earlier stages, run by the kernels."""
        c, s = copy_state(self.carry, self.scratch)
        for _, kern, _, _ in self.stages()[:-1]:
            kern(c, s)
        return c, s

    def pair_end(self, cases) -> tuple:
        """``dedup_truncate`` ending a level pair (the segment graph's
        second K4) against the plain one and then ``seg_active_plain``,
        from the inputs of this state's next K4 (:meth:`dedup_inputs`),
        over segment words (levels run, bound) ``cases``: (the largest
        difference in any K4 output or segment word, those inputs)."""
        state = self.dedup_inputs()
        err = 0
        for run, bound in cases:
            outs = []
            for impl in (K.dedup_truncate, K.dedup_truncate_plain):
                c, s = copy_state(*state)
                seg = torch.tensor([run, bound, 9, 0], dtype=torch.int32,
                                   device=c.scal.device)
                self.dedup_call(impl, seg)(c, s)
                outs.append(list(s.pool_next.tensors())
                            + [c.pk, c.ps, c.pa, c.scal, s.acc, c.stats,
                               seg])
            err = max(err, max_abs_err(*outs))
        return err, state

    def walk(self, first: int = 0) -> Iterator[tuple]:
        """One level from the current state, stage by stage from stage
        ``first`` (2: from the rows as they stand, sorted): yields (name,
        kernel call, plain call, inputs, max_abs_err), where inputs is the
        (carry, scratch) both calls started from. The next stage starts
        from the plain version's outputs."""
        state = copy_state(self.carry, self.scratch)
        for name, kern, plain, outputs in self.stages()[first:]:
            ck, sk = copy_state(*state)
            cp, sp = copy_state(*state)
            kern(ck, sk)
            plain(cp, sp)
            yield (name, kern, plain, state,
                   max_abs_err(outputs(ck, sk), outputs(cp, sp)))
            state = (cp, sp)
