"""HTML timeline of per-process operation bars.

The port's copy of ``jepsen_tpu.checker.timeline`` (a rebuild of
jepsen.checker.timeline): one column per process, one box per
invoke..complete pair (an op never completed extends to the end of the
history), coloured by completion type, with hover titles giving the op's
details, written to ``timeline.html`` in the store. The page is byte for
byte the reference's on the same history.

The nemesis's fault windows (the ``jtpu_fault_active`` gauge's
transitions) are shaded as bands behind the op boxes, so that a burst of
slow or failed client ops lines up with the fault that caused it.
"""

from __future__ import annotations

import html as _html
import os
from typing import Any, Dict, List, Optional, Tuple

from jepsen_tpu_torch.checker import Checker
from jepsen_tpu_torch.history import NEMESIS, History, Op

STYLESHEET = """
body { font-family: sans-serif; }
.ops { position: absolute; }
.op { position: absolute; padding: 2px; border-radius: 2px;
      overflow: hidden; font-size: 10px; }
.op.ok   { background: #6DB6FE; }
.op.info { background: #FEFF7F; }
.op.fail { background: #FEA786; }
.fault { position: absolute; background: rgba(254, 167, 134, 0.25);
         border-left: 3px solid rgba(225, 87, 89, 0.6); }
"""

#: Nemesis f values whose completion closes a fault window (the nemesis
#: layer's heal fs, named here so the checker imports no nemesis).
HEAL_FS = frozenset({"stop", "heal"})

#: Nemesis info ops that are annotations, not invoke/complete pairs.
_NEMESIS_SINGLETONS = frozenset({"heal-verified", "heal-failed",
                                 "nemesis-wedged"})

COL_WIDTH = 100
GUTTER = 106
HEIGHT = 16


def process_index(history: History) -> Dict[Any, int]:
    """Process -> column: the workers first, then the nemesis."""
    procs = sorted({o.process for o in history},
                   key=lambda p: (not isinstance(p, int), str(p)))
    return {p: i for i, p in enumerate(procs)}


def pairs(history: History) -> List[Tuple[int, Op, Optional[int],
                                          Optional[Op]]]:
    """``(invoke index, invocation, completion index, completion)`` rows,
    the completion None for an op never completed, by invoke index."""
    out = []
    open_ops: Dict[Any, Tuple[int, Op]] = {}
    for i, o in enumerate(history):
        if o.is_invoke:
            open_ops[o.process] = (i, o)
        elif o.process in open_ops:
            si, inv = open_ops.pop(o.process)
            out.append((si, inv, i, o))
    for si, inv in open_ops.values():
        out.append((si, inv, None, None))
    out.sort(key=lambda r: r[0])
    return out


def fault_windows(history: History,
                  heal_fs=HEAL_FS) -> List[Tuple[int, int, str]]:
    """The nemesis's fault windows as ``(start_index, end_index, f)``
    ranges of history indices: a window opens at the completion of a
    non-heal nemesis op and closes at the completion of a heal one; a
    window still open at the end of the history extends to it.

    The one nemesis thread records strict invoke/completion pairs, so
    parity suffices; probe annotations (``heal-verified``,
    ``nemesis-wedged``) lie outside the pairing and are skipped."""
    out: List[Tuple[int, int, str]] = []
    open_at: Optional[Tuple[int, str]] = None
    pending: Optional[str] = None
    n = 0
    for i, o in enumerate(history):
        n = i + 1
        if o.process != NEMESIS or o.f in _NEMESIS_SINGLETONS:
            continue
        if pending is None or o.f != pending:
            pending = o.f          # an invocation (or a renamed pair)
            continue
        pending = None             # its completion
        if o.f in heal_fs:
            if open_at is not None:
                out.append((open_at[0], i, open_at[1]))
                open_at = None
        elif open_at is None:
            open_at = (i, str(o.f))
    if open_at is not None:
        out.append((open_at[0], n, open_at[1]))
    return out


def _title(start: Op, stop: Optional[Op]) -> str:
    lat = ((stop.time - start.time) / 1e6
           if stop is not None and stop.time and start.time else None)
    bits = [f"process {start.process}", f"f={start.f}",
            f"value={start.value!r}"]
    if stop is not None and stop.value != start.value:
        bits.append(f"returned={stop.value!r}")
    if lat is not None:
        bits.append(f"{lat:.2f} ms")
    if stop is not None and stop.error:
        bits.append(f"error={stop.error}")
    return " ".join(str(b) for b in bits)


class HTMLTimeline(Checker):
    """Writes ``timeline.html``; always valid."""

    def check(self, test, history: History, opts=None):
        opts = opts or {}
        d = test.get("store-dir")
        if not d:
            return {"valid": True, "skipped": "no store dir"}
        sub = opts.get("subdirectory") or []
        outdir = os.path.join(d, *map(str, sub))
        os.makedirs(outdir, exist_ok=True)

        cols = process_index(history)
        n = len(history)
        divs = []
        # fault bands first: the layer behind the op boxes
        band_w = GUTTER * max(len(cols), 1)
        for si, ei, f in fault_windows(history):
            title = _html.escape(f"nemesis fault window: {f} "
                                 f"(ops {si}..{ei})")
            divs.append(
                f'<div class="fault" title="{title}" '
                f'style="left:0;top:{HEIGHT * si}px;'
                f'width:{band_w}px;'
                f'height:{max(HEIGHT * (ei - si), HEIGHT)}px"></div>')
        for si, inv, ei, comp in pairs(history):
            typ = comp.type if comp is not None else "info"
            top = HEIGHT * si
            height = (HEIGHT * ((ei - si) if ei is not None
                                else (n + 1 - si)))
            left = GUTTER * cols[inv.process]
            body = _html.escape(f"{inv.process} {inv.f} {inv.value!r}")
            title = _html.escape(_title(inv, comp))
            divs.append(
                f'<div class="op {typ}" title="{title}" '
                f'style="width:{COL_WIDTH}px;left:{left}px;top:{top}px;'
                f'height:{max(height, HEIGHT)}px">{body}</div>')

        name = _html.escape(str(test.get("name", "test")))
        key = opts.get("history-key")
        page = (f"<html><head><style>{STYLESHEET}</style></head><body>"
                f"<h1>{name}"
                + (f" key {_html.escape(str(key))}" if key is not None
                   else "")
                + f'</h1><div class="ops">{"".join(divs)}</div>'
                  f"</body></html>")
        with open(os.path.join(outdir, "timeline.html"), "w") as f:
            f.write(page)
        return {"valid": True}


def html() -> HTMLTimeline:
    return HTMLTimeline()
