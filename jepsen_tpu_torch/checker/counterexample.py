"""Counterexample rendering for failed linearizability analyses.

Reference: on ``valid? false`` jepsen renders ``linear.svg`` via
``knossos.linear.report/render-analysis!`` (jepsen/src/jepsen/
checker.clj:96-103), a partial-order diagram of the failing window. This
module draws the equivalent with no dependency, in hand-written SVG:

- one row per process, time (event index) on the x axis;
- the tail of the *maximal linearized prefix* (green), the frontier op the
  search could not get past (red), its concurrent candidate ops (orange),
  and available crashed ops (grey, dashed);
- the reachable frontier *states* (every model state any maximal search
  path ended in), and for each blocked op the states it fails from,
  phrased with the kernel's describe_state.

:class:`jepsen_tpu_torch.checker.wgl.LinearizableChecker` writes the
file into the test's store dir. Counterpart of
``jepsen_tpu/checker/counterexample.py``; the same history and result
draw the same bytes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from jepsen_tpu_torch.models.core import KernelSpec
from jepsen_tpu_torch.ops.encode import RET_INF, PackedHistory

_GREEN, _RED, _ORANGE, _GREY = "#2ca02c", "#d62728", "#ff7f0e", "#888888"
_PREFIX_TAIL = 6      # linearized-prefix ops shown for context
_MAX_CANDIDATES = 18  # concurrent ops shown


def _op_label(p: PackedHistory, j: int) -> str:
    inv_op, _ = p.ops[j] if j < len(p.ops) else (None, None)
    if inv_op is None:
        return f"op {j}"
    v = inv_op.value
    if inv_op.f == "read":
        # reads are checked against their completion value
        comp = p.ops[j][1]
        if comp is not None and comp.value is not None:
            v = comp.value
    return f"{inv_op.f} {v if v is not None else ''}".strip()


def _describe(kernel: KernelSpec, state: int, values: List[Any]) -> str:
    if kernel.describe_state is not None:
        return kernel.describe_state(int(state), values)
    return str(int(state))


def _failure_notes(p: PackedHistory, kernel: KernelSpec, j: int,
                   states: List[int]) -> Tuple[bool, str]:
    """(any_state_accepts, note): step op j from every frontier state."""
    ok_from, fail_from = [], []
    for s in states:
        _, ok = kernel.step(int(s), int(p.f[j]), int(p.v1[j]),
                            int(p.v2[j]))
        (ok_from if ok else fail_from).append(s)
    vals = p.value_table
    if not fail_from:
        return True, "applies from every frontier state"
    if not ok_from:
        return False, ("blocked from every frontier state: " + ", ".join(
            _describe(kernel, s, vals) for s in fail_from[:4]))
    return True, ("blocked from " + ", ".join(
        _describe(kernel, s, vals) for s in fail_from[:4]))


def witness_prefix(p: PackedHistory, kernel: KernelSpec,
                   max_configs: int = 200_000) -> Optional[list]:
    """Reconstruct ONE maximal linearization order — the concrete op
    sequence of a deepest search path (knossos's :final-paths
    equivalent, truncated to a single path; reference
    checker.clj:104-107 truncates to 10 because they can be huge).

    Re-runs a bounded WGL with parent pointers; returns a list of op
    indices (into p.ops) in linearization order, or None when the
    bounded search can't reach the refutation frontier."""
    import numpy as _np
    n = p.n
    n_req = p.n_required
    if n_req == 0:
        return []
    f, v1, v2 = p.f.tolist(), p.v1.tolist(), p.v2.tolist()
    inv, ret = p.inv.tolist(), p.ret.tolist()
    step = kernel.step
    # Candidate upper bound per frontier k, via the non-decreasing
    # suffix-min of inv: every j with inv[j] < ret[k] lies below
    # searchsorted(sufmin, ret[k]). Bounds the inner scan by the
    # candidate window instead of n — at 100k+ ops an O(n)-per-config
    # scan would dwarf the device search this renders for.
    sufmin = _np.minimum.accumulate(_np.asarray(inv, _np.int64)[::-1])[::-1]
    jmax = _np.searchsorted(sufmin, _np.asarray(ret, _np.int64),
                            side="left")

    init = (0, 0, int(p.init_state))
    parent: Dict[tuple, tuple] = {init: None}
    stack = [init]
    best_cfg = init
    best_depth = 0
    explored = 0
    while stack and explored < max_configs:
        cfg = stack.pop()
        k, mask, state = cfg
        explored += 1
        rk = ret[k] if k < n else None
        for j in range(k, int(jmax[k]) if k < n else k):
            if rk is None or inv[j] >= rk:
                continue
            if (mask >> (j - k)) & 1:
                continue
            s2, ok = step(state, f[j], v1[j], v2[j])
            if not ok:
                continue
            if j == k:
                m = mask >> 1
                k2 = k + 1
                while m & 1:
                    m >>= 1
                    k2 += 1
                nxt = (k2, m, int(s2))
            else:
                nxt = (k, mask | (1 << (j - k)), int(s2))
            if nxt in parent:
                continue
            parent[nxt] = (cfg, j)
            depth = nxt[0] + bin(nxt[1]).count("1")
            if (nxt[0], depth) > (best_cfg[0], best_depth):
                best_cfg, best_depth = nxt, depth
            stack.append(nxt)
    order = []
    cur = best_cfg
    while parent.get(cur) is not None:
        cur, j = parent[cur]
        order.append(j)
    order.reverse()
    return order


def analysis(p: PackedHistory, kernel: KernelSpec,
             result: Dict[str, Any]) -> Dict[str, Any]:
    """Structured failure analysis: prefix tail, frontier op, concurrent
    candidates with per-state step outcomes. Pure data — the SVG renderer
    and tests both consume it."""
    best_k = int(result.get("max-linearized-prefix", 0))
    states = result.get("final-states")
    if states is None:
        # Every engine (Python WGL, native, and the device search — which
        # ships its last living pool's configs off-device) now reports
        # final-states itself; this bounded CPU re-run remains only as a
        # safety net for hand-built result dicts.
        from jepsen_tpu_torch.checker.wgl import check_packed
        res2 = check_packed(p, kernel, max_configs=200_000)
        states = res2.get("final-states", [int(p.init_state)])
    states = [int(s) for s in states]

    nr = p.n_required
    rows: List[Dict[str, Any]] = []
    for j in range(max(0, best_k - _PREFIX_TAIL), best_k):
        rows.append({"j": j, "role": "linearized",
                     "label": _op_label(p, j), "note": ""})
    cand: List[int] = []
    if best_k < nr:
        rk = int(p.ret[best_k])
        cand = [j for j in range(best_k, p.n)
                if int(p.inv[j]) < rk][:_MAX_CANDIDATES]
    for j in cand:
        role = ("frontier" if j == best_k
                else "crashed" if j >= nr else "candidate")
        _, note = _failure_notes(p, kernel, j, states)
        rows.append({"j": j, "role": role, "label": _op_label(p, j),
                     "note": note})
    # one concrete maximal linearization order — the :final-paths
    # equivalent (a single path; knossos truncates to 10 at
    # checker.clj:104-107 because they can be huge)
    order = witness_prefix(p, kernel) or []
    return {
        "max-linearized-prefix": best_k,
        "n-required": nr,
        "frontier-states": [_describe(kernel, s, p.value_table)
                            for s in states],
        "final-path": [_op_label(p, j) for j in order],
        "ops": rows,
    }


def render_linear_svg(p: PackedHistory, kernel: KernelSpec,
                      result: Dict[str, Any], path: str) -> Dict[str, Any]:
    """Write the linear.svg counterexample diagram; returns the analysis."""
    a = analysis(p, kernel, result)
    rows = a["ops"]
    if not rows:
        rows = []
    # x axis: event indices of the shown ops
    evs: List[int] = []
    for r in rows:
        j = r["j"]
        evs.append(int(p.inv[j]))
        if int(p.ret[j]) != int(RET_INF):
            evs.append(int(p.ret[j]))
    x0 = min(evs, default=0)
    x1 = max(evs, default=1)
    if x1 <= x0:
        x1 = x0 + 1
    procs = sorted({int(p.process[r["j"]]) for r in rows})
    prow = {pr: i for i, pr in enumerate(procs)}

    left, top, rowh = 70, 110, 34
    w = 980
    h = top + rowh * max(1, len(procs)) + 40

    def sx(ev: int) -> float:
        return left + (ev - x0) / (x1 - x0) * (w - left - 260)

    color = {"linearized": _GREEN, "frontier": _RED,
             "candidate": _ORANGE, "crashed": _GREY}
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
        f'height="{h}" font-family="monospace">',
        f'<rect width="{w}" height="{h}" fill="white"/>',
        f'<text x="12" y="22" font-size="15">non-linearizable: '
        f'{a["max-linearized-prefix"]}/{a["n-required"]} ops linearized; '
        f'frontier cannot advance</text>',
        f'<text x="12" y="44" font-size="12">reachable frontier states: '
        f'{", ".join(a["frontier-states"][:8])}'
        + (f'; one maximal path: '
           f'{" → ".join(a["final-path"][-7:])}'
           if a.get("final-path") else "") + '</text>',
        f'<text x="12" y="66" font-size="11" fill="{_GREEN}">'
        f'linearized prefix</text>',
        f'<text x="150" y="66" font-size="11" fill="{_RED}">frontier op'
        f'</text>',
        f'<text x="250" y="66" font-size="11" fill="{_ORANGE}">concurrent '
        f'candidate</text>',
        f'<text x="420" y="66" font-size="11" fill="{_GREY}">crashed '
        f'(optional)</text>',
    ]
    for pr, i in prow.items():
        y = top + i * rowh
        parts.append(f'<text x="8" y="{y + 14}" font-size="11">p{pr}'
                     f'</text>')
        parts.append(f'<line x1="{left}" y1="{y + 10}" x2="{w - 250}" '
                     f'y2="{y + 10}" stroke="#eeeeee"/>')
    for r in rows:
        j = r["j"]
        y = top + prow[int(p.process[j])] * rowh
        xi = sx(int(p.inv[j]))
        crashed = int(p.ret[j]) == int(RET_INF)
        xr = (w - 255) if crashed else sx(int(p.ret[j]))
        c = color[r["role"]]
        dash = ' stroke-dasharray="4,3"' if crashed else ""
        parts.append(
            f'<rect x="{xi:.1f}" y="{y + 4}" width="{max(xr - xi, 3):.1f}"'
            f' height="12" fill="{c}" fill-opacity="0.35" stroke="{c}"'
            f'{dash}/>')
        label = r["label"] + ("  ✗ " + r["note"]
                              if r["note"].startswith("blocked") else "")
        parts.append(f'<text x="{xi + 2:.1f}" y="{y + 14}" font-size="10">'
                     f'{label}</text>')
    parts.append("</svg>")
    with open(path, "w") as fh:
        fh.write("\n".join(parts))
    return a
