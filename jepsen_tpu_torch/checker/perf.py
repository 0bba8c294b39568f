"""Performance checkers: latency quantiles and throughput rates.

Rebuild of jepsen.checker.perf (jepsen/src/jepsen/checker/perf.clj). The
reference shells out to gnuplot for PNGs; here we compute the same series
(latency points, bucketed quantiles {0.5, 0.95, 0.99, 1.0} over 30 s windows,
rates over 10 s windows — perf.clj:256-257,303) with numpy, emit the data as
JSON artifacts into the store, and render simple self-contained SVG charts
(no subprocess dependency). The port's copy of
``jepsen_tpu.checker.perf``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from jepsen_tpu_torch.checker import Checker
from jepsen_tpu_torch.history import History

QUANTILES = (0.5, 0.95, 0.99, 1.0)
LATENCY_DT = 30.0  # seconds per quantile bucket (perf.clj:256)
RATE_DT = 10.0     # seconds per rate bucket (perf.clj:303)


def latency_series(history: History) -> List[dict]:
    """[(time_s, latency_ms, f, type)] for each completed op.

    Pairs whose completion is ``:info`` with no timestamp are skipped:
    synthesized completions (WAL recovery's reconciled dangling
    invokes, crash bookkeeping) carry ``time=0`` or a time before the
    invocation, which used to emit negative/zero latencies that
    poisoned the quantile buckets. A genuine timed ``:info`` (a crashed
    op whose completion was recorded live) still yields a point."""
    out = []
    for inv, comp in history.pairs():
        if inv is None or comp is None or inv.process == "nemesis":
            continue
        if comp.is_info and (not comp.time or comp.time < inv.time):
            continue
        out.append({
            "time": inv.time / 1e9,
            "latency-ms": (comp.time - inv.time) / 1e6,
            "f": inv.f,
            "type": comp.type,
        })
    return out


def quantile_series(points: List[dict],
                    dt: float = LATENCY_DT) -> Dict[str, list]:
    """Bucketed latency quantiles per f, mirroring perf.clj:221-260."""
    by_f: Dict[Any, List[dict]] = {}
    for p in points:
        by_f.setdefault(p["f"], []).append(p)
    out = {}
    for f, ps in by_f.items():
        ts = np.asarray([p["time"] for p in ps])
        ls = np.asarray([p["latency-ms"] for p in ps])
        if len(ts) == 0:
            continue
        buckets = np.floor(ts / dt).astype(int)
        series = {q: [] for q in QUANTILES}
        for b in sorted(set(buckets.tolist())):
            sel = ls[buckets == b]
            t_mid = (b + 0.5) * dt
            for q in QUANTILES:
                series[q].append([t_mid, float(np.quantile(sel, q))])
        out[str(f)] = {str(q): v for q, v in series.items()}
    return out


def rate_series(history: History, dt: float = RATE_DT) -> Dict[str, list]:
    """Completion rate (ops/sec) per (f, type) in dt buckets
    (perf.clj:285-303), plus an all-types rollup per f (the missing
    ``f``-label breakdown: the reference plots per-f totals alongside
    the per-(f, type) splits, and without the rollup a dashboard cannot
    show 'reads/sec' without re-summing the splits client-side)."""
    acc: Dict[tuple, Dict[int, int]] = {}
    for o in history:
        if o.is_invoke or o.process == "nemesis":
            continue
        b = int(o.time / 1e9 // dt)
        for key in ((str(o.f), o.type), (str(o.f), None)):
            acc.setdefault(key, {}).setdefault(b, 0)
            acc[key][b] += 1
    return {
        (f"{f} {t}" if t is not None else str(f)): [
            [(b + 0.5) * dt, c / dt] for b, c in sorted(buckets.items())]
        for (f, t), buckets in acc.items()
    }


def nemesis_intervals(history: History) -> List[list]:
    """[[start_s, end_s], ...] spans between nemesis action completions
    (util.clj:593-610) for shading graphs.

    Nemesis ops are recorded as :info for both invocation and completion
    (core.clj:292), so we reconstruct pairs by alternation: the nemesis is a
    single thread, so its ops arrive strictly as inv, comp, inv, comp...
    A span opens at the completion of one action (e.g. start) and closes at
    the completion of the next (e.g. stop)."""
    nem_ops = [o for o in history if o.process == "nemesis"]
    completions = nem_ops[1::2]
    out = []
    start: Optional[float] = None
    for o in completions:
        if start is None:
            start = o.time / 1e9
        else:
            out.append([start, o.time / 1e9])
            start = None
    if start is not None:
        out.append([start, None])
    return out


def _svg_line_chart(series: Dict[str, list], title: str,
                    ylabel: str, path: str) -> None:
    """Tiny dependency-free SVG renderer for the store artifacts."""
    w, h, pad = 800, 420, 50
    pts_all = [p for v in series.values()
               for p in (v if isinstance(v, list) else [])]
    if not pts_all:
        return
    xs = [p[0] for p in pts_all]
    ys = [p[1] for p in pts_all]
    x0, x1 = min(xs), max(xs) or 1
    y0, y1 = 0.0, max(ys) or 1.0
    if x1 == x0:
        x1 = x0 + 1

    def sx(x):
        return pad + (x - x0) / (x1 - x0) * (w - 2 * pad)

    def sy(y):
        return h - pad - (y - y0) / (y1 - y0) * (h - 2 * pad)

    colors = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
              "#8c564b", "#e377c2", "#7f7f7f"]
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}">',
        f'<rect width="{w}" height="{h}" fill="white"/>',
        f'<text x="{w/2}" y="20" text-anchor="middle" font-size="14">'
        f'{title}</text>',
        f'<line x1="{pad}" y1="{h-pad}" x2="{w-pad}" y2="{h-pad}" '
        'stroke="black"/>',
        f'<line x1="{pad}" y1="{pad}" x2="{pad}" y2="{h-pad}" '
        'stroke="black"/>',
        f'<text x="12" y="{h/2}" font-size="11" '
        f'transform="rotate(-90 12 {h/2})">{ylabel}</text>',
    ]
    for i, (name, pts) in enumerate(sorted(series.items())):
        if not pts:
            continue
        c = colors[i % len(colors)]
        d = " ".join(f"{sx(p[0]):.1f},{sy(p[1]):.1f}" for p in pts)
        parts.append(f'<polyline fill="none" stroke="{c}" points="{d}"/>')
        parts.append(f'<text x="{w-pad+4}" y="{pad+14*i}" font-size="10" '
                     f'fill="{c}">{name}</text>')
    parts.append("</svg>")
    with open(path, "w") as fh:
        fh.write("\n".join(parts))


def _store_dir(test: dict) -> Optional[str]:
    d = test.get("store-dir") if isinstance(test, dict) else None
    if d:
        os.makedirs(d, exist_ok=True)
    return d


class LatencyGraph(Checker):
    """Latency quantile artifact (checker.clj:390-397)."""

    def check(self, test, history: History, opts=None):
        pts = latency_series(history)
        qs = quantile_series(pts)
        d = _store_dir(test)
        if d:
            with open(os.path.join(d, "latency.json"), "w") as fh:
                json.dump({"points": pts, "quantiles": qs,
                           "nemesis": nemesis_intervals(history)}, fh)
            flat = {f"{f} q{q}": v for f, byq in qs.items()
                    for q, v in byq.items()}
            _svg_line_chart(flat, "latency quantiles", "ms",
                            os.path.join(d, "latency-quantiles.svg"))
        return {"valid": True, "point-count": len(pts)}


class RateGraph(Checker):
    """Throughput artifact (checker.clj:399-405)."""

    def check(self, test, history: History, opts=None):
        rs = rate_series(history)
        d = _store_dir(test)
        if d:
            with open(os.path.join(d, "rate.json"), "w") as fh:
                json.dump({"rates": rs,
                           "nemesis": nemesis_intervals(history)}, fh)
            _svg_line_chart(rs, "throughput", "ops/sec",
                            os.path.join(d, "rate.svg"))
        return {"valid": True}


def latency_graph() -> LatencyGraph:
    return LatencyGraph()


def rate_graph() -> RateGraph:
    return RateGraph()


def perf() -> Checker:
    """Composed latency + rate checker (checker.clj:407-411)."""
    from jepsen_tpu_torch.checker import compose
    return compose({"latency-graph": latency_graph(),
                    "rate-graph": rate_graph()})
