"""History contention profiling: is this history P-decomposable?

The device search wins where the frontier is wide and loses where it is
dense and contended. *Faster linearizability checking via
P-compositionality* (Horn & Kroening, arXiv:1504.00204) answers dense
histories by decomposing them into independent sub-problems; this
module is the host-side instrument that measures whether a concrete
history admits that decomposition, BEFORE anything compiles:

* **key-disjointness components** — ops are grouped by the key they
  touch (the ``independent``-style ``[key, v]`` value convention, an
  explicit ``extra["key"]``, or a caller ``key_fn``); ops with no key
  fall into one shared global component, since they conflict with
  everything on the same cell;
* **concurrency width over time** — open invocations sampled across
  the history (the frontier-width the search will actually face);
* **commutativity classes** — read-only vs mutating op counts per
  ``f`` (read-only runs are what the kernel's partial-order closure
  collapses);
* a **decomposability score** in [0, 1] — ``1 - largest_component/
  total`` — and a predicted decomposition speedup from the
  superlinear-in-length search cost of each component.

`analyze` and `recover` print the forecast (see
:func:`forecast_lines`). Arithmetic only — never compiles, never raises.
The port's copy of ``jepsen_tpu.analysis.contention``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

#: ``f`` values treated as read-only for the commutativity classes
#: (kernel ``ro`` columns are exact per-model; this host mirror only
#: feeds the forecast, so a name-based approximation is fine).
READ_ONLY_FS = ("read", "get", "peek")

#: Sentinel component for ops that touch no identifiable key: they
#: conflict with every other keyless op, so they pool together.
GLOBAL_KEY = "__global__"

#: Bound on the concurrency-width series kept in the profile (sampled
#: evenly; mean/max are exact).
WIDTH_SAMPLES = 64


def default_key(op) -> Any:
    """The key an op touches, or None: an explicit ``extra['key']``
    first, else the ``independent``-style ``[key, v]`` LIST value
    convention (tuples are NOT keys — a cas carries an ``(old, new)``
    tuple)."""
    extra = getattr(op, "extra", None)
    if isinstance(extra, dict) and "key" in extra:
        return extra["key"]
    v = getattr(op, "value", None)
    if isinstance(v, list) and len(v) == 2:
        return v[0]
    return None


def profile(history, key_fn: Optional[Callable[[Any], Any]] = None
            ) -> Dict[str, Any]:
    """Profile a history's contention structure. Accepts a History (or
    any op iterable) or an ``independent``-style ``{key: history}``
    dict; returns the structured profile dict (see module docstring).
    Never raises — an unprofilable history comes back with zero ops."""
    try:
        return _profile(history, key_fn)
    except Exception:  # noqa: BLE001 — a forecast must never break a run
        return {"ops": 0, "keys": 0, "components": 0,
                "largest-component-ops": 0, "decomposability": 0.0,
                "decomposable": False, "est-speedup": 1.0,
                "concurrency": {"mean": 0.0, "max": 0, "series": []},
                "commutativity": {"read-only": 0, "mutating": 0,
                                  "classes": {}}}


def _profile(history, key_fn) -> Dict[str, Any]:
    kf = key_fn or default_key
    if isinstance(history, dict):
        # a keyed batch is decomposed by construction: tag each op
        # with its dict key and profile the interleaved whole
        ops = [(k, op) for k, h in history.items() for op in h]
    else:
        ops = [(None, op) for op in history]

    comp_ops: Dict[Any, int] = {}
    classes: Dict[str, int] = {}
    read_only = mutating = 0
    width = 0
    widths: List[int] = []
    n_invoke = 0
    for dict_key, op in ops:
        typ = getattr(op, "type", None)
        if typ == "invoke":
            n_invoke += 1
            width += 1
            key = dict_key if dict_key is not None else kf(op)
            comp = GLOBAL_KEY if key is None else key
            comp_ops[comp] = comp_ops.get(comp, 0) + 1
            f = str(getattr(op, "f", None))
            classes[f] = classes.get(f, 0) + 1
            if f in READ_ONLY_FS:
                read_only += 1
            else:
                mutating += 1
        elif typ in ("ok", "fail", "info"):
            width = max(0, width - 1)
        widths.append(width)

    if not n_invoke:
        raise ValueError("no invocations")
    largest = max(comp_ops.values())
    score = round(1.0 - largest / n_invoke, 4)
    # Predicted decomposition speedup: per-component search cost grows
    # superlinearly with dense component length (the pool re-derives
    # interleavings quadratically), so cost ~ ops^2 and the batched
    # decomposition is bounded by its largest member.
    total_cost = sum(c * c for c in comp_ops.values())
    est = round(total_cost / (largest * largest), 2)
    if len(widths) > WIDTH_SAMPLES:
        n = len(widths)
        series = [max(widths[i * n // WIDTH_SAMPLES:
                             max(i * n // WIDTH_SAMPLES + 1,
                                 (i + 1) * n // WIDTH_SAMPLES)])
                  for i in range(WIDTH_SAMPLES)]
    else:
        series = list(widths)
    keys = [k for k in comp_ops if k is not GLOBAL_KEY
            and k != GLOBAL_KEY]
    return {
        "ops": n_invoke,
        "keys": len(keys),
        "components": len(comp_ops),
        "largest-component-ops": largest,
        "decomposability": score,
        "decomposable": score >= 0.5,
        "est-speedup": est,
        "concurrency": {
            "mean": round(sum(widths) / len(widths), 2) if widths
            else 0.0,
            "max": max(widths) if widths else 0,
            "series": series},
        "commutativity": {"read-only": read_only, "mutating": mutating,
                          "classes": classes},
    }


def forecast_lines(prof: Dict[str, Any]) -> List[str]:
    """The `# contention:` forecast lines `analyze` / `recover`
    print under the `# plan:` summary."""
    if not prof or not prof.get("ops"):
        return ["# contention: unprofilable history"]
    verdict = ("decomposable" if prof.get("decomposable")
               else "NOT decomposable")
    cc = prof.get("concurrency", {})
    cm = prof.get("commutativity", {})
    lines = [
        ("# contention: {v} (score {s:.2f}) — {c} component(s) over "
         "{o} ops, largest {l}").format(
            v=verdict, s=prof.get("decomposability", 0.0),
            c=prof.get("components", 0), o=prof.get("ops", 0),
            l=prof.get("largest-component-ops", 0)),
        ("# contention: concurrency mean {m:g} max {x}; "
         "{ro} read-only / {mu} mutating op(s)").format(
            m=cc.get("mean", 0.0), x=cc.get("max", 0),
            ro=cm.get("read-only", 0), mu=cm.get("mutating", 0)),
    ]
    if prof.get("decomposable"):
        lines.append(
            f"# contention: predicted decomposition speedup "
            f"~{prof.get('est-speedup', 1.0):g}x "
            f"(ROADMAP item 2; doc/perf.md)")
    return lines


def summary_line(prof: Dict[str, Any]) -> str:
    """One-line form (bench output)."""
    return forecast_lines(prof)[0]
