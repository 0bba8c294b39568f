"""``explain``: why did a stored run get the verdict it got?

A verdict alone (valid, invalid, unknown) hides the search that produced
it. This module turns a stored run's artifacts, ``results.json``,
``history.jsonl``, the per-level ``searchstats.json``
(:mod:`jepsen_tpu_torch.obs.searchstats`) and the supervisor's
``attempts`` trail, into one structured report, which ``python -m
jepsen_tpu_torch explain`` renders:

* valid: the search's shape: levels, rung, prune rates, and a sparkline
  of the frontier's width a level;
* invalid: the violating level (the longest linearized prefix), the
  blocking ops with each frontier state's step outcome, and the witness
  region, from :mod:`jepsen_tpu_torch.checker.counterexample`;
* unknown: the cause chain: lossy truncation levels (from the stats
  lane), window overflow, plan rejections and device faults, each
  citing the trail event that recorded it.

Every reader tolerates torn artifacts: a run killed mid-write loses
sections of its report, never the report. The port's copy of
``jepsen_tpu.explain``: the same report, key for key, on a store
directory written by either package.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from jepsen_tpu_torch.obs import searchstats as obs_searchstats


def _run_ids(run_dir: str) -> Dict[str, str]:
    d = os.path.abspath(run_dir)
    return {"ts": os.path.basename(d),
            "name": os.path.basename(os.path.dirname(d))}


def _trail_cite(ev: Dict[str, Any]) -> Dict[str, Any]:
    """The trail event's fields that a cause cites."""
    keep = ("event", "outcome", "segment", "level", "rung", "effective",
            "error", "headroom", "lossy", "backoff-s")
    return {k: ev[k] for k in keep if k in ev}


def _unknown_causes(results: Dict[str, Any],
                    ss: Optional[Dict[str, Any]],
                    status: str) -> List[Dict[str, Any]]:
    """The cause chain of an unknown verdict, most specific first, each
    citing its evidence."""
    causes: List[Dict[str, Any]] = []
    attempts = results.get("attempts") or []
    # plan rejections and seeded pools come first: they shaped the search
    # before it ran
    plan = results.get("plan") or {}
    for rej in plan.get("rejected") or []:
        causes.append({"cause": "plan-rejected-rung",
                       "detail": (f"rung {rej.get('rung')} rejected by "
                                  f"{' '.join(rej.get('rules') or [])}"),
                       "cite": rej})
    for ev in attempts:
        if ev.get("event") == "plan":
            causes.append({"cause": "plan-seeded-pool",
                           "detail": ev.get("outcome", ""),
                           "cite": _trail_cite(ev)})
    # lossy truncation: the stats lane names the levels
    if results.get("capacity-overflow"):
        c = {"cause": "lossy-truncation",
             "detail": "the pool truncated live unique configurations; "
                       "pool death no longer refutes"}
        if ss and ss.get("levels"):
            tl = [i for i, row in enumerate(ss["levels"]) if row[3] > 0]
            if tl:
                lost = sum(row[3] for row in ss["levels"])
                c["detail"] = (f"lossy truncation at "
                               f"{len(tl)} level(s), first at level "
                               f"{tl[0]}, {lost} unique row(s) lost")
                c["levels"] = tl[:32]
        causes.append(c)
    if results.get("window-overflow"):
        causes.append({"cause": "window-overflow",
                       "detail": "a candidate fell beyond the offset "
                                 "window at every attempted width"})
    for ev in attempts:
        if ev.get("event") in ("oom", "wedge", "transient", "dcn",
                               "fatal"):
            causes.append({"cause": f"device-{ev['event']}",
                           "detail": (f"{ev.get('outcome', '')} at "
                                      f"level {ev.get('level')}"),
                           "cite": _trail_cite(ev)})
    if results.get("error"):
        causes.append({"cause": "checker-error",
                       "detail": str(results["error"])})
    if status == "dead":
        causes.append({"cause": "run-died",
                       "detail": "the run process died mid-run (no "
                                 "final verdict was written); `jtpu "
                                 "recover` rebuilds the history and "
                                 "re-checks"})
    if not causes:
        causes.append({"cause": "no-verdict",
                       "detail": "no results.json and no trail — the "
                                 "run never reached analysis"})
    return causes


def _invalid_section(test: Dict[str, Any], results: Dict[str, Any],
                     model) -> Optional[Dict[str, Any]]:
    """The counterexample section: the violating level, the blocking ops
    and the witness region. None when the history cannot be packed again
    (a torn store): the report degrades."""
    try:
        from jepsen_tpu_torch.checker import counterexample
        from jepsen_tpu_torch.ops.encode import pack_with_init
        history = test.get("history") or []
        pk = pack_with_init(history, model)
        if pk is None:
            return None
        packed, kernel = pk
        a = counterexample.analysis(packed, kernel, results)
        blocked = [r for r in a.get("ops", [])
                   if r.get("role") in ("frontier", "candidate",
                                        "crashed")
                   and str(r.get("note", "")).startswith("blocked")]
        shown = [r["j"] for r in a.get("ops", [])]
        return {
            "violating-level": a.get("max-linearized-prefix"),
            "n-required": a.get("n-required"),
            "frontier-states": a.get("frontier-states"),
            "blocking-ops": blocked,
            "witness-region": ({"first-op": min(shown),
                                "last-op": max(shown)}
                               if shown else None),
            "final-path": a.get("final-path"),
            "ops": a.get("ops"),
        }
    except Exception:  # noqa: BLE001 -- degrade, never error (torn runs)
        return None


def explain_report(run_dir: str, model=None) -> Dict[str, Any]:
    """The structured report of a stored run. Never raises on a torn or
    partial store: its sections degrade to None or go absent."""
    from jepsen_tpu_torch import store
    if model is None:
        from jepsen_tpu_torch.models import CASRegister
        model = CASRegister()
    try:
        test = store.load(run_dir)
    except Exception:  # noqa: BLE001 -- a torn store still explains
        test = {"history": [], "results": None}
    results = test.get("results") or {}
    try:
        status = store.run_status(run_dir)
    except Exception:  # noqa: BLE001
        status = "unknown"
    ss = obs_searchstats.read_searchstats(run_dir)
    valid = results.get("valid")
    kind = ("valid" if valid is True
            else "invalid" if valid is False
            else "unknown")
    report: Dict[str, Any] = {
        **_run_ids(run_dir),
        "run-dir": os.path.abspath(run_dir),
        "status": status,
        "valid": valid if isinstance(valid, (bool, type(None)))
        else str(valid),
        "kind": kind,
        "levels": results.get("levels"),
        "rung": results.get("rung"),
        "backend": results.get("backend"),
        "searchstats": (results.get("searchstats")
                        or (ss or {}).get("summary")),
        "frontier-series": ([row[4] for row in ss["levels"]]
                            if ss and ss.get("levels") else None),
    }
    if kind == "invalid":
        report["counterexample"] = _invalid_section(test, results, model)
        if report["counterexample"] is None:
            # degrade to the raw result fields the search stored
            report["counterexample-raw"] = {
                "violating-level": results.get("max-linearized-prefix"),
                "frontier-op": results.get("frontier-op"),
                "final-states": results.get("final-states"),
            }
    if kind == "unknown":
        report["cause-chain"] = _unknown_causes(results, ss, status)
    return report


def render_text(report: Dict[str, Any]) -> str:
    """The command line's rendering: ``# explain:`` lines."""
    lines: List[str] = []
    head = (f"# explain: {report.get('name')}/{report.get('ts')} — "
            f"{report.get('kind')}")
    if report.get("status") not in (None, "done", "unknown"):
        head += f" (run {report['status']})"
    lines.append(head)
    ss = report.get("searchstats")
    if ss:
        lines.append(
            "# explain: search shape: {lv} level(s), dup-rate "
            "{dr:.0%}, prune-efficiency {pe:.0%}, frontier area {fa} "
            "(peak {fp}), {tr} truncation loss(es)".format(
                lv=ss.get("levels", 0), dr=ss.get("dup-rate", 0.0),
                pe=ss.get("prune-efficiency", 0.0),
                fa=ss.get("frontier-area", 0),
                fp=ss.get("frontier-peak", 0),
                tr=ss.get("trunc-losses", 0)))
    series = report.get("frontier-series")
    if series:
        lines.append("# explain: frontier/level "
                     + obs_searchstats.sparkline(series))
    if report.get("rung"):
        lines.append(f"# explain: rung {report['rung']}, "
                     f"levels {report.get('levels')}")
    cex = report.get("counterexample")
    if cex:
        lines.append(
            f"# explain: non-linearizable at op "
            f"{cex.get('violating-level')}/{cex.get('n-required')}: "
            f"the frontier cannot advance")
        for r in (cex.get("blocking-ops") or [])[:8]:
            lines.append(f"# explain:   blocked: {r.get('label')} — "
                         f"{r.get('note')}")
        wr = cex.get("witness-region")
        if wr:
            lines.append(f"# explain: witness region: ops "
                         f"{wr['first-op']}..{wr['last-op']}")
        if cex.get("final-path"):
            lines.append("# explain: one maximal path: "
                         + " -> ".join(cex["final-path"][-8:]))
    elif report.get("counterexample-raw"):
        raw = report["counterexample-raw"]
        lines.append(f"# explain: non-linearizable at op "
                     f"{raw.get('violating-level')} (history not "
                     f"re-packable; raw result fields)")
    for c in report.get("cause-chain") or []:
        lines.append(f"# explain: cause: {c['cause']} — {c['detail']}")
        if c.get("cite"):
            lines.append(f"# explain:   trail: {c['cite']}")
    return "\n".join(lines)
