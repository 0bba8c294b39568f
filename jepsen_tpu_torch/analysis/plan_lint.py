"""The findings face of the plan gate (:mod:`jepsen_tpu_torch.checker.plan`).

Counterpart of ``PlanRejectedError`` and ``findings_from_report`` in
``jepsen_tpu/analysis/plan_lint.py``: a plan report's issues become
:class:`~jepsen_tpu_torch.analysis.history_lint.Finding` records, and the
pre-search gate raises :class:`PlanRejectedError` (the plan-level sibling
of ``MalformedHistoryError``) before any device state is allocated.

==========================  ========  =================================
rule                        severity  what it catches
==========================  ========  =================================
PLAN-OOM                    error     the candidate's buffers exceed
                                      the byte budget
PLAN-INT32-OVERFLOW         error     event indices, sort keys or the
                                      level counter leave int32
PLAN-CRASH-WIDTH            error     more crashed ops than the
                                      crashed-set width
PLAN-WINDOW                 error     a pinned window above MAX_WINDOW
PLAN-TRACE                  error     no kernel takes the candidate's
                                      level shape
PLAN-WINDOW-UNBOUNDED       warning   the needed window exceeds
                                      MAX_WINDOW: no rung can refute
PLAN-EXPAND-CLAMPED         note      expand exceeds capacity
PLAN-SEEDED                 note      the supervised search seeds this
                                      rung's pool below its maximum
==========================  ========  =================================

The reference's pinned lint matrix (``lint_matrix``) is its own
repository lint and has no counterpart here; the sharding rules wait for
the multi-GPU search.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from jepsen_tpu_torch.analysis import summarize
from jepsen_tpu_torch.analysis.history_lint import Finding


class PlanRejectedError(Exception):
    """The pre-search plan gate rejected every candidate plan; raised
    before any engine state is allocated or any kernel launched. Kill
    switch: JTPU_PLAN_GATE=0."""

    def __init__(self, message: str,
                 findings: Optional[List[Finding]] = None,
                 report: Optional[Dict[str, Any]] = None):
        self.findings = findings or []
        self.report = report or {}
        counts = summarize(self.findings)
        if counts:
            message += " (" + " ".join(f"{r}={n}"
                                       for r, n in counts.items()) + ")"
        super().__init__(message)


def findings_from_report(report: Dict[str, Any],
                         path: str = "<plan>") -> List[Finding]:
    """A plan report's issues as Findings, anchored on (candidate label
    or ``dims``) / rule; an issue repeated per candidate row counts
    once."""
    out: List[Finding] = []
    seen = set()
    for i in report.get("issues", []):
        label = i.get("label") or "dims"
        key = (i["rule"], label, i["message"])
        if key in seen:
            continue
        seen.add(key)
        out.append(Finding(
            rule=i["rule"], severity=i["severity"], path=path, line=0,
            message=(f"{label}: {i['message']}" if label != "dims"
                     else i["message"]),
            anchor=f"{label}/{i['rule']}"))
    return out
