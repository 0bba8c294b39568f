"""The findings face of the plan gate (:mod:`jepsen_tpu_torch.checker.plan`).

Counterpart of ``PlanRejectedError`` and ``findings_from_report`` in
``jepsen_tpu/analysis/plan_lint.py``: a plan report's issues become
:class:`~jepsen_tpu_torch.analysis.Finding` records, and the
pre-search gate raises :class:`PlanRejectedError` (the plan-level sibling
of ``MalformedHistoryError``) before any device state is allocated.

==========================  ========  =================================
rule                        severity  what it catches
==========================  ========  =================================
PLAN-OOM                    error     the candidate's buffers exceed
                                      the byte budget
PLAN-SHARD-INDIVISIBLE      error     the mesh axis does not divide
                                      the capacity or the expansion
PLAN-SHARD-SKEW             warning   a shard's slice of the expansion
                                      is too thin to keep it busy
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

The ``plan`` pass of ``python -m jepsen_tpu_torch lint`` runs the engine
over the reference's pinned fixture matrix (:data:`PLAN_MATRIX`, every
model family with an integer kernel at representative dims), arithmetic
only, against the ladder and byte budget of the card (none on a host
without one), and with a mesh axis the pool-sharded plan too.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from jepsen_tpu_torch.analysis import ERROR, Finding, summarize


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


#: The pinned plan fixture matrix (the reference's): (label, model name,
#: dims keywords), one row per model family with an integer kernel.
PLAN_MATRIX = (
    ("localkv-small", "cas-register",
     dict(n_required=150, n_crashed=3, window_needed=5)),
    ("register-10k-flagship", "cas-register",
     dict(n_required=10000, n_crashed=20, window_needed=10)),
    ("register-crashy", "cas-register",
     dict(n_required=500, n_crashed=96, window_needed=8)),
    ("register-wide-100", "cas-register",
     dict(n_required=400, n_crashed=0, window_needed=100)),
    ("mutex-suite", "mutex",
     dict(n_required=600, n_crashed=4, window_needed=6)),
    ("set-suite", "set",
     dict(n_required=2000, n_crashed=8, window_needed=16)),
    ("unordered-queue-suite", "unordered-queue",
     dict(n_required=800, n_crashed=8, window_needed=12)),
    ("fifo-queue-suite", "fifo-queue",
     dict(n_required=800, n_crashed=8, window_needed=12)),
    ("noop-smoke", "noop",
     dict(n_required=64, n_crashed=0, window_needed=2)),
)


def lint_matrix(trace: bool = False,
                mesh_axis: Optional[int] = None) -> List[Finding]:
    """The plan engine over :data:`PLAN_MATRIX`: its findings, and
    ``PLAN-NO-VALID-CANDIDATE`` for a row no candidate survives.
    ``trace=True`` also checks each candidate's level shape against the
    kernels; ``mesh_axis`` adds each row's pool-sharded plan."""
    from jepsen_tpu_torch.checker import plan as plan_mod
    from jepsen_tpu_torch.models.core import kernel_spec_for
    from jepsen_tpu_torch.serve import models
    registry = models()
    out: List[Finding] = []
    for label, model_name, dkw in PLAN_MATRIX:
        kernel = kernel_spec_for(registry[model_name]())
        report = plan_mod.analyze(plan_mod.PlanDims(**dkw), kernel=kernel,
                                  trace=trace, mesh_axis=mesh_axis)
        out.extend(findings_from_report(report, path=f"plan:{label}"))
        if report["selected"] is None:
            out.append(Finding(
                rule="PLAN-NO-VALID-CANDIDATE", severity=ERROR,
                path=f"plan:{label}", line=0,
                message=(f"no candidate plan survives for "
                         f"{model_name} at {dkw}"),
                anchor=f"{label}/PLAN-NO-VALID-CANDIDATE"))
    return out
