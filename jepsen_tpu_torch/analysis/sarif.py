"""SARIF 2.1.0 export for the shared findings core.

Static Analysis Results Interchange Format (OASIS SARIF 2.1.0) is what
CI forges ingest to annotate pull requests inline — GitHub code
scanning, GitLab SAST, Azure DevOps all consume it. Every pass that
speaks :class:`~jepsen_tpu_torch.analysis.Finding` (the four code/history
passes *and* the plan verifier) exports through this one translator,
so ``python -m jepsen_tpu_torch lint --format sarif`` and
``python -m jepsen_tpu_torch plan --format sarif`` and
``tools/torch_lint_gate.py --sarif OUT`` all emit the same schema.

Mapping: rule id -> ``rule.id``; severity -> ``level`` (error/warning/
note map 1:1); the line-number-independent baseline anchor ->
``partialFingerprints["jtpuAnchor/v1"]`` so forge-side deduplication
survives reformatting exactly like the local baseline does. Findings
with no real file (history artifacts, plan pseudo-paths) keep their
path string as the artifact URI — SARIF only requires a string.

The port's copy of ``jepsen_tpu.analysis.sarif``: the same document
for the same findings, tool name and URIs included.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List

from jepsen_tpu_torch.analysis import Finding

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://docs.oasis-open.org/sarif/sarif/v2.1.0/"
                "errata01/os/schemas/sarif-schema-2.1.0.json")

#: Finding severity -> SARIF result level (1:1 by design).
_LEVELS = {"error": "error", "warning": "warning", "note": "note"}


def _result(f: Finding) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "ruleId": f.rule,
        "level": _LEVELS.get(f.severity, "warning"),
        "message": {"text": f.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.path.replace("\\", "/")},
                "region": {"startLine": max(int(f.line), 1),
                           "startColumn": max(int(f.col), 0) + 1},
            },
        }],
    }
    if f.anchor:
        out["partialFingerprints"] = {"jtpuAnchor/v1": f.anchor}
    return out


def to_sarif(findings: Iterable[Finding],
             tool_name: str = "jtpu-lint",
             tool_uri: str = "doc/lint.md",
             rule_help: str = "doc/plan.md") -> Dict[str, Any]:
    """One SARIF log with one run: the tool descriptor lists every rule
    that actually fired (forges require each result's ruleId to
    resolve), results carry location + fingerprint per finding."""
    fl: List[Finding] = list(findings)
    rules = sorted({f.rule for f in fl})
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": tool_name,
                "informationUri": tool_uri,
                "rules": [{"id": r,
                           "helpUri": (rule_help if r.startswith("PLAN-")
                                       else tool_uri)}
                          for r in rules],
            }},
            "results": [_result(f) for f in fl],
        }],
    }


def render(findings: Iterable[Finding], **kwargs: Any) -> str:
    return json.dumps(to_sarif(findings, **kwargs), indent=2,
                      sort_keys=False) + "\n"


def write(path: str, findings: Iterable[Finding], **kwargs: Any) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(render(findings, **kwargs))
