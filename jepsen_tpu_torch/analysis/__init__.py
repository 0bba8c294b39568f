"""Host-side history analysis: the pre-search gate."""

from __future__ import annotations

from typing import Dict, Iterable


def summarize(findings: Iterable) -> Dict[str, int]:
    """Counts of findings by rule id, sorted by rule (the ``lint`` entry
    of a key the gate refused)."""
    out: Dict[str, int] = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return dict(sorted(out.items()))
