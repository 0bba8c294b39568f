"""Host-side history analysis: the pre-search gate, its summary line and
the contention forecast."""

from __future__ import annotations

from typing import Dict, Iterable


def summarize(findings: Iterable) -> Dict[str, int]:
    """Counts of findings by rule id, sorted by rule (the ``lint`` entry
    of a key the gate refused)."""
    out: Dict[str, int] = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return dict(sorted(out.items()))


def summary_line(findings: Iterable) -> str:
    """One-line ``# lint:`` summary: counts by rule, 'clean' when none."""
    counts = summarize(findings)
    if not counts:
        return "# lint: clean"
    return "# lint: " + " ".join(f"{r}={n}" for r, n in counts.items())
