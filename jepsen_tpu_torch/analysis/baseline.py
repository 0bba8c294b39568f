"""Lint baseline: deliberately-accepted findings, committed with
justifications, so CI gates on *new* findings only.

Format — one accepted finding per line::

    <rule> <path>#<anchor> — <one-line justification>

The key is line-number-independent (rule + file + structural anchor:
enclosing qualname / normalized snippet), so baselines survive
reformatting; ``#`` separates path from anchor and `` — `` (em dash)
separates the key from its mandatory justification. Lines starting with
``#`` are comments. The port's default baseline is
``jepsen_tpu_torch/analysis/lint.baseline`` (the reference's
``lint.baseline`` at the repo root holds the reference's own).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Tuple

from jepsen_tpu_torch.analysis import Finding, repo_root

BASELINE_NAME = os.path.join("jepsen_tpu_torch", "analysis",
                             "lint.baseline")
_SEP = " — "  # " — "

#: The justification placeholder ``--write-baseline`` emits for new
#: entries. It marks an acceptance nobody has reviewed yet: ``lint
#: --strict`` refuses to treat such an entry as a real acceptance
#: (see :func:`stubbed`).
STUB = "TODO: justify this acceptance"


def stubbed(baseline: Dict[str, str]) -> List[str]:
    """Keys whose justification is missing or still the TODO stub —
    acceptances that were never actually reviewed."""
    return sorted(k for k, just in baseline.items()
                  if not just or just.startswith("TODO"))


def default_path(root: Optional[str] = None) -> str:
    return os.path.join(root or repo_root(), BASELINE_NAME)


def load(path: Optional[str] = None,
         root: Optional[str] = None) -> Dict[str, str]:
    """key -> justification. A missing file is an empty baseline."""
    p = path or default_path(root)
    out: Dict[str, str] = {}
    if not os.path.exists(p):
        return out
    with open(p, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if _SEP in line:
                key, just = line.split(_SEP, 1)
            else:
                key, just = line, ""
            out[key.strip()] = just.strip()
    return out


def split(findings: Iterable[Finding], baseline: Dict[str, str]
          ) -> Tuple[List[Finding], List[Finding]]:
    """(new, accepted): findings not/covered by the baseline."""
    new, accepted = [], []
    for f in findings:
        (accepted if f.key() in baseline else new).append(f)
    return new, accepted


def render_keys(keys: Iterable[str],
                justifications: Optional[Dict[str, str]] = None) -> str:
    """Baseline text for a set of keys, preserving any existing
    justifications and stubbing the rest (a stub must be replaced by a
    real justification before committing — the gate treats the entry as
    accepted either way, the review process should not)."""
    justifications = justifications or {}
    lines = [
        "# jtpu lint baseline — deliberately accepted findings.",
        "# One per line: <rule> <path>#<anchor> — <justification>.",
        "# Regenerate with: python -m jepsen_tpu_torch lint --write-baseline",
        "",
    ]
    for k in sorted(set(keys)):
        just = justifications.get(k) or STUB
        lines.append(f"{k}{_SEP}{just}")
    return "\n".join(lines) + "\n"


def render(findings: Iterable[Finding],
           justifications: Optional[Dict[str, str]] = None) -> str:
    return render_keys((x.key() for x in findings), justifications)


def write(path: str, findings: Iterable[Finding],
          keep_existing: bool = True) -> None:
    existing = load(path) if keep_existing else {}
    with open(path, "w", encoding="utf-8") as f:
        f.write(render(findings, existing))


def prune(path: str, live_keys: Iterable[str]) -> List[str]:
    """Rewrite the baseline dropping entries whose key no longer
    matches any live finding (the accepted debt was fixed); surviving
    entries keep their justifications verbatim. Returns the pruned
    keys; a baseline with no stale entries is left untouched."""
    existing = load(path)
    live = set(live_keys)
    stale = sorted(k for k in existing if k not in live)
    if not stale:
        return []
    survivors = {k: j for k, j in existing.items() if k in live}
    with open(path, "w", encoding="utf-8") as f:
        f.write(render_keys(survivors.keys(), survivors))
    return stale
