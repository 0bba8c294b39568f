"""Static analysis of the port: reject broken suites, malformed histories
and racy or crash-unsafe host code before they burn device time.

The port's copy of ``jepsen_tpu.analysis``: the same findings, rules,
baseline, SARIF export and passes, with their scopes pointed at
``jepsen_tpu_torch/``. Seven passes:

1. :mod:`~jepsen_tpu_torch.analysis.suite_lint` — AST pass over every
   module in ``jepsen_tpu_torch/suites/``, cross-checked against the
   ``SUITES`` registry.
2. :mod:`~jepsen_tpu_torch.analysis.history_lint` — the structural
   history validator; also the pre-search gate.
3. :mod:`~jepsen_tpu_torch.analysis.width_lint` (pass ``width``) — the
   integer-width rules of the reference's JAX pass (``JAX-INT32-OVERFLOW``
   and ``JAX-SHIFT-WIDTH``, the reference's rule ids) over the packed int32
   columns (``ops/encode.py``) and the Python side of the kernels. The
   reference's rules about traced bodies have no counterpart: nothing in
   the port is traced (ROADMAP §C).
4. :mod:`~jepsen_tpu_torch.analysis.lockset_lint` — the static race
   detector over the threaded stack.
5. :mod:`~jepsen_tpu_torch.analysis.plan_lint` — the plan engine
   (:mod:`jepsen_tpu_torch.checker.plan`) over a pinned model x dims
   matrix.
6. :mod:`~jepsen_tpu_torch.analysis.deadlock_lint` — lock-order cycles
   and locks held across blocking calls over the serving scope.
7. :mod:`~jepsen_tpu_torch.analysis.walcheck_lint` — crash-consistency
   dataflow on the serve and stream intake paths.

Findings carry file:line, a rule id and a severity; the port's baseline
(``jepsen_tpu_torch/analysis/lint.baseline``,
:mod:`~jepsen_tpu_torch.analysis.baseline`) holds its accepted findings,
each with a justification. CLI: ``python -m jepsen_tpu_torch lint``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

ERROR = "error"
WARNING = "warning"
NOTE = "note"

#: Gate order: errors always gate; warnings gate in strict mode; notes
#: never gate.
SEVERITIES = (ERROR, WARNING, NOTE)


@dataclass
class Finding:
    """One analysis finding.

    ``anchor`` is the line-number-independent identity used for baseline
    matching: ``<enclosing qualname>/<normalized snippet>`` for code
    findings, a structural key for history findings.
    """

    rule: str
    severity: str
    path: str          # repo-relative where possible
    line: int
    message: str
    anchor: str = ""
    col: int = 0

    def key(self) -> str:
        return f"{self.rule} {self.path}#{self.anchor}"

    def format(self) -> str:
        return (f"{self.path}:{self.line}: {self.severity}: "
                f"[{self.rule}] {self.message}")


def repo_root() -> str:
    """The repository root (parent of the jepsen_tpu_torch package)."""
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def relpath(path: str, root: Optional[str] = None) -> str:
    root = root or repo_root()
    ap = os.path.abspath(path)
    try:
        rp = os.path.relpath(ap, root)
    except ValueError:  # different drive
        return ap
    return ap if rp.startswith("..") else rp


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


def worst_severity(findings: Iterable[Finding]) -> Optional[str]:
    rank = {s: i for i, s in enumerate(SEVERITIES)}
    worst = None
    for f in findings:
        if worst is None or rank.get(f.severity, 99) < rank.get(worst, 99):
            worst = f.severity
    return worst


# ---------------------------------------------------------------------------
# Pass orchestration
# ---------------------------------------------------------------------------

#: Default scan scopes, relative to the repo root: each the reference's
#: scope mapped file for file onto the port. The history pass has no
#: file scope: it runs over histories handed to it.
DEFAULT_SCOPES = {
    "suite": ("jepsen_tpu_torch/suites",),
    "width": ("jepsen_tpu_torch/checker", "jepsen_tpu_torch/ops/encode.py",
              "jepsen_tpu_torch/kernels", "jepsen_tpu_torch/obs",
              "jepsen_tpu_torch/resilience.py", "jepsen_tpu_torch/serve.py",
              "jepsen_tpu_torch/stream.py"),
    "lockset": ("jepsen_tpu_torch/core.py", "jepsen_tpu_torch/journal.py",
                "jepsen_tpu_torch/nemesis", "jepsen_tpu_torch/obs",
                "jepsen_tpu_torch/serve.py", "jepsen_tpu_torch/stream.py",
                "jepsen_tpu_torch/fleet.py",
                "jepsen_tpu_torch/checker/engine.py"),
    # a joint analysis: the acquisition graph spans modules
    "deadlock": ("jepsen_tpu_torch/serve.py", "jepsen_tpu_torch/stream.py",
                 "jepsen_tpu_torch/fleet.py",
                 "jepsen_tpu_torch/checker/engine.py",
                 "jepsen_tpu_torch/obs/observatory.py",
                 "jepsen_tpu_torch/obs/federation.py",
                 "jepsen_tpu_torch/obs/straggler.py"),
    "walcheck": ("jepsen_tpu_torch/serve.py", "jepsen_tpu_torch/stream.py",
                 "jepsen_tpu_torch/obs/federation.py",
                 "jepsen_tpu_torch/obs/straggler.py"),
}

PASSES = ("suite", "history", "width", "lockset", "deadlock", "walcheck",
          "plan")


def _expand(paths: Iterable[str], root: str) -> List[str]:
    out: List[str] = []
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isdir(ap):
            for name in sorted(os.listdir(ap)):
                if name.endswith(".py"):
                    out.append(os.path.join(ap, name))
        elif os.path.exists(ap):
            out.append(ap)
    return out


def lint_files(paths: Iterable[str], passes: Iterable[str] = PASSES,
               root: Optional[str] = None) -> List[Finding]:
    """Run the code passes over explicit files (.py) and history
    artifacts (.jsonl / .wal)."""
    from jepsen_tpu_torch.analysis import (
        deadlock_lint, history_lint, lockset_lint, suite_lint,
        walcheck_lint, width_lint,
    )
    root = root or repo_root()
    passes = tuple(passes)
    findings: List[Finding] = []
    code_files: List[str] = []
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        if not os.path.exists(ap):
            # a typo'd path must not read as "clean"
            findings.append(Finding(
                rule="LINT-MISSING-FILE", severity=ERROR,
                path=relpath(ap, root), line=0,
                message="no such file", anchor="missing"))
            continue
        if p.endswith((".jsonl", ".wal")):
            if "history" in passes:
                findings.extend(history_lint.lint_history_file(ap,
                                                               root=root))
            continue
        code_files.append(ap)
        if "suite" in passes:
            findings.extend(suite_lint.lint_file(ap, root=root))
        if "width" in passes:
            findings.extend(width_lint.lint_file(ap, root=root))
        if "lockset" in passes:
            findings.extend(lockset_lint.lint_file(ap, root=root))
    # joint passes see all named files at once
    if "deadlock" in passes and code_files:
        findings.extend(deadlock_lint.lint_paths(code_files, root=root))
    if "walcheck" in passes and code_files:
        findings.extend(walcheck_lint.lint_paths(code_files, root=root))
    return findings


def lint_repo(root: Optional[str] = None,
              passes: Iterable[str] = PASSES,
              histories: Iterable[str] = ()) -> List[Finding]:
    """Run every pass at its default scope over the repo; ``histories``
    adds saved history files (.jsonl/.wal) for the history pass."""
    from jepsen_tpu_torch.analysis import (
        deadlock_lint, history_lint, lockset_lint, suite_lint,
        walcheck_lint, width_lint,
    )
    root = root or repo_root()
    passes = tuple(passes)
    findings: List[Finding] = []
    if "suite" in passes:
        files = _expand(DEFAULT_SCOPES["suite"], root)
        findings.extend(suite_lint.lint_suites(files, root=root))
    if "width" in passes:
        for f in _expand(DEFAULT_SCOPES["width"], root):
            findings.extend(width_lint.lint_file(f, root=root))
    if "lockset" in passes:
        for f in _expand(DEFAULT_SCOPES["lockset"], root):
            findings.extend(lockset_lint.lint_file(f, root=root))
    if "deadlock" in passes:
        findings.extend(deadlock_lint.lint_paths(
            _expand(DEFAULT_SCOPES["deadlock"], root), root=root))
    if "walcheck" in passes:
        findings.extend(walcheck_lint.lint_paths(
            _expand(DEFAULT_SCOPES["walcheck"], root), root=root))
    if "history" in passes:
        for h in histories:
            ap = h if os.path.isabs(h) else os.path.join(root, h)
            findings.extend(history_lint.lint_history_file(ap, root=root))
    if "plan" in passes:
        # not file-scoped: the plan engine over the pinned matrix
        from jepsen_tpu_torch.analysis import plan_lint
        findings.extend(plan_lint.lint_matrix())
    return findings
