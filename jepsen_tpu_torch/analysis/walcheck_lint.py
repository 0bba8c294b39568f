"""Crash-consistency linter for the serve/stream intake paths.

The daemon's durability contract: a client that sees a success
acknowledgement (an HTTP 202, a ``done`` record) must find its request
again after a crash. That holds only if a WAL append *dominates* the
ack on every control-flow path, and only if artifacts appear in the
run dir atomically (tmp + ``os.replace``) under names the dir scanners
ignore until published.

The pass runs a statement-level dominance dataflow per function:
``journaled`` becomes true after a statement that (transitively) calls
a journal append — ``*.journal.append(...)``, ``self._journal(...)``,
``self._wal.write(...)``, or a constructor/helper that does — and
``replaced`` after a statement that reaches ``os.replace``. Branch
merge is intersection ("on every path"), except branches whose test
mentions ``replay``: a replayed request was journaled by a previous
incarnation, so the replay arm unions (documented exemption). Returns
whose value contains a duplicate marker (a dict literal with a
``"duplicate"`` key) are idempotent re-acks of already-journaled work
and exempt.

==========================  ========  =================================
rule                        severity  what it catches
==========================  ========  =================================
WAL-ACK-BEFORE-JOURNAL      error     a 202-tuple return, or a journal
                                      record with ``event`` of
                                      ``done``/``verdict``, reachable
                                      with no dominating WAL append
                                      (for done/verdict: no dominating
                                      ``os.replace`` — the ack must
                                      follow the artifact publish)
ATOMIC-WRITE-DIRECT         warning   ``open(path, "w"/"wb")`` whose
                                      path expression has no tmp step
                                      — a crash mid-write leaves a torn
                                      artifact under the final name
                                      (append-mode WALs are exempt)
ATOMIC-TMP-SCANNED          warning   a tmp filename built without a
                                      dot prefix in a module that scans
                                      directories — ``os.listdir``
                                      replay/GC would pick up the torn
                                      tmp file as a real artifact
LINT-SYNTAX                 error     the module does not parse
==========================  ========  =================================

The port's copy of ``jepsen_tpu.analysis.walcheck_lint``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from jepsen_tpu_torch.analysis import ERROR, Finding, WARNING
from jepsen_tpu_torch.analysis.astutil import (
    dotted, parse_file, scope_map, snippet,
)

#: Call tails that journal durably (direct evidence).
_JOURNAL_RECV_HINTS = ("journal", "wal")

#: Function names whose call sites count as journaling.
_JOURNAL_FN_NAMES = ("_journal",)

#: Dir-scanning calls: their presence makes stray tmp names dangerous.
_SCAN_TAILS = frozenset({"listdir", "scandir", "iterdir", "glob"})

#: Journal events that acknowledge completion: these must follow the
#: artifact publish (os.replace) on the same path.
_DONE_EVENTS = ("done", "verdict")


def _is_journal_call(call: ast.Call, journal_fns: Set[str]) -> bool:
    f = call.func
    if isinstance(f, ast.Attribute):
        recv = dotted(f.value).lower()
        if f.attr in ("append", "write") and any(
                h in recv for h in _JOURNAL_RECV_HINTS):
            return True
        if f.attr in journal_fns:
            return True
    elif isinstance(f, ast.Name) and f.id in journal_fns:
        return True
    return False


def _is_replace_call(call: ast.Call, replace_fns: Set[str]) -> bool:
    d = dotted(call.func)
    tail = d.rsplit(".", 1)[-1] if d else ""
    return tail == "replace" and d.startswith("os") or tail in replace_fns


def _fn_defs(tree: ast.Module) -> Dict[str, ast.AST]:
    """name -> def node for module functions, class methods, and class
    constructors (``ClassName`` counts as its ``__init__``)."""
    out: Dict[str, ast.AST] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.setdefault(m.name, m)
                    if m.name == "__init__":
                        out[node.name] = m
    return out


def _closure(trees: List[ast.Module], seeds: Set[str],
             direct_test) -> Set[str]:
    """Names of functions that (transitively) perform the seeded
    behaviour, across ALL scanned files at once (``serve.py`` acks 202
    relying on ``stream.StreamSession.__init__`` journaling the open
    record). ``direct_test(call, acc)`` says a call is direct
    evidence; a call to an already-marked name propagates."""
    defs: Dict[str, ast.AST] = {}
    for tree in trees:
        for name, fn in _fn_defs(tree).items():
            defs.setdefault(name, fn)
    marked = set(seeds)
    changed = True
    while changed:
        changed = False
        for name, fn in defs.items():
            if name in marked:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                d = dotted(node.func)
                tail = d.rsplit(".", 1)[-1] if d else ""
                if direct_test(node, marked) or tail in marked:
                    marked.add(name)
                    changed = True
                    break
    return marked


class _State:
    __slots__ = ("journaled", "replaced")

    def __init__(self, journaled=False, replaced=False):
        self.journaled = journaled
        self.replaced = replaced

    def copy(self):
        return _State(self.journaled, self.replaced)

    def merge_all_paths(self, other):
        self.journaled = self.journaled and other.journaled
        self.replaced = self.replaced and other.replaced

    def merge_any_path(self, other):
        self.journaled = self.journaled or other.journaled
        self.replaced = self.replaced or other.replaced


def _returns_202(node: ast.Return) -> bool:
    v = node.value
    if isinstance(v, ast.Tuple) and v.elts:
        first = v.elts[0]
        return isinstance(first, ast.Constant) and first.value == 202
    return False


def _has_duplicate_marker(node: ast.Return) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Dict):
            for k in sub.keys:
                if isinstance(k, ast.Constant) and k.value == "duplicate":
                    return True
        if isinstance(sub, ast.Constant) and sub.value == "duplicate":
            return True
    return False


def _done_event(call: ast.Call) -> Optional[str]:
    """The ``done``/``verdict`` event name when this call journals a
    completion record (a dict argument with ``"event": "done"`` etc.)."""
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        for sub in ast.walk(arg):
            if not isinstance(sub, ast.Dict):
                continue
            for k, v in zip(sub.keys, sub.values):
                if isinstance(k, ast.Constant) and k.value == "event" and \
                        isinstance(v, ast.Constant) and \
                        v.value in _DONE_EVENTS:
                    return v.value
    return None


class _FnChecker:
    def __init__(self, rp, scopes, journal_fns, replace_fns, findings):
        self.rp = rp
        self.scopes = scopes
        self.journal_fns = journal_fns
        self.replace_fns = replace_fns
        self.findings = findings

    def add(self, node, msg):
        self.findings.append(Finding(
            rule="WAL-ACK-BEFORE-JOURNAL", severity=ERROR, path=self.rp,
            line=node.lineno, col=node.col_offset, message=msg,
            anchor=f"{self.scopes.get(node, '')}/{snippet(node)}"))

    def scan_stmt_effects(self, stmt: ast.stmt, st: _State) -> None:
        """Update state with the journal/replace effects of one
        statement's expressions (no recursion into sub-statements)."""
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                if _is_journal_call(node, self.journal_fns):
                    st.journaled = True
                if _is_replace_call(node, self.replace_fns):
                    st.replaced = True

    def check_acks(self, stmt: ast.stmt, st: _State) -> None:
        if isinstance(stmt, ast.Return) and _returns_202(stmt):
            if _has_duplicate_marker(stmt):
                return
            if not st.journaled:
                self.add(stmt, "202 acknowledged with no dominating WAL "
                               "append on this path — a crash after the "
                               "ack loses the request")
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) and \
                    _is_journal_call(node, self.journal_fns):
                ev = _done_event(node)
                if ev and not st.replaced:
                    self.add(node,
                             f"'{ev}' record journaled with no dominating "
                             f"os.replace on this path — the record "
                             f"acknowledges an artifact that may not "
                             f"have been published")

    def run_body(self, body: List[ast.stmt], st: _State) -> None:
        for stmt in body:
            self.run_stmt(stmt, st)

    def run_stmt(self, stmt: ast.stmt, st: _State) -> None:
        if isinstance(stmt, ast.If):
            s_then = st.copy()
            s_else = st.copy()
            # the test itself evaluates first (rarely journals)
            self.run_body(stmt.body, s_then)
            self.run_body(stmt.orelse, s_else)
            replay = "replay" in snippet(stmt.test, limit=200).lower()
            if replay:
                st.merge_any_path(s_then)
                st.merge_any_path(s_else)
            else:
                merged = s_then
                merged.merge_all_paths(s_else)
                st.journaled = merged.journaled
                st.replaced = merged.replaced
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self.scan_expr(item.context_expr, st)
            self.run_body(stmt.body, st)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            s_loop = st.copy()
            self.run_body(stmt.body, s_loop)
            self.run_body(stmt.orelse, st)
            # zero-iteration path: state unchanged
            return
        if isinstance(stmt, ast.Try):
            s_body = st.copy()
            self.run_body(stmt.body, s_body)
            for h in stmt.handlers:
                # handlers run from an unknown point: conservative —
                # only what held at try entry is guaranteed
                s_h = st.copy()
                self.run_body(h.body, s_h)
            st.journaled = s_body.journaled
            st.replaced = s_body.replaced
            self.run_body(stmt.finalbody, st)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            # nested defs execute later; analyzed separately
            return
        self.check_acks(stmt, st)
        self.scan_stmt_effects(stmt, st)

    def scan_expr(self, expr: ast.AST, st: _State) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                if _is_journal_call(node, self.journal_fns):
                    st.journaled = True
                if _is_replace_call(node, self.replace_fns):
                    st.replaced = True


def _module_scans_dirs(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            d = dotted(node.func)
            if d.rsplit(".", 1)[-1] in _SCAN_TAILS:
                return True
    return False


def _tmp_name_findings(tree: ast.Module, rp: str,
                       scopes: Dict[ast.AST, str]) -> List[Finding]:
    if not _module_scans_dirs(tree):
        return []
    out: List[Finding] = []

    def flag(node):
        out.append(Finding(
            rule="ATOMIC-TMP-SCANNED", severity=WARNING, path=rp,
            line=node.lineno, col=node.col_offset,
            message="tmp filename is not dot-prefixed in a module that "
                    "scans directories — replay/GC may treat a torn tmp "
                    "file as a real artifact",
            anchor=f"{scopes.get(node, '')}/{snippet(node)}"))

    for node in ast.walk(tree):
        if isinstance(node, ast.JoinedStr):
            text = "".join(v.value for v in node.values
                           if isinstance(v, ast.Constant)
                           and isinstance(v.value, str))
            if ".tmp" not in text and "tmp." not in text:
                continue
            first = node.values[0] if node.values else None
            dot_prefixed = (isinstance(first, ast.Constant) and
                            isinstance(first.value, str) and
                            first.value.startswith("."))
            if not dot_prefixed:
                flag(node)
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            right = node.right
            if isinstance(right, ast.Constant) and \
                    isinstance(right.value, str) and \
                    ".tmp" in right.value:
                flag(node)
    return out


def _atomic_write_findings(tree: ast.Module, rp: str,
                           scopes: Dict[ast.AST, str]) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and
                isinstance(node.func, ast.Name) and
                node.func.id == "open" and len(node.args) >= 2):
            continue
        mode = node.args[1]
        if not (isinstance(mode, ast.Constant) and
                isinstance(mode.value, str)):
            continue
        if "w" not in mode.value and "x" not in mode.value:
            continue  # read or append ("a" is the WAL idiom)
        path_src = snippet(node.args[0], limit=200).lower()
        if "tmp" in path_src:
            continue
        out.append(Finding(
            rule="ATOMIC-WRITE-DIRECT", severity=WARNING, path=rp,
            line=node.lineno, col=node.col_offset,
            message=f"direct write to {snippet(node.args[0])!r} without a "
                    f"tmp + os.replace step — a crash mid-write leaves a "
                    f"torn artifact under the final name",
            anchor=f"{scopes.get(node, '')}/{snippet(node)}"))
    return out


def lint_paths(paths: List[str], root: Optional[str] = None
               ) -> List[Finding]:
    findings: List[Finding] = []
    parsed = []
    for path in paths:
        tree, err, rp = parse_file(path, root)
        if tree is None:
            findings.append(err)
            continue
        parsed.append((tree, rp))
    if not parsed:
        return findings

    trees = [t for t, _ in parsed]
    journal_fns = _closure(
        trees, set(_JOURNAL_FN_NAMES),
        lambda call, acc: _is_journal_call(call, acc))
    replace_fns = _closure(
        trees, set(),
        lambda call, acc: _is_replace_call(call, acc))

    for tree, rp in parsed:
        scopes = scope_map(tree)
        checker = _FnChecker(rp, scopes, journal_fns, replace_fns,
                             findings)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                checker.run_body(node.body, _State())
        findings.extend(_atomic_write_findings(tree, rp, scopes))
        findings.extend(_tmp_name_findings(tree, rp, scopes))
    return findings


def lint_file(path: str, root: Optional[str] = None) -> List[Finding]:
    return lint_paths([path], root)
