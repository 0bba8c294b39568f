"""Small AST helpers shared by the code-analysis passes.

The port's copy of ``jepsen_tpu.analysis.astutil``.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Optional, Set, Tuple

from jepsen_tpu_torch.analysis import ERROR, Finding, relpath


def parse_file(path: str, root: Optional[str] = None
               ) -> Tuple[Optional[ast.Module], Optional[Finding], str]:
    """Parse a python file. Returns (tree, None, relpath) on success,
    (None, syntax-finding, relpath) on failure — unparsable code is
    itself a finding (rule LINT-SYNTAX), not a crash."""
    rp = relpath(path, root)
    try:
        with open(path, encoding="utf-8") as f:
            src = f.read()
    except OSError as e:
        return None, Finding(rule="LINT-SYNTAX", severity=ERROR, path=rp,
                             line=0, message=f"unreadable: {e}",
                             anchor="unreadable"), rp
    try:
        return ast.parse(src, filename=path), None, rp
    except SyntaxError as e:
        return None, Finding(rule="LINT-SYNTAX", severity=ERROR, path=rp,
                             line=e.lineno or 0,
                             message=f"syntax error: {e.msg}",
                             anchor="syntax"), rp


def scope_map(tree: ast.Module) -> Dict[ast.AST, str]:
    """node -> qualname of the innermost enclosing function/class scope
    ('' at module level). Drives line-number-independent anchors."""
    scopes: Dict[ast.AST, str] = {}

    def walk(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            scopes[child] = prefix
            p = prefix
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                p = f"{prefix}.{child.name}" if prefix else child.name
            walk(child, p)

    walk(tree, "")
    return scopes


def dotted(func: ast.AST) -> str:
    """Best-effort dotted name of a call target: Name 'f' -> 'f',
    Attribute chains 'a.b.c' -> 'a.b.c', anything else -> ''."""
    parts = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    if parts:  # e.g. <call>.attr — keep the attr tail
        return "." + ".".join(reversed(parts))
    return ""


def snippet(node: ast.AST, limit: int = 60) -> str:
    """Compact normalized source of a node, for baseline anchors."""
    try:
        s = ast.unparse(node)
    except Exception:  # noqa: BLE001 — very old/odd nodes
        s = type(node).__name__
    s = " ".join(s.split())
    return s[:limit]


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def keyword_arg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def read_source(path: str) -> Optional[str]:
    """The file's source text, or None when unreadable (the caller has
    already turned that into a LINT-SYNTAX finding via parse_file)."""
    try:
        with open(path, encoding="utf-8") as f:
            return f.read()
    except OSError:
        return None


def self_attr(node: ast.AST) -> Optional[str]:
    """'attr' when node is exactly ``self.attr``, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


#: Constructor tails that create a mutual-exclusion object.
LOCK_CTORS = ("Lock", "RLock")


def class_locks(cls: ast.ClassDef) -> Tuple[Set[str], Dict[str, str]]:
    """Discover a class's lock attributes and condition aliases.

    Returns ``(locks, alias)`` where ``locks`` is the set of ``self``
    attribute names bound to ``threading.Lock()`` / ``RLock()`` (or a
    bare ``Condition()``, which owns its lock), and ``alias`` maps a
    ``Condition(self.x)`` attribute to the lock attribute it wraps —
    ``with self.cond:`` and ``with self.x:`` are the same acquisition.
    """
    locks: Set[str] = set()
    alias: Dict[str, str] = {}
    for node in ast.walk(cls):
        if not (isinstance(node, ast.Assign) and
                isinstance(node.value, ast.Call)):
            continue
        tail = dotted(node.value.func).rsplit(".", 1)[-1]
        for t in node.targets:
            a = self_attr(t)
            if a is None:
                continue
            if tail in LOCK_CTORS:
                locks.add(a)
            elif tail == "Condition":
                arg = node.value.args[0] if node.value.args else None
                wrapped = self_attr(arg) if arg is not None else None
                if wrapped:
                    alias[a] = wrapped
                else:
                    locks.add(a)
    return locks, alias


def canon_lock(attr: str, alias: Dict[str, str]) -> str:
    """Resolve condition-alias chains to the canonical lock attribute."""
    seen: Set[str] = set()
    while attr in alias and attr not in seen:
        seen.add(attr)
        attr = alias[attr]
    return attr


GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*|none)")


def guarded_by_lines(src: str) -> Dict[int, str]:
    """1-based line number -> lock name for every ``# guarded-by: x``
    trailing annotation in the source (``none`` opts an attribute out
    of lockset inference)."""
    out: Dict[int, str] = {}
    for i, line in enumerate(src.splitlines(), start=1):
        m = GUARDED_BY_RE.search(line)
        if m:
            out[i] = m.group(1)
    return out


def parent_map(tree: ast.Module) -> Dict[int, ast.AST]:
    """id(child) -> parent node, for upward pattern matching."""
    out: Dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[id(child)] = node
    return out


def class_methods(cls: ast.ClassDef
                  ) -> Dict[str, ast.FunctionDef]:
    """name -> FunctionDef for the class's direct methods (nested
    classes and their methods are not included)."""
    return {m.name: m for m in cls.body
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}


def self_call_name(call: ast.Call) -> Optional[str]:
    """'m' when the call is exactly ``self.m(...)``, else None — the
    intra-class call-graph edge used for inter-procedural locksets."""
    if isinstance(call.func, ast.Attribute) and \
            isinstance(call.func.value, ast.Name) and \
            call.func.value.id == "self":
        return call.func.attr
    return None
