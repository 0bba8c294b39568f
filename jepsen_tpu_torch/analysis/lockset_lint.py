"""Lockset linter — a static race detector for the threaded stack.

Two engines share this pass:

**Legacy dict-key engine**. ``core.conj_op`` is THE
serialization point (core.clj:43-47): every worker, the nemesis
thread, and the WAL tee append through it under
``test["_history_lock"]``. The state that lock guards —
``test["_active_histories"]`` and ``test["_journal"]`` — must never be
touched off-lock while those threads can be live. Any access to a
guarded key outside a ``with <x>["_history_lock"]`` block is flagged.

**Generalized class engine**. For every class in scope the
pass auto-discovers its lock attributes (``self.x = threading.Lock()``
/ ``RLock()``; ``threading.Condition(self.x)`` aliases the wrapped
lock), then computes the lockset held at every ``self.attr`` access:
lexically from ``with self.<lock>:`` regions, and inter-procedurally
for private helpers via the intra-class call graph (a helper's entry
lockset is the intersection of the locksets held at its ``self.m()``
call sites — ``__init__`` call sites excluded, construction happens
before threads exist). An attribute counts as *guarded* by lock L when
it is annotated ``# guarded-by: L`` on its assignment line, or when
inference finds at least :data:`MIN_LOCKED` accesses under L making up
at least :data:`GUARD_RATIO` of its non-lifecycle accesses.
``# guarded-by: none`` opts an attribute out entirely.

==========================  ========  =================================
rule                        severity  what it catches
==========================  ========  =================================
LOCK-UNGUARDED              error     off-lock access to a guarded
                                      attribute (or, legacy engine,
                                      guarded dict key) outside any
                                      lifecycle method
LOCK-INCONSISTENT           warning   access under the *wrong* lock;
                                      off-lock mutation of an attribute
                                      that is mostly-but-not-majority
                                      locked; ``# guarded-by:`` naming
                                      an unknown lock
LOCK-LIFECYCLE              warning   off-lock access from a lifecycle
                                      method (``stop``/``close``/
                                      ``drain``/…) — racy unless the
                                      call site can prove no other
                                      thread is live
LINT-SYNTAX                 error     the module does not parse
==========================  ========  =================================

``__init__`` accesses are exempt (publishing fresh state before
threads exist is the construction pattern), as are accesses through
non-``self`` receivers (``s = cls.__new__(cls); s.ops = …`` replay
idioms run single-threaded by contract).

The port's copy of ``jepsen_tpu.analysis.lockset_lint``.
"""

from __future__ import annotations

import ast
from collections import defaultdict
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from jepsen_tpu_torch.analysis import ERROR, Finding, WARNING
from jepsen_tpu_torch.analysis.astutil import (
    canon_lock, class_locks, class_methods, guarded_by_lines, parent_map,
    parse_file, read_source, scope_map, self_attr, snippet,
)

#: Keys of test-map state serialized by the history lock (legacy engine).
GUARDED_KEYS = ("_active_histories", "_journal")

LOCK_KEY = "_history_lock"

#: Inference bar: an attribute is guarded by L when >= MIN_LOCKED of
#: its counted accesses hold L and they make up >= GUARD_RATIO of all
#: counted accesses.
MIN_LOCKED = 2
GUARD_RATIO = 0.7

#: Method calls that mutate their receiver — an off-lock
#: ``self.x.append(...)`` is a write race, not a read race.
MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "add", "update",
    "setdefault", "pop", "popleft", "popitem", "remove", "discard",
    "clear", "sort", "reverse", "rotate", "move_to_end", "write",
})

#: Methods where off-lock access downgrades to LOCK-LIFECYCLE: they
#: run at the edges of the object's life where single-threadedness is
#: plausible but unproven.
_LIFECYCLE_PREFIXES = ("stop", "close", "shutdown", "drain", "teardown",
                       "start", "join")
_LIFECYCLE_NAMES = frozenset({"__del__", "__exit__", "__enter__"})


def _is_lifecycle(method: str) -> bool:
    if method in _LIFECYCLE_NAMES:
        return True
    return method.lstrip("_").startswith(_LIFECYCLE_PREFIXES)


# ---------------------------------------------------------------------------
# legacy dict-key engine (core.py / journal.py / nemesis)

def _const(node: ast.AST):
    return node.value if isinstance(node, ast.Constant) else None


def _is_lock_ctx(expr: ast.AST) -> bool:
    """Does a with-item context expression acquire the history lock?
    Matches ``<x>["_history_lock"]`` and ``<x>.get("_history_lock")``."""
    if isinstance(expr, ast.Subscript) and _const(expr.slice) == LOCK_KEY:
        return True
    if isinstance(expr, ast.Call) and \
            isinstance(expr.func, ast.Attribute) and \
            expr.func.attr == "get" and expr.args and \
            _const(expr.args[0]) == LOCK_KEY:
        return True
    return False


def _guarded_ids(tree: ast.Module) -> Set[int]:
    """ids of all nodes lexically inside a history-lock with-block."""
    out: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                _is_lock_ctx(item.context_expr) for item in node.items):
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    out.add(id(sub))
    return out


def _lint_dict_keys(tree: ast.Module, rp: str,
                    scopes: Dict[ast.AST, str]) -> List[Finding]:
    guarded = _guarded_ids(tree)
    findings: List[Finding] = []

    # Assignment targets that create a key are initialization.
    init_targets: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    init_targets.add(id(t))
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and \
                isinstance(node.target, ast.Subscript):
            init_targets.add(id(node.target))

    def add(rule, sev, node, key, what):
        findings.append(Finding(
            rule=rule, severity=sev, path=rp, line=node.lineno,
            col=node.col_offset,
            message=f"{what} of lock-guarded {key!r} outside a "
                    f"'with ...[\"{LOCK_KEY}\"]' block",
            anchor=f"{scopes.get(node, '')}/{snippet(node)}"))

    for node in ast.walk(tree):
        if id(node) in guarded:
            continue
        if isinstance(node, ast.Subscript):
            key = _const(node.slice)
            if key in GUARDED_KEYS and id(node) not in init_targets:
                add("LOCK-UNGUARDED", ERROR, node, key, "access")
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and node.args:
            key = _const(node.args[0])
            if key not in GUARDED_KEYS:
                continue
            attr = node.func.attr
            if attr in ("setdefault", "pop"):
                add("LOCK-LIFECYCLE", WARNING, node, key,
                    f"{attr}()")
            elif attr == "get":
                add("LOCK-UNGUARDED", ERROR, node, key, "get()")
    return findings


# ---------------------------------------------------------------------------
# generalized class engine

class _Access:
    __slots__ = ("attr", "node", "method", "mutation", "held", "lifecycle")

    def __init__(self, attr, node, method, mutation, held, lifecycle):
        self.attr = attr
        self.node = node
        self.method = method
        self.mutation = mutation
        self.held = held
        self.lifecycle = lifecycle


def _walk_held(node: ast.AST, held: FrozenSet[str],
               held_out: Dict[int, FrozenSet[str]],
               calls: List[Tuple[str, FrozenSet[str]]],
               locks: Set[str], alias: Dict[str, str]) -> None:
    """Record the lexical lockset held at every node under ``node``.
    Nested functions execute later (possibly on another thread), so
    their bodies restart from the empty lockset."""
    held_out[id(node)] = held
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.Lambda)):
        for child in ast.iter_child_nodes(node):
            _walk_held(child, frozenset(), held_out, calls, locks, alias)
        return
    if isinstance(node, (ast.With, ast.AsyncWith)):
        acquired: Set[str] = set()
        for item in node.items:
            a = self_attr(item.context_expr)
            if a is not None:
                c = canon_lock(a, alias)
                if c in locks:
                    acquired.add(c)
            _walk_held(item, held, held_out, calls, locks, alias)
        inner = held | acquired
        for stmt in node.body:
            _walk_held(stmt, inner, held_out, calls, locks, alias)
        return
    if isinstance(node, ast.Call) and \
            isinstance(node.func, ast.Attribute) and \
            isinstance(node.func.value, ast.Name) and \
            node.func.value.id == "self":
        calls.append((node.func.attr, held))
    for child in ast.iter_child_nodes(node):
        _walk_held(child, held, held_out, calls, locks, alias)


def _method_held_maps(methods: Dict[str, ast.FunctionDef],
                      locks: Set[str], alias: Dict[str, str]
                      ) -> Dict[str, Dict[int, FrozenSet[str]]]:
    """Fixpoint over the intra-class call graph: a private helper's
    entry lockset is the intersection of locksets held at its
    ``self.m()`` call sites (``__init__`` sites excluded)."""
    entry: Dict[str, FrozenSet[str]] = {n: frozenset() for n in methods}
    held_maps: Dict[str, Dict[int, FrozenSet[str]]] = {}
    for _ in range(4):
        callsites: Dict[str, List[FrozenSet[str]]] = defaultdict(list)
        for name, fn in methods.items():
            out: Dict[int, FrozenSet[str]] = {}
            calls: List[Tuple[str, FrozenSet[str]]] = []
            for child in ast.iter_child_nodes(fn):
                _walk_held(child, entry[name], out, calls, locks, alias)
            held_maps[name] = out
            if name != "__init__":
                for callee, held in calls:
                    callsites[callee].append(held)
        new_entry: Dict[str, FrozenSet[str]] = {}
        for name in methods:
            sites = callsites.get(name)
            if sites and name.startswith("_") and not name.startswith("__"):
                inter = sites[0]
                for s in sites[1:]:
                    inter = inter & s
                new_entry[name] = inter
            else:
                new_entry[name] = frozenset()
        if new_entry == entry:
            break
        entry = new_entry
    return held_maps


def _is_mutation(node: ast.Attribute, parents: Dict[int, ast.AST]) -> bool:
    if isinstance(node.ctx, (ast.Store, ast.Del)):
        return True
    parent = parents.get(id(node))
    if isinstance(parent, ast.Subscript) and parent.value is node and \
            isinstance(parent.ctx, (ast.Store, ast.Del)):
        return True
    if isinstance(parent, ast.Attribute) and parent.value is node and \
            parent.attr in MUTATORS:
        gp = parents.get(id(parent))
        if isinstance(gp, ast.Call) and gp.func is parent:
            return True
    return False


def _collect_accesses(cls: ast.ClassDef,
                      methods: Dict[str, ast.FunctionDef],
                      held_maps: Dict[str, Dict[int, FrozenSet[str]]],
                      locks: Set[str], alias: Dict[str, str],
                      parents: Dict[int, ast.AST]) -> List[_Access]:
    out: List[_Access] = []
    for name, fn in methods.items():
        if name == "__init__":
            continue
        held = held_maps[name]
        life = _is_lifecycle(name)
        for node in ast.walk(fn):
            a = self_attr(node) if isinstance(node, ast.Attribute) else None
            if a is None:
                continue
            if canon_lock(a, alias) in locks or a in alias:
                continue
            out.append(_Access(a, node, name, _is_mutation(node, parents),
                               held.get(id(node), frozenset()), life))
    return out


def _annotated_attrs(cls: ast.ClassDef,
                     ann_lines: Dict[int, str]) -> Dict[str, Tuple[str, int]]:
    """attr -> (lock-name-or-'none', annotation line): ``# guarded-by:``
    annotations attach to the ``self.attr = ...`` line they trail, or
    to the line directly above it (for assignments too long to share
    a line with the comment)."""
    out: Dict[str, Tuple[str, int]] = {}
    for node in ast.walk(cls):
        if not isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            continue
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            a = self_attr(t)
            if a is None:
                continue
            for ln in (node.lineno, node.lineno - 1):
                if ln in ann_lines:
                    out[a] = (ann_lines[ln], ln)
                    break
    return out


def _lint_class(cls: ast.ClassDef, rp: str, scopes: Dict[ast.AST, str],
                ann_lines: Dict[int, str],
                parents: Dict[int, ast.AST]) -> List[Finding]:
    locks, alias = class_locks(cls)
    if not locks:
        return []
    methods = class_methods(cls)
    held_maps = _method_held_maps(methods, locks, alias)
    accesses = _collect_accesses(cls, methods, held_maps, locks, alias,
                                 parents)
    annotated = _annotated_attrs(cls, ann_lines)
    findings: List[Finding] = []

    def add(rule, sev, node, msg):
        findings.append(Finding(
            rule=rule, severity=sev, path=rp, line=node.lineno,
            col=node.col_offset, message=msg,
            anchor=f"{scopes.get(node, '')}/{snippet(node)}"))

    by_attr: Dict[str, List[_Access]] = defaultdict(list)
    for acc in accesses:
        by_attr[acc.attr].append(acc)

    for attr, accs in sorted(by_attr.items()):
        # counted accesses drive inference: lifecycle methods run at
        # the thread-free edges, so they neither vote for nor against
        counted = [a for a in accs if not a.lifecycle]
        locked_n: Dict[str, int] = defaultdict(int)
        for a in counted:
            for lk in a.held:
                locked_n[lk] += 1
        guard: Optional[str] = None
        if attr in annotated:
            name, line = annotated[attr]
            if name == "none":
                continue
            c = canon_lock(name, alias)
            if c not in locks:
                add("LOCK-INCONSISTENT", WARNING, cls,
                    f"{cls.name}.{attr}: '# guarded-by: {name}' names an "
                    f"unknown lock (line {line}); discovered locks: "
                    f"{sorted(locks)}")
                continue
            guard = c
        elif locked_n:
            best = max(locked_n, key=lambda k: locked_n[k])
            n = locked_n[best]
            if n >= MIN_LOCKED and counted and n / len(counted) >= GUARD_RATIO:
                guard = best

        if guard is not None:
            for a in accs:
                if guard in a.held:
                    continue
                what = "mutation" if a.mutation else "read"
                if a.held:
                    add("LOCK-INCONSISTENT", WARNING, a.node,
                        f"{cls.name}.{attr} is guarded by "
                        f"'self.{guard}' but this {what} in {a.method}() "
                        f"holds {sorted(a.held)}")
                elif a.lifecycle:
                    add("LOCK-LIFECYCLE", WARNING, a.node,
                        f"off-lock {what} of '{guard}'-guarded "
                        f"{cls.name}.{attr} in lifecycle method "
                        f"{a.method}() — safe only if no other thread "
                        f"is live")
                else:
                    add("LOCK-UNGUARDED", ERROR, a.node,
                        f"{what} of '{guard}'-guarded {cls.name}.{attr} "
                        f"in {a.method}() without the lock")
        elif attr not in annotated and locked_n and \
                max(locked_n.values()) >= MIN_LOCKED:
            # below the inference bar, but mostly-locked: off-lock
            # MUTATIONS are still suspicious (lost updates); off-lock
            # reads of e.g. a draining flag are the accepted fast path
            best = max(locked_n, key=lambda k: locked_n[k])
            for a in counted:
                if a.mutation and not a.held:
                    add("LOCK-INCONSISTENT", WARNING, a.node,
                        f"off-lock mutation of {cls.name}.{attr} in "
                        f"{a.method}(), which is accessed under "
                        f"'self.{best}' elsewhere")
    return findings


def lint_file(path: str, root: Optional[str] = None) -> List[Finding]:
    tree, err, rp = parse_file(path, root)
    if tree is None:
        return [err]
    scopes = scope_map(tree)
    findings = _lint_dict_keys(tree, rp, scopes)
    src = read_source(path)
    ann_lines = guarded_by_lines(src) if src else {}
    parents = parent_map(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            findings.extend(_lint_class(node, rp, scopes, ann_lines,
                                        parents))
    return findings
