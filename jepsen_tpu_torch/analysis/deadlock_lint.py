"""Deadlock linter — lock-order cycles and locks held across blocking
operations, over the whole serving scope at once.

The pass builds a joint lock-acquisition graph across every file in
scope. Lock nodes are ``Class.attr`` (from :func:`astutil.class_locks`
discovery, condition aliases canonicalized) and module-level
``module.NAME`` locks. Edges come from lexically nested ``with``
blocks and, inter-procedurally, from calls made while a lock is held
into functions whose transitive acquisition set is known — including
cross-class calls resolved through ``self.attr = ClassName(...)``
constructor assignments and unique lock-attribute names (``d._work``
resolves to ``CheckDaemon._lock`` because ``_work`` names exactly one
discovered condition).

==========================  ========  =================================
rule                        severity  what it catches
==========================  ========  =================================
LOCK-ORDER-CYCLE            error     a cycle in the acquisition graph
                                      — two threads interleaving those
                                      paths deadlock
LOCK-HELD-BLOCKING          warning   a lock held across a blocking
                                      operation: device calls, fsync,
                                      sleeps, socket/HTTP sends,
                                      ``Thread.join``, subprocess waits
LINT-SYNTAX                 error     a module does not parse
==========================  ========  =================================

``Condition.wait()`` on the condition wrapping a held lock is *not*
blocking-while-held — wait releases the lock — and is skipped when the
receiver resolves to an alias of a lock in the held set.

The port's copy of ``jepsen_tpu.analysis.deadlock_lint``; a CUDA
``synchronize`` blocks as a device transfer does.
"""

from __future__ import annotations

import ast
import os
from collections import defaultdict
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from jepsen_tpu_torch.analysis import ERROR, Finding, WARNING
from jepsen_tpu_torch.analysis.astutil import (
    canon_lock, class_locks, class_methods, const_str, dotted, parse_file,
    scope_map, self_attr, snippet,
)

#: Dotted-prefix call targets that block the calling thread.
_BLOCKING_PREFIXES = ("os.fsync", "time.sleep", "subprocess.", "socket.",
                      "urllib.", "requests.", "shutil.")

#: Method tails that block regardless of receiver.
_BLOCKING_TAILS = frozenset({
    "fsync", "communicate", "sendall", "sendto", "recv", "recvfrom",
    "accept", "connect", "urlopen", "getresponse", "block_until_ready",
    "device_get", "device_put", "synchronize",
})

#: Repo device entry points: a packed check occupies the accelerator
#: for the whole escalation ladder.
_DEVICE_PREFIX = "check_packed"

LockNode = Tuple[str, str]          # (owner, attr) e.g. ("CheckDaemon", "_lock")
FnKey = Tuple[str, Optional[str], str]   # (relpath, class or None, fn name)


class _FnInfo:
    __slots__ = ("node", "cls", "rp", "acquires", "blocking", "calls")

    def __init__(self, node, cls, rp):
        self.node = node
        self.cls = cls          # class name or None
        self.rp = rp
        self.acquires: Set[LockNode] = set()
        # (ast node, description, lexically-held frozenset)
        self.blocking: List[Tuple[ast.AST, str, FrozenSet[LockNode]]] = []
        # (callee FnKey, held-at-site, call node)
        self.calls: List[Tuple[FnKey, FrozenSet[LockNode], ast.AST]] = []


class _Scope:
    """Everything discovered about the files under analysis."""

    def __init__(self):
        self.classes: Dict[str, ast.ClassDef] = {}
        self.class_rp: Dict[str, str] = {}
        self.locks: Dict[str, Set[str]] = {}       # class -> lock attrs
        self.alias: Dict[str, Dict[str, str]] = {}  # class -> cond aliases
        self.module_locks: Dict[str, Set[str]] = {}  # rp -> NAMEs
        self.fns: Dict[FnKey, _FnInfo] = {}
        self.attr_types: Dict[Tuple[str, str], str] = {}  # (cls, attr) -> cls
        # lock/alias attr name -> {(class, canonical lock attr)}
        self.attr_owners: Dict[str, Set[Tuple[str, str]]] = defaultdict(set)


def _module_locks(tree: ast.Module) -> Set[str]:
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            tail = dotted(node.value.func).rsplit(".", 1)[-1]
            if tail in ("Lock", "RLock", "Condition"):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
    return out


def _discover(trees: List[Tuple[ast.Module, str]]) -> _Scope:
    sc = _Scope()
    for tree, rp in trees:
        sc.module_locks[rp] = _module_locks(tree)
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                sc.classes[node.name] = node
                sc.class_rp[node.name] = rp
                locks, alias = class_locks(node)
                sc.locks[node.name] = locks
                sc.alias[node.name] = alias
                for a in locks:
                    sc.attr_owners[a].add((node.name, a))
                for a in alias:
                    c = canon_lock(a, alias)
                    if c in locks:
                        sc.attr_owners[a].add((node.name, c))
                for name, fn in class_methods(node).items():
                    sc.fns[(rp, node.name, name)] = _FnInfo(fn, node.name, rp)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                sc.fns[(rp, None, node.name)] = _FnInfo(node, None, rp)
    # attr -> class typing, from constructor assignments and the
    # attr-name-matches-class heuristic (self.engine -> Engine)
    lowered = {c.lower(): c for c in sc.classes}
    for tree, rp in trees:
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Assign) and
                    isinstance(node.value, ast.Call)):
                continue
            tail = dotted(node.value.func).rsplit(".", 1)[-1]
            for t in node.targets:
                a = self_attr(t)
                if a is None:
                    continue
                owner = _enclosing_class(tree, node)
                if owner is None:
                    continue
                if tail in sc.classes:
                    sc.attr_types[(owner, a)] = tail
                elif a.lstrip("_").lower() in lowered:
                    sc.attr_types[(owner, a)] = lowered[a.lstrip("_").lower()]
    return sc


_ENCLOSING_CACHE: Dict[int, Dict[int, str]] = {}


def _enclosing_class(tree: ast.Module, target: ast.AST) -> Optional[str]:
    cache = _ENCLOSING_CACHE.get(id(tree))
    if cache is None:
        cache = {}
        for cls in tree.body:
            if isinstance(cls, ast.ClassDef):
                for sub in ast.walk(cls):
                    cache[id(sub)] = cls.name
        _ENCLOSING_CACHE[id(tree)] = cache
    return cache.get(id(target))


def _resolve_lock(expr: ast.AST, cls: Optional[str], rp: str,
                  sc: _Scope) -> Optional[LockNode]:
    """The lock node a with-item context expression acquires, if any."""
    a = self_attr(expr)
    if a is not None and cls is not None:
        c = canon_lock(a, sc.alias.get(cls, {}))
        if c in sc.locks.get(cls, set()):
            return (cls, c)
        t = sc.attr_types.get((cls, a))
        if t:
            return None  # with self.someobject: — not a lock we know
        return None
    if isinstance(expr, ast.Name):
        if expr.id in sc.module_locks.get(rp, set()):
            mod = os.path.basename(rp).rsplit(".", 1)[0]
            return (mod, expr.id)
        return None
    if isinstance(expr, ast.Attribute):
        owners = sc.attr_owners.get(expr.attr, set())
        if len(owners) == 1:
            return next(iter(owners))
    return None


def _resolve_call(call: ast.Call, cls: Optional[str], rp: str,
                  sc: _Scope) -> Optional[FnKey]:
    f = call.func
    if isinstance(f, ast.Attribute):
        recv = f.value
        a = self_attr(recv)
        if a is not None and cls is not None:
            t = sc.attr_types.get((cls, a))
            if t:
                key = (sc.class_rp[t], t, f.attr)
                return key if key in sc.fns else None
            return None
        if isinstance(recv, ast.Name) and recv.id == "self" and cls:
            key = (rp, cls, f.attr)
            return key if key in sc.fns else None
        d = dotted(f)
        tail2 = d.rsplit(".", 1)[-1] if d else ""
        if tail2 in sc.classes and f.attr == tail2:
            return (sc.class_rp[tail2], tail2, "__init__")
        return None
    if isinstance(f, ast.Name):
        if f.id in sc.classes:
            key = (sc.class_rp[f.id], f.id, "__init__")
            return key if key in sc.fns else None
        key = (rp, None, f.id)
        return key if key in sc.fns else None
    return None


def _is_cond_wait_on_held(call: ast.Call, cls: Optional[str],
                          held: FrozenSet[LockNode], sc: _Scope) -> bool:
    """``self.cond.wait()`` / ``d._work.wait()`` where the condition
    wraps a held lock: wait() releases it, not blocking-while-held."""
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr in ("wait", "wait_for")):
        return False
    recv = f.value
    a = self_attr(recv)
    if a is not None and cls is not None:
        c = canon_lock(a, sc.alias.get(cls, {}))
        return (cls, c) in held
    if isinstance(recv, ast.Attribute):
        owners = sc.attr_owners.get(recv.attr, set())
        return len(owners) == 1 and next(iter(owners)) in held
    return False


def _blocking_reason(call: ast.Call, cls: Optional[str],
                     held: FrozenSet[LockNode], sc: _Scope
                     ) -> Optional[str]:
    d = dotted(call.func)
    tail = d.rsplit(".", 1)[-1] if d else ""
    if tail.startswith(_DEVICE_PREFIX):
        return f"device call {d}()"
    if any(d.startswith(p) for p in _BLOCKING_PREFIXES):
        return f"{d}()"
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        recv = call.func.value
        if attr in _BLOCKING_TAILS:
            return f"{d or attr}()"
        if attr in ("wait", "wait_for"):
            if _is_cond_wait_on_held(call, cls, held, sc):
                return None
            return f"{d or attr}()"
        if attr == "join":
            if const_str(recv) is not None or \
                    isinstance(recv, ast.JoinedStr):
                return None
            parts = d.split(".")
            if "path" in parts or parts[0] in ("os", "posixpath", "ntpath"):
                return None
            return f"{d or attr}()"
    elif isinstance(call.func, ast.Name) and call.func.id == "sleep":
        return "sleep()"
    return None


class _Edges:
    def __init__(self):
        # (src, dst) -> example (rp, line, context)
        self.edges: Dict[Tuple[LockNode, LockNode],
                         Tuple[str, int, str]] = {}

    def add(self, held: FrozenSet[LockNode], acquired: LockNode,
            rp: str, line: int, ctx: str) -> None:
        for h in held:
            if h != acquired:
                self.edges.setdefault((h, acquired), (rp, line, ctx))


def _walk_fn(info: _FnInfo, key: FnKey, sc: _Scope, edges: _Edges) -> None:
    rp, cls = info.rp, info.cls

    def walk(node: ast.AST, held: FrozenSet[LockNode]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not info.node:
            for child in ast.iter_child_nodes(node):
                walk(child, frozenset())
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired: Set[LockNode] = set()
            for item in node.items:
                ln = _resolve_lock(item.context_expr, cls, rp, sc)
                if ln is not None:
                    acquired.add(ln)
                    edges.add(held, ln, rp, node.lineno,
                              f"{key[2]}() nests 'with {snippet(item.context_expr)}'")
                    info.acquires.add(ln)
                walk(item, held)
            inner = held | acquired
            for stmt in node.body:
                walk(stmt, inner)
            return
        if isinstance(node, ast.Call):
            reason = _blocking_reason(node, cls, held, sc)
            if reason is not None:
                info.blocking.append((node, reason, held))
            callee = _resolve_call(node, cls, rp, sc)
            if callee is not None and callee != key:
                info.calls.append((callee, held, node))
        for child in ast.iter_child_nodes(node):
            walk(child, held)

    for child in ast.iter_child_nodes(info.node):
        walk(child, frozenset())


def _cycles(edges: Dict[Tuple[LockNode, LockNode], Tuple[str, int, str]]
            ) -> List[List[LockNode]]:
    """Strongly-connected components with a cycle (size > 1, or a
    self-loop), each reported once."""
    graph: Dict[LockNode, Set[LockNode]] = defaultdict(set)
    for (a, b) in edges:
        graph[a].add(b)
        graph.setdefault(b, set())
    index: Dict[LockNode, int] = {}
    low: Dict[LockNode, int] = {}
    on: Set[LockNode] = set()
    stack: List[LockNode] = []
    out: List[List[LockNode]] = []
    counter = [0]

    def strong(v: LockNode) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        for w in graph[v]:
            if w not in index:
                strong(w)
                low[v] = min(low[v], low[w])
            elif w in on:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on.discard(w)
                comp.append(w)
                if w == v:
                    break
            if len(comp) > 1 or (v, v) in edges:
                out.append(sorted(comp))

    for v in sorted(graph):
        if v not in index:
            strong(v)
    return out


def lint_paths(paths: List[str], root: Optional[str] = None
               ) -> List[Finding]:
    """Joint analysis over all given files — the acquisition graph
    spans modules (the daemon holds its lock into breaker/engine/fleet
    methods), so per-file analysis would miss cross-module edges."""
    findings: List[Finding] = []
    trees: List[Tuple[ast.Module, str]] = []
    scopes_by_rp: Dict[str, Dict[ast.AST, str]] = {}
    for path in paths:
        tree, err, rp = parse_file(path, root)
        if tree is None:
            findings.append(err)
            continue
        trees.append((tree, rp))
        scopes_by_rp[rp] = scope_map(tree)
    if not trees:
        return findings

    sc = _discover(trees)
    edges = _Edges()
    for key, info in sc.fns.items():
        _walk_fn(info, key, sc, edges)

    # transitive acquisition sets, then call-site edges
    changed = True
    while changed:
        changed = False
        for key, info in sc.fns.items():
            for callee, _, _ in info.calls:
                ci = sc.fns.get(callee)
                if ci and not ci.acquires <= info.acquires:
                    info.acquires |= ci.acquires
                    changed = True
    for key, info in sc.fns.items():
        for callee, held, node in info.calls:
            if held:
                ci = sc.fns.get(callee)
                if ci:
                    for acq in ci.acquires:
                        edges.add(held, acq, info.rp, node.lineno,
                                  f"{key[2]}() calls {callee[2]}()")

    # entry-held fixpoint (union: "some caller holds it") for
    # blocking-while-held through helpers
    entry_held: Dict[FnKey, FrozenSet[LockNode]] = \
        {k: frozenset() for k in sc.fns}
    changed = True
    while changed:
        changed = False
        for key, info in sc.fns.items():
            for callee, held, _ in info.calls:
                if callee in entry_held:
                    merged = entry_held[callee] | held | entry_held[key]
                    if merged != entry_held[callee]:
                        entry_held[callee] = merged
                        changed = True

    def lock_name(ln: LockNode) -> str:
        return f"{ln[0]}.{ln[1]}"

    for comp in _cycles(edges.edges):
        names = [lock_name(c) for c in comp]
        examples = []
        for (a, b), (erp, eline, ectx) in sorted(edges.edges.items()):
            if a in comp and b in comp:
                examples.append(f"{lock_name(a)}->{lock_name(b)} "
                                f"({erp}:{eline}, {ectx})")
        first = sorted((v for (k, v) in edges.edges.items()
                        if k[0] in comp and k[1] in comp),
                       key=lambda v: (v[0], v[1]))
        rp0, line0 = (first[0][0], first[0][1]) if first else ("", 0)
        findings.append(Finding(
            rule="LOCK-ORDER-CYCLE", severity=ERROR, path=rp0, line=line0,
            message="lock-order cycle: " + " -> ".join(names) +
                    "; edges: " + "; ".join(examples[:4]),
            anchor="lock-order/" + "->".join(names)))

    for key, info in sc.fns.items():
        scopes = scopes_by_rp.get(info.rp, {})
        for node, reason, lexical in info.blocking:
            effective = lexical | entry_held[key]
            if not effective:
                continue
            via = "" if lexical else " (lock held by a caller)"
            findings.append(Finding(
                rule="LOCK-HELD-BLOCKING", severity=WARNING, path=info.rp,
                line=node.lineno, col=node.col_offset,
                message=f"{', '.join(sorted(lock_name(h) for h in effective))}"
                        f" held across blocking {reason}{via}",
                anchor=f"{scopes.get(node, '')}/{snippet(node)}"))
    _ENCLOSING_CACHE.clear()
    return findings


def lint_file(path: str, root: Optional[str] = None) -> List[Finding]:
    return lint_paths([path], root)
