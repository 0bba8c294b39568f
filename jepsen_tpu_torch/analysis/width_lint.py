"""Pass 3 (``width``): integer-width hazards in the packed int32 columns
and the Python side of the kernels.

The port's counterpart of ``jepsen_tpu.analysis.jax_lint``. It keeps the
reference's two rules about integer widths, with their rule ids and the
reference's folding of literals and of named constants (module-level
bindings, and names imported from other modules of the repository, up to
two imports deep), and drops the four about traced bodies
(``JAX-HOST-SYNC``, ``JAX-HOST-CAST``, ``JAX-UNHASHABLE-STATIC``,
``JAX-TRACE-IN-JIT``): nothing in the port is traced. Its device code is
``csrc/search.cu`` and its segment graph is built in C (ROADMAP §C).

==========================  ========  =================================
rule                        severity  what it catches
==========================  ========  =================================
JAX-INT32-OVERFLOW          error     a compile-time integer outside
                                      the target width in an
                                      ``int32``/``uint32`` cast (the
                                      packed encoding is int32 columns)
JAX-SHIFT-WIDTH             error     a constant shift of >= 32 bits of
                                      a value that is not itself a
                                      constant (a 32-bit lane shifts by
                                      the count mod 32: silent garbage)
LINT-SYNTAX                 error     the module does not parse
==========================  ========  =================================

Scope (``DEFAULT_SCOPES["width"]``): ``checker/``, ``ops/encode.py``,
``kernels/``, ``obs/``, ``resilience.py``, ``serve.py`` and ``stream.py``
of ``jepsen_tpu_torch``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from jepsen_tpu_torch.analysis import ERROR, Finding
from jepsen_tpu_torch.analysis.astutil import (dotted, parse_file, scope_map,
                                               snippet)

INT32_MIN, INT32_MAX = -(2 ** 31), 2 ** 31 - 1
UINT32_MAX = 2 ** 32 - 1


def _const_int(node: ast.AST, resolve=None) -> Optional[int]:
    """Fold a compile-time integer expression: literals combined with
    + - * ** << >> & | and unary +/- (e.g. ``2**31 - 1``), plus — when
    ``resolve`` is given — module-level named constants (``resolve``
    maps a name to its folded int, or None; shadowed names must come
    back None from the resolver)."""
    if isinstance(node, ast.Constant):
        v = node.value
        return v if isinstance(v, int) and not isinstance(v, bool) \
            else None
    if isinstance(node, ast.Name) and resolve is not None:
        v = resolve(node.id)
        return v if isinstance(v, int) and not isinstance(v, bool) \
            else None
    if isinstance(node, ast.UnaryOp) and isinstance(
            node.op, (ast.USub, ast.UAdd)):
        v = _const_int(node.operand, resolve)
        if v is None:
            return None
        return -v if isinstance(node.op, ast.USub) else v
    if isinstance(node, ast.BinOp):
        left = _const_int(node.left, resolve)
        right = _const_int(node.right, resolve)
        if left is None or right is None:
            return None
        op = node.op
        try:
            if isinstance(op, ast.Add):
                return left + right
            if isinstance(op, ast.Sub):
                return left - right
            if isinstance(op, ast.Mult):
                return left * right
            if isinstance(op, ast.Pow) and 0 <= right <= 128:
                return left ** right
            if isinstance(op, ast.LShift) and 0 <= right <= 128:
                return left << right
            if isinstance(op, ast.RShift) and 0 <= right <= 128:
                return left >> right
            if isinstance(op, ast.BitAnd):
                return left & right
            if isinstance(op, ast.BitOr):
                return left | right
        except (OverflowError, ValueError):
            return None
    return None


# ---------------------------------------------------------------------------
# Named-constant environment: module-level NAME = <int expr> bindings,
# including names imported from other repo modules (depth-limited), so
# a width constant defined in ops/encode.py and shifted in checker code
# no longer escapes the overflow/shift rules.
# ---------------------------------------------------------------------------

#: Calls folded as identity when building the environment: a module
#: constant defined as np.int32(2**31 - 1) (e.g. encode.RET_INF) is a
#: compile-time width too.
_CONST_CASTS = ("int", "int32", "uint32", "int64", "uint64")

#: Import-resolution depth limit (A imports from B imports from C stops
#: here) — enough for the real width chains, bounded against cycles.
_ENV_MAX_DEPTH = 2

#: abspath -> folded module env (memoized per process; the repo scan
#: lints many files importing the same constants module).
_ENV_CACHE: Dict[str, Dict[str, int]] = {}


def _module_file(module: str, root: Optional[str]) -> Optional[str]:
    """Best-effort source path of an absolute dotted module inside the
    repo root (package __init__ or plain module); None otherwise."""
    import os
    if not root or not module:
        return None
    base = os.path.join(root, *module.split("."))
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(cand):
            return cand
    return None


def _fold_binding(value: ast.AST, env: Dict[str, int]) -> Optional[int]:
    v = _const_int(value, env.get)
    if v is None and isinstance(value, ast.Call) and len(value.args) == 1:
        tail = dotted(value.func).rsplit(".", 1)[-1]
        if tail in _CONST_CASTS:
            v = _const_int(value.args[0], env.get)
    return v


def _module_env(tree: ast.Module, root: Optional[str],
                depth: int = 0) -> Dict[str, int]:
    """Fold the module's top-level integer constants to a name -> value
    map. Names rebound at module level are ambiguous and dropped;
    ``from x import NAME`` pulls folded constants out of repo-local
    modules up to _ENV_MAX_DEPTH."""
    env: Dict[str, int] = {}
    if depth < _ENV_MAX_DEPTH:
        for node in tree.body:
            if isinstance(node, ast.ImportFrom) and node.module \
                    and not node.level:
                src = _module_file(node.module, root)
                if src is None:
                    continue
                sub = _file_env(src, root, depth + 1)
                for alias in node.names:
                    if alias.name in sub:
                        env[alias.asname or alias.name] = sub[alias.name]
    assigns = []
    counts: Dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            assigns.append((name, node.value))
            counts[name] = counts.get(name, 0) + 1
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and node.value is not None:
            assigns.append((node.target.id, node.value))
            counts[node.target.id] = counts.get(node.target.id, 0) + 1
    changed = True
    while changed:                 # constants referencing constants
        changed = False
        for name, value in assigns:
            if counts.get(name, 0) > 1:
                continue
            v = _fold_binding(value, env)
            if v is not None and env.get(name) != v:
                env[name] = v
                changed = True
    return env


def _file_env(path: str, root: Optional[str], depth: int = 0
              ) -> Dict[str, int]:
    import os
    key = os.path.abspath(path)
    if key in _ENV_CACHE:
        return _ENV_CACHE[key]
    _ENV_CACHE[key] = {}           # cycle guard before recursing
    tree, err, _ = parse_file(path, root)
    if tree is not None:
        _ENV_CACHE[key] = _module_env(tree, root, depth)
    return _ENV_CACHE[key]


def _local_names(fn: ast.AST) -> Set[str]:
    """Names bound directly inside one function scope (args and every
    assignment form), NOT descending into nested functions — a nested
    def's locals don't shadow its enclosing scope."""
    names: Set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            names.add(a.arg)
        if args.vararg:
            names.add(args.vararg.arg)
        if args.kwarg:
            names.add(args.kwarg.arg)

    def targets(t):
        if isinstance(t, ast.Name):
            names.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                targets(e)
        elif isinstance(t, ast.Starred):
            targets(t.value)

    body = getattr(fn, "body", None)
    if isinstance(body, ast.AST):          # lambda: body is one expr
        stack = [body]
    else:
        stack = list(body or [])
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            names.add(n.name)
            continue
        if isinstance(n, ast.Lambda):
            continue
        if isinstance(n, ast.Assign):
            for t in n.targets:
                targets(t)
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            targets(n.target)
        elif isinstance(n, (ast.For, ast.AsyncFor)):
            targets(n.target)
        elif isinstance(n, ast.NamedExpr):
            targets(n.target)
        elif isinstance(n, (ast.With, ast.AsyncWith)):
            for item in n.items:
                if item.optional_vars is not None:
                    targets(item.optional_vars)
        elif isinstance(n, (ast.ListComp, ast.SetComp, ast.DictComp,
                            ast.GeneratorExp)):
            for gen in n.generators:
                targets(gen.target)
        stack.extend(ast.iter_child_nodes(n))
    return names


def _shadow_sets(tree: ast.Module) -> Dict[int, frozenset]:
    """id(node) -> names shadowed at that node by enclosing function
    scopes (a local ``W`` must not fold as the module's ``W``)."""
    out: Dict[int, frozenset] = {}

    def walk(node: ast.AST, inherited: frozenset) -> None:
        for child in ast.iter_child_nodes(node):
            out[id(child)] = inherited
            inh = inherited
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                inh = inherited | frozenset(_local_names(child))
            walk(child, inh)

    walk(tree, frozenset())
    return out


def lint_file(path: str, root: Optional[str] = None) -> List[Finding]:
    tree, err, rp = parse_file(path, root)
    if tree is None:
        return [err]
    scopes = scope_map(tree)
    findings: List[Finding] = []
    # the module's folded integer constants (and repo-local imports),
    # masked per node by the names its enclosing functions rebind
    env = _module_env(tree, root or None)
    shadows = _shadow_sets(tree)

    def resolver(node: ast.AST):
        shadowed = shadows.get(id(node), frozenset())

        def resolve(name: str):
            return None if name in shadowed else env.get(name)

        return resolve

    def add(rule, sev, node, msg):
        findings.append(Finding(
            rule=rule, severity=sev, path=rp,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0), message=msg,
            anchor=f"{scopes.get(node, '')}/{snippet(node)}"))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            tail = dotted(node.func).rsplit(".", 1)[-1]
            if tail in ("int32", "uint32") and len(node.args) == 1:
                v = _const_int(node.args[0], resolver(node))
                if v is not None:
                    lo, hi = ((0, UINT32_MAX) if tail == "uint32"
                              else (INT32_MIN, INT32_MAX))
                    if not (lo <= v <= hi):
                        add("JAX-INT32-OVERFLOW", ERROR, node,
                            f"compile-time value {v} does not fit "
                            f"{tail} [{lo}, {hi}] — the packed "
                            f"encoding would silently wrap")
        elif isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.LShift, ast.RShift)):
            sh = _const_int(node.right, resolver(node))
            if sh is not None and sh >= 32 and \
                    _const_int(node.left, resolver(node)) is None:
                add("JAX-SHIFT-WIDTH", ERROR, node,
                    f"constant shift by {sh} bits: a 32-bit lane "
                    f"shifts modulo 32 on device — this is silent "
                    f"garbage, widen the type or split the shift")
    return findings
