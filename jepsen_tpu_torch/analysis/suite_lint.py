"""Pass 1: suite linter — AST checks over ``jepsen_tpu_torch/suites/``
cross-checked against the ``SUITES`` registry.

A broken suite module used to surface only when someone ran it: the
registry import warns, the constructor TypeErrors on its opts dict, a
client missing ``invoke`` crashes its worker after full DB setup, and a
generator emitting an op with a bogus ``type`` poisons the history the
checker later chokes on. All of that is statically decidable:

==========================  ========  =================================
rule                        severity  what it catches
==========================  ========  =================================
SUITE-REGISTRY-MISSING      error     a ``SUITES`` row whose module
                                      lacks the named constructor
SUITE-CTOR-ARITY            error     a registered constructor that is
                                      not callable with one opts dict
SUITE-CLIENT-NO-INVOKE      error     a concrete Client subclass that
                                      never implements ``invoke``
SUITE-OP-TYPE               error     an op literal whose ``type`` is
                                      outside invoke/ok/fail/info
SUITE-OP-NO-F               warning   an op literal with no ``f``
SUITE-BLOCKING-NO-TIMEOUT   warning   a known-blocking call on an
                                      invoke path without a timeout
LINT-SYNTAX                 error     the module does not parse
==========================  ========  =================================

The op-type rule shares its notion of legality with the runtime decode
guard (``VALID_TYPES`` of :mod:`jepsen_tpu_torch.history`, which carries
the reference's ``opcheck`` module).

The port's copy of ``jepsen_tpu.analysis.suite_lint``, over the port's
suites and ``SUITES``.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Set

from jepsen_tpu_torch.analysis import ERROR, Finding, WARNING
from jepsen_tpu_torch.analysis.astutil import (const_str, dotted, keyword_arg,
                                         parse_file, scope_map, snippet)
from jepsen_tpu_torch.history import VALID_TYPES as VALID_OP_TYPES

#: Known-blocking calls and where their timeout lives: dotted-name
#: suffix -> (timeout kwarg, 0-based positional index or None). A call
#: matching a suffix with neither the kwarg nor the positional present
#: is flagged when reachable from a client ``invoke``.
BLOCKING_CALLS = {
    "socket.create_connection": ("timeout", 1),
    "create_connection": ("timeout", 1),
    "urllib.request.urlopen": ("timeout", 2),
    "request.urlopen": ("timeout", 2),
    "urlopen": ("timeout", 2),
    "subprocess.run": ("timeout", None),
    "subprocess.check_output": ("timeout", None),
    "subprocess.check_call": ("timeout", None),
    "subprocess.call": ("timeout", None),
    "requests.get": ("timeout", None),
    "requests.post": ("timeout", None),
    "requests.put": ("timeout", None),
    "requests.delete": ("timeout", None),
    "requests.head": ("timeout", None),
    "requests.request": ("timeout", None),
}

#: Names that mark the Client protocol root in a class's bases
#: (``Client``, ``client.Client``, ``client_ns.Client``).
_CLIENT_ROOT = "Client"


def _has_timeout(call: ast.Call, kw: str, pos: Optional[int]) -> bool:
    if keyword_arg(call, kw) is not None:
        return True
    if pos is not None and len(call.args) > pos:
        return True
    return False


def _blocking_spec(call: ast.Call):
    name = dotted(call.func)
    if not name:
        return None
    if name in BLOCKING_CALLS:
        return name, BLOCKING_CALLS[name]
    # suffix match for aliased imports (from urllib.request import urlopen)
    tail = name.rsplit(".", 1)[-1]
    if tail in BLOCKING_CALLS and "." not in name:
        return name, BLOCKING_CALLS[tail]
    return None


class _Module:
    """Parsed view of one suite module: top-level defs, classes with
    their methods and base names."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.scopes = scope_map(tree)
        self.functions: Dict[str, ast.FunctionDef] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        self.assigned: Set[str] = set()
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.assigned.add(t.id)

    def methods(self, cls: ast.ClassDef) -> Dict[str, ast.FunctionDef]:
        return {n.name: n for n in cls.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

    def base_names(self, cls: ast.ClassDef) -> List[str]:
        out = []
        for b in cls.bases:
            if isinstance(b, ast.Name):
                out.append(b.id)
            elif isinstance(b, ast.Attribute):
                out.append(b.attr)
        return out

    def local_mro(self, cls: ast.ClassDef) -> List[ast.ClassDef]:
        """cls plus its in-module ancestor chain (no external bases)."""
        out, todo, seen = [], [cls], set()
        while todo:
            c = todo.pop(0)
            if c.name in seen:
                continue
            seen.add(c.name)
            out.append(c)
            for b in c.bases:
                if isinstance(b, ast.Name) and b.id in self.classes:
                    todo.append(self.classes[b.id])
        return out

    def is_client(self, cls: ast.ClassDef) -> bool:
        """Does cls (transitively, within this module) inherit the
        Client protocol root?"""
        for c in self.local_mro(cls):
            if _CLIENT_ROOT in self.base_names(c):
                return True
        return False


def _op_literal_findings(mod: _Module, rp: str) -> List[Finding]:
    out: List[Finding] = []

    def add(rule, sev, node, msg):
        out.append(Finding(rule=rule, severity=sev, path=rp,
                           line=getattr(node, "lineno", 0),
                           col=getattr(node, "col_offset", 0),
                           message=msg,
                           anchor=f"{mod.scopes.get(node, '')}/"
                                  f"{snippet(node)}"))

    for node in ast.walk(mod.tree):
        # dict literals shaped like op templates
        if isinstance(node, ast.Dict):
            keys = {const_str(k): v for k, v in zip(node.keys,
                                                    node.values)
                    if k is not None}
            if "type" not in keys:
                continue
            tval = const_str(keys["type"])
            has_f = "f" in keys
            if tval is None:
                continue  # dynamic type expr: not checkable
            # op-likeness: an explicit f key, or a legal op type. A dict
            # with an exotic type AND no f is some other record (e.g. a
            # bank checker's {"type": "wrong-n", ...}) — skipped.
            if has_f:
                if tval not in VALID_OP_TYPES:
                    add("SUITE-OP-TYPE", ERROR, node,
                        f"op literal has type {tval!r}; legal types "
                        f"are {'/'.join(VALID_OP_TYPES)}")
            elif tval in VALID_OP_TYPES:
                add("SUITE-OP-NO-F", WARNING, node,
                    f"op literal of type {tval!r} has no 'f' — "
                    f"unmatchable by any model")
        # Op(...) constructions and op.replace(type=...) rewrites
        elif isinstance(node, ast.Call):
            name = dotted(node.func)
            tkw = keyword_arg(node, "type")
            tval = const_str(tkw) if tkw is not None else None
            if name == "Op" or name.endswith(".Op") or name == "op":
                if tval is not None and tval not in VALID_OP_TYPES:
                    add("SUITE-OP-TYPE", ERROR, node,
                        f"Op constructed with type {tval!r}; legal "
                        f"types are {'/'.join(VALID_OP_TYPES)}")
                if (tval == "invoke"
                        and keyword_arg(node, "f") is None
                        and len(node.args) < 2):
                    add("SUITE-OP-NO-F", WARNING, node,
                        "invoke Op constructed with no 'f'")
            elif name.endswith(".replace") and tval is not None \
                    and tval not in VALID_OP_TYPES:
                add("SUITE-OP-TYPE", ERROR, node,
                    f"op completed with type {tval!r}; legal types "
                    f"are {'/'.join(VALID_OP_TYPES)}")
    return out


def _invoke_path_findings(mod: _Module, rp: str) -> List[Finding]:
    """Blocking calls without a timeout, reachable from any client
    ``invoke`` via same-class ``self.*()`` calls and module-level
    helper functions (a one-module call-graph closure)."""
    out: List[Finding] = []
    for cls in mod.classes.values():
        methods = {}
        for c in mod.local_mro(cls):
            for name, fn in mod.methods(c).items():
                methods.setdefault(name, fn)
        if "invoke" not in methods:
            continue
        # BFS the invoke path: self-methods + local functions
        todo, seen_fns = [methods["invoke"]], set()
        while todo:
            fn = todo.pop(0)
            if id(fn) in seen_fns:
                continue
            seen_fns.add(id(fn))
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted(node.func)
                if name.startswith("self."):
                    m = name[5:]
                    if m in methods:
                        todo.append(methods[m])
                elif name in mod.functions:
                    todo.append(mod.functions[name])
                spec = _blocking_spec(node)
                if spec is None:
                    continue
                cname, (kw, pos) = spec
                if not _has_timeout(node, kw, pos):
                    out.append(Finding(
                        rule="SUITE-BLOCKING-NO-TIMEOUT",
                        severity=WARNING, path=rp,
                        line=node.lineno, col=node.col_offset,
                        message=f"{cname}() on the invoke path of "
                                f"{cls.name} has no timeout: one hung "
                                f"call stalls the whole worker",
                        anchor=f"{mod.scopes.get(node, '')}/"
                               f"{snippet(node)}"))
    # dedup: shared helpers reachable from several clients
    uniq: Dict[str, Finding] = {}
    for f in out:
        uniq.setdefault(f"{f.key()}:{f.line}", f)
    return list(uniq.values())


def _client_findings(mod: _Module, rp: str) -> List[Finding]:
    out: List[Finding] = []
    base_of: Set[str] = set()
    for cls in mod.classes.values():
        for b in cls.bases:
            if isinstance(b, ast.Name):
                base_of.add(b.id)
    for cls in mod.classes.values():
        if not mod.is_client(cls):
            continue
        if cls.name in base_of:
            continue  # an intermediate base: its leaves are checked
        has_invoke = any("invoke" in mod.methods(c)
                         for c in mod.local_mro(cls))
        if not has_invoke:
            out.append(Finding(
                rule="SUITE-CLIENT-NO-INVOKE", severity=ERROR, path=rp,
                line=cls.lineno,
                message=f"client class {cls.name} never implements "
                        f"invoke(test, op) — its workers would crash "
                        f"on the first operation",
                anchor=f"{cls.name}/class"))
    return out


def lint_file(path: str, root: Optional[str] = None) -> List[Finding]:
    """Suite-lint one module (no registry cross-check — that needs the
    whole directory; see :func:`lint_suites`)."""
    tree, err, rp = parse_file(path, root)
    if tree is None:
        return [err]
    mod = _Module(tree)
    return (_op_literal_findings(mod, rp)
            + _client_findings(mod, rp)
            + _invoke_path_findings(mod, rp))


def lint_suites(paths: Iterable[str], root: Optional[str] = None,
                registry: Optional[dict] = None) -> List[Finding]:
    """Suite-lint a set of modules plus the registry cross-check: every
    ``SUITES`` row must resolve to a constructor def that is callable
    with a single opts dict."""
    paths = list(paths)
    findings: List[Finding] = []
    mods: Dict[str, _Module] = {}
    rps: Dict[str, str] = {}
    for p in paths:
        name = os.path.splitext(os.path.basename(p))[0]
        tree, err, rp = parse_file(p, root)
        rps[name] = rp
        if tree is None:
            findings.append(err)
            continue
        mod = _Module(tree)
        mods[name] = mod
        findings.extend(_op_literal_findings(mod, rp))
        findings.extend(_client_findings(mod, rp))
        findings.extend(_invoke_path_findings(mod, rp))

    if registry is None:
        from jepsen_tpu_torch.suites import SUITES
        registry = SUITES
    for suite, (modname, attr) in sorted(registry.items()):
        mod = mods.get(modname)
        if mod is None:
            if modname not in rps:  # module file absent entirely
                findings.append(Finding(
                    rule="SUITE-REGISTRY-MISSING", severity=ERROR,
                    path=f"jepsen_tpu_torch/suites/{modname}.py", line=0,
                    message=f"registry entry {suite!r} points at "
                            f"missing module {modname!r}",
                    anchor=f"registry/{suite}"))
            continue
        rp = rps[modname]
        fn = mod.functions.get(attr)
        if fn is None:
            if attr not in mod.assigned:
                findings.append(Finding(
                    rule="SUITE-REGISTRY-MISSING", severity=ERROR,
                    path=rp, line=0,
                    message=f"registry entry {suite!r}: module "
                            f"{modname!r} has no constructor {attr!r}",
                    anchor=f"registry/{suite}"))
            continue
        args = fn.args
        n_pos = len(args.args) + len(args.posonlyargs)
        n_default = len(args.defaults)
        required = n_pos - n_default
        if required > 1 or (n_pos == 0 and args.vararg is None):
            findings.append(Finding(
                rule="SUITE-CTOR-ARITY", severity=ERROR, path=rp,
                line=fn.lineno,
                message=f"constructor {attr}() must be callable with "
                        f"one opts dict ({required} required "
                        f"positional parameter(s) found)",
                anchor=f"{attr}/signature"))
    return findings
