"""Structural history validation: the pre-search gate.

A fast O(n) host walk that rejects a structurally malformed history with
a rule id and an op position before any packing or device work.
Counterpart of ``gate_history`` in ``jepsen_tpu.analysis.history_lint``.

==========================  ========  =================================
rule                        severity  what it catches
==========================  ========  =================================
HIST-DECODE                 warning   undecodable lines were skipped
HIST-OP-TYPE                error     op ``type`` outside
                                      invoke/ok/fail/info
HIST-UNMATCHED-COMPLETE     error     ok/fail completion from a process
                                      with no open invocation
HIST-PROC-REUSE             error     an identical invoke re-issued
                                      while the first is still open
HIST-DANGLING-INVOKE        error     an invocation abandoned while its
                                      process went on to other ops
HIST-INDEX-ORDER            error     non-monotonic ``index`` values
HIST-F-MISMATCH             error     a completion whose ``f`` differs
                                      from its invocation's
HIST-INVOKE-NO-F            warning   an invocation with no ``f``
HIST-UNMATCHED-INFO         note      a bare non-nemesis info marker
HIST-OPEN-INVOKE            note      invoke still open at history end
==========================  ========  =================================

Only error-severity findings gate.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional

from jepsen_tpu_torch.analysis import (ERROR, NOTE, WARNING,  # noqa: F401
                                       Finding, relpath)
from jepsen_tpu_torch.history import (INVALID_TYPE_FLAG, NEMESIS,
                                      invalid_op_type)


class MalformedHistoryError(Exception):
    """Raised by :func:`gate_history` when a history has error-severity
    findings; carries them so callers can render rule ids."""

    def __init__(self, findings: List[Finding], where: str = "check"):
        self.findings = findings
        head = "; ".join(f.format() for f in findings[:5])
        more = len(findings) - 5
        if more > 0:
            head += f"; ... {more} more"
        super().__init__(
            f"malformed history rejected before {where}: {head}")


def _get(o: Any, key: str, default=None):
    if isinstance(o, dict):
        return o.get(key, default)
    return getattr(o, key, default)


def lint_history(history: Iterable[Any], source: str = "history",
                 decode_errors: Optional[int] = None) -> List[Finding]:
    """Walk a history (Ops or op dicts) once; return its findings."""
    out: List[Finding] = []

    def add(rule, sev, i, msg, anchor=""):
        out.append(Finding(rule=rule, severity=sev, path=source,
                           line=i + 1, message=msg,
                           anchor=anchor or f"op{i}"))

    if decode_errors is None:
        decode_errors = int(getattr(history, "decode_errors", 0) or 0)
    if decode_errors:
        out.append(Finding(
            rule="HIST-DECODE", severity=WARNING, path=source, line=0,
            message=f"{decode_errors} line(s) were undecodable and "
                    f"skipped when this history was loaded",
            anchor="decode"))

    open_by_proc: dict = {}   # process -> (pos, op)
    last_index = None
    for i, o in enumerate(history):
        typ = _get(o, "type")
        f = _get(o, "f")
        proc = _get(o, "process")
        extra = _get(o, "extra") or {}
        flagged = (extra.get(INVALID_TYPE_FLAG)
                   if isinstance(extra, dict) else None) or \
            (_get(o, INVALID_TYPE_FLAG) if isinstance(o, dict) else None)

        bad = invalid_op_type(typ)
        if bad or flagged:
            add("HIST-OP-TYPE", ERROR, i,
                flagged if isinstance(flagged, str) else bad,
                anchor=f"type/{typ!r}")
            continue  # pairing rules assume a legal type

        idx = _get(o, "index", -1)
        if isinstance(idx, int) and idx >= 0:
            if last_index is not None and idx <= last_index:
                add("HIST-INDEX-ORDER", ERROR, i,
                    f"op index {idx} is not greater than the previous "
                    f"assigned index {last_index}",
                    anchor=f"index/{idx}")
            last_index = idx if last_index is None else max(last_index,
                                                            idx)

        if proc == NEMESIS:
            continue  # nemesis ops never pair

        if typ == "invoke":
            if f is None:
                add("HIST-INVOKE-NO-F", WARNING, i,
                    f"invoke by process {proc!r} has no 'f'",
                    anchor=f"no-f/{proc!r}")
            prev = open_by_proc.get(proc)
            if prev is not None:
                j, prev_op = prev
                if (_get(prev_op, "f") == f
                        and _get(prev_op, "value") == _get(o, "value")):
                    add("HIST-PROC-REUSE", ERROR, i,
                        f"process {proc!r} reused before completion: "
                        f"invoke {f!r} re-issued while the invoke at "
                        f"position {j} is still open",
                        anchor=f"reuse/{proc!r}/{f!r}")
                else:
                    add("HIST-DANGLING-INVOKE", ERROR, j,
                        f"invoke {_get(prev_op, 'f')!r} by process "
                        f"{proc!r} at position {j} was abandoned "
                        f"without a completion (the process went on to "
                        f"invoke {f!r} at position {i})",
                        anchor=f"dangling/{proc!r}/"
                               f"{_get(prev_op, 'f')!r}")
            open_by_proc[proc] = (i, o)
        else:  # a completion
            prev = open_by_proc.pop(proc, None)
            if prev is None:
                if typ == "info":
                    add("HIST-UNMATCHED-INFO", NOTE, i,
                        f"info op {f!r} by process {proc!r} has no "
                        f"open invocation",
                        anchor=f"info/{proc!r}/{f!r}")
                else:
                    add("HIST-UNMATCHED-COMPLETE", ERROR, i,
                        f"{typ} completion {f!r} by process {proc!r} "
                        f"has no open invocation",
                        anchor=f"unmatched/{proc!r}/{f!r}")
            elif f is not None and _get(prev[1], "f") is not None \
                    and _get(prev[1], "f") != f:
                add("HIST-F-MISMATCH", ERROR, i,
                    f"completion f={f!r} does not match the open "
                    f"invocation's f={_get(prev[1], 'f')!r} for "
                    f"process {proc!r}",
                    anchor=f"fmismatch/{proc!r}/{f!r}")

    for proc, (j, op_) in sorted(open_by_proc.items(),
                                 key=lambda kv: kv[1][0]):
        add("HIST-OPEN-INVOKE", NOTE, j,
            f"invoke {_get(op_, 'f')!r} by process {proc!r} is still "
            f"open at history end (a crashed op: legal, linearized "
            f"optionally)",
            anchor=f"open/{proc!r}/{_get(op_, 'f')!r}")
    return out


def errors(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == ERROR]


def gate_history(history: Iterable[Any], where: str = "device search",
                 source: str = "history") -> List[Finding]:
    """Lint, and raise :class:`MalformedHistoryError` on any error
    finding; returns all findings when the history passes."""
    findings = lint_history(history, source=source)
    errs = errors(findings)
    if errs:
        raise MalformedHistoryError(errs, where=where)
    return findings


def lint_history_file(path: str, root: Optional[str] = None
                      ) -> List[Finding]:
    """Lint a saved history artifact (.jsonl through History.from_jsonl,
    .wal through the journal reader): the ``lint`` command's entry."""
    rp = relpath(path, root)
    if path.endswith(".wal"):
        from jepsen_tpu_torch import journal
        try:
            h, stats = journal.read_wal(path)
        except OSError as e:
            return [Finding(rule="HIST-DECODE", severity=ERROR, path=rp,
                            line=0, message=f"unreadable WAL: {e}",
                            anchor="decode")]
        return lint_history(h, source=rp,
                            decode_errors=stats.get("corrupt", 0))
    from jepsen_tpu_torch.history import History
    try:
        with open(path) as f:
            h = History.from_jsonl(f.read())
    except OSError as e:
        return [Finding(rule="HIST-DECODE", severity=ERROR, path=rp,
                        line=0, message=f"unreadable history: {e}",
                        anchor="decode")]
    return lint_history(h, source=rp)
