"""Operations and histories.

A test run produces a *history*: an ordered list of operations. An
operation is an invocation (``type='invoke'``) or a completion (``'ok'``,
``'fail'`` or ``'info'``) performed by a logical *process* against the
system under test. Counterpart of ``jepsen_tpu.history``; the op-type
validation it shares with the history gate lives here too.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, Optional, Union

NEMESIS = "nemesis"

INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"

VALID_TYPES = (INVOKE, OK, FAIL, INFO)

#: The extra-dict key that flags an op whose type failed validation: the
#: op is kept (one corrupt record must not unload a whole history) and
#: the pre-search gate rejects the history.
INVALID_TYPE_FLAG = "lint:invalid-type"


def invalid_op_type(t: Any) -> Optional[str]:
    """None when ``t`` is a legal op type; else a short reason string."""
    if t in VALID_TYPES:
        return None
    return f"op type {t!r} is not one of {'/'.join(VALID_TYPES)}"


@dataclass(slots=True)
class Op:
    """One operation event: type, f, value, process, time, index, error,
    plus an open ``extra`` dict for workload-specific keys."""

    type: str
    f: Any = None
    value: Any = None
    process: Union[int, str, None] = None
    time: int = 0
    index: int = -1
    error: Any = None
    extra: Optional[dict] = None

    def replace(self, **kw) -> "Op":
        return dataclasses.replace(self, **kw)

    @property
    def is_invoke(self) -> bool:
        return self.type == INVOKE

    @property
    def is_ok(self) -> bool:
        return self.type == OK

    @property
    def is_fail(self) -> bool:
        return self.type == FAIL

    @property
    def is_info(self) -> bool:
        return self.type == INFO

    def to_dict(self) -> dict:
        d = {"type": self.type, "f": self.f, "value": self.value,
             "process": self.process, "time": self.time,
             "index": self.index}
        if self.error is not None:
            d["error"] = self.error
        if self.extra:
            d.update(self.extra)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Op":
        known = {"type", "f", "value", "process", "time", "index", "error"}
        extra = {k: v for k, v in d.items() if k not in known}
        bad = invalid_op_type(d["type"])
        if bad and INVALID_TYPE_FLAG not in extra:
            extra[INVALID_TYPE_FLAG] = bad
        return cls(type=d["type"], f=d.get("f"), value=d.get("value"),
                   process=d.get("process"), time=d.get("time", 0),
                   index=d.get("index", -1), error=d.get("error"),
                   extra=extra or None)

    def __str__(self) -> str:
        err = f"\t{self.error}" if self.error is not None else ""
        return f"{self.process}\t{self.type}\t{self.f}\t{self.value}{err}"


def op(type: str, f: Any = None, value: Any = None, **kw) -> Op:
    """Convenience constructor."""
    return Op(type=type, f=f, value=value, **kw)


def invoke(f: Any = None, value: Any = None, **kw) -> Op:
    return Op(type=INVOKE, f=f, value=value, **kw)


# Predicates usable on an Op or an op dict.
def _ty(o) -> str:
    return o.type if isinstance(o, Op) else o["type"]


def is_invoke(o) -> bool:
    return _ty(o) == INVOKE


def is_ok(o) -> bool:
    return _ty(o) == OK


def is_fail(o) -> bool:
    return _ty(o) == FAIL


def is_info(o) -> bool:
    return _ty(o) == INFO


class History(list):
    """A list of Ops with analysis helpers."""

    #: Lines :meth:`from_jsonl` could not decode (a torn or corrupted
    #: artifact).
    decode_errors: int = 0

    #: Decoded ops whose ``type`` failed validation (kept, but flagged for
    #: the history gate).
    type_errors: int = 0

    @classmethod
    def of(cls, ops: Iterable[Union[Op, dict]]) -> "History":
        return cls(o if isinstance(o, Op) else Op.from_dict(o) for o in ops)

    def index(self) -> "History":
        """Assign sequential ``index`` to each op in place; returns self."""
        for i, o in enumerate(self):
            o.index = i
        return self

    def invocations(self) -> Iterator[Op]:
        return (o for o in self if o.is_invoke)

    def completions(self) -> Iterator[Op]:
        return (o for o in self if not o.is_invoke)

    def oks(self) -> Iterator[Op]:
        return (o for o in self if o.is_ok)

    def processes(self) -> list:
        """Distinct processes in order of first appearance."""
        return list(dict.fromkeys(o.process for o in self))

    def complete(self) -> "History":
        """A new history in which an invocation completed ``ok`` with no
        value of its own takes its completion's value (so a model sees a
        read's result at its invocation). Does not mutate self."""
        out = History()
        pending: dict = {}
        for o in self:
            if o.is_invoke:
                c = o.replace()
                pending[o.process] = c
                out.append(c)
            else:
                inv = pending.pop(o.process, None)
                if inv is not None and o.is_ok and inv.value is None:
                    inv.value = o.value
                out.append(o.replace())
        return out

    def pairs(self) -> Iterator[tuple]:
        """(invocation, completion-or-None) pairs in invocation order: an
        op's completion is the next op of its process. A completion with
        no open invocation yields (None, completion)."""
        pending: dict = {}
        order: list = []
        for o in self:
            if o.is_invoke:
                pending[o.process] = [o, None]
                order.append(pending[o.process])
            else:
                slot = pending.pop(o.process, None)
                if slot is not None:
                    slot[1] = o
                else:
                    order.append([None, o])
        for inv, comp in order:
            yield inv, comp

    def latencies(self) -> list:
        """[(invoke_op, latency_nanos)] of each completed operation."""
        return [(inv, comp.time - inv.time) for inv, comp in self.pairs()
                if inv is not None and comp is not None]

    def filter(self, pred: Callable[[Op], bool]) -> "History":
        return History(o for o in self if pred(o))

    def remove_failures(self) -> "History":
        """Drop failed invocations and their ``fail`` completions: a
        failed op is known not to have taken place."""
        failed = set()
        open_by_proc: dict = {}
        for i, o in enumerate(self):
            if o.is_invoke:
                open_by_proc[o.process] = i
            elif o.is_fail:
                j = open_by_proc.pop(o.process, None)
                failed.add(i)
                if j is not None:
                    failed.add(j)
            else:
                open_by_proc.pop(o.process, None)
        return History(o for i, o in enumerate(self) if i not in failed)

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(o.to_dict(), default=_json_default)
                         for o in self)

    @classmethod
    def from_jsonl(cls, text: str) -> "History":
        """Parse a saved history. An undecodable line is skipped and
        counted (``decode_errors``); an op with an illegal ``type`` is
        kept but flagged and counted (``type_errors``), so the history
        gate rejects it with a diagnostic."""
        log = logging.getLogger("jepsen")
        h = cls()
        bad = bad_types = 0
        for i, line in enumerate(text.splitlines()):
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
                if not isinstance(d, dict) or "type" not in d:
                    raise ValueError("not an op dict")
                o = Op.from_dict(d)
                if o.extra and INVALID_TYPE_FLAG in o.extra:
                    bad_types += 1
                    log.warning("history.jsonl line %d: %s", i + 1,
                                o.extra[INVALID_TYPE_FLAG])
                h.append(o)
            except (ValueError, TypeError, KeyError):
                bad += 1
                log.warning("history.jsonl line %d is undecodable; "
                            "skipping it", i + 1)
        h.decode_errors = bad
        h.type_errors = bad_types
        return h


def _json_default(x):
    if isinstance(x, (set, frozenset, tuple)):
        return list(x)
    return str(x)
