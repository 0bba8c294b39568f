"""Operations and histories.

A test run produces a *history*: an ordered list of operations. An
operation is an invocation (``type='invoke'``) or a completion (``'ok'``,
``'fail'`` or ``'info'``) performed by a logical *process* against the
system under test. Counterpart of ``jepsen_tpu.history``; the op-type
validation it shares with the history gate lives here too.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Iterable, Optional, Union

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


class History(list):
    """A list of Ops."""

    @classmethod
    def of(cls, ops: Iterable[Union[Op, dict]]) -> "History":
        return cls(o if isinstance(o, Op) else Op.from_dict(o) for o in ops)
