"""History checkers. A checker examines a completed history and returns a
result map whose ``valid`` key is True, False or :data:`UNKNOWN`.

Checkers compose (:class:`Compose`); a composed validity is the most
severe of its parts (False, then unknown, then True). The linearizability
checker is :mod:`jepsen_tpu_torch.checker.wgl` (``linearizable``,
exported here); its device search is :mod:`jepsen_tpu_torch.checker.gpu`,
its host engines :mod:`jepsen_tpu_torch.checker.native` and
:mod:`jepsen_tpu_torch.checker.jitlin`. The latency and rate artifacts are
:mod:`jepsen_tpu_torch.checker.perf`; the fold checkers (set, counter,
queue, total-queue, unique-ids) :mod:`jepsen_tpu_torch.checker.basic`,
exported here; the HTML timeline :mod:`jepsen_tpu_torch.checker.timeline`.
"""

from __future__ import annotations

import traceback
from typing import Any, Dict, Optional

from jepsen_tpu_torch.util import real_pmap

UNKNOWN = "unknown"

#: Severity order for merging validity: False, then unknown, then True.
_PRIORITY = {False: 0, UNKNOWN: 1, True: 2}


def merge_valid(valids) -> Any:
    """Merge a collection of validity values; the most severe wins."""
    out = True
    for v in valids:
        if _PRIORITY.get(v, 1) < _PRIORITY.get(out, 1):
            out = v
    return out


class Checker:
    """Base checker protocol."""

    def check(self, test: dict, history,
              opts: Optional[dict] = None) -> Dict[str, Any]:
        raise NotImplementedError

    def __call__(self, test, history, opts=None):
        return self.check(test, history, opts)


class FnChecker(Checker):
    """Adapt a plain function (test, history, opts) -> result."""

    def __init__(self, fn, name=None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "fn-checker")

    def check(self, test, history, opts=None):
        return self.fn(test, history, opts)


def check_safe(checker: Checker, test: dict, history,
               opts: Optional[dict] = None) -> Dict[str, Any]:
    """Like ``checker.check``, but an exception yields ``{"valid":
    "unknown", "error": <traceback>}`` with its failure class
    (``error-class``, :func:`jepsen_tpu_torch.resilience.classify_failure`)
    and, when the exception carries a ``resilience_trail``, the
    ``attempts`` it records."""
    try:
        return checker.check(test, history, opts or {})
    except Exception as e:  # noqa: BLE001
        from jepsen_tpu_torch.resilience import classify_failure
        out: Dict[str, Any] = {"valid": UNKNOWN,
                               "error": traceback.format_exc(),
                               "error-class": classify_failure(e)}
        trail = getattr(e, "resilience_trail", None)
        if trail:
            out["attempts"] = list(trail)
        return out


class Compose(Checker):
    """A map of name -> checker, all run in parallel threads; the result
    holds each one's under its name and the merged ``valid``."""

    def __init__(self, checkers: Dict[str, Checker]):
        self.checkers = checkers

    def check(self, test, history, opts=None):
        names = list(self.checkers)
        results = real_pmap(
            lambda n: check_safe(self.checkers[n], test, history, opts),
            names)
        return {"valid": merge_valid(r.get("valid", UNKNOWN)
                                     for r in results),
                **dict(zip(names, results))}


def compose(checkers: Dict[str, Checker]) -> Compose:
    return Compose(checkers)


class Unbridled(Checker):
    """A checker which is always happy."""

    def check(self, test, history, opts=None):
        return {"valid": True}


def noop_checker() -> Checker:
    return Unbridled()


from jepsen_tpu_torch.checker.basic import (  # noqa: E402,F401
    Counter,
    QueueChecker,
    SetChecker,
    TotalQueue,
    UniqueIds,
    counter,
    queue,
    set_checker,
    total_queue,
    unique_ids,
)
from jepsen_tpu_torch.checker.wgl import (  # noqa: E402,F401
    LinearizableChecker, linearizable)
from jepsen_tpu_torch.checker.perf import (  # noqa: E402,F401
    latency_graph, perf, rate_graph)
