"""Just-in-time linearization: the second host linearizability search.

The reference selects among three knossos algorithms at
jepsen/src/jepsen/checker.clj:85-94: ``:wgl`` (Wing-Gong-Lowe, in
:mod:`jepsen_tpu_torch.checker.wgl`, the native engine
:mod:`jepsen_tpu_torch.checker.native` and the device search
:mod:`jepsen_tpu_torch.checker.gpu`), ``:linear`` (Lowe's just-in-time
linearization over *configurations*), and ``:competition`` (raced, the
first answer wins). This module is ``:linear`` and the race.
Counterpart of ``jepsen_tpu/checker/jitlin.py``.

Algorithm: walk the history's events in time order, keeping a set of
configurations ``(linearized, state)`` where ``linearized`` is the set of
in-flight ops already linearized and ``state`` the model state. On an op's
*return*, every surviving configuration must be extendable, by
linearizing some sequence of in-flight ops "just in time", to one that
includes the returning op; configurations that cannot are pruned. The
history is linearizable iff a configuration survives every return.

An independent implementation: another search order (event-driven, not
the return-order frontier), another configuration encoding (the in-flight
set, not prefix and mask), and none of WGL's reductions, so it doubles
as a differential oracle for the WGL searches.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.models.core import KernelSpec, Model, is_inconsistent
from jepsen_tpu_torch.ops.encode import RET_INF, PackedHistory


def _bound_stop(should_stop: Optional[Callable[[], bool]],
                deadline_s: Optional[float]):
    """Fold an optional wall-clock deadline into a should_stop predicate
    (:func:`jepsen_tpu_torch.resilience.deadline_stop`), the host
    search's counterpart of the device segment watchdog. Returns
    (should_stop, describe) where ``describe(msg)`` rewrites a
    cancellation message when it was the deadline that fired."""
    if deadline_s is None:
        return should_stop, (lambda msg: msg)
    from jepsen_tpu_torch.resilience import deadline_stop
    import time as _time
    t_end = _time.monotonic() + deadline_s

    def describe(msg: str) -> str:
        if _time.monotonic() > t_end:
            return f"deadline {deadline_s}s exceeded"
        return msg

    return deadline_stop(deadline_s, should_stop), describe


def check_jit_packed(p: PackedHistory, kernel: KernelSpec,
                     max_configs: Optional[int] = None,
                     should_stop: Optional[Callable[[], bool]] = None,
                     deadline_s: Optional[float] = None
                     ) -> Dict[str, Any]:
    """JIT linearization over a packed single-key history.

    Returns {'valid': bool|'unknown', 'configs-explored': n, ...};
    ``should_stop`` is polled so a competition race can abandon the
    slower algorithm, and ``deadline_s`` bounds the search by wall
    clock the same way the device path's watchdog bounds segments.
    """
    should_stop, _describe = _bound_stop(should_stop, deadline_s)
    n = p.n
    if p.n_required == 0:
        return {"valid": True, "configs-explored": 0}
    f, v1, v2 = p.f.tolist(), p.v1.tolist(), p.v2.tolist()
    step = kernel.step

    # Event timeline: (event_index, is_return, op_id). Crashed ops have no
    # return event — they stay in flight forever, optionally linearized.
    events: List[Tuple[int, bool, int]] = []
    for j in range(n):
        events.append((int(p.inv[j]), False, j))
        if int(p.ret[j]) != int(RET_INF):
            events.append((int(p.ret[j]), True, j))
    events.sort()

    pending: Set[int] = set()
    # configuration: (frozenset of linearized in-flight ops, state)
    configs: Set[Tuple[frozenset, int]] = {(frozenset(), int(p.init_state))}
    explored = 0

    for ev, is_ret, j in events:
        if not is_ret:
            pending.add(j)
            continue
        # return of required op j: expand each configuration by
        # linearizing in-flight ops just in time; keep only those that
        # linearized j
        new_configs: Set[Tuple[frozenset, int]] = set()
        seen: Set[Tuple[frozenset, int]] = set()
        stack = list(configs)
        while stack:
            L, s = stack.pop()
            if (L, s) in seen:
                continue
            seen.add((L, s))
            explored += 1
            if max_configs is not None and explored > max_configs:
                return {"valid": UNKNOWN, "configs-explored": explored,
                        "error": f"config budget {max_configs} exhausted"}
            if should_stop is not None and explored % 512 == 0 \
                    and should_stop():
                return {"valid": UNKNOWN, "configs-explored": explored,
                        "error": _describe("cancelled")}
            if j in L:
                # j committed: drop it from the in-flight set key
                new_configs.add((L - {j}, s))
                continue
            for q in pending:
                if q in L:
                    continue
                s2, ok = step(s, f[q], v1[q], v2[q])
                if ok:
                    stack.append((L | {q}, int(s2)))
        pending.discard(j)
        if not new_configs:
            inv_op = p.ops[j][0] if j < len(p.ops) else None
            return {"valid": False, "configs-explored": explored,
                    "failed-at-event": ev,
                    "failed-op": inv_op.to_dict() if inv_op else None}
        configs = new_configs
    return {"valid": True, "configs-explored": explored}


def check_jit_model(history, model: Model,
                    max_configs: Optional[int] = None,
                    should_stop: Optional[Callable[[], bool]] = None,
                    deadline_s: Optional[float] = None
                    ) -> Dict[str, Any]:
    """JIT linearization over arbitrary Model objects."""
    should_stop, _describe = _bound_stop(should_stop, deadline_s)
    from jepsen_tpu_torch.checker.wgl import _pair_sorted
    rows = _pair_sorted(history)
    n = len(rows)
    n_req = sum(1 for r in rows if r[1] != int(RET_INF))
    if n_req == 0:
        return {"valid": True, "configs-explored": 0}
    ops = [r[2] for r in rows]
    events: List[Tuple[int, bool, int]] = []
    for j, (inv_ev, ret_ev, _) in enumerate(rows):
        events.append((inv_ev, False, j))
        if ret_ev != int(RET_INF):
            events.append((ret_ev, True, j))
    events.sort()

    pending: Set[int] = set()
    configs: Set[Tuple[frozenset, Model]] = {(frozenset(), model)}
    explored = 0
    for ev, is_ret, j in events:
        if not is_ret:
            pending.add(j)
            continue
        new_configs: Set[Tuple[frozenset, Model]] = set()
        seen: Set[Tuple[frozenset, Model]] = set()
        stack = list(configs)
        while stack:
            L, m = stack.pop()
            if (L, m) in seen:
                continue
            seen.add((L, m))
            explored += 1
            if max_configs is not None and explored > max_configs:
                return {"valid": UNKNOWN, "configs-explored": explored,
                        "error": f"config budget {max_configs} exhausted"}
            if should_stop is not None and explored % 512 == 0 \
                    and should_stop():
                return {"valid": UNKNOWN, "configs-explored": explored,
                        "error": _describe("cancelled")}
            if j in L:
                new_configs.add((L - {j}, m))
                continue
            for q in pending:
                if q in L:
                    continue
                m2 = m.step(ops[q])
                if not is_inconsistent(m2):
                    stack.append((L | {q}, m2))
        pending.discard(j)
        if not new_configs:
            return {"valid": False, "configs-explored": explored,
                    "failed-at-event": ev,
                    "failed-op": ops[j].to_dict()}
        configs = new_configs
    return {"valid": True, "configs-explored": explored}


def competition(fns: Dict[str, Callable[[Callable[[], bool]], dict]],
                ) -> Dict[str, Any]:
    """Race algorithms in threads; the first definitive answer wins and
    the losers are cancelled via their should_stop poll (reference
    knossos.competition, selected at checker.clj:90-94).

    ``fns`` maps algorithm name -> fn(should_stop) -> result dict.
    """
    import threading

    done = threading.Event()
    lock = threading.Lock()
    result: Dict[str, Any] = {}
    unknowns: Dict[str, Any] = {}

    def runner(name: str, fn) -> None:
        try:
            r = fn(done.is_set)
        except Exception as e:  # noqa: BLE001 — loser must not kill race
            r = {"valid": UNKNOWN, "error": repr(e)}
        with lock:
            if r.get("valid") is not UNKNOWN and not result:
                result.update(r)
                result["algorithm"] = name
                done.set()
            else:
                unknowns[name] = r
                if len(unknowns) == len(fns):
                    done.set()

    threads = [threading.Thread(target=runner, args=(nm, fn), daemon=True)
               for nm, fn in fns.items()]
    for t in threads:
        t.start()
    done.wait()
    for t in threads:
        t.join(timeout=5.0)
    if result:
        return result
    # every algorithm came back unknown: report one of them
    name, r = next(iter(unknowns.items()))
    r["algorithm"] = name
    return r
