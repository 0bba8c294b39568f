"""The linearizability checker facade and the exact host searches.

Counterpart of ``jepsen_tpu/checker/wgl.py`` (``check_packed``,
``check_model`` and ``LinearizableChecker``). The host searches are
Wing-Gong-Lowe: a configuration is ``(k, mask, state)`` with ops
``[0, k)`` (in return order) linearized and ``mask`` marking further
linearized ops at offsets >= k; a DFS with a visited set explores them.
``check_packed`` steps the packed history's word kernel; ``check_model``
steps model objects, for a model with no word kernel or a history its
word cannot hold.

With ``backend="gpu"`` the device search decides. The host searches run
only when the device cannot: it answered UNKNOWN, or the model has no
word kernel or the history does not fit the word (the reference's
routing). The result then says so (``fallback-from: "gpu"`` and a
``fallback-reason``). A build or launch failure raises: it is never
turned into a host fallback. Which host search answers is the facade's
``algorithm``: by default the C++ engine (:mod:`.native`) where it
builds, else the Python search here; or ``:linear`` (:mod:`.jitlin`), or
a race of them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from jepsen_tpu_torch.checker import UNKNOWN, Checker
from jepsen_tpu_torch.checker.gpu import check_history_gpu
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.models.core import KernelSpec, Model, is_inconsistent
from jepsen_tpu_torch.ops.encode import (RET_INF, PackedHistory,
                                         pack_with_init)


def check_packed(p: PackedHistory, kernel: KernelSpec,
                 max_configs: Optional[int] = None,
                 should_stop=None) -> Dict[str, Any]:
    """Exact WGL over a packed history. The mask is a Python int, so no
    window limit applies. Past ``max_configs`` explored configurations
    the result is UNKNOWN; ``should_stop``, a nullary callable, is polled
    every 512 configurations and cancels the search (UNKNOWN,
    ``error: "cancelled"``) when it returns True."""
    n = p.n
    n_req = p.n_required
    if n_req == 0:
        return {"valid": True, "configs-explored": 0}
    f, v1, v2, inv, ret = (p.f.tolist(), p.v1.tolist(), p.v2.tolist(),
                           p.inv.tolist(), p.ret.tolist())
    step = kernel.step
    ro = ([bool(kernel.readonly(f[j], v1[j], v2[j])) for j in range(n_req)]
          if kernel.readonly is not None else None)
    cand_cache: Dict[int, List[int]] = {}

    def candidates(k: int) -> List[int]:
        c = cand_cache.get(k)
        if c is None:
            rk = ret[k]
            c = cand_cache[k] = [j for j in range(k, n) if inv[j] < rk]
        return c

    init = (0, 0, int(p.init_state))
    stack = [init]
    seen = {init}
    explored = 0
    best_k = 0
    best_states: set = {int(p.init_state)}
    while stack:
        k, mask, state = stack.pop()
        explored += 1
        if max_configs is not None and explored > max_configs:
            return {"valid": UNKNOWN,
                    "error": f"config budget {max_configs} exhausted",
                    "configs-explored": explored,
                    "max-linearized-prefix": best_k}
        if should_stop is not None and explored % 512 == 0 \
                and should_stop():
            return {"valid": UNKNOWN, "configs-explored": explored,
                    "error": "cancelled"}
        # read-only candidates that succeed are taken at once (one closure
        # successor); a crashed op that leaves the state unchanged is
        # never taken now
        pure_mask = 0
        impure = []
        for j in candidates(k):
            if (mask >> (j - k)) & 1:
                continue
            s2, ok = step(state, f[j], v1[j], v2[j])
            if not ok:
                continue
            if j >= n_req and int(s2) == state:
                continue
            if j < n_req and ro is not None and ro[j]:
                pure_mask |= 1 << (j - k)
                continue
            impure.append((j, int(s2)))
        succs = []
        if pure_mask:
            m = mask | pure_mask
            k2 = k
            while m & 1:
                m >>= 1
                k2 += 1
            succs.append((k2, m, state))
        else:
            for j, s2 in impure:
                if j == k:
                    m = mask >> 1
                    k2 = k + 1
                    while m & 1:
                        m >>= 1
                        k2 += 1
                    succs.append((k2, m, s2))
                else:
                    succs.append((k, mask | (1 << (j - k)), s2))
        for cfg in succs:
            if cfg[0] > best_k:
                best_k = cfg[0]
                best_states = {cfg[2]}
            elif cfg[0] == best_k and len(best_states) < 16:
                best_states.add(cfg[2])
            if cfg[0] >= n_req:
                return {"valid": True, "configs-explored": explored}
            if cfg not in seen:
                seen.add(cfg)
                stack.append(cfg)
    return {
        "valid": False,
        "configs-explored": explored,
        "max-linearized-prefix": best_k,
        "frontier-op": _describe_op(p, best_k) if best_k < n else None,
        "final-states": sorted(best_states),
    }


def _describe_op(p: PackedHistory, j: int) -> Optional[dict]:
    if j >= len(p.ops):
        return None
    inv_op, _ = p.ops[j]
    return inv_op.to_dict() if inv_op is not None else None


def _pair_sorted(history) -> List[Tuple[int, int, Op]]:
    """Pair invocations with completions, drop failed pairs, back-fill an
    ok completion's value into the op that is stepped, and sort by (ret,
    inv): [(inv_ev, ret_ev, op)], crashed ops with ret RET_INF."""
    pending: Dict[Any, Tuple[int, Op]] = {}
    rows: List[Tuple[int, int, Op]] = []
    for ev, o in enumerate(history):
        if o.is_invoke:
            pending[o.process] = (ev, o)
        elif o.process in pending:
            inv_ev, inv_op = pending.pop(o.process)
            if o.is_fail:
                continue
            if o.is_ok:
                val = o.value if o.value is not None else inv_op.value
                rows.append((inv_ev, ev, inv_op.replace(value=val)))
            else:  # info: pending forever
                rows.append((inv_ev, int(RET_INF), inv_op))
    for inv_ev, inv_op in pending.values():
        rows.append((inv_ev, int(RET_INF), inv_op))
    rows.sort(key=lambda r: (r[1], r[0]))
    return rows


def check_model(history, model: Model, max_configs: Optional[int] = None,
                should_stop=None) -> Dict[str, Any]:
    """Exact WGL over model objects: the same search as
    :func:`check_packed`, stepping ``model`` with each op, with the
    model's ``readonly_op`` driving the pure-op closure; ``max_configs``
    and ``should_stop`` as there."""
    rows = _pair_sorted(history)
    n = len(rows)
    n_req = sum(1 for r in rows if r[1] != int(RET_INF))
    if n_req == 0:
        return {"valid": True, "configs-explored": 0}
    inv = [r[0] for r in rows]
    ret = [r[1] for r in rows]
    ops = [r[2] for r in rows]
    cand_cache: Dict[int, List[int]] = {}

    def candidates(k: int) -> List[int]:
        c = cand_cache.get(k)
        if c is None:
            rk = ret[k]
            c = cand_cache[k] = [j for j in range(k, n) if inv[j] < rk]
        return c

    init = (0, 0, model)
    stack = [init]
    seen = {init}
    explored = 0
    best_k = 0
    best_models: List[Model] = [model]
    while stack:
        k, mask, m = stack.pop()
        explored += 1
        if max_configs is not None and explored > max_configs:
            return {"valid": UNKNOWN,
                    "error": f"config budget {max_configs} exhausted",
                    "configs-explored": explored}
        if should_stop is not None and explored % 512 == 0 \
                and should_stop():
            return {"valid": UNKNOWN, "configs-explored": explored,
                    "error": "cancelled"}
        pure_mask = 0
        impure = []
        for j in candidates(k):
            if (mask >> (j - k)) & 1:
                continue
            m2 = m.step(ops[j])
            if is_inconsistent(m2):
                continue
            if j >= n_req and m2 == m:
                continue  # a no-effect crashed op is never taken now
            if j < n_req and m.readonly_op(ops[j]):
                pure_mask |= 1 << (j - k)
                continue
            impure.append((j, m2))
        if pure_mask:
            mm = mask | pure_mask
            k2 = k
            while mm & 1:
                mm >>= 1
                k2 += 1
            succs = [(k2, mm, m)]
        else:
            succs = []
            for j, m2 in impure:
                if j == k:
                    mm = mask >> 1
                    k2 = k + 1
                    while mm & 1:
                        mm >>= 1
                        k2 += 1
                    succs.append((k2, mm, m2))
                else:
                    succs.append((k, mask | (1 << (j - k)), m2))
        for cfg in succs:
            if cfg[0] > best_k:
                best_k = cfg[0]
                best_models = [cfg[2]]
            elif cfg[0] == best_k and len(best_models) < 16 \
                    and cfg[2] not in best_models:
                best_models.append(cfg[2])
            if cfg[0] >= n_req:
                return {"valid": True, "configs-explored": explored}
            if cfg not in seen:
                seen.add(cfg)
                stack.append(cfg)
    return {
        "valid": False,
        "configs-explored": explored,
        "max-linearized-prefix": best_k,
        "frontier-op": ops[best_k].to_dict() if best_k < n else None,
        "final-models": [repr(m) for m in best_models],
    }


class LinearizableChecker(Checker):
    """Checker facade (reference checker.clj:82-107 ``linearizable``).

    backend:
      'gpu' -- (default) the device search on ``device`` (None = CUDA);
               the host search only when it answers UNKNOWN or the
               history does not fit the model's word, labelled
               ``fallback-from: "gpu"``.
      'cpu' -- the host search.

    algorithm, the host search (the reference's knossos choice of
    ``:competition``, ``:linear`` or ``:wgl``, checker.clj:85-94):
      'auto'        -- (default) 'native' when the C++ engine builds on
                       this host, else 'wgl'
      'wgl'         -- the Python Wing-Gong-Lowe search (this module)
      'linear'      -- just-in-time linearization (checker.jitlin)
      'native'      -- the C++ WGL engine (checker.native), result
                       ``engine: "native"``; the Python WGL answers when
                       it is missing or cannot settle the history (window
                       overflow, an escalated budget)
      'competition' -- every available engine raced in threads, the first
                       definitive answer wins (result ``algorithm``)
    Only 'wgl', 'linear' and 'competition' apply to a history the model's
    word cannot hold. ``max_configs`` bounds the host search's explored
    configurations (UNKNOWN past it).

    ``opts["deadline"]``, a ``time.monotonic()`` instant, stops the device
    search at its next segment barrier past it; the timeout result is
    returned as it is, with no host search after it. On ``valid: false``
    with a ``store-dir`` in the test map, ``linear.svg`` is written there
    (result keys ``counterexample``, ``final-path``, ``configs``).
    """

    def __init__(self, model: Optional[Model] = None, backend: str = "gpu",
                 device=None, max_configs: Optional[int] = None,
                 algorithm: str = "auto"):
        if backend not in ("gpu", "cpu"):
            raise ValueError(f"unknown backend {backend!r}")
        if algorithm not in ("auto", "wgl", "linear", "native",
                             "competition"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        if algorithm == "auto":
            # the C++ engine gives the Python search's verdicts and
            # explored-config counts (same search order): where it builds
            # it is a pure speed-up; its UNKNOWNs fall back below
            from jepsen_tpu_torch.checker import native
            algorithm = "native" if native.available() else "wgl"
        self.model = model
        self.backend = backend
        self.device = device
        self.max_configs = max_configs
        self.algorithm = algorithm

    def check(self, test, history, opts=None):
        model = self.model or test.get("model")
        if model is None:
            raise ValueError("linearizable checker needs a model")
        out = self._check(history, model, opts)
        if out.get("valid") is False:
            self._render(test, history, model, out)
        return out

    def _check(self, history, model: Model, opts) -> Dict[str, Any]:
        if self.backend == "cpu":
            out = self._check_host(history, model)
            out.setdefault("backend", "cpu")
            return out
        res = check_history_gpu(history, model, device=self.device,
                                deadline=(opts or {}).get("deadline"))
        if res is not None and (res.get("valid") is not UNKNOWN
                                or res.get("error") == ":info/timeout"):
            return res
        out = self._check_host(history, model)
        out.setdefault("backend", "cpu")
        out["fallback-from"] = "gpu"
        out["fallback-reason"] = (
            "model has no integer kernel or history exceeds the word "
            "encoding" if res is None
            else res.get("error", "device search returned unknown"))
        return out

    def _check_host(self, history, model: Model) -> Dict[str, Any]:
        """The reference's host routing (its ``wgl.py`` ``_check_host``)."""
        from jepsen_tpu_torch.checker import native
        from jepsen_tpu_torch.checker.jitlin import (
            check_jit_model, check_jit_packed, competition)
        budget = self.max_configs
        try:
            pk = pack_with_init(history, model)
        except ValueError:  # an op or value the word kernel cannot hold
            pk = None
        if pk is None:
            # the object path: the native engine needs the packed words
            if self.algorithm == "linear":
                return check_jit_model(history, model, budget)
            if self.algorithm == "competition":
                return competition({
                    "wgl": lambda stop: check_model(
                        history, model, budget, should_stop=stop),
                    "linear": lambda stop: check_jit_model(
                        history, model, budget, should_stop=stop),
                })
            return check_model(history, model, budget)
        packed, kernel = pk
        if self.algorithm == "linear":
            return check_jit_packed(packed, kernel, budget)
        if self.algorithm == "native":
            res = native.check_packed_native(packed, kernel, budget)
            if res["valid"] is not UNKNOWN:
                return res
            if "budget" in res.get("error", "") \
                    and not res.get("tiers-escalated"):
                # a first-tier budget verdict is final: the Python search
                # would explore the same capped configurations. An
                # escalated one is not (narrower tiers spent part of the
                # cap), so the unbounded-window search below takes it
                return res
            # a window overflow or no engine: the unbounded search answers
            return check_packed(packed, kernel, budget)
        if self.algorithm == "competition":
            racers = {
                "wgl": lambda stop: check_packed(
                    packed, kernel, budget, should_stop=stop),
                "linear": lambda stop: check_jit_packed(
                    packed, kernel, budget, should_stop=stop),
            }
            if native.available():
                racers["native"] = lambda stop: native.check_packed_native(
                    packed, kernel, budget, should_stop=stop)
            return competition(racers)
        return check_packed(packed, kernel, budget)

    def _render(self, test, history, model: Model, out: dict) -> None:
        """On valid:false, write the linear.svg counterexample into the
        store (reference checker.clj:96-103 renders it with
        knossos.linear.report/render-analysis!). A failure to render
        never masks the verdict."""
        import os
        d = test.get("store-dir") if isinstance(test, dict) else None
        if not d:
            return
        try:
            from jepsen_tpu_torch.checker.counterexample import (
                render_linear_svg)
            try:
                pk = pack_with_init(history, model)
            except ValueError:
                return  # the object path: no packed encoding to draw
            os.makedirs(d, exist_ok=True)
            a = render_linear_svg(pk[0], pk[1], out,
                                  os.path.join(d, "linear.svg"))
            out["counterexample"] = "linear.svg"
            if a.get("final-path"):
                # knossos's :final-paths: one maximal linearization order
                # (checker.clj:104-107)
                out["final-path"] = a["final-path"]
            if a.get("frontier-states"):
                # knossos's :configs: the reachable frontier states, the
                # first 10 as checker.clj:104-107 keeps
                out["configs"] = a["frontier-states"][:10]
        except Exception as e:  # noqa: BLE001
            out["counterexample-error"] = repr(e)


def linearizable(model: Optional[Model] = None, backend: str = "gpu",
                 device=None, max_configs: Optional[int] = None,
                 algorithm: str = "auto") -> LinearizableChecker:
    return LinearizableChecker(model, backend, device, max_configs,
                               algorithm)
