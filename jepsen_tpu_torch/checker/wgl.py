"""The linearizability checker facade and the exact host search.

Counterpart of ``jepsen_tpu/checker/wgl.py`` (``check_packed`` and
``LinearizableChecker``). The host search is Wing-Gong-Lowe over the
packed history: a configuration is ``(k, mask, state)`` with ops
``[0, k)`` (in return order) linearized and ``mask`` marking further
linearized ops at offsets >= k; a DFS with a visited set explores them.
With ``backend="gpu"`` the device search decides, and the host search
runs only when the device answers UNKNOWN; the result then says so
(``fallback-from: "gpu"``). A build or launch failure raises: it is never
turned into a host fallback.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from jepsen_tpu_torch.checker import UNKNOWN, Checker
from jepsen_tpu_torch.checker.gpu import check_history_gpu
from jepsen_tpu_torch.models.core import KernelSpec, Model
from jepsen_tpu_torch.ops.encode import PackedHistory, pack_with_init


def check_packed(p: PackedHistory, kernel: KernelSpec) -> Dict[str, Any]:
    """Exact WGL over a packed history. The mask is a Python int, so no
    window limit applies."""
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


class LinearizableChecker(Checker):
    """Checker facade.

    backend:
      'gpu' -- (default) the device search on ``device`` (None = CUDA);
               the exact host search only when it answers UNKNOWN.
      'cpu' -- the exact host search.
    """

    def __init__(self, model: Optional[Model] = None, backend: str = "gpu",
                 device=None):
        if backend not in ("gpu", "cpu"):
            raise ValueError(f"unknown backend {backend!r}")
        self.model = model
        self.backend = backend
        self.device = device

    def check(self, test, history, opts=None):
        model = self.model or test.get("model")
        if model is None:
            raise ValueError("linearizable checker needs a model")
        if self.backend == "cpu":
            out = self._check_host(history, model)
            out.setdefault("backend", "cpu")
            return out
        res = check_history_gpu(history, model, device=self.device)
        if res is None:
            raise ValueError(
                f"model {model!r} has no integer kernel in this port, or an "
                f"op does not fit its encoding")
        if res.get("valid") is not UNKNOWN:
            return res
        out = self._check_host(history, model)
        out.setdefault("backend", "cpu")
        out["fallback-from"] = "gpu"
        out["fallback-reason"] = res.get("error",
                                         "device search returned unknown")
        return out

    def _check_host(self, history, model: Model) -> Dict[str, Any]:
        pk = pack_with_init(history, model)
        if pk is None:
            raise ValueError(f"model {model!r} has no integer kernel in "
                             f"this port")
        packed, kernel = pk
        return check_packed(packed, kernel)


def linearizable(model: Optional[Model] = None, backend: str = "gpu",
                 device=None) -> LinearizableChecker:
    return LinearizableChecker(model, backend, device)
