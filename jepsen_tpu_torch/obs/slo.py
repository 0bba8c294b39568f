"""SLO engine: declarative objectives evaluated as burn rates.

A copy of the reference's ``jepsen_tpu/obs/slo.py``: the same objectives,
windows, burn arithmetic, transitions and gauge.

An objective says "99% of verdicts inside 5s" or "99.9% of answers not
5xx"; the engine turns each into an **error-budget burn rate** over the
time-series store (:mod:`jepsen_tpu_torch.obs.tsdb`)::

    burn = bad_ratio(window) / (1 - target)

burn = 1 means the budget is being spent exactly as fast as the SLO
allows; burn = 10 exhausts a month's budget in three days. Following
the multi-window pattern (Google SRE workbook ch. 5), an objective
**breaches** only when *every* window (5m and 1h) burns at or above
``JTPU_SLO_BURN`` — the short window proves the problem is current,
the long one that it is material — and **recovers** when the short
window cools back below it. Transitions emit ``slo.breach`` /
``slo.recovered`` trail events, update the
``jtpu_slo_burn_rate{slo,tenant}`` gauge (registered lazily here, so
the exposition is untouched while ``JTPU_TSDB=0`` keeps the engine
unconstructed), and optionally POST to ``JTPU_SLO_WEBHOOK``.

Default objectives over the serve daemon's metrics:

* ``verdict-latency-p99``  — p99 of ``jtpu_serve_request_seconds``
  inside ``JTPU_SLO_LATENCY_P99_S`` (default 5s), target 99%;
* ``queue-wait-p95``       — p95 of ``jtpu_serve_queue_wait_seconds``
  inside ``JTPU_SLO_QUEUE_P95_S`` (default 1s), target 95%;
* ``availability``         — bad = breaker-open/draining rejections +
  deadline timeouts, answered = verdicts + bad, target
  ``JTPU_SLO_AVAILABILITY`` (default 99.9%).

The engine subscribes to the store's tick (``tsdb.on_tick``), so its
cost is one windowed sum per objective per sample — no extra threads.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from jepsen_tpu_torch.obs import metrics as obs_metrics
from jepsen_tpu_torch.obs import trace as obs_trace
from jepsen_tpu_torch.obs import tsdb as obs_tsdb

log = logging.getLogger("jepsen.slo")

#: (label, seconds). Breach needs every window burning; recovery needs
#: only the first (shortest) window cool.
DEFAULT_WINDOWS: Tuple[Tuple[str, float], ...] = (("5m", 300.0),
                                                  ("1h", 3600.0))

DEFAULT_BURN = 1.0


def _env_f(name: str, default: float) -> float:
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        log.warning("%s=%r is not a number; using %s", name, v, default)
        return default


class Objective:
    """One declarative objective. ``kind`` picks the bad/total source:

    * ``latency``      — histogram ``metric``; bad = observations above
      ``threshold`` seconds (from windowed bucket deltas);
    * ``availability`` — ``bad_of``/``good_of`` counter specs, each a
      list of ``(metric, {label: value})`` windowed-delta terms.
    """

    def __init__(self, name: str, kind: str, target: float,
                 metric: Optional[str] = None,
                 threshold: Optional[float] = None,
                 bad_of: Optional[List[Tuple[str, dict]]] = None,
                 good_of: Optional[List[Tuple[str, dict]]] = None):
        self.name = name
        self.kind = kind
        self.target = float(target)
        self.metric = metric
        self.threshold = threshold
        self.bad_of = bad_of or []
        self.good_of = good_of or []

    def describe(self) -> dict:
        doc: Dict[str, Any] = {"kind": self.kind, "target": self.target}
        if self.metric:
            doc["metric"] = self.metric
        if self.threshold is not None:
            doc["threshold-s"] = self.threshold
        return doc

    # -- bad/total inside one window ----------------------------------

    def _counts(self, db: obs_tsdb.TSDB, window_s: float, now: float,
                match: dict) -> Tuple[float, float]:
        if self.kind == "latency":
            cnt, _sm, buckets = db.window_hist(self.metric, window_s,
                                               now, **match)
            if cnt <= 0:
                return 0.0, 0.0
            bounds = db.bounds(self.metric) or []
            good = 0
            for i, b in enumerate(bounds):
                if b <= self.threshold and i < len(buckets):
                    good += buckets[i]
            return float(cnt - good), float(cnt)
        bad = sum(db.window_delta(m, window_s, now, **{**lbl, **match})
                  for m, lbl in self.bad_of)
        good = sum(db.window_delta(m, window_s, now, **{**lbl, **match})
                   for m, lbl in self.good_of)
        return float(bad), float(bad + good)

    def burn(self, db: obs_tsdb.TSDB, window_s: float, now: float,
             match: Optional[dict] = None) -> Tuple[float, float]:
        """``(burn rate, total answered)`` for one window. An empty
        window burns 0 — no traffic spends no budget."""
        bad, total = self._counts(db, window_s, now, match or {})
        if total <= 0:
            return 0.0, 0.0
        budget = max(1e-9, 1.0 - self.target)
        return (bad / total) / budget, total

    def tenants(self, db: obs_tsdb.TSDB) -> List[str]:
        """Tenant label values present in this objective's series."""
        names = [self.metric] if self.metric else \
            [m for m, _ in self.bad_of + self.good_of]
        out = set()
        for n in names:
            for sk in db.series_keys(n):
                for k, v in obs_tsdb._key_pairs(sk):
                    if k == "tenant":
                        out.add(v)
        return sorted(out)


def default_objectives() -> List[Objective]:
    """The serve daemon's stock objectives (env-tunable thresholds)."""
    return [
        Objective("verdict-latency-p99", "latency", target=0.99,
                  metric="jtpu_serve_request_seconds",
                  threshold=_env_f("JTPU_SLO_LATENCY_P99_S", 5.0)),
        Objective("queue-wait-p95", "latency", target=0.95,
                  metric="jtpu_serve_queue_wait_seconds",
                  threshold=_env_f("JTPU_SLO_QUEUE_P95_S", 1.0)),
        Objective("availability", "availability",
                  target=_env_f("JTPU_SLO_AVAILABILITY", 0.999),
                  bad_of=[("jtpu_serve_rejected_total",
                           {"reason": "breaker-open"}),
                          ("jtpu_serve_rejected_total",
                           {"reason": "draining"}),
                          ("jtpu_serve_deadline_timeouts_total", {})],
                  good_of=[("jtpu_serve_completed_total", {})]),
    ]


class SLOEngine:
    """Evaluates objectives on every tsdb tick and tracks breach state.

    Single evaluator thread (the tsdb sampler drives :meth:`evaluate`);
    one lock makes the latest snapshot readable from HTTP/healthz
    threads. Construct only when the tsdb layer is on — construction
    registers the burn-rate gauge."""

    def __init__(self, db: obs_tsdb.TSDB,
                 objectives: Optional[List[Objective]] = None,
                 windows: Tuple[Tuple[str, float], ...] = DEFAULT_WINDOWS,
                 burn_threshold: Optional[float] = None,
                 webhook: Optional[str] = None,
                 on_transition: Optional[Callable[[dict], None]] = None):
        self.db = db  # guarded-by: none — config, immutable after init
        # guarded-by: none — configuration, immutable after init
        self.objectives = list(objectives if objectives is not None
                               else default_objectives())
        self.windows = tuple(windows)               # guarded-by: none
        self.burn_threshold = _env_f("JTPU_SLO_BURN", DEFAULT_BURN) \
            if burn_threshold is None else float(burn_threshold)
        self.webhook = webhook if webhook is not None \
            else os.environ.get("JTPU_SLO_WEBHOOK") or None
        self.on_transition = on_transition          # guarded-by: none
        self._gauge = obs_metrics.gauge(
            "jtpu_slo_burn_rate",
            "error-budget burn rate per SLO and tenant over the short "
            "window (1.0 = spending exactly the objective's budget)")
        self._lock = threading.Lock()
        self._breached: Dict[str, bool] = {}
        self._last: Dict[str, Any] = {"objectives": {}, "breached": 0}
        db.on_tick.append(self.evaluate)

    # -- evaluation ---------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One pass over every objective; returns (and retains) the
        snapshot doc served by ``/slo`` and healthz."""
        now = float(self.db.now_fn()) if now is None else float(now)
        docs: Dict[str, Any] = {}
        transitions: List[dict] = []
        short_label, short_s = self.windows[0]
        with self._lock:
            for obj in self.objectives:
                burns: Dict[str, float] = {}
                totals: Dict[str, float] = {}
                for label, w in self.windows:
                    b, n = obj.burn(self.db, w, now)
                    burns[label] = round(b, 6)
                    totals[label] = n
                was = self._breached.get(obj.name, False)
                hot = all(b >= self.burn_threshold
                          for b in burns.values()) \
                    and totals[short_label] > 0
                cooled = burns[short_label] < self.burn_threshold
                if not was and hot:
                    breached = True
                elif was and cooled:
                    breached = False
                else:
                    breached = was
                if breached != was:
                    self._breached[obj.name] = breached
                    transitions.append(
                        {"slo": obj.name,
                         "event": ("slo.breach" if breached
                                   else "slo.recovered"),
                         "burn": burns[short_label],
                         "windows": dict(burns), "ts": now})
                self._gauge.set(burns[short_label], slo=obj.name,
                                tenant="all")
                for t in obj.tenants(self.db):
                    tb, _n = obj.burn(self.db, short_s, now,
                                      {"tenant": t})
                    self._gauge.set(round(tb, 6), slo=obj.name,
                                    tenant=t)
                doc = obj.describe()
                doc["windows"] = burns
                doc["answered"] = totals[short_label]
                doc["breached"] = self._breached.get(obj.name, False)
                docs[obj.name] = doc
            self._last = {
                "burn-threshold": self.burn_threshold,
                "windows": {l: s for l, s in self.windows},
                "objectives": docs,
                "breached": sum(1 for v in self._breached.values()
                                if v),
            }
            snap = self._last
        for tr in transitions:
            self._announce(tr)
        return snap

    def _announce(self, tr: dict) -> None:
        obs_trace.event(tr["event"], slo=tr["slo"], burn=tr["burn"],
                        tenant="all")
        log.warning("%s: %s (burn %.3g, windows %s)", tr["event"],
                    tr["slo"], tr["burn"], tr["windows"])
        cb = self.on_transition
        if cb is not None:
            try:
                cb(tr)
            except Exception:
                log.warning("slo transition callback failed",
                            exc_info=True)
        if self.webhook:
            threading.Thread(target=self._post_webhook, args=(tr,),
                             name="jtpu-slo-webhook",
                             daemon=True).start()

    def _post_webhook(self, tr: dict) -> None:
        # fire-and-forget: an unreachable webhook must never stall or
        # kill the evaluator
        try:
            import urllib.request
            req = urllib.request.Request(
                self.webhook, data=json.dumps(tr).encode("utf-8"),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=5).close()
        except Exception as e:
            log.warning("SLO webhook %s failed: %s", self.webhook, e)

    # -- reads --------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The last evaluation (evaluating now if none yet)."""
        with self._lock:
            if self._last.get("objectives"):
                return self._last
        return self.evaluate()

    def breached(self) -> int:
        with self._lock:
            return sum(1 for v in self._breached.values() if v)

    def max_burn(self) -> float:
        with self._lock:
            docs = (self._last.get("objectives") or {}).values()
        short = self.windows[0][0]
        return max((d.get("windows", {}).get(short, 0.0)
                    for d in docs), default=0.0)
