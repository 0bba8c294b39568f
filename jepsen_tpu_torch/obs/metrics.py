"""Metrics registry: counters, gauges, fixed-bucket histograms.

A copy of the reference's ``jepsen_tpu/obs/metrics.py``: the same
metric names, the same exposition byte for byte.

Prometheus's data model without the dependency: a metric has a name, a
help string, and one series per label set; histograms carry fixed upper
bounds chosen at creation (cumulative ``le`` buckets plus sum/count in
the exposition, so rates and quantile estimates work in any Prometheus/
Grafana stack). Everything is guarded by one registry lock — updates
are dict arithmetic, cheap enough for per-fsync / per-segment call
sites (per-op call sites go through the tracer instead).

Surfaces:

* :func:`Registry.to_prometheus` — the text exposition format, served
  at ``/metrics`` by the check daemon (:mod:`jepsen_tpu_torch.serve`);
* :func:`Registry.snapshot` / :func:`write_snapshot` — a JSON document,
  written as the ``metrics.json`` run artifact by
  :func:`jepsen_tpu_torch.obs.finish_run` (the
  registry is process-global, so the snapshot is cumulative across the
  runs this process performed — exactly what a scrape would see).

Instrumented modules create their metrics at import time via the
module-level :func:`counter`/:func:`gauge`/:func:`histogram` helpers
(get-or-create), so ``/metrics`` lists the catalog as soon as the
layers load, not only after the first event.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

#: Default histogram bounds (seconds): 100us .. 30s, log-ish spacing —
#: covers WAL fsyncs, client ops, device segments, and heal probes.
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0)

_LabelKey = Tuple[Tuple[str, str], ...]


def quantile_from_buckets(q: float, counts: List[int],
                          bounds: Tuple[float, ...]) -> Optional[float]:
    """Nearest-rank quantile over non-cumulative bucket ``counts``
    (``len(bounds) + 1`` entries, the last being the +Inf overflow):
    the upper bound of the bucket holding the ``ceil(q * total)``-th
    observation. Observations past the last bound report the last bound
    — the histogram cannot resolve further. None when empty. Module
    level so the tsdb/SLO layers can run it over *windowed* bucket
    deltas, not just live series."""
    total = sum(counts)
    if total <= 0:
        return None
    q = min(max(float(q), 0.0), 1.0)
    rank = max(1, math.ceil(q * total))
    cum = 0
    for i, c in enumerate(counts[:len(bounds)]):
        cum += c
        if cum >= rank:
            return bounds[i]
    return bounds[-1] if bounds else None


def _labels_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """HELP-line escaping per the text exposition format: backslash and
    newline only (quotes are legal in help text)."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(key: _LabelKey, extra: Iterable[Tuple[str, str]] = ()
                ) -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in list(key) + list(extra)]
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_num(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._series: Dict[_LabelKey, Any] = {}

    def _expose_series(self, key: _LabelKey, val: Any) -> List[str]:
        return [f"{self.name}{_fmt_labels(key)} {_fmt_num(val)}"]

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        for key in sorted(self._series):
            lines.extend(self._expose_series(key, self._series[key]))
        return lines

    def snapshot(self) -> Any:
        return {_fmt_labels(k) or "": v for k, v in self._series.items()}


class Counter(_Metric):
    """A monotonically-increasing total."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _labels_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_labels_key(labels), 0.0))

    def total(self, **match) -> float:
        """Sum across every series whose labels include ``match`` (all
        series when empty) — e.g. cold compiles across kinds for the
        ``# compile:`` attribution line."""
        want = set(_labels_key(match))
        with self._lock:
            return float(sum(v for k, v in self._series.items()
                             if want <= set(k)))


class Gauge(_Metric):
    """A point-in-time value (also usable as a high-water mark via
    :meth:`set_max` — e.g. the search frontier's widest live row
    count)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_labels_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _labels_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def set_max(self, value: float, **labels) -> None:
        key = _labels_key(labels)
        with self._lock:
            self._series[key] = max(self._series.get(key, value),
                                    float(value))

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_labels_key(labels), 0.0))


class Histogram(_Metric):
    """Fixed-bucket histogram. Each series is ``[counts..., sum,
    count]`` where ``counts[i]`` is the NON-cumulative tally of
    observations <= bounds[i] and > bounds[i-1]; the exposition emits
    the cumulative ``le`` form Prometheus expects.

    ``observe(..., exemplar={"trace_id": tid})`` additionally remembers
    the labeled observation as that bucket's **exemplar** — emitted as
    an OpenMetrics ``# {trace_id="..."} value`` suffix on the bucket
    line, so a scrape of a tail-latency bucket links straight to the
    exact slow request's distributed trace. Last-write-wins per bucket
    (the OpenMetrics model); an exposition without exemplars is
    byte-identical to the pre-exemplar format."""

    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help, lock)
        self.bounds = tuple(sorted(float(b) for b in buckets))
        self._exemplars: Dict[Tuple[_LabelKey, int],
                              Tuple[Dict[str, str], float]] = {}

    def observe(self, value: float,
                exemplar: Optional[Dict[str, Any]] = None,
                **labels) -> None:
        key = _labels_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = [0] * (len(self.bounds) + 1) \
                    + [0.0, 0]
            i = 0
            for i, b in enumerate(self.bounds):
                if value <= b:
                    break
            else:
                i = len(self.bounds)
            s[i] += 1
            s[-2] += float(value)
            s[-1] += 1
            if exemplar:
                self._exemplars[(key, i)] = (
                    {str(k): str(v) for k, v in exemplar.items()},
                    float(value))

    def series(self, **labels) -> Optional[dict]:
        """{bucket-counts (non-cumulative), sum, count} for one series."""
        with self._lock:
            s = self._series.get(_labels_key(labels))
            if s is None:
                return None
            return {"buckets": list(s[:-2]), "sum": s[-2], "count": s[-1]}

    def total(self, **match) -> Dict[str, float]:
        """``{"sum", "count"}`` across every series whose labels include
        ``match`` — e.g. all compile-phase device seconds regardless of
        kind."""
        want = set(_labels_key(match))
        tot_sum, tot_count = 0.0, 0
        with self._lock:
            for k, s in self._series.items():
                if want <= set(k):
                    tot_sum += s[-2]
                    tot_count += s[-1]
        return {"sum": tot_sum, "count": tot_count}

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Nearest-rank quantile estimate over bucket counts: the sum
        runs across every series whose labels include ``labels`` (all
        of them when empty — the SLO engine asks for p99 across
        tenants). Returns the upper bound of the bucket holding the
        q-th observation (:func:`quantile_from_buckets`); None when no
        matching series has observations."""
        want = set(_labels_key(labels))
        counts = [0] * (len(self.bounds) + 1)
        with self._lock:
            for k, s in self._series.items():
                if want <= set(k):
                    for i in range(len(counts)):
                        counts[i] += s[i]
        return quantile_from_buckets(q, counts, self.bounds)

    def _exemplar_suffix(self, key: _LabelKey, i: int) -> str:
        ex = self._exemplars.get((key, i))
        if not ex:
            return ""
        labels, value = ex
        inner = ",".join(f'{k}="{_escape(v)}"'
                         for k, v in sorted(labels.items()))
        return f" # {{{inner}}} {_fmt_num(value)}"

    def _expose_series(self, key: _LabelKey, s: list) -> List[str]:
        lines = []
        cum = 0
        for i, b in enumerate(self.bounds):
            cum += s[i]
            lines.append(f"{self.name}_bucket"
                         f"{_fmt_labels(key, [('le', _fmt_num(b))])} "
                         f"{cum}{self._exemplar_suffix(key, i)}")
        cum += s[len(self.bounds)]
        lines.append(f"{self.name}_bucket"
                     f"{_fmt_labels(key, [('le', '+Inf')])} {cum}"
                     f"{self._exemplar_suffix(key, len(self.bounds))}")
        lines.append(f"{self.name}_sum{_fmt_labels(key)} "
                     f"{_fmt_num(s[-2])}")
        lines.append(f"{self.name}_count{_fmt_labels(key)} {s[-1]}")
        return lines

    def snapshot(self) -> Any:
        out = {}
        for k, v in self._series.items():
            doc = {"buckets": list(v[:-2]),
                   "bounds": list(self.bounds),
                   "sum": v[-2], "count": v[-1]}
            exs = {i: {"labels": dict(labels), "value": value}
                   for (key, i), (labels, value)
                   in self._exemplars.items() if key == k}
            if exs:
                doc["exemplars"] = exs
            out[_fmt_labels(k) or ""] = doc
        return out


class Registry:
    """Name -> metric, with get-or-create accessors. One lock serializes
    every update (contention is negligible at the instrumented call
    rates; the per-op hot path records spans, not metrics)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, self._lock,
                                              **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def to_prometheus(self) -> str:
        """The text exposition format (version 0.0.4)."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """``{"ts": wall-clock, <name>: {"kind", "help", "series"}}``.
        The ``ts`` field rides at top level next to the metric names
        (names are ``jtpu_``-prefixed, no collision); consumers that
        iterate metric entries skip the float. The tsdb sampler and
        ``watch`` both date samples off it."""
        with self._lock:
            metrics = dict(self._metrics)
        doc: Dict[str, Any] = {"ts": time.time()}
        for name, m in sorted(metrics.items()):
            doc[name] = {"kind": m.kind, "help": m.help,
                         "series": m.snapshot()}
        return doc

    def reset(self) -> None:
        """Drop every metric (tests)."""
        with self._lock:
            self._metrics.clear()


#: The process-global registry every instrumented layer writes to and
#: /metrics + metrics.json read from.
REGISTRY = Registry()

#: Content-Type for the exposition endpoint.
PROMETHEUS_CTYPE = "text/plain; version=0.0.4; charset=utf-8"


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, buckets)


def write_snapshot(path: str) -> None:
    """Atomically write the registry snapshot as a JSON artifact
    (tmp + ``os.replace``, the store's crash-safety contract — obs must
    not import store, store imports the instrumented layers)."""
    doc = json.dumps(REGISTRY.snapshot(), indent=2, default=repr)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(doc)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
