"""Straggler observatory: per-host skew scored against the fleet.

A copy of the reference's ``jepsen_tpu/obs/straggler.py`` over the
port's metrics registry.

*Near-Optimal Wafer-Scale Reduce* (PAPERS.md) motivates the problem:
one straggling participant bounds every barriered reduction, so skew
detection must be continuous, not post-mortem. This module keeps two
EWMAs per host — segment device-time (fed by the leader's collect
barrier and by federated ``checker.segment`` span frames) and
heartbeat/frame age — and scores each host against the **median of the
other hosts' EWMAs**::

    score(h) = max_signal  ewma_signal(h) / median(ewma_signal(others))

Scoring against the *others'* median (not the fleet median including
``h``) keeps the detector sharp at small fleet widths: with two hosts
the fleet median is the mean, which dilutes a 5x straggler to a 1.7x
score; against the other host alone the ratio survives intact.

A host whose score reaches ``JTPU_STRAGGLER_SIGMA`` (default 2.0, the
kind of multiplicative skew worth re-dealing rows over) is **flagged**:

* the lazily-registered ``jtpu_fleet_straggler_score{host}`` gauge
  carries every host's score (registration happens in the constructor,
  so the exposition is untouched while ``JTPU_FEDERATE=0`` keeps the
  detector unconstructed, mirroring :mod:`jepsen_tpu_torch.obs.slo`);
* :meth:`poll_new` reports newly-flagged hosts exactly once — the
  elastic fleet turns that into a ``straggler-flagged`` trail event and
  forces the next work-steal re-deal; the serve ``FleetPlacer`` and the
  gang shard loop consult :meth:`flagged` to place shards on unflagged
  hosts first.

Flagging is advisory only: it reorders/forces placement and stealing
but never changes verdicts (shard-to-host assignment is verdict-
neutral — every lane computes the same carry wherever it runs).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Set

from jepsen_tpu_torch.obs import metrics as obs_metrics

DEFAULT_SIGMA = 2.0

#: EWMA weight for the newest observation — heavy on purpose, so a
#: host that turns slow is flagged within the acceptance window of
#: three merge rounds rather than ten.
ALPHA = 0.5

#: Observations required per host before it can be *flagged* (scores
#: are published immediately; one noisy segment must not trigger a
#: re-deal). Each host's FIRST segment sample is discarded before
#: counting starts — it is cold-jit compile time, not skew.
MIN_SAMPLES = 2

#: Segment-signal denominator floor: a fleet whose other hosts
#: answered "instantly" must not divide by zero, and segments under
#: ~50ms are dominated by host-side dispatch/scheduling jitter rather
#: than device work (a 1ms-vs-5ms split is noise, not a 5x straggler)
#: — a host only scores on segment time once its EWMA clears
#: sigma x 50ms over the others.
MED_FLOOR = 0.05

#: Age-signal denominator floor: sub-second heartbeat/frame ages are
#: beacon-cadence jitter (workers beat every ~0.25s), not skew — a
#: host only scores on age once it sits a full second staler than the
#: others' median.
AGE_FLOOR = 1.0


def sigma_from_env() -> float:
    v = os.environ.get("JTPU_STRAGGLER_SIGMA")
    if not v:
        return DEFAULT_SIGMA
    try:
        return max(1.0, float(v))
    except ValueError:
        return DEFAULT_SIGMA


def host_key(host: Any) -> str:
    """The federation-wide key for a fleet host object: the host-dir
    basename when it has one (matches the ``host=`` attribute worker
    segment spans and telemetry frames carry), else its name."""
    d = getattr(host, "dir", None)
    if d:
        base = os.path.basename(os.path.normpath(str(d)))
        if base:
            return base
    return str(getattr(host, "name", "?"))


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if not n:
        return 0.0
    if n % 2:
        return s[n // 2]
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


class StragglerDetector:
    """Thread-safe EWMA scorer. Construct only when federation is on —
    construction registers the score gauge."""

    def __init__(self, sigma: Optional[float] = None):
        self.sigma = sigma_from_env() if sigma is None else float(sigma)
        self._lock = threading.Lock()
        # guarded-by: _lock — per-host EWMAs per signal + sample counts
        self._seg: Dict[str, float] = {}
        self._age: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._warm: Set[str] = set()
        self._announced: Set[str] = set()
        self._gauge = obs_metrics.gauge(
            "jtpu_fleet_straggler_score",
            "per-host skew vs the median of the other hosts' segment "
            "and heartbeat EWMAs (1.0 = keeping pace)")

    # -- feeds --------------------------------------------------------

    def observe_segment(self, host: str, seconds: float) -> None:
        """One per-host segment duration from the collect barrier or a
        federated ``checker.segment`` span."""
        self._observe("seg", host, float(seconds), count=True)

    def observe_heartbeat(self, host: str, age_s: float) -> None:
        """Heartbeat (or telemetry-frame) age at observation time."""
        self._observe("age", host, float(age_s), count=False)

    def forget(self, host: str) -> None:
        """Drop a host that left the fleet: a dead host must not skew
        the others' medians, and rejoining starts it fresh."""
        with self._lock:
            self._seg.pop(host, None)
            self._age.pop(host, None)
            self._count.pop(host, None)
            self._warm.discard(host)
            self._announced.discard(host)
        self._publish()

    def _observe(self, which: str, host: str, v: float,
                 count: bool) -> None:
        if v < 0:
            return
        with self._lock:
            table = self._seg if which == "seg" else self._age
            if count and host not in self._warm:
                # a host's FIRST segment is cold-jit compile time, not
                # skew (every host pays it, at wildly varying scale) —
                # seeding the EWMA with it would take rounds to decay,
                # so it is discarded and the EWMA seeds from the
                # second segment
                self._warm.add(host)
                return
            cur = table.get(host)
            table[host] = v if cur is None else \
                ALPHA * v + (1.0 - ALPHA) * cur
            if count:
                self._count[host] = self._count.get(host, 0) + 1
        self._publish()

    # -- scores -------------------------------------------------------

    def _scores_locked(self) -> Dict[str, float]:
        hosts = set(self._seg) | set(self._age)
        out: Dict[str, float] = {}
        for h in hosts:
            score = 1.0
            for table, floor in ((self._seg, MED_FLOOR),
                                 (self._age, AGE_FLOOR)):
                v = table.get(h)
                if v is None or len(table) < 2:
                    continue
                med = _median([w for h2, w in table.items() if h2 != h])
                score = max(score, v / max(med, floor))
            out[h] = round(score, 3)
        return out

    def scores(self) -> Dict[str, float]:
        with self._lock:
            return self._scores_locked()

    def flagged(self) -> Set[str]:
        """Hosts currently scoring at or above sigma (with enough
        samples to trust the score)."""
        with self._lock:
            scores = self._scores_locked()
            return {h for h, s in scores.items()
                    if s >= self.sigma
                    and self._count.get(h, 0) >= MIN_SAMPLES}

    def poll_new(self) -> Set[str]:
        """Newly-flagged hosts since the last poll (un-flagged hosts
        are forgotten, so a relapse announces again)."""
        cur = self.flagged()
        with self._lock:
            new = cur - self._announced
            self._announced = cur
        return new

    def prefer(self, hosts: Iterable[Any]) -> List[Any]:
        """The placement advisory: the same hosts, unflagged first
        (stable — original order is kept within each class). With
        fewer shards than hosts, flagged hosts simply get none."""
        flagged = self.flagged()
        return sorted(hosts, key=lambda h: host_key(h) in flagged)

    def _publish(self) -> None:
        for h, s in self.scores().items():
            self._gauge.set(s, host=h)
