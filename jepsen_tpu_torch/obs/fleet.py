"""Fleet telemetry: merge N hosts' run artifacts into one view.

The port's copy of ``jepsen_tpu.obs.fleet``: a host module over run
directories, each holding a process's ``trace.jsonl``, ``metrics.json``
and ``progress.json``. It correlates them into one view (which host
straggles, which host's frontier is widest, how much headroom each card
has left), and stitches one request's trace across the processes that
touched it (``trace request``). The port has no fleet scheduler yet
(ROADMAP A7), so a ``heartbeat.json`` only comes from a copied
directory; a process's own run directory is a one-host fleet.

:func:`merge` fuses host directories:

* **Clock alignment.** Each host's trace timestamps are monotonic ns
  from *that process's* epoch — mutually meaningless. But a multi-host
  device step is a barrier: the cross-host collective (the DCN gather
  of a sharded search, the keyed batch launch — spans
  ``checker.device.sharded`` / ``checker.device.batch``; failing
  those, the first ``checker.segment`` / ``core.run``) happens at the
  same wall instant on every participating host. The first anchor span
  name present in every host's trace aligns them: every host's
  timeline is shifted so its first anchor span starts where the
  reference host's does.
* **Traces** concatenate with a ``host`` attribute and per-track
  monotonic order preserved; :func:`to_chrome` renders one Chrome/
  Perfetto document with one process per host, device lanes included.
* **Metrics** re-key every series with a ``host`` label; counters
  additionally aggregate to a summed ``fleet`` series and gauges to a
  maxed one (the conservative read for headroom-style gauges is the
  worst host — consumers can still read per-host series).
* **Progress** is kept per host, and :func:`format_fleet` renders the
  side-by-side status lines (level, shard imbalance, headroom) that
  ``python -m jepsen_tpu_torch watch --fleet`` shows.

Everything tolerates ragged fleets: a host missing an artifact (killed
early, ``JTPU_TRACE=0``) contributes what it has.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from jepsen_tpu_torch.obs import trace as obs_trace

#: The per-host artifacts a fleet merge consumes. heartbeat.json is an
#: elastic fleet worker's liveness beacon, written next to the
#: observatory artifacts; its age drives the host=dead rendering below.
HOST_ARTIFACTS = ("trace.jsonl", "metrics.json", "progress.json",
                  "heartbeat.json")

#: The heartbeat artifact's filename.
HEARTBEAT_NAME = "heartbeat.json"

#: Heartbeat age (seconds) past which a host renders as dead in the
#: fleet view (the fleet's JTPU_FLEET_DEAD_S default).
HEARTBEAT_DEAD_S = 10.0

#: Anchor span names tried in order; the first present in EVERY host's
#: trace wins. The cross-host device launches are true barriers; the
#: fallbacks degrade gracefully for single-device fixtures.
DEFAULT_ANCHORS = ("checker.device.sharded", "checker.device.batch",
                   "checker.segment", "core.run")


def is_host_dir(d: str) -> bool:
    try:
        return any(os.path.exists(os.path.join(d, a))
                   for a in HOST_ARTIFACTS)
    except OSError:  # dir vanished mid-probe
        return False


def discover_hosts(run_dir: str) -> List[str]:
    """Host artifact directories under a run directory: immediate
    subdirectories carrying any host artifact, else the run directory
    itself (a single-host run is a one-host fleet). Tolerates the run
    dir vanishing mid-scan (a dead fleet is rendered, not raised)."""
    try:
        entries = (os.listdir(run_dir) if os.path.isdir(run_dir)
                   else [])
    except OSError:
        return []
    subs = sorted(
        os.path.join(run_dir, e) for e in entries
        if os.path.isdir(os.path.join(run_dir, e))
        and not os.path.islink(os.path.join(run_dir, e))
        and is_host_dir(os.path.join(run_dir, e)))
    if subs:
        return subs
    return [run_dir] if is_host_dir(run_dir) else []


def read_host(d: str, host: Optional[str] = None) -> Dict[str, Any]:
    """One host's artifact set: ``{"host", "dir", "trace",
    "trace-stats", "metrics", "progress", "heartbeat", "missing"}``
    with absent artifacts as empty/None.

    A host dir that has VANISHED (the host died and its scratch was
    reaped, or an NFS mount dropped) or goes torn mid-poll must come
    back as a ``missing`` host, never an exception — the fleet view's
    whole job is rendering dead hosts next to live ones."""
    host = host or os.path.basename(os.path.normpath(d)) or d
    out: Dict[str, Any] = {"host": host, "dir": d, "trace": [],
                           "trace-stats": None, "metrics": None,
                           "progress": None, "heartbeat": None,
                           "missing": False}
    try:
        if not os.path.isdir(d):
            out["missing"] = True
            return out
        tpath = os.path.join(d, obs_trace.TRACE_NAME)
        if os.path.exists(tpath):
            try:
                out["trace"], out["trace-stats"] = \
                    obs_trace.read_trace(tpath)
            except (OSError, ValueError):
                pass
        mpath = os.path.join(d, "metrics.json")
        try:
            with open(mpath) as f:
                doc = json.load(f)
            if isinstance(doc, dict):
                out["metrics"] = doc
        except (OSError, ValueError):
            pass
        hpath = os.path.join(d, "heartbeat.json")
        try:
            with open(hpath) as f:
                hb = json.load(f)
            if isinstance(hb, dict):
                out["heartbeat"] = hb
        except (OSError, ValueError):
            pass
        from jepsen_tpu_torch.obs import observatory
        out["progress"] = observatory.read_progress(d)
    except OSError:
        # the dir went away between the isdir probe and a read
        out["missing"] = True
    return out


# ---------------------------------------------------------------------------
# Clock alignment
# ---------------------------------------------------------------------------


def _first_span_ts(records: List[dict], name: str) -> Optional[int]:
    hits = [int(r.get("ts", 0)) for r in records if r.get("name") == name]
    return min(hits) if hits else None


def clock_offsets(hosts: List[Dict[str, Any]],
                  anchors: Tuple[str, ...] = DEFAULT_ANCHORS
                  ) -> Tuple[Dict[str, int], Optional[str]]:
    """Per-host ns offsets aligning every host's first anchor span onto
    the reference (first) host's. Returns ``({host: offset}, anchor)``;
    hosts without a trace (or when no anchor is shared) get offset 0
    and anchor None is reported."""
    traced = [h for h in hosts if h["trace"]]
    offsets = {h["host"]: 0 for h in hosts}
    if len(traced) < 2:
        return offsets, None
    for name in anchors:
        ts = {h["host"]: _first_span_ts(h["trace"], name)
              for h in traced}
        if all(v is not None for v in ts.values()):
            ref = ts[traced[0]["host"]]
            for h in traced:
                offsets[h["host"]] = ref - ts[h["host"]]
            return offsets, name
    return offsets, None


# ---------------------------------------------------------------------------
# Metrics merging
# ---------------------------------------------------------------------------

_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def _parse_labels(key: str) -> List[Tuple[str, str]]:
    """A formatted label string (``{a="b",c="d"}`` or ``""``) back to
    pairs — the inverse of metrics._fmt_labels for the label values the
    registry actually emits."""
    return _LABEL_RE.findall(key or "")


def _with_host(key: str, host: str) -> str:
    pairs = _parse_labels(key) + [("host", host)]
    pairs.sort()
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"


def merge_metrics(hosts: List[Dict[str, Any]]) -> Dict[str, Any]:
    """All hosts' ``metrics.json`` snapshots as one catalog:
    ``{name: {"kind", "help", "series": {labels+host: value},
    "fleet": {labels: aggregate}}}`` — counters/histograms sum across
    hosts, gauges take the max (the worst-host read)."""
    out: Dict[str, Any] = {}
    for h in hosts:
        snap = h.get("metrics") or {}
        for name, m in snap.items():
            if not isinstance(m, dict):
                continue
            ent = out.setdefault(name, {"kind": m.get("kind"),
                                        "help": m.get("help", ""),
                                        "series": {}, "fleet": {}})
            for key, val in (m.get("series") or {}).items():
                ent["series"][_with_host(key, h["host"])] = val
                if isinstance(val, dict):
                    _merge_hist_series(ent["fleet"], key, val)
                    continue
                if not isinstance(val, (int, float)):
                    continue
                cur = ent["fleet"].get(key)
                if m.get("kind") == "gauge":
                    ent["fleet"][key] = (val if cur is None
                                         else max(cur, val))
                else:
                    ent["fleet"][key] = (cur or 0) + val
    return out


def _merge_hist_series(fleet: Dict[str, Any], key: str,
                       val: Dict[str, Any]) -> None:
    """Fold one host's histogram series doc into the fleet aggregate:
    buckets/count/sum add, bounds come from the first host seen, and
    **exemplars survive** — last-write-wins per bucket index, so the
    fleet ``/metrics`` view keeps its trace-id links instead of
    silently dropping every exemplar at the host merge. Exemplar keys
    arrive as ints in-process but as strings after the metrics.json
    round-trip; both fold onto the string key."""
    cur = fleet.get(key)
    if not isinstance(cur, dict):
        cur = fleet[key] = {
            "buckets": [0] * len(val.get("buckets") or []),
            "bounds": list(val.get("bounds") or []),
            "sum": 0.0, "count": 0}
    buckets = [int(b) for b in (val.get("buckets") or [])]
    old = cur["buckets"]
    for i, b in enumerate(buckets):
        if i < len(old):
            old[i] += b
        else:
            old.append(b)
    cur["sum"] = round(float(cur.get("sum", 0.0))
                       + float(val.get("sum", 0.0)), 9)
    cur["count"] = int(cur.get("count", 0)) + int(val.get("count", 0))
    ex = val.get("exemplars")
    if isinstance(ex, dict) and ex:
        tgt = cur.setdefault("exemplars", {})
        for i, doc in ex.items():
            tgt[str(i)] = doc


def _gauge_value(metrics: Optional[dict], name: str) -> Optional[float]:
    m = (metrics or {}).get(name)
    series = (m or {}).get("series") or {}
    vals = [v for v in series.values() if isinstance(v, (int, float))]
    return min(vals) if vals else None


# ---------------------------------------------------------------------------
# The merge
# ---------------------------------------------------------------------------


def merge(dirs: List[str],
          names: Optional[List[str]] = None) -> Dict[str, Any]:
    """Fuse N host run directories. Returns ``{"hosts", "anchor",
    "offsets", "trace", "metrics", "progress", "summary"}`` where
    ``trace`` is the aligned, host-attributed record list (monotonic
    per (host, tid) track) and ``summary`` is one row per host with the
    fleet-view fields (state, level, imbalance, headroom)."""
    hosts = [read_host(d, (names[i] if names and i < len(names)
                           else None))
             for i, d in enumerate(dirs)]
    # de-duplicate colliding basenames (two ".../run" dirs)
    seen: Dict[str, int] = {}
    for h in hosts:
        n = seen.get(h["host"], 0)
        seen[h["host"]] = n + 1
        if n:
            h["host"] = f"{h['host']}~{n}"
    offsets, anchor = clock_offsets(hosts)
    merged_trace: List[dict] = []
    for h in hosts:
        off = offsets.get(h["host"], 0)
        recs = [dict(r, ts=int(r.get("ts", 0)) + off, host=h["host"])
                for r in h["trace"]]
        recs.sort(key=lambda r: (r.get("tid", 0), r["ts"]))
        merged_trace.extend(recs)
    import time as _time
    summary = []
    for h in hosts:
        p = h.get("progress") or {}
        state = p.get("state")
        hb_age = None
        hb = h.get("heartbeat")
        if hb and isinstance(hb.get("ts"), (int, float)):
            hb_age = round(max(_time.time() - hb["ts"], 0.0), 1)
        if h.get("missing"):
            # the artifact dir itself vanished: the host is dead, and
            # the fleet view must say so, not raise
            state = "dead"
        elif hb_age is not None and hb_age > HEARTBEAT_DEAD_S \
                and state not in ("done",):
            state = "dead"
        row = {
            "host": h["host"],
            "state": state,
            "level": p.get("level"),
            "level-budget": p.get("level-budget"),
            "frontier-rows": p.get("frontier-rows"),
            "imbalance": (p.get("imbalance")
                          if p.get("imbalance") is not None else
                          _gauge_value(h.get("metrics"),
                                       "jtpu_shard_imbalance_ratio")),
            "headroom": _gauge_value(h.get("metrics"),
                                     "jtpu_device_headroom_ratio"),
            "spans": len(h["trace"]),
            "missing": bool(h.get("missing")),
        }
        if hb_age is not None:
            row["heartbeat-age-s"] = hb_age
        summary.append(row)
    return {"hosts": [h["host"] for h in hosts],
            "anchor": anchor, "offsets": offsets,
            "trace": merged_trace,
            "metrics": merge_metrics(hosts),
            "progress": {h["host"]: h.get("progress") for h in hosts},
            "summary": summary}


def _sync_epoch_wall(records: List[dict]) -> Optional[int]:
    """The wall-clock ns at this trace's monotonic epoch, from its
    first ``trace.sync`` anchor event (None without one)."""
    for r in records:
        if r.get("name") == "trace.sync" \
                and isinstance(r.get("wall_ns"), (int, float)):
            return int(r["wall_ns"]) - int(r.get("ts", 0))
    return None


def stitch_request(run_dir: Optional[str], trace_id: str,
                   extra_dirs: Optional[List[str]] = None
                   ) -> Dict[str, Any]:
    """One request's distributed trace, stitched across every process
    that touched it: the serve daemon's ``trace.jsonl`` plus any fleet
    worker host dirs underneath (or passed explicitly). Returns
    ``{"trace-id", "records", "hosts", "offsets", "method"}`` with
    records on one aligned timeline, sorted by start time.

    Alignment prefers the ``trace.sync`` wall-clock anchors long-lived
    tracers emit (exact for same-machine processes); hosts without one
    fall back to the fleet merge's shared-anchor-span heuristic, and a
    lone traced process needs no alignment at all."""
    dirs: List[str] = []
    if run_dir:
        dirs.append(run_dir)
        for d in discover_hosts(run_dir):
            if d not in dirs:
                dirs.append(d)
    for d in extra_dirs or []:
        if d not in dirs:
            dirs.append(d)
    hosts = [h for h in (read_host(d) for d in dirs) if h["trace"]]
    seen: Dict[str, int] = {}
    for h in hosts:
        n = seen.get(h["host"], 0)
        seen[h["host"]] = n + 1
        if n:
            h["host"] = f"{h['host']}~{n}"
    offsets = {h["host"]: 0 for h in hosts}
    method = None
    if len(hosts) >= 2:
        sync = {h["host"]: _sync_epoch_wall(h["trace"]) for h in hosts}
        if all(v is not None for v in sync.values()):
            ref = sync[hosts[0]["host"]]
            offsets = {host: epoch - ref
                       for host, epoch in sync.items()}
            method = "wall-clock"
        else:
            offsets, anchor = clock_offsets(hosts)
            method = f"anchor:{anchor}" if anchor else None
    records: List[dict] = []
    for h in hosts:
        off = offsets.get(h["host"], 0)
        records.extend(
            dict(r, ts=int(r.get("ts", 0)) + off, host=h["host"])
            for r in h["trace"] if r.get("trace") == trace_id)
    records.sort(key=lambda r: (r["ts"], r.get("host", ""),
                                r.get("tid", 0)))
    return {"trace-id": trace_id, "records": records,
            "hosts": [h["host"] for h in hosts],
            "offsets": offsets, "method": method}


def to_chrome(merged: Dict[str, Any]) -> dict:
    """A merged fleet -> one Chrome/Perfetto document, one process per
    host (vs the single-process :func:`jepsen_tpu_torch.obs.trace.to_chrome`)
    so host timelines render as separate, aligned track groups."""
    pids = {h: i + 1 for i, h in enumerate(merged.get("hosts", []))}
    events: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": f"jtpu:{host}"}}
        for host, pid in pids.items()]
    for r in merged.get("trace", []):
        args = {k: v for k, v in r.items()
                if k not in ("name", "ts", "dur", "tid", "sid", "pid",
                             "host")}
        if "pid" in r:
            args["parent"] = r["pid"]
        ev = {"name": str(r.get("name", "?")), "cat": "jtpu",
              "pid": pids.get(r.get("host"), 0),
              "tid": int(r.get("tid", 0)),
              "ts": int(r.get("ts", 0)) / 1e3, "args": args}
        if r.get("dur", 0) > 0:
            ev["ph"] = "X"
            ev["dur"] = int(r["dur"]) / 1e3
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def format_fleet(merged: Dict[str, Any]) -> List[str]:
    """Side-by-side status lines, one per host — the ``watch --fleet``
    payload (imbalance + headroom are the straggler/OOM-risk signals
    the fleet scheduler will act on)."""
    lines = []
    anchor = merged.get("anchor")
    lines.append(f"# fleet: {len(merged.get('hosts', []))} host(s)"
                 + (f", clocks aligned on {anchor}" if anchor
                    else ", clocks unaligned (no shared anchor span)"))
    for row in merged.get("summary", []):
        bits = []
        if row.get("missing"):
            lines.append(f"# fleet: {row['host']}: host=dead "
                         f"(artifact dir vanished)")
            continue
        if row.get("state") == "dead":
            bits.append("host=dead")
        if row.get("level") is not None:
            budget = row.get("level-budget")
            bits.append(f"level {row['level']}"
                        + (f"/{budget}" if budget else ""))
        if row.get("frontier-rows") is not None:
            bits.append(f"frontier {row['frontier-rows']} rows")
        if row.get("state") and row["state"] != "dead":
            bits.append(f"state={row['state']}")
        if row.get("heartbeat-age-s") is not None:
            bits.append(f"heartbeat {row['heartbeat-age-s']:g}s ago")
        bits.append("imbalance "
                    + (f"{row['imbalance']:.2f}x"
                       if row.get("imbalance") is not None else "n/a"))
        bits.append("headroom "
                    + (f"{100 * row['headroom']:.0f}%"
                       if row.get("headroom") is not None else "n/a"))
        bits.append(f"{row['spans']} span(s)")
        lines.append(f"# fleet: {row['host']}: " + " | ".join(bits))
    return lines
