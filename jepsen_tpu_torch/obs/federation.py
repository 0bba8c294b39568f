"""Cross-host telemetry federation: its read side.

The port's copy of the read side of ``jepsen_tpu.obs.federation``. A
fleet host's exporter appends CRC'd telemetry frames to
``telemetry.frames`` in its host directory (the op journal's record
framing, so a torn final record is skipped); :func:`read_frames` and
:func:`fleet_ages` read them. :func:`trace_find` answers "which
requests?" from a serve directory's files alone: the serve WAL gives id,
tenant, trace id, verdict, seconds and device seconds, the result files
the error class, and the frames and trace files the hosts whose spans
carry each trace id (``python -m jepsen_tpu_torch trace find``).

The exporter (``FrameExporter``) and the daemon's collector
(``Federator``) come with the multi-GPU fleet (ROADMAP A7); until then a
serve directory's only host is the daemon itself.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Any, Dict, List, Optional, Set

from jepsen_tpu_torch import journal
from jepsen_tpu_torch.obs import trace as obs_trace

#: Per-host frame file inside the host dir (next to ``heartbeat.json``).
FRAMES_NAME = "telemetry.frames"


def read_frames(host_dir: str) -> List[dict]:
    """Every decodable frame record in a host dir, file order. A torn
    final record (exporter SIGKILLed mid-append) is silently skipped —
    the journal framing's torn-tail discipline."""
    path = os.path.join(host_dir, FRAMES_NAME)
    if not os.path.exists(path):
        return []
    try:
        records, _stats = journal.read_json_records(path)
    except OSError:
        return []
    return [r for r in records if r.get("k") == "frame"]


def fleet_ages(root: str, pattern: str = "fleet-host-*",
               now: Optional[float] = None) -> Dict[str, float]:
    """Per-host frame age (wall seconds since each host's newest frame)
    straight from the files, for out-of-process readers."""
    now = time.time() if now is None else float(now)
    out: Dict[str, float] = {}
    for d in sorted(glob.glob(os.path.join(root, pattern))):
        last, host = 0.0, os.path.basename(os.path.normpath(d))
        for rec in read_frames(d):
            try:
                t = float(rec.get("t", 0.0))
            except (TypeError, ValueError):
                continue
            host = str(rec.get("host") or host)
            last = max(last, t)
        if last:
            out[host] = round(max(0.0, now - last), 3)
    return out


# ---------------------------------------------------------------------------
# Trace search
# ---------------------------------------------------------------------------


def _trace_hosts(serve_dir: str,
                 pattern: str = "fleet-host-*") -> Dict[str, Set[str]]:
    """trace id -> hosts whose spans carry it, from the federated
    frames, the per-host trace sinks, and the daemon's own sink (the
    local-backend case, where segment spans carry ``host=`` but live
    in the leader's file)."""
    out: Dict[str, Set[str]] = {}

    def note(tid: Any, host: Any) -> None:
        if tid and host:
            out.setdefault(str(tid), set()).add(str(host))

    for d in sorted(glob.glob(os.path.join(serve_dir, pattern))):
        base = os.path.basename(os.path.normpath(d))
        for rec in read_frames(d):
            for sp in rec.get("spans") or []:
                note(sp.get("trace"),
                     sp.get("host") or rec.get("host") or base)
        tj = os.path.join(d, obs_trace.TRACE_NAME)
        if os.path.exists(tj):
            try:
                with open(tj, errors="replace") as f:
                    for line in f:
                        try:
                            sp = json.loads(line)
                        except ValueError:
                            continue  # torn tail of a live sink
                        note(sp.get("trace"), sp.get("host") or base)
            except OSError:
                pass
    own = os.path.join(serve_dir, obs_trace.TRACE_NAME)
    if os.path.exists(own):
        try:
            with open(own, errors="replace") as f:
                for line in f:
                    try:
                        sp = json.loads(line)
                    except ValueError:
                        continue
                    note(sp.get("trace"), sp.get("host"))
        except OSError:
            pass
    return out


def _result_error_class(serve_dir: str, rid: str) -> Optional[str]:
    path = os.path.join(serve_dir, f"{rid}.json")
    try:
        with open(path) as f:
            result = json.load(f)
    except (OSError, ValueError):
        return None
    ec = result.get("error-class")
    return str(ec) if ec else None


def trace_find(serve_dir: str, tenant: Optional[str] = None,
               min_device_s: Optional[float] = None,
               error_class: Optional[str] = None,
               host: Optional[str] = None,
               limit: int = 50) -> List[dict]:
    """Search the serve run for requests matching every given filter.

    Row sources: the serve WAL's ``accepted``/``done`` records (id,
    tenant, trace id, verdict, seconds, usage device-seconds), result
    files (error class, read lazily), and the federated span index
    (host attribution). Newest first, capped at ``limit``. Purely
    file-based — works against a live daemon's dir or a dead one's.
    """
    wal = os.path.join(serve_dir, "serve.wal")
    rows: Dict[str, Dict[str, Any]] = {}
    if os.path.exists(wal):
        try:
            records, _stats = journal.read_json_records(wal)
        except OSError:
            records = []
        for rec in records:
            rid = rec.get("id")
            if not rid:
                continue
            ev = rec.get("event")
            if ev == "accepted":
                r = rows.setdefault(str(rid), {"id": str(rid)})
                r["tenant"] = rec.get("tenant", "anon")
                r["ts"] = rec.get("ts")
                if rec.get("trace"):
                    r["trace"] = str(rec["trace"])
            elif ev == "done":
                r = rows.setdefault(str(rid), {"id": str(rid)})
                r["valid"] = rec.get("valid")
                r["seconds"] = rec.get("seconds")
                if rec.get("tenant"):
                    r.setdefault("tenant", rec["tenant"])
                u = rec.get("usage")
                if isinstance(u, dict):
                    r["device-s"] = u.get("device-s")
    span_hosts = _trace_hosts(serve_dir)
    out: List[dict] = []
    for r in rows.values():
        hs = sorted(span_hosts.get(r.get("trace") or "", ()))
        if hs:
            r["hosts"] = hs
        if tenant is not None and r.get("tenant") != tenant:
            continue
        if min_device_s is not None:
            try:
                dev = float(r.get("device-s") or 0.0)
            except (TypeError, ValueError):
                dev = 0.0
            if dev < float(min_device_s):
                continue
        if host is not None and host not in (r.get("hosts") or ()):
            continue
        if error_class is not None:
            ec = _result_error_class(serve_dir, r["id"])
            if ec != error_class:
                continue
            r["error-class"] = ec
        out.append(r)
    out.sort(key=lambda r: (-(r.get("ts") or 0.0), r.get("id")))
    out = out[:max(0, int(limit))]
    if error_class is None:
        for r in out:
            ec = _result_error_class(serve_dir, r["id"])
            if ec:
                r["error-class"] = ec
    return out
