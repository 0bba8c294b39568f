"""Device-level profiling: what did the card itself run?

Counterpart of ``jepsen_tpu/obs/profiler.py`` on ``torch.profiler``. The
host tracer (:mod:`jepsen_tpu_torch.obs.trace`) can say a
``checker.segment`` took 12 ms; this module says which kernels the card
ran inside it:

* :func:`capture`: an opt-in (``JTPU_PROF=1``) context manager the
  supervised search wraps itself in. It runs ``torch.profiler.profile``
  (CPU and, for a search on the card, CUDA activities) and writes its
  ``export_chrome_trace`` into ``<run_dir>/profile/`` at the end, under a
  ``prof.capture`` host span: the clock anchor of the merge. A nested
  capture does nothing; a capture the platform refuses is counted
  (``jtpu_prof_captures_total{outcome="failed"}``) and the refusal is
  sticky for the process; with profiling off no artifact differs.
* :func:`read_profile` / :func:`parse_trace`: the capture's device
  records (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``). A capture
  with none (a CPU-only run) takes its ``cpu_op`` records as its device
  lane, as the reference takes its XLA runtime threads on the CPU.
* :func:`merge_into_host`: the device records on the host trace's clock,
  each under the ``checker.segment`` host span that contains it.
* :func:`kernel_self_times` / :func:`top_kernels`: per-(rung, name)
  self-time rollups.
* :func:`segment_kernel_times`: each kernel's device time inside each
  segment.

**The segment graphs.** A segment is one CUDA graph launch whose WHILE
node runs a level pair per iteration. The nodes of one graph launch are
the kernel records that share its correlation id. Where the profile
holds a record for every execution of the body (a segment's graph
records reach the body's launches times its iterations, both known from
the span: ``body`` and the levels run), a kernel's time is the sum of its
records (``"attribution": "per-execution"``). Where it holds fewer, as
CUPTI does on the H100 (it records the conditional body's kernels once a
graph launch, one iteration's worth), each graph kernel's recorded time
is scaled by the body's launches over its records: the executions the
device's level counter says ran (``"attribution":
"scaled-by-level-counter"``). Records outside a graph launch (PyTorch's
own kernels and copies at the segment's end) are summed as they are.
Which one applies is read from each capture, per segment, and labelled
in the rows.

Kill switch: ``JTPU_PROF`` (default off). Profiling also needs
``JTPU_TRACE`` on: without the host trace there is nothing to merge
under, and ``JTPU_TRACE=0`` writes no artifact whatever ``JTPU_PROF``
says. A capture does not change what the check computes.
"""

from __future__ import annotations

import glob
import gzip
import json
import logging
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from jepsen_tpu_torch.obs import metrics as obs_metrics
from jepsen_tpu_torch.obs import trace as obs_trace

log = logging.getLogger("jepsen.obs")

#: The profile directory's name inside a run directory.
PROFILE_DIRNAME = "profile"

#: The host anchor span recorded over each captured region.
CAPTURE_SPAN = "prof.capture"

#: Host span names a device record may be parented under (deepest wins).
HOST_PARENTS = ("checker.segment", "checker.device.single",
                "checker.device.batch", "checker.device.batch-segment",
                "stream.segment")

#: Synthetic tid base for device lanes in merged records.
DEVICE_TID_BASE = 1 << 40

#: Chrome-trace categories of records the card ran.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

#: The category that stands in for the device on a CPU-only capture.
CPU_CAT = "cpu_op"

_CAPTURES_TOTAL = obs_metrics.counter(
    "jtpu_prof_captures_total",
    "device-profiler captures completed, labeled outcome=ok|failed")

_lock = threading.Lock()
_DIR: Optional[str] = None     # armed run directory (attach/detach)
_ACTIVE = False                # a capture is in flight
_FAILED: Optional[str] = None  # sticky: the platform refused a capture
_SEQ = 0                       # captures written by this process


def enabled() -> bool:
    """Whether device profiling is opted in (JTPU_PROF, default off);
    it needs the host tracer on too."""
    on = os.environ.get("JTPU_PROF", "0").lower() in (
        "1", "true", "yes", "on")
    return on and obs_trace.enabled()


def attach(store_dir: Optional[str]) -> None:
    """Arm the profiler with a run directory; nothing is created until a
    capture starts."""
    global _DIR
    with _lock:
        _DIR = store_dir or None


def detach() -> None:
    global _DIR
    with _lock:
        _DIR = None


def profile_dir(run_dir: str) -> str:
    return os.path.join(run_dir, PROFILE_DIRNAME)


def failure() -> Optional[str]:
    """The sticky refusal of this process's first failed capture, or
    None."""
    with _lock:
        return _FAILED


def _activities(cuda: bool) -> list:
    """The capture's activities: the CPU's, and CUDA's where the search
    runs on the card (``cuda``), with CUDA initialised first: a check
    that is its process's first CUDA work (``run``'s) is then traced with
    its kernels, not with the CPU's operators alone."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda and torch.cuda.is_available():
        torch.cuda.init()
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class _Capture:
    """One ``capture()`` call. Inert when disabled, dir-less, nested in
    another capture, or after a refusal."""

    def __init__(self, cuda: bool = False):
        self.dir: Optional[str] = None
        self.span = None
        self.prof = None
        self.want_cuda = cuda
        self.cuda = False

    def __enter__(self) -> "_Capture":
        global _ACTIVE
        with _lock:
            if not enabled() or _DIR is None or _ACTIVE or _FAILED:
                return self
            target = profile_dir(_DIR)
            _ACTIVE = True
        created = False
        try:
            import torch
            if not os.path.isdir(target):
                os.makedirs(target, exist_ok=True)
                created = True
            acts = _activities(self.want_cuda)
            self.cuda = len(acts) > 1
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        except Exception as e:  # noqa: BLE001 -- profiling must not wedge
            if created:
                try:
                    os.rmdir(target)
                except OSError:
                    pass
            self.prof = None
            _refused(e)
            return self
        self.dir = target
        self.span = obs_trace.span(CAPTURE_SPAN, dir=PROFILE_DIRNAME)
        self.span.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        global _ACTIVE, _SEQ
        if self.dir is None:
            return False
        try:
            if self.span is not None:
                self.span.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            with _lock:
                _SEQ += 1
                seq = _SEQ
            path = os.path.join(self.dir, f"capture-{os.getpid()}-"
                                          f"{seq}.trace.json")
            self.prof.export_chrome_trace(path)
            recs, st = parse_trace(path)
            if not recs or (self.cuda and st["cpu-stand-in"]):
                raise RuntimeError(
                    "the capture holds no "
                    + ("CUDA kernel" if self.cuda else "CPU operator")
                    + " record")
            _CAPTURES_TOTAL.inc(outcome="ok")
        except Exception as e:  # noqa: BLE001 -- counted, never raised
            _refused(e)
        finally:
            with _lock:
                _ACTIVE = False
        return False


def _refused(e: BaseException) -> None:
    global _FAILED
    msg = f"{type(e).__name__}: {e}"
    with _lock:
        if _FAILED is None:
            _FAILED = msg
    _CAPTURES_TOTAL.inc(outcome="failed")
    log.warning("device profiling unavailable (%s); JTPU_PROF is a no-op "
                "in this process from now on", msg)


def capture(cuda: bool = False) -> _Capture:
    """``with profiler.capture(cuda=...): <device search>``: a no-op
    unless JTPU_PROF is on and a run directory is armed. Nested captures
    are no-ops (the outermost wins). ``cuda``: whether the search runs on
    the card (see :func:`_activities`)."""
    return _Capture(cuda)


# ---------------------------------------------------------------------------
# Reading a capture
# ---------------------------------------------------------------------------


def find_traces(prof_dir: str) -> List[str]:
    """The capture's trace files (``*.trace.json`` / ``.gz``), sorted."""
    hits = (glob.glob(os.path.join(prof_dir, "**", "*.trace.json.gz"),
                      recursive=True)
            + glob.glob(os.path.join(prof_dir, "**", "*.trace.json"),
                        recursive=True))
    return sorted(hits)


def parse_trace(path: str) -> Tuple[List[dict], Dict[str, Any]]:
    """One exported trace file -> (device records, stats). Records are
    ``{"name", "ts", "dur", "lane", "track": "device"}`` in nanoseconds
    (the export is in microseconds); ``stats["t0"]`` is the earliest
    timestamp of any record in the file (the capture's start, in the
    same clock), ``stats["cpu-stand-in"]`` whether the CPU operators
    stand in for a device lane. A truncated or corrupt file gives
    ``([], {"error": ...})``; it never raises."""
    stats: Dict[str, Any] = {"events": 0, "device": 0}
    try:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            doc = json.loads(f.read())
    except Exception as e:  # noqa: BLE001 -- a torn capture is data loss
        return [], {"events": 0, "device": 0,
                    "error": f"{type(e).__name__}: {e}"}
    events = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(events, list):
        return [], {"events": 0, "device": 0, "error": "no traceEvents"}
    xs = []
    for e in events:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        try:
            ts = int(float(e["ts"]) * 1e3)
            dur = int(float(e.get("dur", 0)) * 1e3)
        except (KeyError, TypeError, ValueError):
            continue
        xs.append((e, ts, dur))
    stats["events"] = len(xs)
    if xs:
        stats["t0"] = min(ts for _, ts, _ in xs)
    cats = {str(e.get("cat", "")) for e, _, _ in xs}
    use = DEVICE_CATS if cats & set(DEVICE_CATS) else (CPU_CAT,)
    stats["cpu-stand-in"] = use == (CPU_CAT,)
    out: List[dict] = []
    for e, ts, dur in xs:
        cat = str(e.get("cat", ""))
        if cat not in use:
            continue
        args = e.get("args") or {}
        lane = (f"device:{args.get('device', e.get('pid'))}/stream:"
                f"{args.get('stream', e.get('tid'))}"
                if cat != CPU_CAT else f"host/{e.get('tid')}")
        rec = {"name": str(e.get("name", "?")), "ts": ts, "dur": dur,
               "lane": lane, "track": "device", "cat": cat}
        for k in ("graph id", "graph node id", "correlation"):
            if k in args:
                rec[k.replace(" ", "-")] = args[k]
        out.append(rec)
    out.sort(key=lambda r: r["ts"])
    stats["device"] = len(out)
    return out, stats


def read_profile(run_dir: str) -> Tuple[List[dict], Dict[str, Any]]:
    """Every device record of a run's captures. ``(records, stats)``;
    each record carries its ``file``, and each file's ``t0`` is in
    ``stats["t0"]``."""
    pdir = profile_dir(run_dir)
    stats: Dict[str, Any] = {"files": 0, "events": 0, "device": 0,
                             "errors": 0, "t0": {}}
    if not os.path.isdir(pdir):
        return [], stats
    records: List[dict] = []
    for path in find_traces(pdir):
        recs, s = parse_trace(path)
        stats["files"] += 1
        stats["events"] += s.get("events", 0)
        stats["device"] += s.get("device", 0)
        if s.get("error"):
            stats["errors"] += 1
        if "t0" in s:
            stats["t0"][path] = s["t0"]
        for r in recs:
            r["file"] = path
        records.extend(recs)
    records.sort(key=lambda r: r["ts"])
    return records, stats


# ---------------------------------------------------------------------------
# Merging into the host trace
# ---------------------------------------------------------------------------


def merge_into_host(host_records: List[dict], device_records: List[dict],
                    t0: Optional[Dict[str, int]] = None) -> List[dict]:
    """Shift device records onto the host trace's clock and parent each
    under the deepest :data:`HOST_PARENTS` span containing its midpoint.

    Alignment: the ``prof.capture`` host spans, oldest first, are matched
    with the capture files in order; a file's earliest record (``t0``,
    else its earliest device record) is mapped onto its span's start. A
    graph launch's nodes (records sharing one correlation id) go under
    the segment span of that launch: within a capture the i-th launch is
    the i-th ``checker.segment`` span with a ``body``, when their counts
    agree (the clock mapping alone can put a launch's first nodes before
    its span). Returns the new records only."""
    if not device_records:
        return []
    anchors = sorted((r for r in host_records
                      if r.get("name") == CAPTURE_SPAN),
                     key=lambda r: int(r.get("ts", 0)))
    files = sorted({r.get("file") for r in device_records},
                   key=lambda f: min(int(r["ts"]) for r in device_records
                                     if r.get("file") == f))
    offset: Dict[Any, int] = {}
    anchor_sid: Dict[Any, int] = {}
    for i, f in enumerate(files):
        start = (t0 or {}).get(f)
        if start is None:
            start = min(int(r["ts"]) for r in device_records
                        if r.get("file") == f)
        if i < len(anchors):
            a = anchors[i]
        elif anchors:
            a = anchors[-1]
        else:
            a = min(host_records, key=lambda r: int(r.get("ts", 0)),
                    default={"ts": 0, "sid": 0})
        offset[f] = int(a.get("ts", 0)) - start
        anchor_sid[f] = int(a.get("sid", 0))

    parents = sorted(
        ((int(r.get("ts", 0)), int(r.get("ts", 0)) + int(r.get("dur", 0)),
          int(r.get("sid", 0)))
         for r in host_records if r.get("name") in HOST_PARENTS
         and r.get("dur", 0) > 0),
        key=lambda t: t[1] - t[0])
    rung_by_sid = {int(r.get("sid", 0)): r.get("rung")
                   for r in host_records
                   if r.get("name") in HOST_PARENTS
                   and r.get("rung") is not None}

    launch_sid = _launch_parents(host_records, device_records, anchors,
                                 files)
    lanes: Dict[str, int] = {}
    out: List[dict] = []
    for r in device_records:
        f = r.get("file")
        ts = int(r["ts"]) + offset[f]
        dur = int(r.get("dur", 0))
        mid = ts + dur // 2
        pid = anchor_sid[f]
        for lo, hi, sid in parents:
            if lo <= mid <= hi:
                pid = sid
                break
        pid = launch_sid.get((f, r.get("correlation")), pid)
        lane = str(r.get("lane", "device"))
        tid = lanes.setdefault(lane, DEVICE_TID_BASE + len(lanes))
        rec = {"name": r["name"], "ts": ts, "dur": dur, "tid": tid,
               "sid": 0, "track": "device", "lane": lane}
        for k in ("cat", "correlation"):
            if k in r:
                rec[k] = r[k]
        if pid:
            rec["pid"] = pid
        if pid in rung_by_sid:
            rec["rung"] = rung_by_sid[pid]
        out.append(rec)
    return out


def _launch_parents(host_records: List[dict], device_records: List[dict],
                    anchors: List[dict], files: List[Any]) -> Dict[tuple, int]:
    """{(file, correlation id): segment span sid} for the graph launches
    of each capture file, matched in order with the graph segments'
    spans inside that file's ``prof.capture`` span; empty for a file
    whose counts disagree."""
    launches: Dict[Any, Dict[Any, int]] = {}
    for r in device_records:
        c = r.get("correlation")
        if c is not None:
            first = launches.setdefault(r.get("file"), {})
            first[c] = min(first.get(c, int(r["ts"])), int(r["ts"]))
    counts: Dict[tuple, int] = {}
    for r in device_records:
        key = (r.get("file"), r.get("correlation"))
        counts[key] = counts.get(key, 0) + 1
    out: Dict[tuple, int] = {}
    for i, f in enumerate(files):
        if i >= len(anchors):
            break
        lo = int(anchors[i].get("ts", 0))
        hi = lo + int(anchors[i].get("dur", 0))
        segs = sorted((r for r in host_records
                       if r.get("name") == "checker.segment" and r.get("body")
                       and lo <= int(r.get("ts", 0)) <= hi),
                      key=lambda r: int(r.get("ts", 0)))
        graph = sorted((c for c, t in launches.get(f, {}).items()
                        if counts[(f, c)] > 1),
                       key=lambda c: launches[f][c])
        if segs and len(graph) == len(segs):
            for c, sp in zip(graph, segs):
                out[(f, c)] = int(sp.get("sid", 0))
    return out


def merged_records(run_dir: str) -> Tuple[List[dict], Dict[str, Any]]:
    """The host trace and the device captures of one run directory,
    merged; the host records alone when there is no readable capture."""
    host, stats = obs_trace.read_trace(
        os.path.join(run_dir, obs_trace.TRACE_NAME))
    dev, pstats = read_profile(run_dir)
    merged = host + merge_into_host(host, dev, pstats.get("t0"))
    stats = dict(stats)
    stats["device"] = len(dev)
    stats["profile-files"] = pstats.get("files", 0)
    stats["profile-errors"] = pstats.get("errors", 0)
    return merged, stats


# ---------------------------------------------------------------------------
# Kernel rollups
# ---------------------------------------------------------------------------


def kernel_self_times(device_records: List[dict]) -> List[dict]:
    """Per-(rung, name) self-time rollup over the device lanes (each
    record's duration less what records nested directly inside it on its
    lane cover), sorted by self time: ``{"name", "rung", "count",
    "self-ns", "total-ns"}``."""
    by_lane: Dict[str, List[dict]] = {}
    for r in device_records:
        by_lane.setdefault(str(r.get("lane", "?")), []).append(r)
    acc: Dict[tuple, Dict[str, int]] = {}

    def close(frame: dict) -> None:
        acc[frame["key"]]["self-ns"] += frame["dur"] - frame["child"]

    for recs in by_lane.values():
        recs = sorted(recs, key=lambda r: (int(r["ts"]),
                                           -int(r.get("dur", 0))))
        stack: List[dict] = []
        for r in recs:
            ts = int(r["ts"])
            dur = int(r.get("dur", 0))
            while stack and stack[-1]["end"] <= ts:
                close(stack.pop())
            if stack:
                stack[-1]["child"] += dur
            rung = r.get("rung")
            key = (json.dumps(rung) if rung is not None else None,
                   str(r.get("name", "?")))
            row = acc.setdefault(key, {"count": 0, "self-ns": 0,
                                       "total-ns": 0})
            row["count"] += 1
            row["total-ns"] += dur
            stack.append({"end": ts + dur, "key": key, "dur": dur,
                          "child": 0})
        while stack:
            close(stack.pop())
    rows = [{"rung": (json.loads(k[0]) if k[0] else None), "name": k[1],
             **v} for k, v in acc.items()]
    rows.sort(key=lambda r: -r["self-ns"])
    return rows


def top_kernels(device_records: List[dict], k: int = 10) -> List[dict]:
    """The top-k kernel rows by self time (:func:`kernel_self_times`)."""
    return kernel_self_times(device_records)[:max(0, k)]


def segment_kernel_times(merged: List[dict]) -> List[dict]:
    """Each kernel's device time inside each ``checker.segment`` span of
    merged records (:func:`merged_records`). A segment span carries the
    levels it ran (``level``, ``level_end``) and, where it was one graph
    launch, ``body``: the CUDA launches one WHILE iteration (a level
    pair) makes. One row per (segment, kernel): ``{"sid", "name",
    "records", "recorded-ns", "ns", "graph", "attribution"}``, where
    ``ns`` is the attributed time (see the module's docstring) and
    ``graph`` whether the kernel ran as a node of the graph launch."""
    spans = {int(r["sid"]): r for r in merged
             if r.get("name") == "checker.segment" and r.get("sid")}
    by_seg: Dict[int, List[dict]] = {}
    for r in merged:
        if r.get("track") == "device" and int(r.get("pid", 0)) in spans:
            by_seg.setdefault(int(r["pid"]), []).append(r)
    rows: List[dict] = []
    for sid, recs in by_seg.items():
        sp = spans[sid]
        corr: Dict[Any, int] = {}
        for r in recs:
            if r.get("correlation") is not None:
                corr[r["correlation"]] = corr.get(r["correlation"], 0) + 1
        # a graph launch's nodes share its correlation id; its body is
        # what the WHILE node ran, its kernels ("cat" kernel)
        graph = [r for r in recs if r.get("cat") == "kernel"
                 and corr.get(r.get("correlation"), 0) > 1]
        body = int(sp.get("body") or 0)
        levels = int(sp.get("level_end", sp.get("level", 0))) - int(
            sp.get("level", 0))
        expected = (levels + 1) // 2 * body
        scale, how = 1.0, "per-execution"
        if body and graph and len(graph) < expected:
            scale, how = expected / len(graph), "scaled-by-level-counter"
        gids = {id(r) for r in graph}
        acc: Dict[tuple, List[int]] = {}
        for r in recs:
            acc.setdefault((r["name"], id(r) in gids), []).append(
                int(r.get("dur", 0)))
        for (name, in_graph), durs in acc.items():
            f = scale if in_graph else 1.0
            rows.append({"sid": sid, "name": name, "records": len(durs),
                         "recorded-ns": sum(durs), "ns": sum(durs) * f,
                         "graph": in_graph,
                         "attribution": how if in_graph
                         else "per-execution"})
    return rows


def _reset_for_tests() -> None:
    global _DIR, _ACTIVE, _FAILED
    with _lock:
        _DIR, _ACTIVE, _FAILED = None, False, None
