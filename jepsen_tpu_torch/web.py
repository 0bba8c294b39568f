"""Results web browser.

A copy of the reference's ``jepsen_tpu/web.py`` (itself a rebuild of
jepsen.web, jepsen/src/jepsen/web.clj) on the stdlib http server: a test
table with validity color-coding ('/'), a file/directory browser with
text and image previews ('/files/...'), streaming zip downloads of run
directories ('?zip'), and the same path-traversal guard the reference
enforces (web.clj:273-278 assert-file-in-scope!).

Observability surfaces (doc/observability.md):

* ``/metrics`` — this process's metrics registry in Prometheus text
  exposition format, scrapeable like any other production workload;
* ``/trace/<test>/<timestamp>`` — a span-waterfall rendering of a run's
  ``trace.jsonl`` (the home table links it, alongside the per-run
  ``trace.jsonl``/``metrics.json`` artifacts in the file browser and
  zip export). A run checked with ``--profile`` also shows its
  ``profile/`` captures as a device lane: the kernels the card ran, on
  the host trace's clock (:func:`jepsen_tpu_torch.obs.profiler.
  merged_records`), above the host threads.

The check daemon (:mod:`jepsen_tpu_torch.serve`) subclasses
:class:`Handler`, so its routes and the browser share one server.
"""

from __future__ import annotations

import html

import json
import os
import threading
import time
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple
from urllib.parse import quote, unquote, urlparse

VALID_COLORS = {True: "#6DB6FE", False: "#FEA786", "unknown": "#FEFF7F"}

TEXT_EXT = {".txt", ".log", ".json", ".jsonl", ".edn", ".md", ".py", ".cc",
            ".yml", ".yaml", ".csv"}
IMAGE_EXT = {".png": "image/png", ".svg": "image/svg+xml",
             ".jpg": "image/jpeg", ".jpeg": "image/jpeg"}

PAGE = """<!doctype html><html><head><title>{title}</title><style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; }}
td, th {{ padding: .3em .8em; text-align: left;
          border-bottom: 1px solid #ddd; }}
a {{ text-decoration: none; color: #0366d6; }}
.valid {{ font-weight: bold; }}
</style></head><body><h1>{title}</h1>{body}</body></html>"""


def _run_status(run_dir: str):
    """run.state-derived status ('running'/'dead'/'done'/'recovered') or
    None for pre-WAL runs; never raises (the browser must render even
    over a half-broken store)."""
    try:
        from jepsen_tpu_torch import store as store_ns
        return store_ns.run_status(run_dir)
    except Exception:  # noqa: BLE001
        return None


def run_rows(root: str) -> List[Tuple[str, str, object, object]]:
    """(name, timestamp, valid, status) for every saved run, newest
    first (web.clj:47-67 fast-tests). ``status`` surfaces crashed runs:
    'dead' means run.state says running/analyzing but the pid is gone —
    recoverable via ``python -m jepsen_tpu_torch recover``; 'recovered' means
    the verdict came from a WAL-reconstructed history."""
    rows = []
    if not os.path.isdir(root):
        return rows
    for name in sorted(os.listdir(root)):
        name_dir = os.path.join(root, name)
        if not os.path.isdir(name_dir) or name == "latest":
            continue
        for ts in sorted(os.listdir(name_dir), reverse=True):
            run_dir = os.path.join(name_dir, ts)
            if not os.path.isdir(run_dir) or ts == "latest" \
                    or os.path.islink(run_dir):
                continue
            valid = None
            results = os.path.join(run_dir, "results.json")
            if os.path.exists(results):
                try:
                    with open(results) as f:
                        valid = json.load(f).get("valid")
                except (OSError, ValueError):
                    valid = "unknown"
            rows.append((name, ts, valid, _run_status(run_dir)))
    rows.sort(key=lambda r: r[1], reverse=True)
    return rows


def _within(root: str, path: str) -> bool:
    """Path-traversal guard (web.clj:273-278)."""
    root = os.path.realpath(root)
    return os.path.realpath(path).startswith(root + os.sep) or \
        os.path.realpath(path) == root


class _ChunkedWriter:
    """File-like adapter from zipfile writes to HTTP body pieces — the
    archive streams to the client with O(chunk) memory. (Reference
    jepsen/src/jepsen/web.clj:250-271 pipes the zip through a piped
    output stream for the same reason.) ``chunked=True`` frames each
    write as an HTTP/1.1 chunk; ``chunked=False`` writes raw bytes for
    HTTP/1.0 peers (which cannot parse chunked framing — the caller
    then closes the connection to delimit the body). Deliberately not
    seekable: zipfile detects that and switches to streaming mode
    (local headers with data descriptors), never needing to rewrite
    earlier bytes."""

    def __init__(self, wfile, chunked=True):
        self.wfile = wfile
        self.chunked = chunked
        self._pos = 0

    def write(self, b):
        if b:
            if self.chunked:
                self.wfile.write(f"{len(b):X}\r\n".encode("ascii"))
                self.wfile.write(b)
                self.wfile.write(b"\r\n")
            else:
                self.wfile.write(b)
            self._pos += len(b)
        return len(b)

    def flush(self):
        self.wfile.flush()

    def tell(self):
        return self._pos

    def close_chunks(self):
        if self.chunked:
            self.wfile.write(b"0\r\n\r\n")


class Handler(BaseHTTPRequestHandler):
    root = "store"
    # 1.1 (every fixed response carries Content-Length, see _send) so
    # the zip download may use chunked transfer encoding
    protocol_version = "HTTP/1.1"
    # keep-alive must not pin a handler thread forever: idle persistent
    # connections are dropped after this many seconds
    timeout = 60

    def log_message(self, *args):  # quiet by default
        pass

    def _send(self, code: int, body: bytes,
              ctype: str = "text/html; charset=utf-8",
              headers: Optional[dict] = None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _page(self, title: str, body: str, code: int = 200):
        self._send(code, PAGE.format(title=html.escape(title),
                                     body=body).encode())

    # -- routes -------------------------------------------------------------

    def do_GET(self):  # noqa: N802 (stdlib naming)
        url = urlparse(self.path)
        path = unquote(url.path)
        try:
            if path == "/":
                return self.home()
            if path == "/metrics":
                return self.metrics()
            if path.startswith("/live/"):
                return self.live(path[len("/live/"):],
                                 query=url.query)
            if path.startswith("/fleet/"):
                return self.fleet(path[len("/fleet/"):],
                                  query=url.query)
            if path.startswith("/trace/"):
                return self.trace(path[len("/trace/"):])
            if path.startswith("/explain/"):
                return self.explain(path[len("/explain/"):])
            if path.startswith("/files/"):
                return self.files(path[len("/files/"):],
                                  zip_requested=url.query == "zip")
            self._page("404", "<p>Not found.</p>", code=404)
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001
            self._page("Error", f"<pre>{html.escape(repr(e))}</pre>",
                       code=500)

    #: run.state statuses worth a badge (quiet for ordinary done runs).
    STATUS_LABELS = {
        "dead": "dead — recoverable (python -m jepsen_tpu_torch recover)",
        "running": "running",
        "recovered": "recovered from WAL",
    }

    def home(self):
        """Test table with validity colors (web.clj:116-128); crashed
        and recovered runs carry a status badge, traced runs a span-
        waterfall link."""
        rows = []
        for name, ts, valid, status in run_rows(self.root):
            color = VALID_COLORS.get(valid, "#ffffff")
            if status == "dead":
                color = VALID_COLORS["unknown"]
            link = f"/files/{quote(name)}/{quote(ts)}/"
            badge = self.STATUS_LABELS.get(status, "")
            trace_cell = ""
            if os.path.exists(os.path.join(self.root, name, ts,
                                           "trace.jsonl")):
                trace_cell = (f"<a href='/trace/{quote(name)}/"
                              f"{quote(ts)}'>trace</a>")
            explain_cell = (f"<a href='/explain/{quote(name)}/"
                            f"{quote(ts)}'>explain</a>")
            rows.append(
                f"<tr style='background:{color}'>"
                f"<td class=valid>{html.escape(str(valid))}</td>"
                f"<td><a href='{link}'>{html.escape(name)}</a></td>"
                f"<td><a href='{link}'>{html.escape(ts)}</a></td>"
                f"<td>{html.escape(badge)}</td>"
                f"<td>{trace_cell}</td>"
                f"<td>{explain_cell}</td>"
                f"<td><a href='{link[:-1]}?zip'>zip</a></td></tr>")
        body = ("<table><tr><th>valid</th><th>test</th><th>time</th>"
                "<th>state</th><th>trace</th><th>why</th><th></th></tr>"
                + "".join(rows) + "</table>"
                if rows else "<p>No tests run yet.</p>")
        body += ("<p><a href='/metrics'>/metrics</a> — Prometheus "
                 "exposition for this process</p>")
        self._page("Jepsen-TPU results", body)

    def metrics(self):
        """Prometheus text exposition of this process's registry —
        the scrape target a production deployment points its collector
        at (doc/observability.md has the metric catalog)."""
        # Importing the instrumented layers registers their
        # metric catalog, so a fresh `serve` process exposes the stable
        # series names instead of an empty page; the checker-stack
        # metrics appear once a check runs in this process.
        from jepsen_tpu_torch import core as _core  # noqa: F401
        from jepsen_tpu_torch import journal as _journal  # noqa: F401
        from jepsen_tpu_torch import nemesis as _nemesis  # noqa: F401
        from jepsen_tpu_torch.obs import metrics as obs_metrics
        self._send(200, obs_metrics.REGISTRY.to_prometheus().encode(),
                   ctype=obs_metrics.PROMETHEUS_CTYPE)

    #: Long-poll ceiling for /live?wait= (seconds) — bounded so an
    #: abandoned poller cannot pin a handler thread past the keep-alive.
    LIVE_WAIT_MAX_S = 25.0

    def live(self, rel: str, query: str = ""):
        """``/live/<test>/<ts>`` — the run's live search progress as
        JSON: ``{"state": <run.state status>, "progress": <progress.json
        or null>}``. Long-poll flavor: ``?wait=N&since=TS`` blocks up to
        N seconds (capped) until the progress heartbeat's ``ts`` moves
        past ``since``, so the trace page's progress strip can follow a
        multi-minute search without hammering the store. 404s only when
        the run directory itself is missing — a run without a heartbeat
        (JTPU_TRACE=0, killed before the first segment) answers with
        ``progress: null``."""
        import time as _time
        from urllib.parse import parse_qs

        from jepsen_tpu_torch.obs import observatory
        run_dir = os.path.join(self.root, rel.strip("/"))
        if not _within(self.root, run_dir):
            return self._page("403", "<p>Forbidden.</p>", code=403)
        if not os.path.isdir(run_dir):
            return self._send(
                404, b'{"error": "no such run"}',
                ctype="application/json")
        q = parse_qs(query or "")

        def _num(name, default=0.0):
            try:
                return float(q[name][0])
            except (KeyError, IndexError, ValueError):
                return default

        wait = min(max(_num("wait"), 0.0), self.LIVE_WAIT_MAX_S)
        since = _num("since")
        deadline = _time.monotonic() + wait
        while True:
            progress = observatory.read_progress(run_dir)
            changed = (progress or {}).get("ts", 0) > since
            if changed or not wait or _time.monotonic() > deadline:
                break
            _time.sleep(0.25)
        doc = {"state": _run_status(run_dir), "progress": progress}
        self._send(200, json.dumps(doc, default=repr).encode(),
                   ctype="application/json")

    def fleet(self, rel: str, query: str = ""):
        """``/fleet/<test>/<ts>`` — the multi-host view of one run:
        host subdirectories carrying ``trace.jsonl`` / ``metrics.json``
        / ``progress.json`` are merged (clock-aligned on the shared
        anchor span, obs/fleet.py) and rendered side by side — per-host
        search level, shard-imbalance and device headroom, the
        straggler/OOM-risk signals. ``?format=json`` answers the raw
        merge (summary + offsets; the trace stays on disk). A run
        without host subdirectories renders as a one-host fleet."""
        from jepsen_tpu_torch.obs import fleet as fleet_ns
        run_dir = os.path.join(self.root, rel.strip("/"))
        if not _within(self.root, run_dir):
            return self._page("403", "<p>Forbidden.</p>", code=403)
        if not os.path.isdir(run_dir):
            return self._page("404", "<p>No such run.</p>", code=404)
        dirs = fleet_ns.discover_hosts(run_dir)
        if not dirs:
            return self._page(
                "404", "<p>No host artifacts (trace.jsonl / "
                       "metrics.json / progress.json) under this run "
                       "(JTPU_TRACE=0?).</p>", code=404)
        merged = fleet_ns.merge(dirs)
        if query == "format=json":
            doc = {k: merged[k] for k in ("hosts", "anchor", "offsets",
                                          "summary", "progress")}
            return self._send(200, json.dumps(doc, default=repr).encode(),
                              ctype="application/json")
        rows = []
        for s in merged["summary"]:
            level = (f"{s['level']}/{s['level-budget']}"
                     if s.get("level") is not None
                     and s.get("level-budget") else
                     (str(s["level"]) if s.get("level") is not None
                      else "—"))
            imb = (f"{s['imbalance']:.2f}x"
                   if s.get("imbalance") is not None else "—")
            head = (f"{100 * s['headroom']:.0f}%"
                    if s.get("headroom") is not None else "—")
            state = str(s.get("state") or "—")
            if s.get("missing"):
                state = "dead (dir vanished)"
            elif s.get("heartbeat-age-s") is not None:
                state += f" (hb {s['heartbeat-age-s']:g}s ago)"
            rows.append(
                "<tr>"
                f"<td>{html.escape(str(s['host']))}</td>"
                f"<td>{html.escape(state)}</td>"
                f"<td>{html.escape(level)}</td>"
                f"<td>{html.escape(str(s.get('frontier-rows') if s.get('frontier-rows') is not None else '—'))}</td>"
                f"<td>{html.escape(imb)}</td>"
                f"<td>{html.escape(head)}</td>"
                f"<td>{s['spans']}</td></tr>")
        anchor = merged.get("anchor")
        body = (f"<p>{len(merged['hosts'])} host(s); clocks "
                + (f"aligned on <code>{html.escape(anchor)}</code>"
                   if anchor else "unaligned (no shared anchor span)")
                + "</p><table><tr><th>host</th><th>state</th>"
                  "<th>level</th><th>frontier</th>"
                  "<th>shard imbalance</th><th>headroom</th>"
                  "<th>spans</th></tr>" + "".join(rows) + "</table>"
                + "<p><code>python -m jepsen_tpu_torch watch --fleet "
                + " ".join(html.escape(d) for d in dirs)
                + "</code></p>")
        self._page(f"fleet {rel}", body)

    #: Spans rendered per waterfall page (deepest-first file order);
    #: beyond this the page says how many were elided.
    TRACE_ROW_CAP = 2000

    def trace(self, rel: str):
        """Span waterfall for one run's trace.jsonl: each span is a bar
        positioned/sized by its ts/dur on a common timeline, grouped by
        thread, colored by span name — the 'where did the wall-clock
        go' page. A ``--profile``d run's captured kernels come first, as
        its device lane. Tolerates torn tails (the run may have been
        killed mid-write, or still be running)."""
        run_dir = os.path.join(self.root, rel.strip("/"))
        if not _within(self.root, run_dir):
            return self._page("403", "<p>Forbidden.</p>", code=403)
        path = os.path.join(run_dir, "trace.jsonl")
        if not os.path.exists(path):
            return self._page("404", "<p>No trace.jsonl for this run "
                                     "(JTPU_TRACE=0?).</p>", code=404)
        from jepsen_tpu_torch.obs import profiler
        records, stats = profiler.merged_records(run_dir)
        self._page(f"trace {rel}",
                   _progress_strip_html(rel)
                   + _waterfall_html(records, stats,
                                     cap=self.TRACE_ROW_CAP))

    def explain(self, rel: str):
        """``/explain/<test>/<ts>`` — the verdict explanation page
        (jepsen_tpu_torch.explain): search-shape summary + frontier sparkline
        for valid runs, violating level / blocking ops / witness region
        for invalid ones, the cited cause chain for unknowns. The
        report readers are torn-tolerant and this handler catches its
        own failures — a SIGKILLed run's partial artifacts render a
        degraded page, never a 500 (the explain-kill chaos scenario
        holds it to that)."""
        run_dir = os.path.join(self.root, rel.strip("/"))
        if not _within(self.root, run_dir):
            return self._page("403", "<p>Forbidden.</p>", code=403)
        if not os.path.isdir(run_dir):
            return self._page("404", "<p>No such run.</p>", code=404)
        try:
            from jepsen_tpu_torch import explain as explain_mod
            report = explain_mod.explain_report(run_dir)
            text = explain_mod.render_text(report)
        except Exception as e:  # noqa: BLE001 — degrade, never 500
            report = {"kind": "unrenderable"}
            text = f"# explain: report unavailable: {e!r}"
        badge = {"valid": "#6DB6FF", "invalid": "#FF6D6D",
                 "unknown": "#FFAA6D"}.get(report.get("kind"), "#ddd")
        body = (
            f"<p><span style='background:{badge};padding:2px 8px;"
            f"border-radius:4px'>{html.escape(str(report.get('kind')))}"
            f"</span> &mdash; <a href='/files/{quote(rel.strip('/'), safe='/')}"
            f"/'>artifacts</a></p>"
            f"<pre>{html.escape(text)}</pre>")
        self._page(f"explain {rel}", body)

    def files(self, rel: str, zip_requested: bool = False):
        """Static file / dir browser / zip download (web.clj:194-271)."""
        target = os.path.join(self.root, rel)
        if not _within(self.root, target):
            return self._page("403", "<p>Forbidden.</p>", code=403)
        if not os.path.exists(target):
            return self._page("404", "<p>Not found.</p>", code=404)
        if os.path.isdir(target):
            if zip_requested:
                return self.zip_dir(target, rel)
            return self.dir_listing(target, rel)
        return self.file(target)

    def dir_listing(self, target: str, rel: str):
        entries = sorted(os.listdir(target))
        items = []
        if rel.strip("/"):
            items.append("<li><a href='..'>..</a></li>")
        for e in entries:
            suffix = "/" if os.path.isdir(os.path.join(target, e)) else ""
            items.append(f"<li><a href='{quote(e)}{suffix}'>"
                         f"{html.escape(e)}{suffix}</a></li>")
        self._page(f"/{rel}", "<ul>" + "".join(items) + "</ul>")

    def file(self, target: str):
        """Stream a single file (same bounded-memory contract as the
        zip path: a multi-GB history log must not be slurped into one
        bytes object per request). Content-Length is known up front, so
        no chunking is needed."""
        ext = os.path.splitext(target)[1].lower()
        if ext in IMAGE_EXT:
            ctype, extra = IMAGE_EXT[ext], {}
        elif ext in TEXT_EXT or not ext:
            ctype, extra = "text/plain; charset=utf-8", {}
        else:
            ctype = "application/octet-stream"
            extra = {"Content-Disposition": "attachment"}
        size = os.path.getsize(target)
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(size))
        for k, v in extra.items():
            self.send_header(k, v)
        self.end_headers()
        try:
            with open(target, "rb") as f:
                while True:
                    piece = f.read(1 << 16)
                    if not piece:
                        break
                    self.wfile.write(piece)
        except Exception:
            # mid-body failure: the connection's framing is broken
            self.close_connection = True

    def zip_dir(self, target: str, rel: str):
        """STREAM a run directory as a zip download (web.clj:250-271
        pipes the archive for the same reason): the archive is chunked
        straight onto the socket as it is built — a multi-GB store
        directory downloads with constant control-node memory instead of
        ballooning an in-memory BytesIO."""
        name = rel.strip("/").replace("/", "-") or "store"
        # Chunked framing requires an HTTP/1.1 peer (RFC 7230 §3.3.1);
        # a 1.0 client gets the raw stream delimited by connection close.
        chunked = self.request_version == "HTTP/1.1"
        self.send_response(200)
        self.send_header("Content-Type", "application/zip")
        self.send_header("Content-Disposition",
                         f'attachment; filename="{name}.zip"')
        if chunked:
            self.send_header("Transfer-Encoding", "chunked")
        else:
            self.close_connection = True
        self.end_headers()
        w = _ChunkedWriter(self.wfile, chunked=chunked)
        try:
            with zipfile.ZipFile(w, "w", zipfile.ZIP_DEFLATED) as z:
                for dirpath, _dirs, files in os.walk(target):
                    for fname in sorted(files):
                        full = os.path.join(dirpath, fname)
                        if os.path.islink(full):
                            continue
                        # z.write streams the file in 8 KiB reads
                        z.write(full, os.path.relpath(full, target))
            w.close_chunks()
        except BrokenPipeError:
            self.close_connection = True
        except Exception:
            # Headers (and part of the body) are already on the wire:
            # the only safe failure signal is an abruptly-terminated
            # stream on a connection that must not be reused. Swallow —
            # re-raising would let do_GET's generic 500 page inject
            # status-line bytes into the middle of the body framing.
            self.close_connection = True


def _progress_strip_html(rel: str) -> str:
    """The live progress strip atop the trace waterfall: status text +
    a fill bar kept fresh by long-polling ``/live/<run>`` (the poll
    blocks server-side on ``?wait=&since=`` until the heartbeat moves,
    so an idle page costs one request per ~20 s). Degrades to a static
    'no heartbeat' line for runs that never published progress
    (JTPU_TRACE=0, pre-observatory runs, or no JS)."""
    live = f"/live/{quote(rel.strip('/'), safe='/')}"
    return (
        "<div style='margin:.5em 0;padding:.4em;background:#f5f5f5;"
        "border-radius:4px'>"
        "<div id=liveText style='font-size:12px'>live: waiting for "
        "progress heartbeat&hellip;</div>"
        "<div style='background:#ddd;height:6px;border-radius:3px;"
        "margin-top:3px'><div id=liveBar style='background:#4E79A7;"
        "height:100%;width:0%;border-radius:3px'></div></div></div>"
        "<script>(function(){\n"
        "var since=0;\n"
        "function render(d){\n"
        " var p=d.progress;\n"
        " if(!p){document.getElementById('liveText').textContent="
        "'live: no progress heartbeat (state='+(d.state||'?')+')';"
        "return false;}\n"
        " since=p.ts||0;\n"
        " var b=p['level-budget']||0,l=p.level||0;\n"
        " document.getElementById('liveBar').style.width="
        "(b?Math.min(100,100*l/b):0)+'%';\n"
        " var bits=['level '+l+'/'+b,'frontier '+(p['frontier-rows']"
        "==null?'?':p['frontier-rows'])+' rows','seg '+p.segments];\n"
        " if(p['levels-per-s'])bits.push(p['levels-per-s']+"
        "' levels/s');\n"
        " if(p.imbalance!=null)bits.push('imbalance '+p.imbalance+"
        "'x');\n"
        " if(p['dup-rate']!=null)bits.push('dup '+"
        "Math.round(100*p['dup-rate'])+'%');\n"
        " if(p['trunc-losses'])bits.push('trunc '+"
        "p['trunc-losses']);\n"
        " if(p.fleet)bits.push('fleet '+p.fleet.hosts+' host(s)'+"
        "(p.fleet.remeshes?' '+p.fleet.remeshes+' remesh(es)':'')+"
        "(p.fleet.steals?' '+p.fleet.steals+' steal(s)':''));\n"
        " if(p['eta-s']!=null&&p.state!=='done')bits.push('eta '+"
        "p['eta-s']+'s');\n"
        " if(p.state==='done')bits.push('done valid='+p.valid);\n"
        " document.getElementById('liveText').textContent='live: '+"
        "bits.join(' | ');\n"
        " return p.state!=='done';}\n"
        "function tick(){\n"
        f" fetch('{live}?wait=20&since='+since)"
        ".then(function(r){return r.json();})\n"
        "  .then(function(d){setTimeout(tick,"
        "render(d)?500:10000);})\n"
        "  .catch(function(){setTimeout(tick,5000);});}\n"
        "tick();})();</script>")


#: Categorical bar palette for the waterfall (cycled by span-name hash).
_TRACE_COLORS = ("#4E79A7", "#F28E2B", "#59A14F", "#E15759", "#B07AA1",
                 "#76B7B2", "#EDC948", "#9C755F")


def _fmt_ns(ns: float) -> str:
    if ns >= 1e9:
        return f"{ns / 1e9:.2f}s"
    if ns >= 1e6:
        return f"{ns / 1e6:.1f}ms"
    return f"{ns / 1e3:.0f}us"


def _waterfall_html(records, stats, cap: int = 2000) -> str:
    """Span records -> one self-contained HTML waterfall (no JS): bars
    positioned by percentage offsets on the run's timeline, grouped by
    thread, durations inline. Links the raw artifact for Perfetto-level
    digging (``python -m jepsen_tpu_torch trace export --format chrome``).
    Device records (``"track": "device"``, a profile's kernels) are
    grouped by their lane and drawn before the host threads."""
    # instants (dur 0 — verdict markers, gang joins, faults) draw as
    # tick marks on the same timeline, except the tracer's own
    # trace.sync clock anchors, which are plumbing, not a phase
    spans = [r for r in records if r.get("dur", 0) > 0
             or (r.get("name") != "trace.sync" and "ts" in r)]
    if not spans:
        return (f"<p>No spans ({stats['torn']} torn, "
                f"{stats['corrupt']} corrupt line(s)).</p>")
    t0 = min(r["ts"] for r in spans)
    t1 = max(r["ts"] + r.get("dur", 0) for r in spans)
    total = max(t1 - t0, 1)
    # stitched cross-process records carry a "host" attribute: group
    # per (host, thread) so two processes' colliding tids stay apart
    by_tid = {}
    for r in spans:
        if r.get("track") == "device":
            key = (0, str(r.get("lane", "")), 0)
        else:
            key = (1, str(r.get("host", "")), r.get("tid", 0))
        by_tid.setdefault(key, []).append(r)
    names = sorted({str(r["name"]) for r in spans})
    color = {n: _TRACE_COLORS[i % len(_TRACE_COLORS)]
             for i, n in enumerate(names)}
    n_dev = sum(1 for r in spans if r.get("track") == "device")
    dev_note = f" ({n_dev} on the device lane)" if n_dev else ""
    parts = [f"<p>{len(spans)} span(s){dev_note} over {_fmt_ns(total)}; "
             f"{stats['torn']} torn, {stats['corrupt']} corrupt. "
             f"Full fidelity: <code>python -m jepsen_tpu_torch trace "
             f"export --format chrome</code> &rarr; ui.perfetto.dev</p>",
             "<div style='font-size:11px'>"]
    shown = 0
    for key in sorted(by_tid):
        rows = sorted(by_tid[key], key=lambda r: r["ts"])
        device, host, tid = key
        if device == 0:
            head = f"device lane {html.escape(host)}"
        else:
            head = (f"{html.escape(host)} thread {tid}" if host
                    else f"thread {tid}")
        parts.append(f"<h3>{head}</h3>")
        # the device lanes take at most half the cap: the host threads
        # after them always keep the other half
        limit = cap // 2 if device == 0 else cap
        for r in rows:
            if shown >= limit:
                break
            shown += 1
            left = 100.0 * (r["ts"] - t0) / total
            dur = r.get("dur", 0)
            width = max(100.0 * dur / total, 0.1)
            label = html.escape(
                f"{r['name']} ({_fmt_ns(dur)})" if dur
                else f"{r['name']} @{_fmt_ns(r['ts'] - t0)}")
            attrs = {k: v for k, v in r.items()
                     if k not in ("name", "ts", "dur", "tid", "sid",
                                  "pid", "host", "track", "lane")}
            tip = html.escape(json.dumps(attrs, default=repr)) \
                if attrs else ""
            parts.append(
                "<div style='position:relative;height:15px;"
                "margin:1px 0;background:#f5f5f5'>"
                f"<div title='{tip}' style='position:absolute;"
                f"left:{left:.3f}%;width:{width:.3f}%;height:100%;"
                f"background:{color[str(r['name'])]}'></div>"
                f"<span style='position:relative;padding-left:4px'>"
                f"{label}</span></div>")
    parts.append("</div>")
    if shown < len(spans):
        parts.append(f"<p>{len(spans) - shown} span(s) elided "
                     f"(cap {cap}).</p>")
    return "".join(parts)


def request_trace_html(stitched: dict, cap: int = 2000) -> str:
    """One stitched request trace (:func:`jepsen_tpu_torch.obs.fleet.
    stitch_request`) -> the single-request waterfall the serve daemon's
    ``/trace/request/<id>`` page shows: every process's spans for one
    trace id on one aligned timeline."""
    records = stitched.get("records") or []
    stats = {"spans": len(records), "torn": 0, "corrupt": 0}
    hosts = stitched.get("hosts") or []
    method = stitched.get("method")
    tid = str(stitched.get("trace-id", ""))
    head = (f"<p>trace <code>{html.escape(tid)}</code>: "
            f"{len(records)} record(s) across "
            f"{max(len(hosts), 1)} process(es)"
            + (f"; clocks aligned via <code>{html.escape(method)}"
               f"</code>" if method else "")
            + f". CLI: <code>python -m jepsen_tpu_torch trace request "
              f"{html.escape(tid)}"
              f"</code></p>")
    return head + _waterfall_html(records, stats, cap=cap)


def flightrec_html(dumps: list) -> str:
    """The flight-recorder inventory (:func:`jepsen_tpu_torch.obs.flightrec.
    list_dumps`) -> the serve daemon's ``/flightrec`` page: one row per
    dump, newest first, linking the raw JSON."""
    if not dumps:
        return ("<p>No flight-recorder dumps. The daemon writes one to "
                "<code>flightrec/</code> on breaker trip, drain, and "
                "SIGTERM "
                "(<code>JTPU_FLIGHTREC_SECONDS</code> window).</p>")
    rows = ["<table><tr><th>dump</th><th>reason</th><th>when</th>"
            "<th>spans</th><th>traces</th><th>bytes</th></tr>"]
    for d in dumps:
        name = html.escape(str(d.get("name", "")))
        ts = d.get("wall-ts")
        when = time.strftime("%Y-%m-%d %H:%M:%S",
                             time.localtime(ts)) if ts else "?"
        rows.append(
            f"<tr><td><a href='/flightrec/{name}'><code>{name}</code>"
            f"</a></td><td>{html.escape(str(d.get('reason', '')))}</td>"
            f"<td>{when}</td><td>{d.get('spans', 0)}</td>"
            f"<td>{d.get('trace-ids', 0)}</td>"
            f"<td>{d.get('bytes', 0)}</td></tr>")
    rows.append("</table>")
    rows.append("<p>CLI: <code>python -m jepsen_tpu_torch flightrec "
                "[dump]</code></p>")
    return "".join(rows)


def trace_find_html(rows: list) -> str:
    """Trace-search results (:func:`jepsen_tpu_torch.obs.federation.
    trace_find`) -> a ``/trace/find`` page: one row per matching request,
    newest first, linking the stitched per-request waterfall. The daemon
    mounts no such route until the federator is ported."""
    if not rows:
        return ("<p>No matching requests. Filters: "
                "<code>?tenant=</code> <code>&amp;min-device-s=</code> "
                "<code>&amp;error-class=</code> <code>&amp;host=</code> "
                "<code>&amp;limit=</code>; add "
                "<code>&amp;format=json</code> for the raw rows.</p>")
    out = ["<table><tr><th>request</th><th>tenant</th><th>when</th>"
           "<th>valid</th><th>seconds</th><th>device-s</th>"
           "<th>hosts</th><th>error-class</th></tr>"]
    for r in rows:
        rid = html.escape(str(r.get("id", "")))
        ts = r.get("ts")
        when = time.strftime("%Y-%m-%d %H:%M:%S",
                             time.localtime(ts)) if ts else "?"
        dev = r.get("device-s")
        out.append(
            f"<tr><td><a href='/trace/request/{rid}'><code>{rid}"
            f"</code></a></td>"
            f"<td>{html.escape(str(r.get('tenant', '')))}</td>"
            f"<td>{when}</td>"
            f"<td>{html.escape(str(r.get('valid', '')))}</td>"
            f"<td>{r.get('seconds', '')}</td>"
            f"<td>{dev if dev is not None else ''}</td>"
            f"<td>{html.escape(' '.join(r.get('hosts') or []))}</td>"
            f"<td>{html.escape(str(r.get('error-class') or ''))}</td>"
            f"</tr>")
    out.append("</table>")
    out.append("<p>CLI: <code>python -m jepsen_tpu_torch trace find "
               "--tenant T "
               "--min-device-s S --error-class C --host H</code></p>")
    return "".join(out)


def serve(host: str = "127.0.0.1", port: int = 8080,
          root: str = "store",
          handler_cls: Optional[type] = None) -> ThreadingHTTPServer:
    """Start the results server (web.clj:315-320); caller runs
    serve_forever (or uses serve_background). ``handler_cls`` lets the
    check daemon (:mod:`jepsen_tpu_torch.serve`) mount its POST /check /
    /healthz / /drain routes on the same server; None keeps the plain
    results browser — byte-identical to the pre-daemon behavior."""
    base = handler_cls or Handler
    handler = type("BoundHandler", (base,), {"root": root})
    return ThreadingHTTPServer((host, port), handler)


def serve_background(host: str = "127.0.0.1", port: int = 0,
                     root: str = "store") -> ThreadingHTTPServer:
    """serve() on a daemon thread; returns the live server (its
    server_port reports the bound port when port=0)."""
    server = serve(host, port, root)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server
