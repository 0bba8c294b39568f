"""Command line of the port.

``python -m jepsen_tpu_torch serve --check-daemon`` runs the check daemon
(:mod:`jepsen_tpu_torch.serve`). Its flags are the reference's daemon
flags (``jtpu serve``): ``--host``, ``--port``, ``--serve-dir``,
``--workers``, ``--queue-max``, ``--tenant-max`` and ``--deadline-s``;
``--device cpu`` runs the searches on the CPU (the kernels' plain
versions) instead of CUDA. The process serves until ``POST /drain`` (or
an interrupt) and then exits 0.

``python -m jepsen_tpu_torch stream --history FILE`` is the client of a
daemon's stream routes (the reference's ``jtpu stream``): it opens a
stream, POSTs the history's ops (a JSON array or JSON lines of op maps)
as sequenced, CRC'd chunks, waiting out 429s and resending from the
daemon's ``need`` on a 409 gap, seals it and polls for the verdict, which
it prints. Exit 0 when valid, 1 when not (or unknown), 254 for bad
arguments or an empty history, 255 when the daemon fails a call.

``python -m jepsen_tpu_torch plan --dims N[,CRASHED[,WINDOW[,EVENTS]]]``
(or ``--dims @file.json``, or ``--history FILE``) verifies a search plan
before any device time (the reference's ``jtpu plan``): every candidate
rung with its footprint in the port's own buffers, the ``PLAN-*`` rules
and the shape check (:mod:`jepsen_tpu_torch.checker.plan`). It plans for
CUDA unless ``--device cpu``. Exit 0 when no error-severity finding, 1
when one, 254 for bad arguments. ``--mesh`` (the sharded plan) and
``--format sarif`` are refused: the port has neither the multi-GPU search
nor a SARIF renderer yet.

``python -m jepsen_tpu_torch run --suite local-kv`` runs a test (the
reference's ``jtpu run``): ``core.run`` boots the suite's system, drives
its clients under the generator with the nemesis, tees every op into the
WAL, saves the store under ``--store-root`` and then checks the history,
on the card unless ``--device cpu`` (the kernels' plain versions) or
``--backend cpu`` (the host search). ``--node``, ``--concurrency`` and
``--time-limit`` default to the suite's own settings. ``--watch`` and
``--fleet`` are refused: the port has neither the live status printer
nor the multi-GPU fleet yet.

``python -m jepsen_tpu_torch analyze --store DIR`` re-checks a stored run
(by either package) and prints, before the result, its lint summary, its
``# plan:`` line, the ``# contention:`` forecast, the ``# compile:`` split
of the check's wall clock and the ``# search:`` analytics.
``python -m jepsen_tpu_torch recover`` finds the runs under
``--store-root`` whose process died mid-flight, rebuilds each history
from its WAL (dangling invokes become ``info``), re-checks it and marks
the run done. All three take ``--backend`` and ``--device``; ``analyze``
and ``recover`` also ``--model`` and ``--algorithm``. ``run --suite``
offers the local-kv suites and the sqlite ones (``sqlite-register``,
``sqlite-bank``, ``sqlite-register-toctou``: the real SQLite engine).

``python -m jepsen_tpu_torch explain [--store DIR]`` says why a stored
run (by either package; the latest under ``--store-root`` by default) got
its verdict (:mod:`jepsen_tpu_torch.explain`): the search's shape for a
valid run, the violating level, blocking ops and witness region for an
invalid one, the cause chain for an unknown one, as ``# explain:`` lines
or, with ``--format json``, the report. It reads the artifacts only: no
check runs.

Exit codes, as the reference's command line has them: 0 valid, 1 not
valid (or unknown), 254 bad arguments or a missing store, 255 an internal
error, a CUDA device that does not initialise among them: with the card's
backend, nothing carries on on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Optional

#: exit codes, as the reference's command line has them
OK, TEST_FAILED, INVALID_ARGS, CRASHED = 0, 1, 254, 255


class _ArgError(Exception):
    pass


class _Parser(argparse.ArgumentParser):
    """Raises instead of exiting, so :func:`main` answers bad arguments
    with 254."""

    def error(self, message):
        raise _ArgError(message)


def _parser() -> argparse.ArgumentParser:
    from jepsen_tpu_torch.serve import models
    from jepsen_tpu_torch.suites import SUITES
    p = _Parser(prog="python -m jepsen_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="run the multi-tenant check daemon")
    s.add_argument("--check-daemon", action="store_true",
                   help="serve POST /check, GET /check/<id>, /healthz, "
                        "/drain and the /stream routes (the only service "
                        "of the port)")
    s.add_argument("-b", "--host", default="0.0.0.0")
    s.add_argument("-p", "--port", type=int, default=8080,
                   help="port to listen on (0: any free port)")
    s.add_argument("--serve-dir", default=os.path.join("store", "serve"),
                   metavar="DIR",
                   help="daemon directory: request journal and results")
    s.add_argument("--workers", type=int, default=None,
                   help="check worker threads (JTPU_SERVE_WORKERS)")
    s.add_argument("--queue-max", type=int, default=None,
                   help="queue depth past which POST /check answers 429 "
                        "(JTPU_SERVE_QUEUE)")
    s.add_argument("--tenant-max", type=int, default=None,
                   help="queued requests a tenant may have "
                        "(JTPU_SERVE_TENANT_MAX)")
    s.add_argument("--deadline-s", type=float, default=None,
                   help="default per-request deadline; past it a request "
                        "answers :info/timeout (JTPU_SERVE_DEADLINE_S)")
    s.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the searches run (default: cuda)")
    t = sub.add_parser("stream", help="stream a history into a check "
                                      "daemon's /stream routes and await "
                                      "the verdict")
    t.add_argument("--url", default="http://127.0.0.1:8080",
                   help="daemon base URL")
    t.add_argument("--history", required=True, metavar="FILE",
                   help="history file: a JSON array or JSON lines of op "
                        "maps")
    t.add_argument("--model", default="cas-register", choices=list(models()))
    t.add_argument("--tenant", default="default")
    t.add_argument("--chunk", type=int, default=1000, help="ops per chunk")
    t.add_argument("--auth-token", default=None, metavar="TOKEN",
                   help="Authorization: Bearer TOKEN")
    t.add_argument("--poll", type=float, default=0.5,
                   help="verdict poll interval (seconds)")
    t.add_argument("--timeout", type=float, default=600.0,
                   help="the client's whole budget (seconds)")
    q = sub.add_parser("plan", help="verify a search plan ahead of any "
                                    "device time: encoding, memory and "
                                    "kernel shape")
    q.add_argument("--history", default=None, metavar="FILE",
                   help="derive the dims from a history file (a JSON array "
                        "or JSON lines of op maps)")
    q.add_argument("--dims", default=None, metavar="SPEC",
                   help="dims without a history: 'N_REQUIRED[,N_CRASHED"
                        "[,WINDOW_NEEDED[,N_EVENTS]]]' or @file.json (keys: "
                        "n_required, n_crashed, window_needed, n_events, "
                        "keys, capacity, window, expand, bytes_limit)")
    q.add_argument("--model", default="cas-register", choices=list(models()))
    q.add_argument("--keys", type=int, default=1,
                   help="verify the keyed-batch plan for this many keys")
    q.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="the pool-sharded plan (not in this package yet)")
    q.add_argument("--capacity", type=int, default=None,
                   help="pin the rung instead of the ladder")
    q.add_argument("--window", type=int, default=None)
    q.add_argument("--expand", type=int, default=None)
    q.add_argument("--bytes-limit", type=int, default=None,
                   help="byte budget (default: JTPU_PLAN_BYTES_LIMIT, else "
                        "the card's memory, else unchecked)")
    q.add_argument("--no-trace", action="store_true",
                   help="skip the shape check (arithmetic only)")
    q.add_argument("--format", default="text",
                   choices=["text", "json", "sarif"])
    q.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the device whose ladder and memory to plan for")
    r = sub.add_parser("run", help="run a registered suite: workload, "
                                   "store, then the check")
    r.add_argument("--suite", required=True, choices=sorted(SUITES))
    r.add_argument("-n", "--node", action="append", metavar="HOSTNAME",
                   help="node to run the test on; repeatable (default: "
                        "the suite's nodes)")
    r.add_argument("--nodes-file", metavar="FILENAME",
                   help="file of node hostnames, one per line")
    r.add_argument("--username", default="root", help="ssh username")
    r.add_argument("--password", default="root", help="sudo password")
    r.add_argument("--strict-host-key-checking", action="store_true",
                   help="check ssh host keys")
    r.add_argument("--ssh-private-key", metavar="FILE",
                   help="ssh identity file")
    r.add_argument("--ssh-mode", default=None,
                   choices=[None, "ssh", "dummy", "local"],
                   help="control-plane transport (dummy = record only)")
    r.add_argument("--concurrency", default=None,
                   help="worker count; an integer, optionally followed by "
                        "n to multiply by the node count (e.g. 3n; "
                        "default: the suite's)")
    r.add_argument("--test-count", type=int, default=1,
                   help="how many times to repeat the test")
    r.add_argument("--time-limit", type=int, default=None,
                   help="test phase duration in seconds (default: the "
                        "suite's)")
    r.add_argument("--op-timeout", type=float, default=None,
                   metavar="SECONDS",
                   help="bound each client op: a hung invoke becomes an "
                        ":info op and the process reincarnates")
    r.add_argument("--store-root", default="store", metavar="DIR",
                   help="where runs are stored")
    _add_device_opts(r)
    r.add_argument("--watch", action="store_true",
                   help="live search status (not in this package yet)")
    r.add_argument("--fleet", type=int, default=None, metavar="N",
                   help="the elastic multi-GPU fleet (not in this "
                        "package yet)")
    a = sub.add_parser("analyze", help="re-check a stored run offline")
    a.add_argument("--store", default=None,
                   help="store directory (default: the latest under "
                        "./store)")
    _add_check_opts(a)
    v = sub.add_parser("recover", help="recover runs that died mid-flight "
                                       "from their WALs and re-check them")
    v.add_argument("--store", default=None,
                   help="a specific run directory (default: scan "
                        "--store-root for dead runs)")
    v.add_argument("--store-root", default="store",
                   help="store root to scan for dead runs")
    v.add_argument("--no-analyze", action="store_true",
                   help="reconstruct histories only; skip the checker")
    v.add_argument("--force", action="store_true",
                   help="recover --store even if its run.state says done "
                        "or its pid looks alive")
    _add_check_opts(v)
    e = sub.add_parser("explain", help="explain a stored run's verdict "
                                       "from its artifacts (results, "
                                       "searchstats, attempts trail)")
    e.add_argument("--store", default=None,
                   help="run directory (default: the latest under "
                        "--store-root)")
    e.add_argument("--store-root", default="store")
    e.add_argument("--model", default="cas-register", choices=list(models()),
                   help="the model the counterexample is packed with "
                        "(invalid verdicts only)")
    e.add_argument("--format", default="text", choices=["text", "json"])
    return p


def _add_check_opts(p: argparse.ArgumentParser) -> None:
    """The checker options of analyze and recover."""
    from jepsen_tpu_torch.serve import models
    p.add_argument("--model", default="cas-register", choices=list(models()),
                   help="the model to check against")
    p.add_argument("--algorithm", default="auto",
                   choices=["auto", "wgl", "linear", "native",
                            "competition"],
                   help="the host search")
    _add_device_opts(p)


def _add_device_opts(p: argparse.ArgumentParser) -> None:
    """Where the check runs: the options of run, analyze and recover."""
    p.add_argument("--backend", default="gpu", choices=["gpu", "cpu"],
                   help="gpu: the device search (default); cpu: the host "
                        "search")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the device search runs (default: cuda; cpu "
                        "runs the kernels' plain versions)")
    p.add_argument("--segment-iters", type=int, default=None, metavar="N",
                   help="device-search levels per checkpointed segment "
                        "(JTPU_SEGMENT_ITERS)")
    p.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler trace of the check into "
                        "<run>/profile/ (JTPU_PROF=1)")


def serve(opts: argparse.Namespace) -> int:
    from jepsen_tpu_torch import serve as serve_ns
    if not opts.check_daemon:
        print("serve: the port serves only the check daemon; pass "
              "--check-daemon", file=sys.stderr)
        return 2
    cfg = serve_ns.ServeConfig(root=opts.serve_dir,
                               device="cpu" if opts.device == "cpu"
                               else None)
    for name in ("workers", "queue_max", "tenant_max"):
        if getattr(opts, name) is not None:
            setattr(cfg, name, getattr(opts, name))
    if opts.deadline_s is not None:
        cfg.deadline_s = opts.deadline_s or None
    daemon, server = serve_ns.run_daemon(cfg, host=opts.host,
                                         port=opts.port)
    print(f"Listening on http://{opts.host}:{server.server_port}/ (check "
          f"daemon: POST /check, GET /check/<id>, /healthz, /drain"
          f"{', /stream' if daemon._streams is not None else ''})",
          flush=True)
    try:
        daemon.drained.wait()
    except KeyboardInterrupt:
        daemon.drain(timeout_s=30.0)
    server.shutdown()
    server.server_close()
    daemon.stop()
    return 0


def _load_ops(path: str) -> list:
    """A history file's op maps: a JSON array, or one per line."""
    with open(path) as f:
        text = f.read().strip()
    if text.startswith("["):
        return json.loads(text)
    return [json.loads(ln) for ln in text.splitlines() if ln.strip()]


def stream(opts: argparse.Namespace) -> int:
    import urllib.error
    import urllib.request

    from jepsen_tpu_torch.stream import chunk_crc
    base = opts.url.rstrip("/")

    def call(method, path, doc=None):
        req = urllib.request.Request(
            base + path, method=method,
            data=None if doc is None else json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"})
        if opts.auth_token:
            req.add_header("Authorization", f"Bearer {opts.auth_token}")
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read() or b"{}")
            except ValueError:
                body = {}
            return e.code, body

    try:
        ops = _load_ops(opts.history)
    except (OSError, ValueError) as e:
        print(f"cannot read {opts.history}: {e}", file=sys.stderr)
        return INVALID_ARGS
    if not ops:
        print("history is empty; nothing to stream", file=sys.stderr)
        return INVALID_ARGS
    deadline = time.monotonic() + opts.timeout

    def budget() -> float:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError("stream client budget exhausted")
        return left

    opening = {"tenant": opts.tenant, "model": opts.model}
    code, body = call("POST", "/stream", opening)
    while code == 429:
        time.sleep(min(float(body.get("retry-after-s") or 1.0), budget()))
        code, body = call("POST", "/stream", opening)
    if code != 202:
        print(f"open failed: HTTP {code} {body}", file=sys.stderr)
        return CRASHED
    sid = body["id"]
    n_chunk = max(1, opts.chunk)
    chunks = [ops[i:i + n_chunk] for i in range(0, len(ops), n_chunk)]
    print(f"# stream: {sid} -> {base} ({len(ops)} ops in {len(chunks)} "
          f"chunk(s) of <= {n_chunk})", flush=True)
    seq = 0
    while seq < len(chunks):
        code, body = call("POST", f"/stream/{sid}/ops",
                          {"seq": seq, "ops": chunks[seq],
                           "crc": chunk_crc(chunks[seq])})
        if code == 202:
            seq += 1
        elif code == 429:
            time.sleep(min(float(body.get("retry-after-s") or 1.0),
                           budget()))
        elif code == 409 and body.get("error") == "gap":
            # chunks are idempotent: resend from the daemon's cursor
            seq = int(body["need"])
        elif code == 409 and body.get("error") == "stream-failed":
            # the online check refuted a stable prefix: the verdict is in
            print(f"# stream: {sid} failed fast at chunk {seq}; awaiting "
                  f"the verdict", flush=True)
            break
        else:
            print(f"chunk {seq} failed: HTTP {code} {body}", file=sys.stderr)
            return CRASHED
        budget()
    code, body = call("POST", f"/stream/{sid}/close",
                      {"chunks": len(chunks)})
    if code not in (200, 202) and body.get("error") != "stream-failed":
        print(f"close failed: HTTP {code} {body}", file=sys.stderr)
        return CRASHED
    while True:
        code, body = call("GET", f"/stream/{sid}")
        if code == 200 and body.get("state") == "done" \
                and body.get("result") is not None:
            break
        time.sleep(min(opts.poll, budget()))
    result = body["result"]
    print(json.dumps(result, indent=2, default=repr))
    return OK if result.get("valid") is True else TEST_FAILED


def _plan_dims(opts: argparse.Namespace, model):
    """The dims ``plan`` verifies, or an error message. Shape knobs a
    ``@file.json`` pins fill the flags not given."""
    from jepsen_tpu_torch.checker import plan
    from jepsen_tpu_torch.history import History
    if opts.history:
        try:
            h = History.of(_load_ops(opts.history))
        except (OSError, ValueError) as e:
            return f"cannot read {opts.history}: {e}"
        dims = plan.PlanDims.from_history(h, model)
        if dims is None:
            return f"model {opts.model} has no integer kernel; nothing to plan"
        return dims
    if not opts.dims:
        return "pass --history FILE or --dims SPEC"
    spec = opts.dims
    if spec.startswith("@"):
        try:
            with open(spec[1:], encoding="utf-8") as f:
                d = json.load(f)
        except (OSError, ValueError) as e:
            return f"--dims {spec!r}: {e}"
        for knob in ("capacity", "window", "expand", "mesh", "bytes_limit"):
            if getattr(opts, knob) is None and d.get(knob) is not None:
                setattr(opts, knob, int(d[knob]))
        return plan.PlanDims(
            n_required=int(d["n_required"]),
            n_crashed=int(d.get("n_crashed", 0)),
            window_needed=int(d.get("window_needed", 1)),
            n_events=(int(d["n_events"]) if d.get("n_events") is not None
                      else None),
            keys=int(d.get("keys", opts.keys or 1)))
    try:
        parts = [int(x) for x in spec.split(",")]
    except ValueError:
        return (f"--dims {spec!r}: expected comma-separated integers or "
                f"@file.json")
    if not parts or len(parts) > 4:
        return f"--dims {spec!r}: 1-4 integers"
    return plan.PlanDims(*parts, keys=opts.keys or 1)


def plan_cmd(opts: argparse.Namespace) -> int:
    from jepsen_tpu_torch.checker import plan
    from jepsen_tpu_torch.models.core import kernel_spec_for
    from jepsen_tpu_torch.serve import models
    if opts.format == "sarif":
        print("plan: --format sarif is refused: this package has no SARIF "
              "renderer yet; use text or json", file=sys.stderr)
        return INVALID_ARGS
    model = models()[opts.model]()
    dims = _plan_dims(opts, model)
    if isinstance(dims, str):
        print(dims, file=sys.stderr)
        return INVALID_ARGS
    if opts.mesh is not None:
        print("plan: --mesh is refused: the pool-sharded plan needs the "
              "multi-GPU search, which this package does not have yet",
              file=sys.stderr)
        return INVALID_ARGS
    if (opts.keys or 1) > 1 and dims.keys == 1:
        dims = plan.PlanDims(dims.n_required, dims.n_crashed,
                             dims.window_needed, dims.n_events,
                             keys=opts.keys)
    report = plan.analyze(dims, kernel=kernel_spec_for(model),
                          capacity=opts.capacity, window=opts.window,
                          expand=opts.expand, bytes_limit=opts.bytes_limit,
                          trace=not opts.no_trace, device=opts.device)
    errors = [i for i in report["issues"] if i["severity"] == "error"]
    if opts.format == "json":
        print(json.dumps(report, indent=2))
        return TEST_FAILED if errors else OK
    d, lim = report["dims"], report["bytes-limit"]
    print(f"# plan: dims n={d['n-required']}+{d['n-crashed']} "
          f"window<={d['window-needed']} keys={d['keys']}, limit "
          f"{'unchecked' if lim is None else f'{lim} B'}")
    for i in report["issues"]:
        if not i.get("label"):   # dims-level, not per-candidate
            print(f"# plan: {i['severity'].upper()} [{i['rule']}] "
                  f"{i['message']}")
    for c in report["candidates"]:
        mark = "ok " if c["status"] == "ok" else "REJ"
        line = (f"# plan: {mark} {c['label']:<36} "
                f"{c['footprint']['total-bytes'] / 1e6:9.3f} MB")
        if c.get("cost"):
            # integer operations and bytes of one level (kernels/cost.py)
            line += (f" {c['cost']['flops'] / 1e6:10.2f} MOP/level "
                     f"{c['cost']['bytes-accessed'] / 1e6:9.3f} MB/level")
        rules = sorted({i["rule"] for i in c["issues"]})
        if rules:
            line += "  " + " ".join(rules)
        print(line)
    print(f"# plan: selected {report['selected'] or 'NONE'}; "
          f"{len(errors)} error finding(s)")
    return TEST_FAILED if errors else OK


def _apply_check_env(opts: argparse.Namespace) -> None:
    """--segment-iters and --profile reach the device search through the
    environment it reads, for every check this process runs."""
    if opts.segment_iters is not None:
        os.environ["JTPU_SEGMENT_ITERS"] = str(opts.segment_iters)
    if opts.profile:
        os.environ["JTPU_PROF"] = "1"


def _device(opts: argparse.Namespace):
    """The device argument of the checkers: None (CUDA) or "cpu"."""
    return "cpu" if opts.device == "cpu" else None


def _card_refused(opts: argparse.Namespace, cmd: str) -> bool:
    """True, with the reason on stderr, when the check is to run on the
    card and CUDA does not initialise: the command then stops before any
    work, and does not carry on on the CPU."""
    if opts.backend != "gpu" or opts.device == "cpu":
        return False
    from jepsen_tpu_torch import accel
    try:
        accel.ensure_usable(cmd)
    except accel.AcceleratorUnavailable as e:
        print(f"{cmd}: {e}", file=sys.stderr)
        return True
    return False


def _parse_concurrency(c: str, n_nodes: int) -> int:
    """'3n' -> 3 * nodes; a plain integer otherwise."""
    import re
    m = re.fullmatch(r"(\d+)(n?)", str(c))
    if not m:
        raise _ArgError(f"--concurrency {c} should be an integer "
                        f"optionally followed by n")
    return int(m.group(1)) * (n_nodes if m.group(2) == "n" else 1)


def _test_opts(opts: argparse.Namespace) -> dict:
    """The option map a suite constructor takes (the reference's
    ``test_opt_fn``); options left at None are the suite's own."""
    nodes = list(opts.node or [])
    if opts.nodes_file:
        with open(opts.nodes_file) as f:
            nodes += [ln.strip() for ln in f if ln.strip()]
    out = {"ssh": {"username": opts.username, "password": opts.password,
                   "strict-host-key-checking":
                       opts.strict_host_key_checking,
                   "private-key-path": opts.ssh_private_key,
                   "mode": opts.ssh_mode},
           "test-count": opts.test_count, "op-timeout": opts.op_timeout,
           "store-root": opts.store_root, "backend": opts.backend,
           "device": _device(opts), "segment-iters": opts.segment_iters,
           "profile": opts.profile}
    if nodes:
        out["nodes"] = nodes
    if opts.concurrency is not None:
        if str(opts.concurrency).endswith("n") and not nodes:
            raise _ArgError("--concurrency Nn needs --node or --nodes-file")
        out["concurrency"] = _parse_concurrency(opts.concurrency, len(nodes))
    if opts.time_limit is not None:
        out["time-limit"] = opts.time_limit
    return out


def run_cmd(opts: argparse.Namespace) -> int:
    from jepsen_tpu_torch import core, suites
    if opts.watch or opts.fleet is not None:
        flag = "--watch" if opts.watch else "--fleet"
        item = "A8 (the live status printer)" if opts.watch \
            else "A7 (the multi-GPU fleet)"
        print(f"run: {flag} is refused: this package does not have "
              f"{item} yet", file=sys.stderr)
        return INVALID_ARGS
    test_opts = _test_opts(opts)
    _apply_check_env(opts)
    if _card_refused(opts, "run"):
        return CRASHED
    ctor = suites.registry()[opts.suite]
    for _ in range(opts.test_count):
        test = core.run(ctor(dict(test_opts)))
        if test["results"].get("valid") is not True:
            return TEST_FAILED
    return OK


def _search_line(out) -> Optional[str]:
    """The ``# search:`` analytics line from the result's searchstats
    roll-up; None when the check ran without the stats lane."""
    ss = (out or {}).get("searchstats")
    if not isinstance(ss, dict):
        return None
    return ("# search: dup-rate {dr:.0%}, prune-efficiency {pe:.0%}, "
            "frontier area {fa} (peak {fp}), truncation-losses {tr} "
            "over {lv} level(s)").format(
                dr=ss.get("dup-rate", 0.0),
                pe=ss.get("prune-efficiency", 0.0),
                fa=ss.get("frontier-area", 0),
                fp=ss.get("frontier-peak", 0),
                tr=ss.get("trunc-losses", 0),
                lv=ss.get("levels", 0))


def _forecast(history, model, opts: argparse.Namespace) -> None:
    """The ``# plan:`` line and the ``# contention:`` lines."""
    from jepsen_tpu_torch.analysis import contention
    from jepsen_tpu_torch.checker import plan
    print(plan.summary_line(history, model, device=opts.device))
    for ln in contention.forecast_lines(contention.profile(history)):
        print(ln)


def _recheck(test: dict, model, opts: argparse.Namespace) -> dict:
    """Re-check a stored run's history; prints the ``# compile:`` and
    ``# search:`` lines. Live progress (and a --profile capture) go to the
    run's directory."""
    from jepsen_tpu_torch import repl
    from jepsen_tpu_torch.checker import gpu
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.obs import observatory, profiler
    checker = linearizable(model, backend=opts.backend, device=_device(opts),
                           algorithm=opts.algorithm)
    observatory.attach(test.get("store-dir"))
    profiler.attach(test.get("store-dir"))
    comp0 = gpu.compile_snapshot()
    t0 = time.perf_counter()
    try:
        out = repl.recheck(test, checker)
    finally:
        wall = time.perf_counter() - t0
        observatory.detach()
        profiler.detach()
    print(gpu.compile_line(gpu.compile_delta(comp0), wall))
    sline = _search_line(out)
    if sline:
        print(sline)
    return out


def analyze_cmd(opts: argparse.Namespace) -> int:
    from jepsen_tpu_torch import analysis, core, repl, store
    from jepsen_tpu_torch.analysis.history_lint import lint_history
    from jepsen_tpu_torch.serve import models
    if opts.store and not os.path.isdir(opts.store):
        # a missing directory is a typo, not an empty run
        print(f"no such store directory: {opts.store}", file=sys.stderr)
        return INVALID_ARGS
    test = store.load(opts.store) if opts.store else repl.last_test()
    if test is None:
        print("no stored test found", file=sys.stderr)
        return INVALID_ARGS
    _apply_check_env(opts)
    if _card_refused(opts, "analyze"):
        return CRASHED
    history = test.get("history") or []
    model = models()[opts.model]()
    print(analysis.summary_line(lint_history(history)))
    _forecast(history, model, opts)
    out = _recheck(test, model, opts)
    leaked = core.abandoned_threads()
    if leaked:
        print(f"# leaked-threads: {leaked} hung client-op thread(s) "
              f"abandoned by op-timeout and still resident")
    print(json.dumps(out, indent=2, default=repr))
    return OK if out.get("valid") is True else TEST_FAILED


def recover_cmd(opts: argparse.Namespace) -> int:
    from jepsen_tpu_torch import analysis, store
    from jepsen_tpu_torch.analysis import history_lint as hl
    from jepsen_tpu_torch.obs import trace as trace_ns
    from jepsen_tpu_torch.serve import models
    if opts.store:
        d = opts.store
        if not os.path.isdir(d):
            print(f"no such store directory: {d}", file=sys.stderr)
            return INVALID_ARGS
        status = store.run_status(d)
        if status != "dead" and not opts.force:
            print(f"# recovery: {d}: status={status or 'no run.state'}; "
                  f"nothing to recover (--force overrides)")
            return OK if status in ("done", "recovered") else INVALID_ARGS
        targets = [d]
    else:
        targets = store.dead_runs(opts.store_root or "store")
        if not targets:
            print("# recovery: no dead runs found")
            return OK
    _apply_check_env(opts)
    if not opts.no_analyze and _card_refused(opts, "recover"):
        return CRASHED
    worst = OK
    for d in targets:
        try:
            rec = store.recover_run(d)
        except (OSError, ValueError) as e:
            print(f"# recovery: {d}: FAILED: {e}", file=sys.stderr)
            worst = TEST_FAILED
            continue
        s = rec["stats"]
        print(f"# recovery: {d}: {s['ops']} ops recovered "
              f"({s['records']} WAL records, {s['torn']} torn, "
              f"{s['corrupt']} corrupt, {s['reconciled']} dangling "
              f"invoke(s) -> info)")
        tpath = os.path.join(d, trace_ns.TRACE_NAME)
        if os.path.exists(tpath):
            try:
                _, tstats = trace_ns.read_trace(tpath)
                print(f"# trace: {tstats['spans']} span(s) recovered from "
                      f"trace.jsonl ({tstats['torn']} torn, "
                      f"{tstats['corrupt']} corrupt)")
            except OSError as e:
                print(f"# trace: unreadable trace.jsonl: {e}",
                      file=sys.stderr)
        # the structure the reconciler could not repair fails the
        # recovery; decode damage was counted above
        findings = hl.lint_history(rec["history"], decode_errors=0)
        print(analysis.summary_line(findings))
        model = models()[opts.model]()
        _forecast(rec["history"], model, opts)
        errs = hl.errors(findings)
        if errs:
            for f in errs[:10]:
                print(f"# lint: {d}: {f.format()}", file=sys.stderr)
            print(f"# recovery: {d}: FAILED: recovered history is "
                  f"malformed ({len(errs)} error finding(s); see above)",
                  file=sys.stderr)
            worst = TEST_FAILED
            continue
        if opts.no_analyze:
            continue
        out = _recheck(store.load(d), model, opts)
        store.write_results(d, out)
        store.write_state(d, "done", recovered=True, recovery=s)
        print(f"# recovery: {d}: verdict valid={out.get('valid')}")
        if out.get("valid") is not True:
            worst = TEST_FAILED
    return worst


def explain_cmd(opts: argparse.Namespace) -> int:
    from jepsen_tpu_torch import explain, store
    from jepsen_tpu_torch.serve import models
    d = opts.store
    if d is None:
        t = store.latest(opts.store_root or "store")
        d = t.get("store-dir") if t else None
    if not d or not os.path.isdir(d):
        print(f"no such store directory: {d}", file=sys.stderr)
        return INVALID_ARGS
    report = explain.explain_report(d, model=models()[opts.model]())
    if opts.format == "json":
        print(json.dumps(report, indent=2, default=repr))
    else:
        print(explain.render_text(report))
    return OK if report.get("valid") is True else TEST_FAILED


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    try:
        opts = _parser().parse_args(argv)
    except _ArgError as e:
        print(f"python -m jepsen_tpu_torch: {e}", file=sys.stderr)
        return INVALID_ARGS
    run = {"stream": stream, "serve": serve, "plan": plan_cmd}.get(opts.cmd)
    if run is not None:
        return run(opts)
    run = {"run": run_cmd, "analyze": analyze_cmd,
           "recover": recover_cmd, "explain": explain_cmd}[opts.cmd]
    try:
        return run(opts)
    except _ArgError as e:
        print(f"python -m jepsen_tpu_torch: {e}", file=sys.stderr)
        return INVALID_ARGS
    except Exception:  # noqa: BLE001 -- the exit-code contract's 255
        import traceback
        traceback.print_exc()
        return CRASHED


if __name__ == "__main__":
    sys.exit(main())
