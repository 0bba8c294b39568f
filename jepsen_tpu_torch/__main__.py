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
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

#: exit codes, as the reference's command line has them
OK, TEST_FAILED, INVALID_ARGS, CRASHED = 0, 1, 254, 255


def _parser() -> argparse.ArgumentParser:
    from jepsen_tpu_torch.serve import models
    p = argparse.ArgumentParser(prog="python -m jepsen_tpu_torch")
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
    return p


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


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    opts = _parser().parse_args(argv)
    run = {"stream": stream, "serve": serve, "plan": plan_cmd}[opts.cmd]
    return run(opts)


if __name__ == "__main__":
    sys.exit(main())
