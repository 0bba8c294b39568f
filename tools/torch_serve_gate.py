#!/usr/bin/env python
"""CI serve gate of the PyTorch/CUDA port: stand the check daemon up,
POST a REAL local-kv history at it over HTTP, poll the verdict, drain,
and exit, inside a wall-clock bound (default 30 s).

The port's copy of ``tools/serve_gate.py``, with the same checks, over
``jepsen_tpu_torch`` on ``--device`` (default ``cuda``, probed first: no
CUDA is exit 2, and the fleet's worker processes run there too):

* a real local-kv suite (real daemons, real sockets) produces a real
  history; the daemon admits it (202 + id) and the polled verdict must
  be ``valid: true`` AND equal to the offline ``analyze``-path verdict;
* a same-bucket burst must form at least one gang of size >= 2
  (``/healthz`` ``stats.batches`` / ``stats.max-batch``);
* ``/healthz`` reports the completed request and a warm bucket;
* the 202 carries a trace id (echoed as a ``traceparent`` header), the
  verdict a phase breakdown, the daemon's trace.jsonl >= 4 span names
  under that one trace id, and a ``/metrics`` histogram bucket an
  OpenMetrics exemplar;
* a 10,000-op stream built on the local-kv history goes in as CRC'd
  sequenced chunks, and its verdict equals the offline verdict over the
  same ops; ``/healthz`` reports the session;
* ``POST /drain`` finishes in-flight work and releases the daemon;
* a second daemon, ``--fleet 2`` with two ``ProcHost`` worker processes:
  a multi-tenant same-bucket burst lands every verdict equal to the
  offline one, ``/healthz`` reports ``fleet.live == 2``; ``GET /usage``
  equals a fold over the WAL's ``done`` records, ``GET /slo`` answers
  every objective with a finite burn; both workers' telemetry frames
  are folded under their ``host=`` labels, and ``GET /trace/find``
  resolves a burst request by tenant.

Usage: python tools/torch_serve_gate.py [--budget SECONDS]
           [--time-limit S] [--device cuda|cpu]
Exit code 0 iff the served verdicts match offline within the budget.
"""

import argparse
import json
import os
import sys
import tempfile
import time
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: the streaming leg's ops: the local-kv history, then a sequential tail
STREAM_OPS = 10_000


def _post(port, path, doc):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(doc).encode() if doc is not None else b"",
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.load(r), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e), dict(e.headers)


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, json.load(r)


def _get_text(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.read().decode()


def gate(dev, root, budget=30.0, time_limit=3):
    """Run the gate's legs on device ``dev`` (a string) with every store
    under ``root``: (problems, summary line)."""
    t0 = time.time()
    from jepsen_tpu_torch import core, serve as serve_ns
    from jepsen_tpu_torch.suites.localkv import localkv_test

    # 1. a REAL history from a real localkv run
    test = localkv_test({"time-limit": time_limit,
                         "nemesis-period": 2, "device": dev})
    test["store-dir"] = os.path.join(root, "local-kv", "run")
    test = core.run(test)
    history = [op.to_dict() for op in test["history"]]
    if not history:
        return ["local-kv produced no history"], None

    # 2. the daemon, on a real port — coalesce window widened so the
    # same-bucket burst below reliably forms a gang inside CI jitter
    cfg = serve_ns.ServeConfig(root=os.path.join(root, "serve"),
                               backend="gpu", device=dev,
                               batch_wait_ms=250.0)
    daemon, server = serve_ns.run_daemon(
        cfg, host="127.0.0.1", port=0, store_root=root)
    port = server.server_port
    problems = []
    verdict = None
    try:
        code, body, hdrs = _post(
            port, "/check", {"tenant": "gate",
                             "model": "cas-register",
                             "history": history})
        if code != 202:
            problems.append(f"POST /check answered {code}: {body}")
        else:
            rid = body["id"]
            trace_id = body.get("trace")
            if not trace_id:
                problems.append("202 body carries no trace id")
            echoed = (hdrs.get("traceparent") or "")
            if trace_id and trace_id not in echoed:
                problems.append(
                    f"traceparent header {echoed!r} does not echo "
                    f"trace {trace_id}")
            deadline = time.time() + budget
            doc = {}
            while time.time() < deadline:
                _, doc = _get(port, f"/check/{rid}")
                if doc.get("state") == "done":
                    break
                time.sleep(0.1)
            if doc.get("state") != "done":
                problems.append(f"request never finished: {doc}")
            else:
                verdict = doc["result"].get("valid")
                if verdict is not True:
                    problems.append(
                        f"served verdict {verdict!r}, want True")
                # the crash-safety equality leg: served == offline
                from jepsen_tpu_torch.checker import check_safe
                from jepsen_tpu_torch.checker.wgl import linearizable
                from jepsen_tpu_torch.history import History
                from jepsen_tpu_torch.models import CASRegister
                offline = check_safe(
                    linearizable(CASRegister(), device=dev),
                    {"name": "serve-gate-offline"},
                    History.of(history))
                if offline.get("valid") != verdict:
                    problems.append(
                        f"served verdict {verdict!r} != offline "
                        f"{offline.get('valid')!r}")
                # the tracing leg: one trace id spans POST -> verdict
                serve_doc = doc["result"].get("serve", {})
                phases = serve_doc.get("phases", {})
                want = {"queue_s", "coalesce_s", "compile_s",
                        "device_s", "verdict_s"}
                if not want <= set(phases):
                    problems.append(
                        f"phase breakdown incomplete: {phases}")
                if serve_doc.get("trace") != trace_id:
                    problems.append(
                        f"verdict carries trace "
                        f"{serve_doc.get('trace')!r}, admission "
                        f"promised {trace_id!r}")
                from jepsen_tpu_torch.obs import trace as trace_ns
                trecs, _ = trace_ns.read_trace(
                    os.path.join(cfg.root, trace_ns.TRACE_NAME))
                names = {r["name"] for r in trecs
                         if r.get("trace") == trace_id}
                if len(names) < 4:
                    problems.append(
                        f"trace {trace_id} spans only {sorted(names)}"
                        f", want >= 4 phases POST -> verdict")
                if not {"serve.request", "serve.verdict"} <= names:
                    problems.append(
                        f"trace {trace_id} missing admission/verdict "
                        f"spans: {sorted(names)}")
        # 3. the gang scheduler: a same-bucket burst must coalesce into
        # at least one batched dispatch of size >= 2 (doc/serve.md,
        # "Concurrent batching") — the first request warmed the bucket,
        # so the burst exercises the batched device path end to end
        burst = []
        for i in range(3):
            code, body, _ = _post(port, "/check",
                                  {"tenant": f"burst-{i % 2}",
                                   "model": "cas-register",
                                   "history": history})
            if code == 202:
                burst.append(body["id"])
            else:
                problems.append(f"burst POST {i} answered {code}: "
                                f"{body}")
        deadline = time.time() + budget
        while time.time() < deadline and burst:
            burst = [r for r in burst
                     if _get(port, f"/check/{r}")[1].get("state")
                     != "done"]
            time.sleep(0.05)
        if burst:
            problems.append(f"{len(burst)} burst request(s) never "
                            f"finished")
        _, health = _get(port, "/healthz")
        stats = health.get("stats", {})
        if not stats.get("batches"):
            problems.append(f"burst dispatched no batch: {stats}")
        elif stats.get("max-batch", 0) < 2:
            problems.append(f"no gang of size >= 2 formed: {stats}")
        if not stats.get("completed"):
            problems.append(f"healthz reports no completed request: "
                            f"{stats}")
        if not health.get("engine", {}).get("warm-buckets"):
            problems.append("healthz reports no warm bucket")
        if "oldest-inflight-s" not in health:
            problems.append("healthz lost the oldest-inflight-s field")
        _, metrics_text = _get_text(port, "/metrics")
        if ' # {trace_id="' not in metrics_text:
            problems.append("no OpenMetrics exemplar on any /metrics "
                            "histogram bucket")
        # 3b. the streaming leg: a 10k-op stream built on the SAME real
        # localkv history (extended with a sequential write/read tail on
        # a fresh process, which keeps the combined single-register
        # history valid) goes in as CRC'd sequenced chunks, and the
        # online checker's verdict must equal the offline verdict over
        # the same ops (doc/serve.md, "Streaming API")
        from jepsen_tpu_torch import stream as stream_ns
        stream_ops = list(history)
        t_next = 1 + max((op.get("time") or 0) for op in history)
        i_next = len(history)
        proc = 1 + max((op.get("process") or 0) for op in history
                       if isinstance(op.get("process"), int))
        value = 1_000_000
        while len(stream_ops) < STREAM_OPS:
            for f, val, typ in (("write", value, "invoke"),
                                ("write", value, "ok"),
                                ("read", None, "invoke"),
                                ("read", value, "ok")):
                stream_ops.append({"type": typ, "f": f, "value": val,
                                   "process": proc, "time": t_next,
                                   "index": i_next})
                t_next += 1
                i_next += 1
            value += 1
        chunks = [stream_ops[i:i + 500]
                  for i in range(0, len(stream_ops), 500)]
        code, body, _ = _post(port, "/stream",
                              {"tenant": "gate-stream",
                               "model": "cas-register"})
        if code != 202:
            problems.append(f"POST /stream answered {code}: {body}")
        else:
            sid = body["id"]
            seq = 0
            deadline = time.time() + budget
            while seq < len(chunks) and time.time() < deadline:
                code, body, _ = _post(
                    port, f"/stream/{sid}/ops",
                    {"seq": seq, "ops": chunks[seq],
                     "crc": stream_ns.chunk_crc(chunks[seq])})
                if code == 202:
                    seq += 1
                elif code == 429:
                    time.sleep(float(body.get("retry-after-s", 0.2)))
                elif code == 409 and "need" in body:
                    seq = int(body["need"])
                else:
                    problems.append(f"stream chunk {seq} answered "
                                    f"{code}: {body}")
                    break
            code, body, _ = _post(port, f"/stream/{sid}/close",
                                  {"chunks": len(chunks)})
            if code != 200:
                problems.append(f"stream close answered {code}: {body}")
            sdoc = {}
            deadline = time.time() + budget
            while time.time() < deadline:
                _, sdoc = _get(port, f"/stream/{sid}")
                if sdoc.get("state") == "done" and "result" in sdoc:
                    break
                time.sleep(0.1)
            if sdoc.get("state") != "done" or "result" not in sdoc:
                problems.append(f"stream never finished: state="
                                f"{sdoc.get('state')!r}")
            else:
                from jepsen_tpu_torch.checker import check_safe
                from jepsen_tpu_torch.checker.wgl import linearizable
                from jepsen_tpu_torch.history import History
                from jepsen_tpu_torch.models import CASRegister
                offline_stream = check_safe(
                    linearizable(CASRegister(), device=dev),
                    {"name": "serve-gate-stream-offline"},
                    History.of(stream_ops))
                got = sdoc["result"].get("valid")
                if got is not True:
                    problems.append(f"streamed verdict {got!r}, "
                                    f"want True")
                if got != offline_stream.get("valid"):
                    problems.append(
                        f"streamed verdict {got!r} != offline "
                        f"{offline_stream.get('valid')!r} over the "
                        f"same {len(stream_ops)} ops")
                _, health = _get(port, "/healthz")
                sm = health.get("streams") or {}
                if not sm.get("sessions"):
                    problems.append(
                        f"healthz reports no stream session: {sm}")
                print(f"# serve-gate: streamed {len(stream_ops)} ops "
                      f"in {len(chunks)} chunk(s), verdict matches "
                      f"offline")
        code, drained, _ = _post(port, "/drain", None)
        if code != 200 or not drained.get("drained"):
            problems.append(f"drain answered {code}: {drained}")
        if not daemon.drained.wait(timeout=5):
            problems.append("drain did not release the daemon")
    finally:
        server.shutdown()
        daemon.stop()

    # 4. the fleet leg: a second daemon with 2 REAL ProcHost workers;
    # a saturating multi-tenant burst (more requests than hosts) must
    # land every verdict, and healthz must show both hosts live
    from jepsen_tpu_torch.checker import check_safe
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.testing import simulate_register_history
    # a SEEDED history for the burst: the local-kv draw above is
    # timing-random, and an unlucky draw escalates the gang to a wide
    # rung; the fleet leg gates dispatch and federation, not escalation,
    # so its shape must be deterministic
    fleet_hist = [op.to_dict() for op in
                  simulate_register_history(300, n_procs=4, n_vals=3,
                                            seed=7)]
    offline_valid = check_safe(
        linearizable(CASRegister(), device=dev),
        {"name": "serve-gate-fleet-offline"},
        History.of(fleet_hist)).get("valid")
    # short telemetry cadences so the federation leg below sees both
    # workers' frames folded well inside the gate budget
    os.environ.setdefault("JTPU_FED_CADENCE", "0.25")
    fcfg = serve_ns.ServeConfig(root=os.path.join(root, "serve-fleet"),
                                backend="gpu", device=dev,
                                batch_wait_ms=250.0,
                                fleet_hosts=2, fleet_backend="proc",
                                tsdb_cadence_s=0.5)
    fdaemon, fserver = serve_ns.run_daemon(
        fcfg, host="127.0.0.1", port=0, store_root=root)
    fport = fserver.server_port
    try:
        if fdaemon.placer is None:
            problems.append("fleet daemon built no placer")
        fburst = []
        for i in range(6):
            code, body, _ = _post(fport, "/check",
                                  {"tenant": f"fleet-{i % 3}",
                                   "model": "cas-register",
                                   "history": fleet_hist})
            if code == 202:
                fburst.append(body["id"])
            else:
                problems.append(f"fleet POST {i} answered {code}: "
                                f"{body}")
        deadline = time.time() + budget
        pending = list(fburst)
        while time.time() < deadline and pending:
            pending = [r for r in pending
                       if _get(fport, f"/check/{r}")[1].get("state")
                       != "done"]
            time.sleep(0.05)
        if pending:
            problems.append(f"{len(pending)} fleet request(s) never "
                            f"finished")
        for r in fburst:
            if r in pending:
                continue
            _, doc = _get(fport, f"/check/{r}")
            got = doc.get("result", {}).get("valid")
            if got != offline_valid:
                problems.append(f"fleet verdict {got!r} != offline "
                                f"{offline_valid!r}")
        _, fhealth = _get(fport, "/healthz")
        fl = fhealth.get("fleet", {})
        if fl.get("live") != 2 or fl.get("hosts") != 2:
            problems.append(f"healthz fleet {fl}, want 2/2 proc hosts")
        if not fl.get("gangs"):
            problems.append(f"fleet dispatched no gang: {fl}")
        # 4b. the telemetry leg: after the saturating burst, the usage
        # meter's live totals must equal a fold over the WAL's done
        # records (doc/observability.md, "Usage metering"), and /slo
        # must answer every declared objective with a finite burn rate
        from jepsen_tpu_torch.obs import usage as usage_ns
        code, usage_doc = _get(fport, "/usage")
        if code != 200:
            problems.append(f"GET /usage answered {code}")
        else:
            wal_totals = usage_ns.from_wal(
                os.path.join(fcfg.root, serve_ns.WAL_NAME))
            if usage_doc != wal_totals:
                problems.append(
                    f"live usage {usage_doc} != WAL fold {wal_totals}")
            tenants = usage_doc.get("tenants", {})
            if len(tenants) < 3:
                problems.append(
                    f"usage meter saw {sorted(tenants)}, want the 3 "
                    f"burst tenants")
        code, slo_doc = _get(fport, "/slo")
        if code != 200:
            problems.append(f"GET /slo answered {code}")
        else:
            objectives = slo_doc.get("objectives", {})
            if not objectives:
                problems.append(f"/slo declares no objectives: "
                                f"{slo_doc}")
            for name, obj in objectives.items():
                windows = obj.get("windows") or {}
                if not windows:
                    problems.append(f"objective {name} answers no "
                                    f"windows: {obj}")
                for win, burn in windows.items():
                    if not (isinstance(burn, (int, float))
                            and burn == burn
                            and abs(burn) != float("inf")):
                        problems.append(
                            f"objective {name} window {win} burn "
                            f"{burn!r} is not finite")
        # 4c. the federation leg: both ProcHost workers export
        # telemetry frames; the daemon's federator must fold them into
        # the ONE tsdb under per-host labels, and trace search must
        # resolve a burst request by tenant across the mesh
        # (doc/observability.md, "Fleet federation")
        if fdaemon.federator is None:
            problems.append("fleet daemon built no federator")
        else:
            want_hosts = {"fleet-host-0", "fleet-host-1"}
            deadline = time.time() + budget
            labeled = set()
            while time.time() < deadline:
                labeled = set()
                series = fdaemon.tsdb.recent(600.0).get("series", {})
                for doc in series.values():
                    for sk in doc:
                        for h in want_hosts:
                            if f'host="{h}"' in sk:
                                labeled.add(h)
                if want_hosts <= labeled:
                    break
                time.sleep(0.1)
            fed_hosts = set(fdaemon.federator.hosts())
            if not want_hosts <= fed_hosts:
                problems.append(
                    f"federator ingested frames from "
                    f"{sorted(fed_hosts)}, want both of "
                    f"{sorted(want_hosts)}")
            if not want_hosts <= labeled:
                problems.append(
                    f"federated tsdb holds host-labeled series for "
                    f"{sorted(labeled)}, want both of "
                    f"{sorted(want_hosts)}")
            code, tf = _get(fport,
                            "/trace/find?tenant=fleet-0&format=json")
            if code != 200:
                problems.append(f"GET /trace/find answered {code}")
            else:
                rows = tf.get("requests", [])
                ids = {r.get("id") for r in rows}
                if not ids & set(fburst):
                    problems.append(
                        f"trace find by tenant resolved "
                        f"{sorted(ids)}, none of the burst ids")
                if any(r.get("tenant") != "fleet-0" for r in rows):
                    problems.append(
                        f"trace find leaked a foreign tenant: {rows}")
        code, drained, _ = _post(fport, "/drain", None)
        if code != 200 or not drained.get("drained"):
            problems.append(f"fleet drain answered {code}: {drained}")
    finally:
        fserver.shutdown()
        fdaemon.stop()

    wall = time.time() - t0
    if wall > budget:
        problems.append(f"gate overran its {budget:.0f}s budget "
                        f"({wall:.1f}s)")
    return problems, (f"# serve-gate: {len(history)} op(s) served, "
                      f"verdict={verdict!r}, {wall:.1f}s")

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--budget", type=float, default=30.0,
                    help="wall-clock bound for the whole gate (s)")
    ap.add_argument("--time-limit", type=int, default=3,
                    help="local-kv workload seconds")
    ap.add_argument("--device", default="cuda",
                    help="the daemons' device (default cuda)")
    args = ap.parse_args(argv)
    from jepsen_tpu_torch import accel
    try:
        accel.ensure_usable("torch_serve_gate", device=args.device)
    except accel.AcceleratorUnavailable as e:
        print(f"# serve-gate: FAILED — {e}", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="jepsen-serve-gate-") as root:
        problems, line = gate(args.device, root, args.budget,
                              args.time_limit)
    if line:
        print(line)
    for p in problems:
        print(f"# serve-gate: FAILED — {p}", file=sys.stderr)
    if problems:
        return 1
    print("# serve-gate: served verdict matches the offline path; "
          "drain released the daemon")
    return 0


if __name__ == "__main__":
    sys.exit(main())
