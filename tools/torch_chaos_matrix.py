#!/usr/bin/env python
"""Chaos matrix of the PyTorch/CUDA port: sweep the injected-fault grid
through the port's resilient execution layer and print a pass/fail
matrix.

The port's copy of ``tools/chaos_matrix.py``: the same 22 scenarios by
the same names, the same table and exit code, over ``jepsen_tpu_torch``
on ``--device`` (default ``cuda``, probed first: no CUDA is exit 2;
every child process, kvnode daemons aside, runs there too). Its use is
the reference's: to qualify a new accelerator image before trusting it
with long runs.

  oom              RESOURCE_EXHAUSTED mid-search: pool halves (with
                   backoff) and the verdict still matches the oracle
  wedge            a wedged device segment: the check ends UNKNOWN with
                   its checkpoint (the port has no quiet move to the
                   CPU), and that checkpoint resumed with device="cpu"
                   gives the uninterrupted verdict and levels
  kill-mid-segment a fatal exception after N segments: the saved
                   checkpoint resumes to the identical verdict
  transient        flaky RPC errors: jittered retries, then success
  hung-client      a client.invoke that never returns: op-timeout turns
                   it into :info and the run completes
  kill9-recover    SIGKILL a real local-kv run mid-workload: `recover`
                   rebuilds the history from the write-ahead journal
                   and the offline checker renders a verdict
  malformed-history  corrupt a real local-kv history three ways
                   (dangling invoke, process reuse, bad op type): the
                   pre-search lint gate rejects each with the right
                   rule id BEFORE any device state or kernel launch;
                   the clean history still checks valid
  trace-integrity  SIGKILL a TRACED local-kv run mid-workload: the
                   streamed trace.jsonl survives (tail-tolerant read),
                   and `recover` prints a `# trace:` span-count summary
  watched-kill     SIGKILL a WATCHED local-kv run mid-workload: /live
                   still answers (state dead, no 500), `watch` degrades
                   to a status line, and recovery renders a verdict
  explain-kill     SIGKILL a local-kv run, then tear its
                   searchstats.json: `recover`, `explain` and the web
                   /explain page all still answer
  prof-kill        SIGKILL a --profile (JTPU_PROF=1) local-kv run while
                   the profiler is mid-capture: the partial capture
                   reads tail-tolerantly, `recover` renders a verdict,
                   and `trace export` degrades to valid Chrome JSON
  plan-rejects     a real local-kv history at an oversized capacity
                   (tiny JTPU_PLAN_BYTES_LIMIT) and on a 3-shard pool
                   mesh: the plan gate rejects each with PLAN-OOM /
                   PLAN-SHARD-INDIVISIBLE BEFORE any device state or
                   kernel launch; the clean configuration checks valid
  fleet-host-kill  SIGKILL one of two ProcHost workers of an elastic
                   fleet search mid-rung: remesh-to-1-hosts, and the
                   verdict matches the single host and the oracle
  straggler-host   slow ONE of two workers (JTPU_CHAOS_SLOW_HOST): the
                   straggler observatory flags exactly it within 3 of
                   its rounds, the flag forces a steal-rebalance, and
                   `trace find --host` attributes a served burst to it
  serve-kill       SIGKILL the check daemon with one request in flight
                   and one queued: the restarted daemon replays its
                   journal and both verdicts equal the offline path's
  trace-request-kill  SIGKILL the daemon mid-check on a request with an
                   inbound traceparent: the replay keeps the ORIGINAL
                   trace id and the stitched waterfall renders
  serve-batch-poison  a 4-request gang with ONE poison member OOMing
                   every gang holding it (gpu._GANG_FAULT): bisection
                   isolates it, 3 survivors answer 200 offline-equal,
                   the poison 500 (oom), the breaker counts 1 failure
  serve-fleet-host-kill  a burst through a fleet-backed daemon with one
                   ProcHost worker SIGKILLed mid-gang: zero lost
                   verdicts, zero poison, zero breaker failures
  stream-kill      SIGKILL the daemon mid-stream after a checkpoint:
                   the restart resumes above level 0 to the offline
                   verdict
  stream-dup       a duplicate / out-of-order chunk storm: history.json
                   byte-identical to a clean session's, verdict offline
  flightrec-kill   SIGKILL the daemon after a poison tripped a breaker:
                   the breaker-trip dump survives whole with the
                   poison's trace id and renders via `flightrec`
  lint-seeded-race patch an off-lock queue append into a COPY of the
                   port's serve.py: the lockset pass fires
                   LOCK-UNGUARDED on exactly the seeded method

Usage: python tools/torch_chaos_matrix.py [--seed N] [--only NAME ...]
           [--device cuda|cpu]
Exit code 0 iff every selected scenario passes.
"""

import argparse
import contextlib
import glob
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

os.environ.setdefault("JEPSEN_RETRY_BASE", "0.001")

from jepsen_tpu_torch import accel, resilience  # noqa: E402
from jepsen_tpu_torch.checker.wgl import check_packed  # noqa: E402
from jepsen_tpu_torch.models import CASRegister  # noqa: E402
from jepsen_tpu_torch.ops.encode import pack_with_init  # noqa: E402
from jepsen_tpu_torch.resilience import (  # noqa: E402
    RetryPolicy, WedgeError, supervised_check_packed)
from jepsen_tpu_torch.testing import simulate_register_history  # noqa: E402

#: how long a scenario waits on a child process before it gives up on
#: it; the child is killed in the scenario's ``finally`` either way
CHILD_WAIT_S = 90.0
#: how long a scenario polls a daemon for its verdicts
VERDICT_WAIT_S = 120.0


def _packed(seed):
    h = simulate_register_history(150, n_procs=5, n_vals=4, seed=seed,
                                  crash_p=0.02)
    return pack_with_init(h, CASRegister())


def _policy():
    return RetryPolicy(backoff_base_s=0.001, backoff_cap_s=0.01)


# ---------------------------------------------------------------------------
# Child processes, the command line and HTTP
# ---------------------------------------------------------------------------


def _start_child(src, **env):
    """``python -c src`` with ``env`` added to this process's; its output
    discarded."""
    return subprocess.Popen([sys.executable, "-c", src],
                            env=dict(os.environ, **env),
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def _reap(proc):
    """Kill ``proc`` if it still runs, and wait for it."""
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=30)


def _localkv_child(run_dir, ports_file, device, time_limit=60):
    """A child that runs a real local-kv test (its checks on ``device``)
    into ``run_dir``, after writing its kvnode ports to ``ports_file``."""
    return (
        "import json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from jepsen_tpu_torch import core\n"
        "from jepsen_tpu_torch.suites.localkv import localkv_test\n"
        f"test = localkv_test({{'time-limit': {time_limit}, "
        f"'nemesis-period': 3, 'device': {device!r}}})\n"
        f"test['store-dir'] = {run_dir!r}\n"
        f"json.dump(test['localkv-ports'], open({ports_file!r}, 'w'))\n"
        "core.run(test)\n")


def _daemon_child(serve_dir, root, port_file, device, prelude="",
                  cfg=""):
    """A child that runs the check daemon on ``device`` over
    ``serve_dir``, publishes its port in ``port_file`` and waits for a
    drain; ``prelude`` runs first, ``cfg`` adds ServeConfig arguments."""
    return (
        "import json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from jepsen_tpu_torch import serve as S\n"
        + prelude +
        f"cfg = S.ServeConfig(root={serve_dir!r}, backend='gpu', "
        f"device={device!r}, workers=1{cfg})\n"
        f"d, srv = S.run_daemon(cfg, host='127.0.0.1', port=0, "
        f"store_root={root!r})\n"
        f"json.dump({{'port': srv.server_port}}, "
        f"open({port_file!r}, 'w'))\n"
        "d.drained.wait()\n")


def _wait_wal(proc, wal, want, deadline, trace_path=None, spans=0):
    """Wait until ``wal`` holds ``want`` lines (and ``trace_path``
    ``spans``): None, or why not."""
    lines = got = 0
    while time.time() < deadline:
        if os.path.exists(wal) and (trace_path is None
                                    or os.path.exists(trace_path)):
            with open(wal, "rb") as f:
                lines = sum(1 for _ in f)
            if trace_path is not None:
                with open(trace_path, "rb") as f:
                    got = sum(1 for _ in f)
            if lines >= want and got >= spans:
                return None
        if proc.poll() is not None:
            return (f"child exited rc={proc.returncode} before the kill "
                    f"(wal lines={lines}"
                    + (f", spans={got}" if trace_path else "") + ")")
        time.sleep(0.2)
    if trace_path is not None:
        return (f"workload never produced enough telemetry "
                f"(wal={lines}, spans={got})")
    return f"workload never reached {want} WAL ops ({lines})"


def _wait_port(proc, port_file, deadline):
    """The port a daemon child published, or (None, why not)."""
    while time.time() < deadline:
        if os.path.exists(port_file):
            try:
                with open(port_file) as f:
                    return json.load(f)["port"], None
            except (OSError, ValueError):
                pass
        if proc.poll() is not None:
            return None, f"daemon exited rc={proc.returncode} at boot"
        time.sleep(0.1)
    return None, "daemon never published its port"


def _kill_kvnodes(ports):
    """Reap kvnode daemons a SIGKILLed run never tore down: match this
    run's ports in /proc cmdlines, CONT (a paused daemon ignores KILL
    delivery ordering otherwise) then KILL."""
    pats = [f"--port {p}" for p in ports]
    for pid_dir in glob.glob("/proc/[0-9]*"):
        try:
            with open(os.path.join(pid_dir, "cmdline"), "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode()
        except OSError:
            continue
        if "kvnode.py" in cmd and any(p in cmd for p in pats):
            pid = int(os.path.basename(pid_dir))
            for sig in (signal.SIGCONT, signal.SIGKILL):
                try:
                    os.kill(pid, sig)
                except OSError:
                    pass


def _kill_run(proc, ports_file):
    """Reap a local-kv child and the kvnode daemons it left."""
    _reap(proc)
    try:
        with open(ports_file) as f:
            _kill_kvnodes(json.load(f))
    except (OSError, ValueError):
        pass


def _cli(argv):
    """``python -m jepsen_tpu_torch ARGV`` in this process: (rc,
    stdout)."""
    from jepsen_tpu_torch import __main__ as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _post(port, path, doc, headers=None):
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(doc).encode(),
        method="POST", headers=headers or {})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.load(r)


def _get(port, path):
    """(status, JSON body) of a GET, an HTTP error's included."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _poll_done(port, rids, timeout=VERDICT_WAIT_S):
    """{rid: (status, doc)} of the requests done within ``timeout``."""
    deadline = time.time() + timeout
    docs = {}
    while time.time() < deadline and len(docs) < len(rids):
        for rid in rids:
            if rid not in docs:
                code, doc = _get(port, f"/check/{rid}")
                if doc.get("state") == "done":
                    docs[rid] = (code, doc)
        time.sleep(0.05)
    return docs


def _offline(ops, device, name):
    """The offline analyze path's result for one op list."""
    from jepsen_tpu_torch.checker import check_safe
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.history import History
    return check_safe(linearizable(CASRegister(), device=device),
                      {"name": name}, History.of(ops))


def _daemon_http(daemon, root):
    """An HTTP server over an in-process daemon; its port."""
    from jepsen_tpu_torch import serve as serve_ns
    from jepsen_tpu_torch import web
    server = web.serve(host="127.0.0.1", port=0, root=root,
                       handler_cls=serve_ns.make_handler(daemon, root=root))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _launch_counts():
    """Every kernel launch counter of the port, summed."""
    from jepsen_tpu_torch.kernels import search as K
    return (sum(K.launches.values()) + sum(K.grid_launches_total.values())
            + K.segments["launches"])


@contextlib.contextmanager
def _no_device_state(record):
    """Any device state for a search (the engine's carry, scratch or
    columns) raises inside this block, and is recorded in ``record``."""
    from jepsen_tpu_torch.checker import engine as engine_mod
    real = (engine_mod.Engine.state, engine_mod.Engine.cols)

    def traced(name):
        def f(*a, **k):
            record.append(name)
            raise AssertionError(f"Engine.{name} called for a rejected "
                                 f"history")
        return f

    engine_mod.Engine.state = traced("state")
    engine_mod.Engine.cols = traced("cols")
    try:
        yield
    finally:
        engine_mod.Engine.state, engine_mod.Engine.cols = real


def _poison_histories(seed):
    """Three survivors and a poison that shares their shape bucket but
    not their packed row count (the fault seam tells them apart by it):
    (survivor op lists, poison ops, poison n); poison None where no seed
    gives one."""
    from jepsen_tpu_torch.history import History
    surv_ops = [[o.to_dict() for o in
                 simulate_register_history(40, n_procs=3, n_vals=3,
                                           seed=seed + i)]
                for i in range(3)]
    surv_ns = {pack_with_init(History.of(o), CASRegister())[0].n
               for o in surv_ops}
    for s in range(seed + 9, seed + 29):
        ops = [o.to_dict() for o in
               simulate_register_history(48, n_procs=3, n_vals=3, seed=s)]
        n = pack_with_init(History.of(ops), CASRegister())[0].n
        if n not in surv_ns:
            return surv_ops, ops, n
    return surv_ops, None, None


def _localkv_history(device, seconds=6):
    """A real local-kv run's test map (store disabled)."""
    from jepsen_tpu_torch import core
    from jepsen_tpu_torch.suites.localkv import localkv_test
    test = localkv_test({"time-limit": seconds, "nemesis-period": 2,
                         "device": device})
    test["store-dir"] = None
    return core.run(test)


# ---------------------------------------------------------------------------
# The supervisor's faults
# ---------------------------------------------------------------------------


def scenario_oom(seed, device="cuda"):
    p, kernel = _packed(seed)
    oracle = check_packed(p, kernel)["valid"]
    fired = []

    def oom_twice(ctx):
        if ctx["segment"] == 1 and len(fired) < 2:
            fired.append(1)
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

    resilience._inject_fault = oom_twice
    try:
        r = supervised_check_packed(p, kernel, capacity=256, expand=16,
                                    segment_iters=8, policy=_policy(),
                                    device=device)
    finally:
        resilience._inject_fault = None
    ok = (r["valid"] == oracle and r["rung"][0] == 64
          and len(fired) == 2)
    return ok, (f"verdict {r['valid']} (oracle {oracle}), pool "
                f"256->{r['rung'][0]}, {len(fired)} OOMs injected")


def scenario_wedge(seed, device="cuda"):
    """A wedged segment. The reference completes the check on its CPU
    fallback (``backend-fallback == "cpu"``); the port has no quiet move
    to the CPU, so its contract is the one checked here: the wedged check
    ends UNKNOWN with its ``checkpoint`` and no ``backend-fallback`` key,
    and that checkpoint resumed with ``device="cpu"`` gives the
    uninterrupted check's ``valid`` and ``levels``."""
    p, kernel = _packed(seed)
    kw = dict(capacity=128, expand=8, segment_iters=8)
    base = supervised_check_packed(p, kernel, device=device, **kw)
    wedged = []

    def wedge_once(ctx):
        if ctx["segment"] == 2 and not wedged:
            wedged.append(1)
            raise WedgeError("injected wedge")

    resilience._inject_fault = wedge_once
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = supervised_check_packed(p, kernel, device=device,
                                        deadline_s=30, **kw)
    finally:
        resilience._inject_fault = None
    try:
        cp = r.get("checkpoint")
        if r["valid"] != "unknown" or cp is None:
            return False, (f"wedged check answered {r['valid']!r} with "
                           f"checkpoint {cp!r}, want UNKNOWN with one")
        if "backend-fallback" in r:
            return False, (f"wedged check moved to "
                           f"{r['backend-fallback']!r} by itself")
        resumed = supervised_check_packed(p, kernel, device="cpu",
                                          resume=cp, **kw)
    finally:
        accel._reset_for_tests()
    ok = (resumed["valid"] == base["valid"]
          and resumed["levels"] == base["levels"]
          and "backend-fallback" not in resumed)
    return ok, (f"wedged at segment {cp.segment} -> UNKNOWN with its "
                f"checkpoint; resumed on cpu: verdict {resumed['valid']} "
                f"levels {resumed['levels']} (uninterrupted "
                f"{base['levels']})")


def scenario_kill_mid_segment(seed, device="cuda"):
    p, kernel = _packed(seed)
    base = supervised_check_packed(p, kernel, capacity=128, expand=8,
                                   segment_iters=8, device=device)
    cps = []

    def killer(ctx):
        if ctx["segment"] == 3:
            raise ValueError("chaos kill")

    resilience._inject_fault = killer
    try:
        try:
            supervised_check_packed(
                p, kernel, capacity=128, expand=8, segment_iters=8,
                policy=RetryPolicy(max_retries=0, backoff_base_s=0.001),
                on_checkpoint=cps.append, device=device)
            return False, "kill never fired"
        except ValueError:
            pass
    finally:
        resilience._inject_fault = None
    if not cps:
        return False, "no checkpoints before the kill"
    r = supervised_check_packed(p, kernel, capacity=128, expand=8,
                                segment_iters=8, resume=cps[-1],
                                device=device)
    ok = (r["valid"] == base["valid"] and r["levels"] == base["levels"])
    return ok, (f"resumed from segment {cps[-1].segment} -> verdict "
                f"{r['valid']} levels {r['levels']} "
                f"(uninterrupted {base['levels']})")


def scenario_transient(seed, device="cuda"):
    p, kernel = _packed(seed)
    base = supervised_check_packed(p, kernel, capacity=64, expand=8,
                                   segment_iters=8, device=device)
    flakes = []

    def flaky(ctx):
        if ctx["segment"] == 1 and len(flakes) < 2:
            flakes.append(1)
            raise ConnectionResetError("flaky rpc")

    resilience._inject_fault = flaky
    try:
        r = supervised_check_packed(p, kernel, capacity=64, expand=8,
                                    segment_iters=8, policy=_policy(),
                                    device=device)
    finally:
        resilience._inject_fault = None
    retries = [a for a in r["attempts"] if a.get("event") == "transient"]
    ok = r["valid"] == base["valid"] and len(retries) == 2
    return ok, f"verdict {r['valid']}, {len(retries)} jittered retries"


def scenario_hung_client(seed, device="cuda"):
    from jepsen_tpu_torch import core
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.testing import (AtomClient, SharedRegister,
                                          atom_test)

    lock = threading.Lock()
    state = {"n": 0, "hung": 0}

    class HangingClient(AtomClient):
        def open(self, test, node):
            return HangingClient(self.register)

        def invoke(self, test, op):
            with lock:
                state["n"] += 1
                me = state["n"]
            if me == 3 and not state["hung"]:
                state["hung"] = 1
                threading.Event().wait(60)
            return super().invoke(test, op)

    reg = SharedRegister()
    t = atom_test(reg)
    t["client"] = HangingClient(reg)
    t["op-timeout"] = 0.3
    t["store-dir"] = None
    t["generator"] = gen.clients(
        gen.stagger(0.01, gen.limit(80, gen.cas_gen())))
    t0 = time.time()
    t = core.run(t)
    wall = time.time() - t0
    infos = [o for o in t["history"]
             if o.is_info and o.process != "nemesis"
             and o.error and "OpTimeout" in str(o.error)]
    ok = bool(infos) and state["hung"] == 1 and wall < 30
    return ok, (f"run completed in {wall:.1f}s with "
                f"{len(infos)} op-timeout info op(s)")


# ---------------------------------------------------------------------------
# Killed runs
# ---------------------------------------------------------------------------


def scenario_kill9_recover(seed, device="cuda"):
    """SIGKILL a REAL local-kv run mid-workload; assert `recover` turns
    its write-ahead journal into a checkable history + verdict."""
    import tempfile

    from jepsen_tpu_torch import store

    root = tempfile.mkdtemp(prefix="jepsen-chaos-kill9-")
    run_dir = os.path.join(root, "local-kv", "run")
    ports_file = os.path.join(root, "ports.json")
    proc = _start_child(_localkv_child(run_dir, ports_file, device))
    try:
        # wait for the workload phase: the WAL grows as ops land
        why = _wait_wal(proc, os.path.join(run_dir, "history.wal"), 40,
                        time.time() + CHILD_WAIT_S)
        if why:
            return False, why
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    finally:
        _kill_run(proc, ports_file)

    if store.run_status(run_dir) != "dead" or \
            run_dir not in store.dead_runs(root):
        return False, (f"dead-run scan missed the killed run "
                       f"(status={store.run_status(run_dir)!r})")
    rc, out = _cli(["recover", "--store-root", root, "--device", device])
    out = out.strip()
    if "# recovery:" not in out:
        return False, f"no '# recovery:' summary in output: {out!r}"
    results = os.path.join(run_dir, "results.json")
    if not os.path.exists(results):
        return False, "recover wrote no results.json"
    with open(results) as f:
        valid = json.load(f).get("valid")
    # safe-mode local-kv is linearizable by construction: the recovered
    # partial history must check valid, and recover must exit 0
    ok = rc == 0 and valid is True and \
        store.run_status(run_dir) == "recovered"
    summary = [ln for ln in out.splitlines()
               if ln.startswith("# recovery:")][0]
    return ok, (f"rc={rc} valid={valid} "
                f"status={store.run_status(run_dir)}; {summary}")


def scenario_malformed_history(seed, device="cuda"):
    """Corrupt a REAL local-kv history (dangling invoke, process reuse,
    bad op type); assert the pre-search lint gate rejects each with the
    right rule id before any device state is made or kernel launched."""
    from jepsen_tpu_torch.analysis.history_lint import MalformedHistoryError
    from jepsen_tpu_torch.checker import gpu
    from jepsen_tpu_torch.history import History

    test = _localkv_history(device)
    h = test["history"]
    if test["results"].get("valid") is not True:
        return False, (f"clean local-kv run should validate, got "
                       f"{test['results'].get('valid')}")

    def corrupt_dangling(ops):
        """Drop an ok completion whose process later invokes a
        DIFFERENT op: the abandoned invoke is dangling mid-stream. (An
        identical next invoke would read as process reuse, the next
        corruption's job.)"""
        for i, o in enumerate(ops):
            if o.type != "ok":
                continue
            nxt = next((p for p in ops[i + 1:]
                        if p.process == o.process
                        and p.type == "invoke"), None)
            if nxt is not None and nxt.f != o.f:
                return History.of(ops[:i] + ops[i + 1:])
        return None

    def corrupt_reuse(ops):
        """Duplicate an invoke in place: the process is reused before
        its open op completes."""
        for i, o in enumerate(ops):
            if o.type == "invoke":
                dup = o.replace(index=-1)
                return History.of(ops[:i + 1] + [dup] + ops[i + 1:])
        return None

    def corrupt_type(ops):
        """Flip one completion's type to a value outside the op
        algebra."""
        for i, o in enumerate(ops):
            if o.type == "ok":
                return History.of(
                    ops[:i] + [o.replace(type="okk")] + ops[i + 1:])
        return None

    corruptions = (("dangling invoke", corrupt_dangling,
                    "HIST-DANGLING-INVOKE"),
                   ("process reuse", corrupt_reuse, "HIST-PROC-REUSE"),
                   ("bad op type", corrupt_type, "HIST-OP-TYPE"))

    made, details, ok = [], [], True
    before = _launch_counts()
    with _no_device_state(made):
        for label, fn, want_rule in corruptions:
            bad = fn(list(h))
            if bad is None:
                ok = False
                details.append(f"{label}: no corruptible op found")
                continue
            try:
                gpu.check_history_gpu(bad, test["model"], device=device)
                ok = False
                details.append(f"{label}: NOT rejected")
            except MalformedHistoryError as e:
                if want_rule in str(e):
                    details.append(f"{label}->{want_rule}")
                else:
                    ok = False
                    details.append(f"{label}: wrong rule in {e}")
    if made or _launch_counts() != before:
        ok = False
        details.append(f"device state made: {made}, launches "
                       f"{_launch_counts() - before}")
    return ok, ("gate rejected " + ", ".join(details)
                + f"; clean run valid over {len(h)} ops")


def scenario_trace_integrity(seed, device="cuda"):
    """SIGKILL a TRACED local-kv run mid-workload; assert the streamed
    span trace survives the crash: trace.jsonl reads tail-tolerantly (at
    most the in-flight line is torn), and `recover` emits a `# trace:`
    span-count summary next to `# lint:`/`# recovery:`."""
    import tempfile

    from jepsen_tpu_torch.obs import trace as trace_ns

    root = tempfile.mkdtemp(prefix="jepsen-chaos-traceint-")
    run_dir = os.path.join(root, "local-kv", "run")
    ports_file = os.path.join(root, "ports.json")
    proc = _start_child(_localkv_child(run_dir, ports_file, device),
                        JTPU_TRACE="1")
    trace_path = os.path.join(run_dir, trace_ns.TRACE_NAME)
    try:
        # a mid-workload state: ops in the WAL AND spans in the trace
        why = _wait_wal(proc, os.path.join(run_dir, "history.wal"), 40,
                        time.time() + CHILD_WAIT_S, trace_path, 10)
        if why:
            return False, why
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    finally:
        _kill_run(proc, ports_file)

    # tail-tolerant read of the crashed run's trace: must not raise,
    # and at most one torn line (the span in flight at the kill)
    records, stats = trace_ns.read_trace(trace_path)
    if not records or stats["corrupt"] or stats["torn"] > 1:
        return False, f"trace read after SIGKILL: {stats}"
    rc, out = _cli(["recover", "--store-root", root, "--no-analyze",
                    "--device", device])
    trace_lines = [ln for ln in out.splitlines()
                   if ln.startswith("# trace:")]
    ok = (rc == 0 and "# recovery:" in out and "# lint:" in out
          and bool(trace_lines)
          and f"{stats['spans']} span(s)" in trace_lines[0])
    return ok, (f"rc={rc} {stats['spans']} span(s) "
                f"({stats['torn']} torn) survived the SIGKILL; "
                f"recover said: {trace_lines[:1]!r}")


def scenario_watched_kill(seed, device="cuda"):
    """SIGKILL a WATCHED local-kv run mid-workload; assert the live
    observability surfaces survive the crash: `/live/<test>/<ts>` answers
    with the dead run's state (never a 500), `watch` renders a status
    line, and `recover` still turns the WAL into a verdict."""
    import tempfile

    from jepsen_tpu_torch import store, web

    root = tempfile.mkdtemp(prefix="jepsen-chaos-watched-")
    run_dir = os.path.join(root, "local-kv", "run")
    ports_file = os.path.join(root, "ports.json")
    proc = _start_child(_localkv_child(run_dir, ports_file, device),
                        JTPU_TRACE="1")
    try:
        why = _wait_wal(proc, os.path.join(run_dir, "history.wal"), 40,
                        time.time() + CHILD_WAIT_S)
        if why:
            return False, why
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    finally:
        _kill_run(proc, ports_file)

    if store.run_status(run_dir) != "dead":
        return False, (f"killed run not detected as dead "
                       f"(status={store.run_status(run_dir)!r})")
    # the live endpoint on the dead run answers JSON, never a 500 (the
    # kill landed mid-workload, before any search segment: progress is
    # legitimately absent)
    server = web.serve_background(root=root)
    try:
        code, doc = _get(server.server_port, "/live/local-kv/run")
        live_ok = code == 200 and doc.get("state") == "dead" \
            and "progress" in doc
    except Exception as e:  # noqa: BLE001 — an erroring endpoint fails
        return False, f"/live endpoint died on the killed run: {e!r}"
    finally:
        server.shutdown()
    # watch on the dead run: one graceful line, exit 0
    watch_rc, watch_out = _cli(["watch", "--store", run_dir, "--once"])
    # and the run still recovers to a verdict, exactly like kill9
    rc, out = _cli(["recover", "--store-root", root, "--device", device])
    recovered = (rc == 0 and "# recovery:" in out
                 and store.run_status(run_dir) == "recovered")
    ok = live_ok and watch_rc == 0 and "# watch:" in watch_out \
        and recovered
    return ok, (f"/live answered state=dead progress="
                f"{doc.get('progress') is not None}; watch rc="
                f"{watch_rc}; recover rc={rc} "
                f"status={store.run_status(run_dir)}")


def scenario_explain_kill(seed, device="cuda"):
    """SIGKILL a local-kv run mid-search; assert the verdict-explain
    surfaces stay torn-tolerant: a partial (or absent) searchstats.json
    never breaks them: `recover` turns the WAL back into a verdict,
    `explain` renders a report from whatever survived, and the web
    `/explain/<test>/<ts>` page answers 200, never a 500."""
    import tempfile
    import urllib.request

    from jepsen_tpu_torch import store, web

    root = tempfile.mkdtemp(prefix="jepsen-chaos-explain-")
    run_dir = os.path.join(root, "local-kv", "run")
    ports_file = os.path.join(root, "ports.json")
    proc = _start_child(_localkv_child(run_dir, ports_file, device),
                        JTPU_TRACE="1")
    try:
        why = _wait_wal(proc, os.path.join(run_dir, "history.wal"), 40,
                        time.time() + CHILD_WAIT_S)
        if why:
            return False, why
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    finally:
        _kill_run(proc, ports_file)

    # the worst tear: a half-written searchstats.json
    with open(os.path.join(run_dir, "searchstats.json"), "w") as f:
        f.write('{"ts": 1, "levels": [[3, 1')
    rc, _ = _cli(["recover", "--store-root", root, "--device", device])
    if rc != 0 or store.run_status(run_dir) != "recovered":
        return False, (f"recover rc={rc} "
                       f"status={store.run_status(run_dir)!r}")
    exp_rc, exp_out = _cli(["explain", "--store", run_dir])
    if exp_rc not in (0, 1) or "# explain:" not in exp_out:
        return False, (f"explain rc={exp_rc}; "
                       f"output: {exp_out[:200]!r}")
    server = web.serve_background(root=root)
    try:
        url = (f"http://127.0.0.1:{server.server_port}"
               f"/explain/local-kv/run")
        with urllib.request.urlopen(url, timeout=10) as r:
            page_ok = r.status == 200
            page = r.read().decode()
    except Exception as e:  # noqa: BLE001 — an erroring page fails
        return False, f"/explain page died on the torn run: {e!r}"
    finally:
        server.shutdown()
    ok = page_ok and "# explain:" in page
    return ok, (f"recover rc={rc}; explain rc={exp_rc} "
                f"({len(exp_out.splitlines())} line(s)); /explain "
                f"status={'200' if page_ok else 'not 200'} with torn "
                f"searchstats.json")


def scenario_prof_kill(seed, device="cuda"):
    """SIGKILL a ``--profile`` (JTPU_PROF=1) local-kv run MID-CAPTURE;
    assert the partial capture reads tail-tolerantly (``read_profile``
    never raises), `recover` still renders a verdict from the WAL, and
    `trace export` degrades gracefully to valid Chrome JSON."""
    import tempfile

    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.obs import profiler

    root = tempfile.mkdtemp(prefix="jepsen-chaos-profkill-")
    run_dir = os.path.join(root, "local-kv", "run")
    ports_file = os.path.join(root, "ports.json")
    # one-level segments stretch the check over many segment ends, so
    # the SIGKILL lands while the profiler is recording
    proc = _start_child(_localkv_child(run_dir, ports_file, device,
                                       time_limit=8),
                        JTPU_TRACE="1", JTPU_PROF="1",
                        JTPU_SEGMENT_ITERS="1")
    prof_dir = profiler.profile_dir(run_dir)
    deadline = time.time() + CHILD_WAIT_S + 30
    try:
        # the profile dir is made when the capture starts
        while time.time() < deadline:
            if os.path.isdir(prof_dir):
                break
            if proc.poll() is not None:
                return False, (f"child exited rc={proc.returncode} "
                               f"before any capture started")
            time.sleep(0.05)
        else:
            return False, "capture never started within 120s"
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    finally:
        _kill_run(proc, ports_file)

    records, pstats = profiler.read_profile(run_dir)
    rc, out = _cli(["recover", "--store-root", root, "--device", device])
    recovered = (rc == 0 and "# recovery:" in out
                 and store.run_status(run_dir) == "recovered")
    export = os.path.join(root, "chrome.json")
    export_rc, _ = _cli(["trace", "export", "--store", run_dir,
                         "-o", export])
    export_ok = False
    if export_rc == 0 and os.path.exists(export):
        try:
            with open(export) as f:
                doc = json.load(f)
            evs = doc.get("traceEvents")
            export_ok = isinstance(evs, list) and len(evs) > 0 and \
                all("name" in e and "ph" in e for e in evs)
        except ValueError:
            export_ok = False
    ok = recovered and export_ok
    return ok, (f"capture killed mid-flight: {pstats['files']} trace "
                f"file(s), {len(records)} device record(s), "
                f"{pstats['errors']} unreadable; recover rc={rc} "
                f"status={store.run_status(run_dir)}; export "
                f"rc={export_rc} valid-chrome={export_ok}")


def scenario_plan_rejects(seed, device="cuda"):
    """Drive a REAL local-kv history into the plan gate with (1) an
    oversized explicit capacity under a tiny byte budget and (2) a pool
    mesh of 3 logical shards that divides neither capacity nor expand;
    assert each is rejected with the right PLAN-* rule id before any
    device state is made or kernel launched (the launch counters,
    ``kernels/search.grid_launches_total`` among them, do not move). The
    same history then checks valid with the oversized knobs removed."""
    from jepsen_tpu_torch import parallel
    from jepsen_tpu_torch.analysis.plan_lint import PlanRejectedError
    from jepsen_tpu_torch.checker import gpu

    test = _localkv_history(device)
    h = test["history"]
    if test["results"].get("valid") is not True:
        return False, (f"clean local-kv run should validate, got "
                       f"{test['results'].get('valid')}")

    made, details, ok = [], [], True
    before = _launch_counts()
    os.environ["JTPU_PLAN_BYTES_LIMIT"] = "200000"
    try:
        with _no_device_state(made):
            # (1) oversized capacity vs the byte budget -> PLAN-OOM
            try:
                gpu.check_history_gpu(h, test["model"], capacity=16384,
                                      window=32, device=device)
                ok = False
                details.append("oversized capacity NOT rejected")
            except PlanRejectedError as e:
                if "PLAN-OOM" in str(e):
                    details.append("capacity-16384->PLAN-OOM")
                else:
                    ok = False
                    details.append(f"capacity: wrong rule in {e}")
            # (2) a pool axis dividing neither capacity nor expand
            mesh = parallel.make_mesh(axis=parallel.POOL_AXIS,
                                      devices=[device] * 3)
            try:
                gpu.check_history_sharded(h, test["model"], mesh,
                                          capacity=128, expand=10)
                ok = False
                details.append("non-dividing mesh NOT rejected")
            except PlanRejectedError as e:
                if "PLAN-SHARD-INDIVISIBLE" in str(e):
                    details.append("mesh-3->PLAN-SHARD-INDIVISIBLE")
                else:
                    ok = False
                    details.append(f"mesh: wrong rule in {e}")
    finally:
        os.environ.pop("JTPU_PLAN_BYTES_LIMIT", None)
    if made or _launch_counts() != before:
        ok = False
        details.append(f"device state made: {made}, launches "
                       f"{_launch_counts() - before}")
    # (3) same history, sane knobs: the gate admits and the verdict
    # still renders (the gate must reject configurations, not work)
    r = gpu.check_history_gpu(h, test["model"], device=device)
    if r["valid"] is not True or "plan" not in r:
        ok = False
        details.append(f"clean config valid={r['valid']} "
                       f"plan={'plan' in r}")
    else:
        details.append(f"clean config valid via {r['plan']['selected']}")
    return ok, ("; ".join(details) + f" over {len(h)} ops")


# ---------------------------------------------------------------------------
# The fleet
# ---------------------------------------------------------------------------


def scenario_fleet_host_kill(seed, device="cuda"):
    """SIGKILL one worker of a 2-process elastic-fleet search (each host
    a real OS process running shard segments on ``device`` over a file
    protocol) mid-rung. The survivor must detect the loss, re-mesh at
    the merge barrier with a ``remesh-to-1-hosts`` trail event, and
    finish with a verdict identical to the uninterrupted single-host
    baseline and the oracle."""
    import tempfile

    from jepsen_tpu_torch import fleet

    p, kernel = _packed(seed)
    base = supervised_check_packed(p, kernel, segment_iters=4,
                                   device=device)
    oracle = check_packed(p, kernel)
    if base["valid"] != oracle["valid"]:
        return False, "single-host baseline disagrees with the oracle"
    d = tempfile.mkdtemp(prefix="jtpu-fleet-")
    hosts = [fleet.ProcHost("w0", os.path.join(d, "w0"), device=device),
             fleet.ProcHost("w1", os.path.join(d, "w1"), device=device)]
    killed = []

    def chaos(round_idx, fl):
        if round_idx == 2 and fl.hosts[1].state == "live":
            os.kill(fl.hosts[1].pid, signal.SIGKILL)
            killed.append(fl.hosts[1].pid)

    try:
        out = fleet.check_packed_fleet(p, kernel, hosts=hosts,
                                       segment_iters=2, on_round=chaos,
                                       device=device)
    finally:
        for h in hosts:
            h.stop()
    if not killed:
        return False, "search finished before the kill round"
    evs = [e.get("outcome") for e in out.get("attempts", [])]
    details = []
    ok = True
    if out.get("valid") != base["valid"]:
        ok = False
        details.append(f"verdict {out.get('valid')!r} != baseline "
                       f"{base['valid']!r}")
    else:
        details.append(f"verdict {out['valid']} == single-host "
                       f"baseline == oracle")
    if "remesh-to-1-hosts" not in evs:
        ok = False
        details.append(f"no remesh-to-1-hosts event in {evs}")
    else:
        details.append("remesh-to-1-hosts after SIGKILL")
    lost = (out.get("fleet") or {}).get("hosts-lost")
    if lost != 1:
        ok = False
        details.append(f"hosts-lost={lost}, want 1")
    return ok, "; ".join(details)


def scenario_straggler_host(seed, device="cuda"):
    """Slow ONE worker of a 2-process elastic-fleet search
    (``JTPU_CHAOS_SLOW_HOST`` stalls it before every shard segment). The
    straggler observatory must flag exactly that host within 3 merge
    rounds in which it ran a segment, the flag must force a
    ``steal-rebalance`` re-deal, and the verdict must match the
    single-host baseline and the oracle. A second leg drives a burst
    through a fleet-backed daemon with the same slowed worker: trace
    search (``trace find --host``) resolves the requests that ran on it,
    every verdict offline-identical."""
    import tempfile

    from jepsen_tpu_torch import fleet
    from jepsen_tpu_torch import serve as serve_ns
    from jepsen_tpu_torch.obs import federation as obs_federation

    p, kernel = _packed(seed)
    base = supervised_check_packed(p, kernel, segment_iters=1,
                                   device=device)
    oracle = check_packed(p, kernel)
    if base["valid"] != oracle["valid"]:
        return False, "single-host baseline disagrees with the oracle"
    details = []

    # leg 1: the elastic-fleet search: flag within 3 rounds, steal
    d = tempfile.mkdtemp(prefix="jtpu-straggler-")
    hosts = [fleet.ProcHost("w0", os.path.join(d, "w0"), device=device),
             fleet.ProcHost("w1", os.path.join(d, "w1"), device=device)]
    os.environ["JTPU_CHAOS_SLOW_HOST"] = "w1:2.0"
    try:
        out = fleet.check_packed_fleet(p, kernel, hosts=hosts,
                                       segment_iters=1, device=device)
    finally:
        os.environ.pop("JTPU_CHAOS_SLOW_HOST", None)
        for h in hosts:
            h.stop()
    if out.get("valid") != base["valid"]:
        return False, (f"verdict {out.get('valid')!r} != baseline "
                       f"{base['valid']!r}")
    details.append(f"verdict {out['valid']} == single-host baseline "
                   f"== oracle")
    evs = out.get("attempts", [])
    flags = [e for e in evs if e.get("event") == "straggler-flagged"]
    flagged_hosts = {e.get("host") for e in flags}
    if "w1" not in flagged_hosts:
        return False, (f"slowed host w1 never flagged (events "
                       f"{[e.get('event') for e in evs]})")
    if flagged_hosts != {"w1"}:
        return False, (f"flagged {sorted(flagged_hosts)}, want the "
                       f"slowed host only")
    # the 3-round budget counts rounds the straggler RAN: a shard whose
    # slice holds no live rows is not dispatched, and an idle host cannot
    # be observed; its dispatched rounds are in its own segment spans
    w1_rounds = []
    try:
        with open(os.path.join(d, "w1", "trace.jsonl"),
                  errors="replace") as f:
            for line in f:
                try:
                    sp = json.loads(line)
                except ValueError:
                    continue
                if sp.get("name") == "checker.segment" \
                        and sp.get("round") is not None:
                    w1_rounds.append(int(sp["round"]))
    except OSError:
        pass
    w1_rounds = sorted(set(w1_rounds))
    if len(w1_rounds) < 3:
        return False, (f"w1 ran only {len(w1_rounds)} segment "
                       f"round(s), too few to flag")
    first = min(e.get("round", 10 ** 9) for e in flags)
    if first > w1_rounds[2]:
        return False, (f"w1 flagged at round {first}, want by its 3rd "
                       f"dispatched segment (rounds {w1_rounds[:4]})")
    nth = w1_rounds.index(first) + 1 if first in w1_rounds else "?"
    details.append(f"w1 (and only w1) flagged at round {first}: "
                   f"dispatched segment #{nth} of its "
                   f"{len(w1_rounds)}")
    if not any(e.get("outcome") == "steal-rebalance" for e in evs):
        return False, (f"no steal-rebalance after the flag "
                       f"(events {[e.get('event') for e in evs]})")
    details.append("flag forced a steal-rebalance re-deal")

    # leg 2: the serve plane: trace search attributes the burst's
    # requests to the slowed worker, verdicts stay offline-identical
    root = tempfile.mkdtemp(prefix="jepsen-chaos-straggler-")
    all_ops = [[o.to_dict() for o in
                simulate_register_history(40, n_procs=3, n_vals=3,
                                          seed=seed + i)]
               for i in range(3)]
    offline = [_offline(o, device, "chaos-straggler-offline")
               for o in all_ops]
    os.environ["JTPU_SEGMENT_ITERS"] = "2"
    os.environ["JTPU_CHAOS_SLOW_HOST"] = "fleet-host-1:0.15"
    cfg = serve_ns.ServeConfig(root=os.path.join(root, "serve"),
                               backend="gpu", device=device, workers=1,
                               batch_max=8, batch_wait_ms=1000.0,
                               fleet_hosts=2, fleet_backend="proc")
    daemon, server = serve_ns.run_daemon(
        cfg, host="127.0.0.1", port=0, store_root=root)
    port = server.server_port
    try:
        rids = [_post(port, "/check", {"tenant": "abc"[i],
                                       "model": "cas-register",
                                       "history": o})["id"]
                for i, o in enumerate(all_ops)]
        docs = _poll_done(port, rids)
        if len(docs) != len(rids):
            return False, (f"only {len(docs)}/{len(rids)} serve "
                           f"requests finished")
        for i, rid in enumerate(rids):
            got = docs[rid][1]["result"].get("valid")
            if got != offline[i].get("valid"):
                return False, (f"served verdict {got!r} != offline "
                               f"{offline[i].get('valid')!r}")
    finally:
        os.environ.pop("JTPU_SEGMENT_ITERS", None)
        os.environ.pop("JTPU_CHAOS_SLOW_HOST", None)
        server.shutdown()
        daemon.stop()
    rows = obs_federation.trace_find(cfg.root, host="fleet-host-1")
    found = {r["id"] for r in rows}
    if not found & set(rids):
        return False, (f"trace find --host fleet-host-1 resolved "
                       f"{sorted(found)}, none of the burst")
    details.append(f"trace find attributed {len(found & set(rids))} "
                   f"burst request(s) to the slowed serve worker; "
                   f"all serve verdicts == offline")
    return True, "; ".join(details)


# ---------------------------------------------------------------------------
# The check daemon
# ---------------------------------------------------------------------------


def scenario_serve_kill(seed, device="cuda"):
    """SIGKILL the check daemon with one request IN-FLIGHT and one
    QUEUED. A restarted daemon must replay its request journal
    (serve.wal), re-run both requests, and render verdicts identical to
    the offline analyze path."""
    import tempfile

    from jepsen_tpu_torch import serve as serve_ns

    root = tempfile.mkdtemp(prefix="jepsen-chaos-servekill-")
    serve_dir = os.path.join(root, "serve")
    port_file = os.path.join(root, "port.json")
    # req1: dense enough that a cold child process is still checking it
    # when the kill lands; req2: small, stays queued behind it
    ops1 = [o.to_dict() for o in
            simulate_register_history(300, n_procs=5, n_vals=4, seed=seed)]
    ops2 = [o.to_dict() for o in
            simulate_register_history(40, n_procs=3, n_vals=3,
                                      seed=seed + 1)]
    proc = _start_child(_daemon_child(serve_dir, root, port_file, device))

    def state(port, rid):
        return _get(port, f"/check/{rid}")[1]["state"]

    try:
        deadline = time.time() + CHILD_WAIT_S
        port, why = _wait_port(proc, port_file, deadline)
        if port is None:
            return False, why
        r1 = _post(port, "/check", {"tenant": "a", "model": "cas-register",
                                    "history": ops1})
        r2 = _post(port, "/check", {"tenant": "b", "model": "cas-register",
                                    "history": ops2})
        # the exact crash window: req1 in flight, req2 queued
        while time.time() < deadline:
            s1 = state(port, r1["id"])
            if s1 == "done":
                return False, ("req1 finished before the kill: make "
                               "it denser")
            if s1 == "running" and state(port, r2["id"]) == "queued":
                break
            time.sleep(0.02)
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    finally:
        _reap(proc)

    # restart (in-process incarnation on the same journal)
    d2 = serve_ns.CheckDaemon(serve_ns.ServeConfig(
        root=serve_dir, backend="gpu", device=device, workers=1))
    d2.start()
    details = []
    ok = True
    try:
        if d2.replay_stats.get("requeued") != 2:
            return False, (f"replay requeued "
                           f"{d2.replay_stats.get('requeued')}, want 2 "
                           f"(stats {d2.replay_stats})")
        details.append("replayed 2 journaled request(s) after SIGKILL")
        with d2._lock:
            rids = list(d2._by_id)
        deadline = time.time() + VERDICT_WAIT_S
        docs = {}
        for rid in rids:
            while time.time() < deadline:
                doc = d2.status(rid)
                if doc and doc["state"] == "done":
                    docs[rid] = doc
                    break
                time.sleep(0.05)
        d2.drain(timeout_s=10)
    finally:
        d2.stop()
    if len(docs) != 2:
        return False, f"re-checked {len(docs)}/2 replayed requests"
    for doc, ops in zip(
            (docs[r] for r in sorted(docs, key=lambda x: docs[x][
                "tenant"])),
            (ops1, ops2)):
        offline = _offline(ops, device, "chaos-serve-offline")
        got = doc["result"].get("valid")
        if got != offline.get("valid"):
            ok = False
            details.append(f"tenant {doc['tenant']}: served {got!r} != "
                           f"offline {offline.get('valid')!r}")
        else:
            details.append(f"tenant {doc['tenant']}: verdict {got} == "
                           f"offline")
    return ok, "; ".join(details)


def scenario_trace_request_kill(seed, device="cuda"):
    """SIGKILL the daemon mid-check on a TRACED request (admitted with
    an inbound traceparent). The restarted daemon's serve.wal replay must
    keep the ORIGINAL trace id, the re-run's spans must join the same
    trace, and the stitched single-request waterfall must still
    render."""
    import tempfile

    from jepsen_tpu_torch import serve as serve_ns
    from jepsen_tpu_torch import web
    from jepsen_tpu_torch.obs import fleet as obs_fleet
    from jepsen_tpu_torch.obs import trace as trace_ns

    root = tempfile.mkdtemp(prefix="jepsen-chaos-tracereq-")
    serve_dir = os.path.join(root, "serve")
    port_file = os.path.join(root, "port.json")
    ops1 = [o.to_dict() for o in
            simulate_register_history(300, n_procs=5, n_vals=4, seed=seed)]
    trace_id = trace_ns.new_trace_id()
    proc = _start_child(_daemon_child(serve_dir, root, port_file, device),
                        JTPU_TRACE="1")
    try:
        deadline = time.time() + CHILD_WAIT_S
        port, why = _wait_port(proc, port_file, deadline)
        if port is None:
            return False, why
        body = _post(port, "/check", {"tenant": "traced",
                                      "model": "cas-register",
                                      "history": ops1},
                     headers={"traceparent":
                              trace_ns.format_traceparent(trace_id)})
        if body.get("trace") != trace_id:
            return False, (f"admission answered trace "
                           f"{body.get('trace')!r}, want the inbound "
                           f"{trace_id}")
        rid = body["id"]
        # kill in the exact window: the request is mid-check
        while time.time() < deadline:
            if _get(port, f"/check/{rid}")[1]["state"] == "running":
                break
            time.sleep(0.02)
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    finally:
        _reap(proc)

    d2 = serve_ns.CheckDaemon(serve_ns.ServeConfig(
        root=serve_dir, backend="gpu", device=device, workers=1))
    d2.start()
    try:
        if d2.replay_stats.get("requeued") != 1:
            return False, (f"replay requeued "
                           f"{d2.replay_stats.get('requeued')}, want 1")
        with d2._lock:
            rid2 = next(iter(d2._by_id))
        deadline = time.time() + VERDICT_WAIT_S
        doc = None
        while time.time() < deadline:
            doc = d2.status(rid2)
            if doc and doc["state"] == "done":
                break
            time.sleep(0.05)
        resolved = d2.resolve_trace(rid2)
        d2.drain(timeout_s=10)
    finally:
        d2.stop()
    if not doc or doc.get("state") != "done":
        return False, f"replayed request never finished: {doc}"
    details = []
    if doc.get("trace") != trace_id:
        return False, (f"replayed request re-minted trace "
                       f"{doc.get('trace')!r}, want the original "
                       f"{trace_id}")
    details.append("replayed request kept its original trace id")
    if resolved != trace_id:
        return False, (f"resolve_trace({rid2}) -> {resolved!r}, want "
                       f"{trace_id}")
    phases = doc["result"].get("serve", {}).get("phases", {})
    if "device_s" not in phases:
        return False, f"re-run verdict lost its phase breakdown: {doc}"
    details.append("re-run verdict carries a phase breakdown")
    stitched = obs_fleet.stitch_request(serve_dir, trace_id)
    names = {r["name"] for r in stitched["records"]}
    if not {"serve.request", "serve.verdict"} <= names:
        return False, (f"stitched waterfall incomplete after SIGKILL: "
                       f"{sorted(names)}")
    # spans are written at exit, so the killed incarnation's open
    # serve.request span is absent; its sync anchor (written at attach)
    # proves it shared the file
    raw, _ = trace_ns.read_trace(
        os.path.join(serve_dir, trace_ns.TRACE_NAME))
    anchors = [r for r in raw if r["name"] == "trace.sync"]
    if len(anchors) < 2:
        return False, (f"{len(anchors)} trace.sync anchor(s) in "
                       f"trace.jsonl, want one per incarnation")
    details.append(f"stitched waterfall renders "
                   f"{len(stitched['records'])} span(s); both "
                   f"incarnations anchored the shared trace.jsonl")
    page = web.request_trace_html(stitched)
    if trace_id not in page or "serve.verdict" not in page:
        return False, "web waterfall page failed to render the trace"
    details.append("web waterfall renders")
    return True, "; ".join(details)


def scenario_serve_batch_poison(seed, device="cuda"):
    """A 4-request same-bucket burst against a REAL daemon (HTTP, warm
    engine, gang scheduler on) with ONE poison member: the injected gang
    fault (``checker.gpu._GANG_FAULT``) OOMs every device call whose gang
    holds the poison. Bisection must isolate it: the 3 survivors answer
    200 with offline-identical verdicts, the poison answers 500 with an
    oom-class error, and its bucket's breaker counts EXACTLY one
    failure."""
    import tempfile

    from jepsen_tpu_torch import serve as serve_ns
    from jepsen_tpu_torch.checker import gpu as gpu_ns

    root = tempfile.mkdtemp(prefix="jepsen-chaos-servepoison-")
    surv_ops, poison_ops, poison_n = _poison_histories(seed)
    if poison_ops is None:
        return False, "poison history not distinguishable by row count"
    offline = [_offline(o, device, "chaos-poison-offline")
               for o in surv_ops]

    cfg = serve_ns.ServeConfig(root=os.path.join(root, "serve"),
                               backend="gpu", device=device, workers=1,
                               batch_max=8, batch_wait_ms=1000.0)
    daemon = serve_ns.CheckDaemon(cfg)
    if daemon.batcher is None:
        return False, "gang scheduler unexpectedly disabled"
    daemon.start()
    server = _daemon_http(daemon, root)
    port = server.server_port

    def gang_fault(pks):
        if any(p.n == poison_n for p in pks):
            raise RuntimeError(
                "RESOURCE_EXHAUSTED: injected gang OOM (chaos)")

    gpu_ns._GANG_FAULT = gang_fault
    details = []
    try:
        # the poison first so it leads the gang, survivors inside the
        # 1 s coalesce window behind it
        rid_p = _post(port, "/check", {"tenant": "a",
                                       "model": "cas-register",
                                       "history": poison_ops})["id"]
        rid_s = [_post(port, "/check", {"tenant": "ab"[i % 2],
                                        "model": "cas-register",
                                        "history": o})["id"]
                 for i, o in enumerate(surv_ops)]
        docs = _poll_done(port, [rid_p] + rid_s)
        if len(docs) != 4:
            return False, f"only {len(docs)}/4 requests finished"

        code, doc = docs[rid_p]
        res = doc["result"]
        gang = (res.get("serve") or {}).get("gang") or {}
        if gang.get("size", 0) < 2:
            return False, (f"no gang formed (size "
                           f"{gang.get('size')}): burst ran serially")
        if not gang.get("poison"):
            return False, f"poison member not isolated: {res}"
        if code != 500:
            return False, f"poison answered {code}, want 500"
        if res.get("error-class") != "oom":
            return False, (f"poison error-class "
                           f"{res.get('error-class')!r}, want 'oom'")
        details.append(f"gang of {gang['size']} bisected "
                       f"{gang.get('bisections')}x; poison 500/oom")

        for i, rid in enumerate(rid_s):
            code, doc = docs[rid]
            res = doc["result"]
            g = (res.get("serve") or {}).get("gang") or {}
            if g.get("poison"):
                return False, f"survivor {i} marked poison: {res}"
            if code != 200:
                return False, f"survivor {i} answered {code}, want 200"
            if res.get("valid") != offline[i].get("valid"):
                return False, (f"survivor {i}: served "
                               f"{res.get('valid')!r} != offline "
                               f"{offline[i].get('valid')!r}")
        details.append("3 survivors: 200, verdicts == offline")

        snap = daemon.breaker.snapshot()
        fails = [r["fails"] for r in snap.values() if r["fails"]]
        if fails != [1]:
            return False, (f"breaker counted {fails or [0]} failures, "
                           f"want exactly [1] (snapshot {snap})")
        details.append("breaker counted exactly 1 failure")
        if daemon.stats["bisections"] < 1:
            return False, "no bisection recorded"
        return True, "; ".join(details)
    finally:
        gpu_ns._GANG_FAULT = None
        server.shutdown()
        daemon.stop()


def scenario_serve_fleet_host_kill(seed, device="cuda"):
    """A multi-tenant same-bucket burst against a REAL fleet-backed
    daemon (HTTP, gang scheduler on, 2 ``ProcHost`` worker processes on
    ``device``) with one worker SIGKILLed mid-gang. The placer must
    detect the loss, re-mesh the gang's lanes onto the survivor, and
    finish: every request answers 200 with an offline-identical verdict,
    no poison, and the breaker counts no failure."""
    import tempfile

    from jepsen_tpu_torch import serve as serve_ns

    root = tempfile.mkdtemp(prefix="jepsen-chaos-servefleet-")
    all_ops = [[o.to_dict() for o in
                simulate_register_history(40, n_procs=3, n_vals=3,
                                          seed=seed + i)]
               for i in range(3)]
    offline = [_offline(o, device, "chaos-fleet-offline") for o in all_ops]

    # small segments force several merge barriers per gang, so the
    # SIGKILL at round 2 lands MID-gang, not after it
    os.environ["JTPU_SEGMENT_ITERS"] = "2"
    cfg = serve_ns.ServeConfig(root=os.path.join(root, "serve"),
                               backend="gpu", device=device, workers=1,
                               batch_max=8, batch_wait_ms=1000.0,
                               fleet_hosts=2, fleet_backend="proc")
    daemon = serve_ns.CheckDaemon(cfg)
    if daemon.placer is None:
        os.environ.pop("JTPU_SEGMENT_ITERS", None)
        return False, "fleet placer unexpectedly disabled"
    killed = []

    def chaos(round_idx, hosts):
        if round_idx >= 2 and not killed and hosts[1].alive():
            os.kill(hosts[1].pid, signal.SIGKILL)
            killed.append(hosts[1].pid)

    daemon.placer.on_round = chaos
    daemon.start()
    server = _daemon_http(daemon, root)
    port = server.server_port
    details = []
    try:
        rids = [_post(port, "/check", {"tenant": "abc"[i],
                                       "model": "cas-register",
                                       "history": o})["id"]
                for i, o in enumerate(all_ops)]
        docs = _poll_done(port, rids)
        if len(docs) != 3:
            return False, f"only {len(docs)}/3 requests finished"
        if not killed:
            return False, "gang finished before the kill round"
        details.append(f"SIGKILLed worker pid {killed[0]} mid-gang")

        sizes = set()
        for i, rid in enumerate(rids):
            code, doc = docs[rid]
            res = doc["result"]
            g = (res.get("serve") or {}).get("gang") or {}
            sizes.add(g.get("size", 0))
            if g.get("poison"):
                return False, (f"tenant {doc['tenant']} misclassified "
                               f"as poison: {res}")
            if code != 200:
                return False, (f"tenant {doc['tenant']} answered "
                               f"{code}, want 200")
            if res.get("valid") != offline[i].get("valid"):
                return False, (f"tenant {doc['tenant']}: served "
                               f"{res.get('valid')!r} != offline "
                               f"{offline[i].get('valid')!r}")
        if max(sizes) < 2:
            return False, (f"no gang formed (sizes {sizes}): burst "
                           f"ran serially")
        details.append(f"gang of {max(sizes)} over 2 proc hosts: all "
                       f"verdicts == offline")

        st = daemon.placer.stats
        if st.get("host-losses", 0) < 1 or st.get("remeshes", 0) < 1:
            return False, (f"no remesh recorded after the kill "
                           f"(placer stats {st})")
        details.append(f"re-meshed to survivor ({st['remeshes']} "
                       f"remesh(es))")
        if daemon.placer.live() != 1:
            return False, f"fleet live={daemon.placer.live()}, want 1"
        if daemon.stats["poisoned"] != 0:
            return False, (f"poisoned={daemon.stats['poisoned']}, "
                           f"want 0")
        snap = daemon.breaker.snapshot()
        fails = [r["fails"] for r in snap.values() if r["fails"]]
        if fails:
            return False, (f"breaker counted {fails} failures, want "
                           f"none (snapshot {snap})")
        details.append("breaker counted 0 failures; 0 poisoned")
        return True, "; ".join(details)
    finally:
        os.environ.pop("JTPU_SEGMENT_ITERS", None)
        server.shutdown()
        daemon.stop()


_STREAM_VERDICT_KEYS = ("valid", "levels", "max-linearized-prefix",
                        "final-states", "frontier-op")


def scenario_stream_kill(seed, device="cuda"):
    """SIGKILL the check daemon MID-STREAM, after the online checker
    has journaled chunks and saved a partial-verdict checkpoint. A
    restarted daemon must replay the per-session WAL, resume the search
    from the checkpointed level (NEVER level 0), and, once the stream is
    sealed, render a verdict identical to the offline analyze path over
    the same ops."""
    import tempfile
    import zipfile

    from jepsen_tpu_torch import resilience as R
    from jepsen_tpu_torch import serve as serve_ns
    from jepsen_tpu_torch import stream as stream_mod

    root = tempfile.mkdtemp(prefix="jepsen-chaos-streamkill-")
    serve_dir = os.path.join(root, "serve")
    port_file = os.path.join(root, "port.json")
    ops = [o.to_dict() for o in
           simulate_register_history(600, n_procs=5, n_vals=4, seed=seed)]
    offline = _offline(ops, device, "chaos-stream-offline")
    chunks = [ops[i:i + 50] for i in range(0, len(ops), 50)]
    # one search level per segment: a checkpoint barrier every segment,
    # so the kill window is wide open
    proc = _start_child(_daemon_child(serve_dir, root, port_file, device),
                        JTPU_SEGMENT_ITERS="1")
    cp_level = 0
    try:
        deadline = time.time() + CHILD_WAIT_S
        port, why = _wait_port(proc, port_file, deadline)
        if port is None:
            return False, why
        sid = _post(port, "/stream", {"tenant": "chaos",
                                      "model": "cas-register"})["id"]
        for seq, chunk in enumerate(chunks):
            _post(port, f"/stream/{sid}/ops",
                  {"seq": seq, "ops": chunk,
                   "crc": stream_mod.chunk_crc(chunk)})
        # the stream stays OPEN: the online search is mid-flight over
        # the stable prefix when the SIGKILL lands, after a checkpoint
        # with level > 0
        cp_path = os.path.join(serve_dir, "streams", sid,
                               stream_mod.CHECKPOINT_NAME)
        while time.time() < deadline and cp_level <= 0:
            try:
                cp_level = R.Checkpoint.load(cp_path).level
            except (OSError, ValueError, KeyError,
                    zipfile.BadZipFile):
                pass
            time.sleep(0.02)
        if cp_level <= 0:
            return False, "no partial-verdict checkpoint before kill"
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    finally:
        _reap(proc)

    d2 = serve_ns.CheckDaemon(serve_ns.ServeConfig(
        root=serve_dir, backend="gpu", device=device, workers=1))
    d2.start()
    details = [f"SIGKILL with checkpoint at level {cp_level}"]
    try:
        if d2.replay_stats.get("streams-resumed") != 1:
            return False, (f"replay resumed "
                           f"{d2.replay_stats.get('streams-resumed')}"
                           f" stream(s), want 1 "
                           f"(stats {d2.replay_stats})")
        st = d2.stream_status(sid)
        if st is None or st["ops"] != len(ops):
            return False, (f"WAL replay rebuilt "
                           f"{st and st['ops']}/{len(ops)} ops")
        details.append(f"WAL replay rebuilt all {len(ops)} ops")
        code, body, _ = d2.stream_close(sid, {"chunks": len(chunks)})
        if code != 200:
            return False, f"close after restart answered {code}: {body}"
        deadline = time.time() + VERDICT_WAIT_S
        st = {}
        while time.time() < deadline:
            st = d2.stream_status(sid) or {}
            if st.get("state") == "done" and "result" in st:
                break
            time.sleep(0.05)
        if st.get("state") != "done" or "result" not in st:
            return False, f"stream never finished after restart: {st}"
    finally:
        d2.drain(timeout_s=10)
        d2.stop()
    result = st["result"]
    resume_level = (result.get("stream") or {}).get("resume-level", 0)
    if resume_level <= 0:
        return False, (f"restart searched from level "
                       f"{resume_level}: checkpoint not resumed "
                       f"(stream {result.get('stream')})")
    details.append(f"resumed search at level {resume_level}, not 0")
    diff = [k for k in _STREAM_VERDICT_KEYS
            if result.get(k) != offline.get(k)]
    if diff:
        return False, (f"streamed verdict differs from offline on "
                       f"{diff}: {[result.get(k) for k in diff]} != "
                       f"{[offline.get(k) for k in diff]}")
    details.append(f"verdict {result['valid']} bit-identical to "
                   f"offline on {len(_STREAM_VERDICT_KEYS)} keys")
    return True, "; ".join(details)


def scenario_stream_dup(seed, device="cuda"):
    """A duplicate / out-of-order chunk storm against the streaming
    intake: every chunk is sent twice, even-indexed chunks arrive before
    their predecessors, and an acked chunk is re-posted after close. The
    sealed session's history.json must be BYTE-identical to a clean
    in-order session's, and the verdict identical to the offline analyze
    path."""
    import tempfile

    from jepsen_tpu_torch import serve as serve_ns
    from jepsen_tpu_torch import stream as stream_mod

    root = tempfile.mkdtemp(prefix="jepsen-chaos-streamdup-")
    ops = [o.to_dict() for o in
           simulate_register_history(240, n_procs=4, n_vals=4, seed=seed)]
    offline = _offline(ops, device, "chaos-streamdup-offline")
    chunks = [ops[i:i + 20] for i in range(0, len(ops), 20)]

    daemon = serve_ns.CheckDaemon(
        serve_ns.ServeConfig(root=os.path.join(root, "serve"),
                             backend="gpu", device=device, workers=1))
    daemon.start()

    def run_session(tenant, storm):
        _, body, _ = daemon.stream_open({"tenant": tenant,
                                         "model": "cas-register"})
        sid = body["id"]
        dup = reordered = 0
        if storm:
            # pairwise swap + double-send: seq 1 lands before seq 0,
            # every chunk repeats, and chunk 0 is re-posted at the end
            order = []
            for i in range(0, len(chunks), 2):
                pair = ([i + 1, i] if i + 1 < len(chunks) else [i])
                order.extend(pair + pair)
            order.append(0)
        else:
            order = list(range(len(chunks)))
        for seq in order:
            code, body, _ = daemon.stream_append(
                sid, {"seq": seq, "ops": chunks[seq],
                      "crc": stream_mod.chunk_crc(chunks[seq])})
            if code != 202:
                return None, (f"{tenant} chunk {seq} answered "
                              f"{code}: {body}")
            dup += bool(body.get("duplicate"))
            reordered += bool(body.get("buffered"))
        code, body, _ = daemon.stream_close(sid, {"chunks": len(chunks)})
        if code != 200:
            return None, f"{tenant} close answered {code}: {body}"
        if storm:
            # at-least-once survives sealing: a late duplicate of an
            # acked chunk after close is absorbed, not an error
            code, body, _ = daemon.stream_append(
                sid, {"seq": 0, "ops": chunks[0],
                      "crc": stream_mod.chunk_crc(chunks[0])})
            if code != 202 or not body.get("duplicate"):
                return None, (f"{tenant} dup-after-close answered "
                              f"{code}: {body}")
        deadline = time.time() + VERDICT_WAIT_S
        st = {}
        while time.time() < deadline:
            st = daemon.stream_status(sid) or {}
            if st.get("state") == "done" and "result" in st:
                break
            time.sleep(0.05)
        if st.get("state") != "done" or "result" not in st:
            return None, f"{tenant} stream never finished: {st}"
        st["dup-sent"] = dup
        st["reordered-sent"] = reordered
        st["history-path"] = os.path.join(
            daemon.config.root, "streams", sid, stream_mod.HISTORY_NAME)
        return st, None

    try:
        clean, err = run_session("clean", storm=False)
        if err:
            return False, err
        storm, err = run_session("storm", storm=True)
        if err:
            return False, err
    finally:
        daemon.drain(timeout_s=10)
        daemon.stop()

    details = []
    if not storm["dup-sent"] or not storm["reordered-sent"]:
        return False, (f"storm was not a storm: {storm['dup-sent']} "
                       f"dup(s), {storm['reordered-sent']} reorder(s)")
    details.append(f"storm absorbed {storm['dup-sent']} duplicate and "
                   f"{storm['reordered-sent']} out-of-order chunk(s)")
    with open(clean["history-path"], "rb") as f:
        clean_bytes = f.read()
    with open(storm["history-path"], "rb") as f:
        storm_bytes = f.read()
    if clean_bytes != storm_bytes:
        return False, ("storm history.json differs from the clean "
                       "session's: intake is not idempotent")
    details.append(f"history.json byte-identical to the clean "
                   f"session's ({len(storm_bytes)} bytes)")
    for st in (clean, storm):
        diff = [k for k in _STREAM_VERDICT_KEYS
                if st["result"].get(k) != offline.get(k)]
        if diff:
            return False, (f"{st['tenant']} verdict differs from "
                           f"offline on {diff}")
    details.append(f"both verdicts ({offline['valid']}) identical to "
                   f"offline")
    return True, "; ".join(details)


def scenario_flightrec_kill(seed, device="cuda"):
    """SIGKILL the daemon MID-BURST, after one poison request tripped
    its bucket's breaker: the breaker-trip flight-recorder dump written
    BEFORE the kill must survive whole (valid JSON, never a half file),
    carry the poison request's trace id, and render through `flightrec`,
    while the SIGTERM-path dump is ABSENT."""
    import tempfile

    from jepsen_tpu_torch.obs import flightrec as flightrec_ns

    root = tempfile.mkdtemp(prefix="jepsen-chaos-flightrec-")
    serve_dir = os.path.join(root, "serve")
    port_file = os.path.join(root, "port.json")
    surv_ops, poison_ops, poison_n = _poison_histories(seed)
    if poison_ops is None:
        return False, "poison history not distinguishable by row count"
    # breaker_fails=1: the poison's isolated failure trips the bucket
    # at once, which fires the breaker-trip flight-recorder dump
    prelude = (
        "from jepsen_tpu_torch.checker import gpu as G\n"
        "def _fault(pks):\n"
        f"    if any(p.n == {poison_n} for p in pks):\n"
        "        raise RuntimeError("
        "'RESOURCE_EXHAUSTED: injected gang OOM (chaos)')\n"
        "G._GANG_FAULT = _fault\n")
    proc = _start_child(
        _daemon_child(serve_dir, root, port_file, device, prelude=prelude,
                      cfg=", batch_max=8, batch_wait_ms=1000.0, "
                          "breaker_fails=1"),
        JTPU_TSDB="1", JTPU_TSDB_CADENCE="0.2")
    try:
        deadline = time.time() + CHILD_WAIT_S
        port, why = _wait_port(proc, port_file, deadline)
        if port is None:
            return False, why
        # the poison leads the gang; survivors inside the 1 s window
        poison_trace = _post(port, "/check", {
            "tenant": "a", "model": "cas-register",
            "history": poison_ops}).get("trace")
        if not poison_trace:
            return False, "poison 202 carried no trace id"
        for i, o in enumerate(surv_ops):
            _post(port, "/check", {"tenant": "ab"[i % 2],
                                   "model": "cas-register", "history": o})
        # the kill window: the breaker has tripped (its dump is on disk)
        # but the burst is still being re-checked
        rec_dir = os.path.join(serve_dir, flightrec_ns.DIR_NAME)
        deadline = time.time() + VERDICT_WAIT_S
        while time.time() < deadline:
            if any(f.startswith("breaker-trip-")
                   for f in (os.listdir(rec_dir)
                             if os.path.isdir(rec_dir) else [])):
                break
            if proc.poll() is not None:
                return False, (f"daemon died rc={proc.returncode} "
                               f"before the breaker tripped")
            time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    finally:
        _reap(proc)

    details = []
    dumps = flightrec_ns.list_dumps(serve_dir)
    reasons = [d["reason"] for d in dumps]
    if "sigterm" in reasons or "drain" in reasons:
        return False, (f"orderly-shutdown dump present after SIGKILL "
                       f"({reasons}): the kill was not a kill")
    trips = [d for d in dumps if d["reason"] == "breaker-trip"]
    if not trips:
        return False, (f"no breaker-trip dump survived the kill "
                       f"(found {reasons or 'none'})")
    leftovers = [f for f in os.listdir(os.path.join(
        serve_dir, flightrec_ns.DIR_NAME)) if f.startswith(".")]
    if leftovers:
        return False, f"half-written dump temp files survived: {leftovers}"
    doc = flightrec_ns.load_dump(serve_dir, trips[0]["name"])
    if doc is None:
        return False, f"breaker-trip dump {trips[0]['name']} unreadable"
    details.append(f"breaker-trip dump whole after SIGKILL "
                   f"({trips[0]['bytes']} bytes, "
                   f"{len(doc.get('spans') or [])} spans)")
    if (doc.get("extra") or {}).get("class") != "oom":
        return False, (f"dump blames class "
                       f"{(doc.get('extra') or {}).get('class')!r}, "
                       f"want 'oom'")
    if poison_trace not in (doc.get("trace-ids") or []):
        return False, (f"poison trace {poison_trace} missing from the "
                       f"dump's {len(doc.get('trace-ids') or [])} "
                       f"trace id(s)")
    details.append("dump carries the poison request's trace id")
    rc_list, out = _cli(["flightrec", "--serve-dir", serve_dir])
    if rc_list != 0 or "breaker-trip" not in out:
        return False, f"flightrec list rc={rc_list}, output {out!r}"
    rc_show, out = _cli(["flightrec", trips[0]["name"],
                         "--serve-dir", serve_dir])
    if rc_show != 0 or f"trace {poison_trace}" not in out:
        return False, (f"flightrec {trips[0]['name']} rc={rc_show} did "
                       f"not render the poison trace")
    details.append("flightrec renders the dump (list + show)")
    return True, "; ".join(details)


def scenario_lint_seeded_race(seed, device="cuda"):
    """Seed a known-bad concurrency pattern (off-lock queue append +
    depth bump, the bug class the lockset pass was built to catch) into a
    COPY of the port's serve.py; assert LOCK-UNGUARDED fires on the
    seeded method and on nothing else new. The unpatched copy's findings
    are the control: only the delta counts."""
    import shutil
    import tempfile

    from jepsen_tpu_torch.analysis import lockset_lint

    anchor = "    def _dequeue(self) -> Optional[CheckRequest]:"
    seeded_method = (
        "    def _seeded_bad_append(self, req):\n"
        "        q = self._queues.get(req.tenant)\n"
        "        if q is None:\n"
        "            q = self._queues[req.tenant] = deque()\n"
        "        q.append(req)\n"
        "        self._depth += 1\n"
        "        return q\n"
        "\n"
    )
    src_path = os.path.join(REPO, "jepsen_tpu_torch", "serve.py")
    with open(src_path, encoding="utf-8") as f:
        src = f.read()
    if src.count(anchor) != 1:
        return False, (f"insertion anchor matched {src.count(anchor)} "
                       f"time(s) in serve.py (need exactly 1): update "
                       f"the seeded-race anchor to track the refactor")

    with tempfile.TemporaryDirectory(prefix="jtpu-seeded-race-") as td:
        pkg = os.path.join(td, "jepsen_tpu_torch")
        os.makedirs(pkg)
        clean = os.path.join(pkg, "serve.py")
        shutil.copyfile(src_path, clean)
        control = {f.key() for f in lockset_lint.lint_file(clean, td)}
        with open(clean, "w", encoding="utf-8") as f:
            f.write(src.replace(anchor, seeded_method + anchor))
        seeded = {f.key() for f in lockset_lint.lint_file(clean, td)}

    delta = sorted(seeded - control)
    want = [k for k in delta
            if k.startswith("LOCK-UNGUARDED ")
            and "_seeded_bad_append" in k]
    if not want:
        return False, (f"lockset pass missed the seeded off-lock "
                       f"append (delta: {delta or 'empty'})")
    noise = [k for k in delta if "_seeded_bad_append" not in k]
    if noise:
        return False, (f"seeding one bad method changed unrelated "
                       f"findings: {noise}")
    return True, (f"seeded off-lock append caught: {len(want)} "
                  f"LOCK-UNGUARDED finding(s) on _seeded_bad_append, "
                  f"zero collateral findings")


SCENARIOS = (
    ("oom", scenario_oom),
    ("wedge", scenario_wedge),
    ("kill-mid-segment", scenario_kill_mid_segment),
    ("transient", scenario_transient),
    ("hung-client", scenario_hung_client),
    ("kill9-recover", scenario_kill9_recover),
    ("malformed-history", scenario_malformed_history),
    ("trace-integrity", scenario_trace_integrity),
    ("watched-kill", scenario_watched_kill),
    ("explain-kill", scenario_explain_kill),
    ("prof-kill", scenario_prof_kill),
    ("plan-rejects", scenario_plan_rejects),
    ("fleet-host-kill", scenario_fleet_host_kill),
    ("straggler-host", scenario_straggler_host),
    ("serve-kill", scenario_serve_kill),
    ("trace-request-kill", scenario_trace_request_kill),
    ("serve-batch-poison", scenario_serve_batch_poison),
    ("serve-fleet-host-kill", scenario_serve_fleet_host_kill),
    ("stream-kill", scenario_stream_kill),
    ("stream-dup", scenario_stream_dup),
    ("flightrec-kill", scenario_flightrec_kill),
    ("lint-seeded-race", scenario_lint_seeded_race),
)


def run_matrix(names, seed, device, out=print):
    """Run the scenarios named (all when empty) on ``device`` and print
    the table; (exit code, rows of (name, ok, seconds, detail))."""
    selected = [(n, fn) for n, fn in SCENARIOS if not names or n in names]
    rows = []
    failed = 0
    for name, fn in selected:
        accel._reset_for_tests()
        t0 = time.time()
        try:
            ok, detail = fn(seed, device)
        except Exception as e:  # noqa: BLE001 — a crash is a failure
            ok, detail = False, f"crashed: {type(e).__name__}: {e}"
        finally:
            resilience._inject_fault = None
        rows.append((name, ok, time.time() - t0, detail))
        failed += 0 if ok else 1

    width = max(len(n) for n, *_ in rows)
    out(f"{'scenario':<{width}}  result  secs  detail")
    for name, ok, secs, detail in rows:
        out(f"{name:<{width}}  {'PASS' if ok else 'FAIL':<6}"
            f"  {secs:4.1f}  {detail}")
    out(f"\n{len(rows) - failed}/{len(rows)} scenarios passed")
    return (1 if failed else 0), rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--only", action="extend", nargs="+", metavar="NAME",
                    choices=[n for n, _ in SCENARIOS],
                    help="run only these scenarios (repeatable)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the scenarios' device (default cuda)")
    args = ap.parse_args(argv)
    try:
        accel.ensure_usable("torch_chaos_matrix", device=args.device)
    except accel.AcceleratorUnavailable as e:
        print(f"# chaos: {e}", file=sys.stderr)
        return 2
    rc, _ = run_matrix(args.only or (), args.seed, args.device)
    return rc


if __name__ == "__main__":
    sys.exit(main())
