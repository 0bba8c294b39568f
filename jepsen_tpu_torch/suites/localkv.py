"""local-kv suite — a REAL multi-process system under the full harness,
on localhost.

The reference's tier-3 tests drive suites against live daemons from the
docker control node (jepsen/test/jepsen/core_test.clj:30-84 ssh-test;
README.md "Running a test"). This environment has no docker, but
localhost processes are real processes: this suite boots N instances of
``examples/localkv/kvnode.py`` (real sockets, real pids, primary-forward
replication), drives a CAS-register workload through the complete
``core.run`` lifecycle over the LOCAL control mode — ``start-stop-daemon``
start, SIGSTOP/SIGCONT hammer-time nemesis, log snarfing, store
artifacts — and checks linearizability.

Two variants:
- ``localkv_test`` — safe mode (every op forwarded to the primary's
  serialization point): the checker should find it linearizable.
- ``localkv_unsafe_test`` — ``--read-local``: reads served from lagging
  async replicas. A deterministic write-settle-write-read schedule makes
  a backup return the OLD value after the new write completed — the
  checker must refute and render the counterexample. A real consistency
  bug, caught in real processes.

Node names are logical ("kv1".."kvN"); each maps to a localhost TCP port
(allocated fresh per test ctor so parallel CI runs cannot collide), and
each port has its own run directory under the temporary directory.

The port's copy of ``jepsen_tpu.suites.localkv``, with one difference:
the linearizability check runs on the card (``backend`` "gpu", the
default) unless the options name the CPU (``backend: "cpu"`` for the host
search, ``device: "cpu"`` for the kernels' plain versions).
"""

from __future__ import annotations

import json
import os
import socket
import sys
import tempfile
import threading
import time
from typing import Optional

from jepsen_tpu_torch import client as client_ns
from jepsen_tpu_torch import db as db_ns
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import nemesis
from jepsen_tpu_torch.checker import compose, perf
from jepsen_tpu_torch.checker.wgl import linearizable
from jepsen_tpu_torch.control import util as cu
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.suites import workloads as wl
from jepsen_tpu_torch.testing import noop_test

KVNODE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))),
    "examples", "localkv", "kvnode.py")
KEY = "jepsen"
RUN_DIR = os.path.join(tempfile.gettempdir(), "jepsen-localkv")


#: In-process allocation cursor: successive ctors in one process never
#: reuse a port.
_port_cursor = iter(range(0, 1 << 20))
_port_lock = threading.Lock()


def free_ports(n: int):
    """n distinct ports for this test's daemons. Disjoint by construction
    across (a) ctors in this process (a shared cursor) and (b) concurrent
    CI processes (a pid-derived base), so parallel test runs cannot hand
    two kvnode clusters the same port. Candidates already bound by an
    unrelated service are probed and skipped; the probe socket closes
    before the daemon binds, so a race with NON-cooperating processes is
    still possible (inherent to pick-then-bind) — setup surfaces it as
    'never came up' with the daemon log path."""
    base = 20000 + (os.getpid() * 131) % 20000
    out = []
    with _port_lock:
        while len(out) < n:
            port = 20000 + (base - 20000 + next(_port_cursor)) % 40000
            try:
                s = socket.socket()
                s.bind(("127.0.0.1", port))
                s.close()
            except OSError:
                continue  # an unrelated service holds it: skip
            out.append(port)
    return out


def node_port(test: dict, node) -> int:
    return test["localkv-ports"][test["nodes"].index(node)]


class LocalKVDB(db_ns.DB, db_ns.LogFiles):
    """Lifecycle for one kvnode process per logical node. The first node
    is the primary (kvnode treats the first peer port as primary)."""

    def __init__(self, read_local: bool = False,
                 repl_delay_ms: float = 30.0):
        self.read_local = read_local
        self.repl_delay_ms = repl_delay_ms

    def _dir(self, test, node) -> str:
        return f"{RUN_DIR}/{node_port(test, node)}"

    def setup(self, test, node):
        port = node_port(test, node)
        d = self._dir(test, node)
        from jepsen_tpu_torch import control
        control.exec(test, node, "mkdir", "-p", d)
        control.exec(test, node, "rm", "-f", f"{d}/kv.log")
        peers = ",".join(str(p) for p in test["localkv-ports"])
        args = [KVNODE, "--port", str(port), "--peers", peers,
                "--repl-delay-ms", str(self.repl_delay_ms)]
        if self.read_local:
            args.append("--read-local")
        # match_executable=False: every node shares the python binary, so
        # start-stop-daemon must match on the pidfile, not the exec path
        cu.start_daemon(test, node, sys.executable, *args,
                        logfile=f"{d}/kv.log", pidfile=f"{d}/kv.pid",
                        chdir=d, match_executable=False)
        # 30 s: a loaded build host has been observed to take 12+ s just
        # to fork+exec the five python nodes concurrently
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                with socket.create_connection(("127.0.0.1", port),
                                              timeout=0.5):
                    return
            except OSError:
                time.sleep(0.1)
        raise RuntimeError(f"kvnode on :{port} never came up "
                           f"(log: {d}/kv.log)")

    def teardown(self, test, node):
        d = self._dir(test, node)
        cu.stop_daemon(test, node, f"{d}/kv.pid")
        # stragglers (e.g. a SIGSTOPped daemon whose pidfile kill landed
        # while frozen): match this node's port, CONT then KILL
        cu.grepkill(test, node, f"kvnode.py --port {node_port(test, node)}",
                    signal=18)
        cu.grepkill(test, node, f"kvnode.py --port {node_port(test, node)}")

    def log_files(self, test, node):
        return [f"{self._dir(test, node)}/kv.log"]


class LocalKVClient(client_ns.Client):
    """JSON-line TCP client. Reads fail on error (they definitely did not
    happen); writes/cas crash to :info (they may have applied).

    Connects LAZILY: ``open`` never raises, so a reincarnated process
    whose node is still SIGSTOPped gets a client that fails its ops until
    the daemon resumes — the reference wraps DB clients in its
    auto-reconnect layer for exactly this (reconnect.clj:92-129,
    cockroach/client.clj:79-95)."""

    def __init__(self, node=None, timeout: float = 2.0):
        self.node = node
        self.port: Optional[int] = None
        self.timeout = timeout
        self.sock: Optional[socket.socket] = None
        self.rfile = None

    def open(self, test, node):
        c = LocalKVClient(node, self.timeout)
        c.port = node_port(test, node)
        return c

    def close(self, test):
        if self.sock:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    def _rpc(self, req: dict) -> dict:
        if self.sock is None:
            self.sock = socket.create_connection(
                ("127.0.0.1", self.port), timeout=self.timeout)
            self.rfile = self.sock.makefile("r")
        self.sock.sendall((json.dumps(req) + "\n").encode())
        line = self.rfile.readline()
        if not line:
            raise OSError("connection closed")
        return json.loads(line)

    def invoke(self, test, op: Op) -> Op:
        crash = "fail" if op.f == "read" else "info"
        try:
            if op.f == "read":
                r = self._rpc({"op": "read", "key": KEY})
                if not r.get("ok"):
                    # e.g. forward-to-primary failed: no observation was
                    # made — recording ok/None would be a fabricated read
                    return op.replace(type="fail", error=r.get("error"))
                return op.replace(type="ok", value=r.get("value"))
            if op.f == "write":
                r = self._rpc({"op": "write", "key": KEY,
                               "value": op.value})
                return op.replace(type="ok" if r.get("ok") else "info",
                                  error=r.get("error"))
            if op.f == "cas":
                old, new = op.value
                r = self._rpc({"op": "cas", "key": KEY, "old": old,
                               "new": new})
                if r.get("ok"):
                    return op.replace(type="ok")
                # a definite mismatch is a clean :fail; any OTHER error
                # (forward lost after the primary may have applied it) is
                # indeterminate and must crash to :info
                return op.replace(
                    type="fail" if r.get("error") == "cas mismatch"
                    else "info",
                    error=r.get("error"))
            raise ValueError(f"unknown op {op.f!r}")
        except (TimeoutError, OSError, json.JSONDecodeError) as e:
            self.close(test)
            return op.replace(type=crash, error=type(e).__name__)


def pause_nemesis():
    """SIGSTOP/SIGCONT one random node's daemon (the reference's
    hammer-time, nemesis.clj:258-272) — targeted by port so only that
    node's process freezes even though all share one machine. start_fn is
    the disruption (nemesis f=start pauses), stop_fn the recovery."""
    def pause(test, node):
        cu.grepkill(test, node,
                    f"kvnode.py --port {node_port(test, node)}", signal=19)
        return f"paused kvnode on {node}"

    def resume(test, node):
        cu.grepkill(test, node,
                    f"kvnode.py --port {node_port(test, node)}", signal=18)
        return f"resumed kvnode on {node}"

    return nemesis.node_start_stopper(nemesis._rand_node, pause, resume)


def _nemesis_cycle(period: float):
    while True:
        yield gen.sleep(period)
        yield gen.once({"type": "info", "f": "start"})
        yield gen.sleep(period)
        yield gen.once({"type": "info", "f": "stop"})


def localkv_test(opts: dict) -> dict:
    """Safe mode: linearizable by construction; the run should validate.
    Hammer-time pauses a node mid-run to exercise crashed ops and client
    reincarnation against real frozen processes. Each resume (f=stop)
    is followed by a convergence probe — every node must answer a read
    again before the heal is trusted — recorded as heal-verified /
    heal-failed ops (opts: 'heal-probe' False disables,
    'heal-probe-deadline' tunes the per-node budget)."""
    opts = dict(opts)
    nodes = opts.get("nodes") or ["kv1", "kv2", "kv3"]
    nem = pause_nemesis()
    if opts.get("heal-probe", True):
        nem.heal_probe = nemesis.client_ping_probe(
            deadline_s=opts.get("heal-probe-deadline", 3.0))
    test = noop_test()
    test.update({
        "name": "local-kv",
        "nodes": nodes,
        "localkv-ports": free_ports(len(nodes)),
        "ssh": {"mode": "local"},
        "db": LocalKVDB(),
        "client": LocalKVClient(),
        "nemesis": nem,
        "model": CASRegister(),
        "checker": compose({
            "perf": perf(),
            "linear": linearizable(CASRegister(),
                                   backend=opts.get("backend", "gpu"),
                                   device=opts.get("device")),
        }),
        "generator": gen.time_limit(
            opts.get("time-limit", 15),
            gen.clients(
                gen.stagger(1 / 20, gen.mix([wl.r, wl.w, wl.cas])),
                gen.seq(_nemesis_cycle(opts.get("nemesis-period", 4))))),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("concurrency", "time-limit", "store-dir",
                          "store-root")})
    return test


def localkv_unsafe_test(opts: dict) -> dict:
    """--read-local with a 1 s replication lag, driven by a DETERMINISTIC
    schedule: write v1, let it replicate, write v2, then immediately read
    from a backup — the backup still serves v1, a stale read the checker
    must refute (and render linear.svg for)."""
    opts = dict(opts)
    nodes = opts.get("nodes") or ["kv1", "kv2", "kv3"]

    # Worker threads are pinned process->node round-robin
    # (core.clj:349-352): thread 0 = kv1 (the primary), thread 1 = kv2
    # (a backup). phases() ends a phase only when its ops have COMPLETED
    # on every in-scope thread, so the backup's read is invoked strictly
    # after write(2) returned — any stale value refutes linearizability.
    def schedule():
        return gen.phases(
            gen.on_threads(lambda t: t == 0, gen.once(
                {"type": "invoke", "f": "write", "value": 1})),
            gen.sleep(2.5),   # v1 replicates everywhere (lag = 1 s)
            gen.on_threads(lambda t: t == 0, gen.once(
                {"type": "invoke", "f": "write", "value": 2})),
            gen.on_threads(lambda t: t == 1, gen.once(
                {"type": "invoke", "f": "read", "value": None})))

    test = noop_test()
    test.update({
        "name": "local-kv-unsafe",
        "nodes": nodes,
        "localkv-ports": free_ports(len(nodes)),
        "ssh": {"mode": "local"},
        "db": LocalKVDB(read_local=True, repl_delay_ms=1000.0),
        "client": LocalKVClient(),
        "model": CASRegister(),
        "checker": compose({
            "perf": perf(),
            "linear": linearizable(CASRegister(),
                                   backend=opts.get("backend", "gpu"),
                                   device=opts.get("device")),
        }),
        "generator": gen.time_limit(
            opts.get("time-limit", 20), gen.clients(schedule())),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("concurrency", "time-limit", "store-dir",
                          "store-root")})
    # The deterministic schedule needs worker thread 1 (the kv2 backup
    # reader); with concurrency < 2 its phase barrier would never
    # complete and the run degenerates to a timeout.
    if int(test.get("concurrency") or 0) < 2:
        test["concurrency"] = max(2, len(nodes))
    return test
