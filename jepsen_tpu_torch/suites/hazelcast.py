"""Hazelcast suite — workload registry over a server shim.

Rebuild of hazelcast/src/jepsen/hazelcast.clj: a registry of workloads
(hazelcast.clj:364-399) — maps (plain vs CRDT), a linearizable lock,
queues, and three unique-ID generators — each a {client, generator,
checker, model} bundle selected by --workload.

Architecture mirrors the reference: Hazelcast's native clients aren't
reachable from a non-JVM process, so the framework ships a *server shim*
that embeds the Hazelcast member and exposes a line protocol
(resources/HazelcastShim.java; the reference's equivalent is the
uberjar built from hazelcast/server/src/jepsen/hazelcast_server.clj with
majority-quorum configs at lines 44-52). Clients here speak that
protocol over TCP. The port carries its own copy of the shim's source
(:data:`SHIM_SOURCE`).

Shim protocol (one request line -> one reply line):
    LOCK <name>            -> OK | FAIL
    UNLOCK <name>          -> OK | FAIL
    ID <kind>              -> <integer id>      (kinds: REF, LONG, GEN)
    MAPPUT <map> <k> <v>   -> OK
    MAPGET <map> <k>       -> <v> | NIL
    MAPCAS <map> <k> <o> <n> -> OK | FAIL
    QOFFER <q> <v>         -> OK | FAIL
    QPOLL <q>              -> <v> | NIL

The port's copy of ``jepsen_tpu.suites.hazelcast``, with one difference:
the linearizability check (the lock workload's) runs on the card (``backend``
"gpu", the default) unless the options name the CPU (``backend:
"cpu"`` for the host search, ``device: "cpu"`` for the kernels' plain
versions).
"""

from __future__ import annotations

import os
import socket
from typing import Dict, Optional

from jepsen_tpu_torch import client as client_ns
from jepsen_tpu_torch import control
from jepsen_tpu_torch import db as db_ns
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import nemesis
from jepsen_tpu_torch.checker import (compose, set_checker, total_queue,
                                      unique_ids)
from jepsen_tpu_torch.checker.wgl import linearizable
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.models import Mutex, UnorderedQueue
from jepsen_tpu_torch.testing import noop_test

SHIM_PORT = 5701
#: the shim's Java source, in this package
SHIM_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "resources", "HazelcastShim.java")


class ShimConn:
    """Line-oriented client for the server shim."""

    def __init__(self, host: str, port: int = SHIM_PORT,
                 timeout: float = 5.0):
        if ":" in host:
            host, port = host.rsplit(":", 1)
        self.addr = (str(host), int(port))
        self.timeout = timeout
        self.sock: Optional[socket.socket] = None
        self._rf = None

    def request(self, *tokens) -> str:
        if self.sock is None:
            self.sock = socket.create_connection(self.addr, self.timeout)
            self.sock.settimeout(self.timeout)
            self._rf = self.sock.makefile("rb")
        line = " ".join(str(t) for t in tokens) + "\n"
        self.sock.sendall(line.encode())
        reply = self._rf.readline()
        if not reply:
            raise ConnectionError("shim closed connection")
        return reply.decode().strip()

    def close(self):
        if self.sock is not None:
            try:
                self.sock.close()
            finally:
                self.sock = None
                self._rf = None


class ShimClient(client_ns.Client):
    def __init__(self, node=None, timeout: float = 5.0):
        self.node = node
        self.timeout = timeout
        self.conn: Optional[ShimConn] = None

    def open(self, test, node):
        c = type(self)(node, self.timeout)
        c.conn = ShimConn(str(node), timeout=self.timeout)
        return c

    def close(self, test):
        if self.conn:
            self.conn.close()

    def _guard(self, op: Op, fn) -> Op:
        try:
            return fn()
        except (TimeoutError, OSError) as e:
            if self.conn:
                self.conn.close()
            crash = "fail" if op.f == "read" else "info"
            return op.replace(type=crash, error=type(e).__name__)


class LockClient(ShimClient):
    """Linearizable mutex (hazelcast.clj lock-client)."""

    def invoke(self, test, op: Op) -> Op:
        def go():
            verb = "LOCK" if op.f == "acquire" else "UNLOCK"
            out = self.conn.request(verb, "jepsen.lock")
            return op.replace(type="ok" if out == "OK" else "fail")
        return self._guard(op, go)


class IdClient(ShimClient):
    """Unique-ID generation; kind in REF (cas loop), LONG (atomic long),
    GEN (flake id generator) — hazelcast.clj's three id workloads."""

    kind = "LONG"

    def invoke(self, test, op: Op) -> Op:
        def go():
            out = self.conn.request("ID", self.kind)
            return op.replace(type="ok", value=int(out))
        return self._guard(op, go)


class RefIdClient(IdClient):
    kind = "REF"


class GenIdClient(IdClient):
    kind = "GEN"


class MapClient(ShimClient):
    """Grow-only set in a map entry (hazelcast.clj map-workload): add =
    CAS-append to one key's list, read = final get."""

    MAP = "jepsen.map"
    KEY = "set"

    def __init__(self, node=None, timeout: float = 5.0, crdt: bool = False):
        super().__init__(node, timeout)
        self.crdt = crdt

    def invoke(self, test, op: Op) -> Op:
        def go():
            if op.f == "add":
                for _ in range(50):
                    cur = self.conn.request("MAPGET", self.MAP, self.KEY)
                    new = (f"{op.value}" if cur == "NIL"
                           else f"{cur},{op.value}")
                    if cur == "NIL":
                        out = self.conn.request("MAPCAS", self.MAP,
                                                self.KEY, "NIL", new)
                    else:
                        out = self.conn.request("MAPCAS", self.MAP,
                                                self.KEY, cur, new)
                    if out == "OK":
                        return op.replace(type="ok")
                return op.replace(type="fail", error="cas-contention")
            if op.f == "read":
                cur = self.conn.request("MAPGET", self.MAP, self.KEY)
                vals = ([] if cur == "NIL"
                        else [int(x) for x in cur.split(",") if x])
                return op.replace(type="ok", value=sorted(vals))
            raise ValueError(f"unknown op {op.f!r}")
        return self._guard(op, go)


class HZQueueClient(ShimClient):
    def invoke(self, test, op: Op) -> Op:
        def go():
            if op.f == "enqueue":
                out = self.conn.request("QOFFER", "jepsen.queue", op.value)
                return op.replace(type="ok" if out == "OK" else "fail")
            if op.f in ("dequeue", "drain"):
                out = self.conn.request("QPOLL", "jepsen.queue")
                if out == "NIL":
                    return op.replace(type="fail", error="empty")
                return op.replace(type="ok", value=int(out))
            raise ValueError(f"unknown op {op.f!r}")
        return self._guard(op, go)


class HazelcastDB(db_ns.DB, db_ns.LogFiles):
    """Upload + launch the shim jar (hazelcast.clj:51-69: uberjar upload,
    daemonized java -jar with the node list)."""

    JAR = "/opt/hazelcast/shim.jar"
    LOG = "/opt/hazelcast/shim.log"
    PID = "/opt/hazelcast/shim.pid"

    def setup(self, test, node):
        from jepsen_tpu_torch.control import util as cu
        jar = test.get("shim-jar")
        control.exec(test, node, "mkdir", "-p", "/opt/hazelcast")
        if jar:
            control.upload(test, node, jar, self.JAR)
        members = ",".join(str(n) for n in test["nodes"])
        cu.start_daemon(test, node, "/usr/bin/java",
                        "-jar", self.JAR, "--members", members,
                        "--port", SHIM_PORT,
                        logfile=self.LOG, pidfile=self.PID,
                        chdir="/opt/hazelcast")

    def teardown(self, test, node):
        from jepsen_tpu_torch.control import util as cu
        cu.stop_daemon(test, node, self.PID, cmd="java")

    def log_files(self, test, node):
        return [self.LOG]


# ---------------------------------------------------------------------------
# Workload registry (hazelcast.clj:364-399)
# ---------------------------------------------------------------------------


def _add_gen():
    import itertools
    counter = itertools.count()

    def op(test, process):
        return {"type": "invoke", "f": "add", "value": next(counter)}
    return op


def _acquire_release():
    def cycle():
        while True:
            yield gen.once({"f": "acquire"})
            yield gen.once({"f": "release"})
    return gen.each(lambda: gen.seq(cycle()))


def workloads(backend: str = "gpu", device=None) -> Dict[str, dict]:
    """Fresh workload bundles (stateful generators => a function)."""
    import itertools
    enq = itertools.count()

    def enqueue_dequeue(test, process):
        import random as _r
        if _r.random() < 0.5:
            return {"type": "invoke", "f": "enqueue", "value": next(enq)}
        return {"type": "invoke", "f": "dequeue", "value": None}

    return {
        "crdt-map": {
            "client": MapClient(crdt=True),
            "generator": gen.stagger(1 / 10, _add_gen()),
            "final-generator": gen.each(
                lambda: gen.once({"f": "read", "value": None})),
            "checker": set_checker(),
        },
        "map": {
            "client": MapClient(crdt=False),
            "generator": gen.stagger(1 / 10, _add_gen()),
            "final-generator": gen.each(
                lambda: gen.once({"f": "read", "value": None})),
            "checker": set_checker(),
        },
        "lock": {
            "client": LockClient(),
            "generator": _acquire_release(),
            "checker": linearizable(Mutex(), backend=backend,
                                    device=device),
            "model": Mutex(),
        },
        "queue": {
            "client": HZQueueClient(),
            "generator": enqueue_dequeue,
            "final-generator": gen.each(
                lambda: gen.once({"f": "drain", "value": None})),
            "checker": total_queue(),
            "model": UnorderedQueue(),
        },
        "atomic-ref-ids": {
            "client": RefIdClient(),
            "generator": gen.stagger(1, {"f": "generate"}),
            "checker": unique_ids(),
        },
        "atomic-long-ids": {
            "client": IdClient(),
            "generator": gen.stagger(1, {"f": "generate"}),
            "checker": unique_ids(),
        },
        "id-gen-ids": {
            "client": GenIdClient(),
            "generator": gen.gen({"f": "generate"}),
            "checker": unique_ids(),
        },
    }


def hazelcast_test(opts: dict) -> dict:
    """Workload-selected test (hazelcast.clj:401-432)."""
    name = opts.get("workload", "lock")
    w = workloads(opts.get("backend", "gpu"), opts.get("device"))[name]
    test = noop_test()
    phases = [gen.time_limit(
        opts.get("time-limit", 60),
        gen.clients(w["generator"], gen.seq(_nemesis_cycle())))]
    if w.get("final-generator") is not None:
        phases += [gen.nemesis(gen.once({"type": "info", "f": "stop"})),
                   gen.sleep(5),
                   gen.clients(w["final-generator"])]
    test.update({
        "name": f"hazelcast-{name}",
        "db": HazelcastDB(),
        "client": w["client"],
        "nemesis": nemesis.partition_majorities_ring(),
        "model": w.get("model"),
        "checker": compose({"workload": w["checker"]}),
        "generator": gen.phases(*phases),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


def _nemesis_cycle():
    while True:
        yield gen.sleep(15)
        yield gen.once({"type": "info", "f": "start"})
        yield gen.sleep(15)
        yield gen.once({"type": "info", "f": "stop"})


def main(argv=None):
    """The reference's command line: ``test`` runs :func:`hazelcast_test`
    with the ``--workload`` bundle (default: lock); ``serve`` the results
    browser."""
    from jepsen_tpu_torch import cli

    def opt_spec(p):
        p.add_argument("--workload", default="lock",
                       choices=sorted(workloads()))

    cli.main(cli.merge_commands(
        cli.single_test_cmd(hazelcast_test, opt_spec=opt_spec),
        cli.serve_cmd()), argv)


if __name__ == "__main__":
    main()
