"""Disque suite — distributed message queue.

Rebuild of disque/src/jepsen/disque.clj: jobs added with replication 3 /
retry 1, payloads through the codec (disque.clj:305-310), total-queue
checking. The client speaks the disque RESP protocol directly
(ADDJOB/GETJOB/ACKJOB); drains write their dequeue completions straight
into the live history the way the reference's drain loop does
(disque.clj:219-243). The port's copy of
``jepsen_tpu.suites.disque``."""

from __future__ import annotations

from typing import Optional

from jepsen_tpu_torch import codec, control, core
from jepsen_tpu_torch import client as client_ns
from jepsen_tpu_torch import db as db_ns
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import nemesis
from jepsen_tpu_torch.checker import compose, total_queue
from jepsen_tpu_torch.checker.perf import latency_graph
from jepsen_tpu_torch.control import util as cu
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.models import UnorderedQueue
from jepsen_tpu_torch.suites.resp import RespClient, RespError
from jepsen_tpu_torch.testing import noop_test
from jepsen_tpu_torch.util import relative_time_nanos

DIR = "/opt/disque"
PORT = 7711
LOGFILE = f"{DIR}/disque.log"
PIDFILE = f"{DIR}/disque.pid"
QUEUE = "jepsen"
TIMEOUT_MS = 100


def _addr(node):
    node = str(node)
    if ":" in node:
        host, port = node.rsplit(":", 1)
        return host, int(port)
    return node, PORT


class DisqueDB(db_ns.DB, db_ns.LogFiles):
    """Build from source at a pinned commit, then daemonize and join the
    cluster (disque.clj db)."""

    def __init__(self,
                 version: str = "f00dd0704128707f7a5effccd5837d796f2c01e3"):
        self.version = version

    def setup(self, test, node):
        url = test.get("tarball",
                       f"https://github.com/antirez/disque/archive/"
                       f"{self.version}.tar.gz")
        cu.install_archive(test, node, url, DIR)
        with control.cd(DIR):
            control.exec(test, node, "make")
        cu.start_daemon(test, node, f"{DIR}/src/disque-server",
                        "--port", PORT, "--logfile", LOGFILE,
                        logfile=LOGFILE, pidfile=PIDFILE, chdir=DIR)
        # meet the first node to form the cluster
        first = test["nodes"][0]
        if node != first:
            control.exec(test, node, f"{DIR}/src/disque",
                         "-p", PORT, "cluster", "meet", first, PORT)

    def teardown(self, test, node):
        cu.stop_daemon(test, node, PIDFILE, cmd="disque-server")
        control.exec(test, node, "rm", "-rf", DIR)

    def log_files(self, test, node):
        return [LOGFILE]


class DisqueClient(client_ns.Client):
    """Queue client over RESP (disque.clj:190-262)."""

    def __init__(self, node=None, replicate: int = 3, retry_s: int = 1,
                 timeout: float = 5.0):
        self.node = node
        self.replicate = replicate
        self.retry_s = retry_s
        self.timeout = timeout
        self.conn: Optional[RespClient] = None

    def open(self, test, node):
        c = DisqueClient(node, self.replicate, self.retry_s, self.timeout)
        host, port = _addr(node)
        c.conn = RespClient(host, port, self.timeout)
        return c

    def close(self, test):
        if self.conn:
            self.conn.close()

    def _enqueue(self, value) -> bool:
        out = self.conn.execute(
            "ADDJOB", QUEUE, codec.encode(value), TIMEOUT_MS,
            "REPLICATE", self.replicate, "RETRY", self.retry_s)
        return out is not None

    def _dequeue(self):
        """-> decoded value or None when empty."""
        out = self.conn.execute("GETJOB", "NOHANG", "TIMEOUT", TIMEOUT_MS,
                                "FROM", QUEUE)
        if not out:
            return None
        _q, job_id, body = out[0]
        self.conn.execute("ACKJOB", job_id)
        return codec.decode(body)

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "enqueue":
                ok = self._enqueue(op.value)
                return op.replace(type="ok" if ok else "fail")
            if op.f == "dequeue":
                v = self._dequeue()
                if v is None:
                    return op.replace(type="fail", error="empty")
                return op.replace(type="ok", value=v)
            if op.f == "drain":
                # Pull until empty, recording each dequeue as its own pair
                # in the live history (disque.clj:219-243).
                while True:
                    inv = Op(type="invoke", f="dequeue", value=None,
                             process=op.process,
                             time=relative_time_nanos())
                    core.conj_op(test, inv)
                    v = self._dequeue()
                    comp = inv.replace(
                        type="fail" if v is None else "ok", value=v,
                        time=relative_time_nanos())
                    core.conj_op(test, comp)
                    if v is None:
                        return op.replace(type="ok", value="exhausted")
            raise ValueError(f"unknown op {op.f!r}")
        except RespError as e:
            if str(e).startswith("NOREPL"):
                return op.replace(type="info", error="not-fully-replicated")
            return op.replace(type="info", error=str(e)[:80])
        except (TimeoutError, OSError) as e:
            if self.conn:
                self.conn.close()
            return op.replace(type="info", error=type(e).__name__)


def std_gen(client_gen, time_limit: float = 100):
    """The standard schedule (disque.clj:276-296): faults during the main
    phase, recover, settle, then every client drains."""
    return gen.phases(
        gen.time_limit(time_limit,
                       gen.clients(client_gen, gen.seq(_nemesis_cycle()))),
        gen.nemesis(gen.once({"type": "info", "f": "stop"})),
        gen.clients(gen.time_limit(10, client_gen)),
        gen.clients(gen.each(lambda: gen.once({"f": "drain"}))),
    )


def _nemesis_cycle():
    while True:
        yield gen.sleep(10)
        yield gen.once({"type": "info", "f": "start"})
        yield gen.sleep(10)
        yield gen.once({"type": "info", "f": "stop"})


def disque_test(opts: dict) -> dict:
    """Queue test with partitions (disque.clj:299-339)."""
    test = noop_test()
    test.update({
        "name": "disque",
        "db": DisqueDB(),
        "client": DisqueClient(),
        "nemesis": nemesis.partition_random_halves(),
        "model": UnorderedQueue(),
        "checker": compose({
            "queue": total_queue(),
            "latency": latency_graph(),
        }),
        "generator": std_gen(gen.delay(1, gen.queue_gen()),
                             opts.get("time-limit", 100)),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


def killer() -> nemesis.NodeStartStopper:
    """Kill a random node on start, restart on stop (disque.clj:266-273)."""
    return nemesis.node_start_stopper(
        lambda ns: __import__("random").choice(ns) if ns else None,
        lambda test, node: cu.stop_daemon(test, node, PIDFILE,
                                          cmd="disque-server"),
        lambda test, node: cu.start_daemon(
            test, node, f"{DIR}/src/disque-server", "--port", PORT,
            "--logfile", LOGFILE, logfile=LOGFILE, pidfile=PIDFILE,
            chdir=DIR))


def main(argv=None):
    """The reference's command line: ``test`` runs :func:`disque_test`,
    ``serve`` the results browser (``python -m
    jepsen_tpu_torch.suites.disque test|serve ...``)."""
    from jepsen_tpu_torch import cli
    cli.main(cli.merge_commands(cli.single_test_cmd(disque_test),
                                cli.serve_cmd()), argv)


if __name__ == "__main__":
    main()
