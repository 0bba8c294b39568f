"""Raftis suite — a linearizable register over redis protocol + raft.

Rebuild of raftis/src/jepsen/raftis.clj: tarball install, cluster-string
startup, read/write register workload against CASRegister(0) with
random-halves partitions (raftis.clj:60-131). The client speaks RESP
directly (GET/SET); cas is additionally supported via WATCH/MULTI/EXEC
for redis-compatible servers that offer it.

The port's copy of ``jepsen_tpu.suites.raftis``, with one difference:
the linearizability check runs on the card (``backend`` "gpu", the
default) unless the options name the CPU (``backend: "cpu"`` for the host
search, ``device: "cpu"`` for the kernels' plain versions).
"""

from __future__ import annotations

from typing import Optional

from jepsen_tpu_torch import client as client_ns
from jepsen_tpu_torch import control
from jepsen_tpu_torch import db as db_ns
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import nemesis
from jepsen_tpu_torch.checker import compose, perf
from jepsen_tpu_torch.checker.wgl import linearizable
from jepsen_tpu_torch.control import util as cu
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.suites.resp import RespClient, RespError
from jepsen_tpu_torch.suites import workloads as wl
from jepsen_tpu_torch.testing import noop_test

DIR = "/opt/raftis"
LOGFILE = f"{DIR}/raftis.log"
PIDFILE = f"{DIR}/raftis.pid"
RAFT_PORT = 8901
CLIENT_PORT = 6379
KEY = "jepsen"


def initial_cluster(test: dict) -> str:
    """host:8901,host:8901,... (raftis.clj:66-74)."""
    return ",".join(f"{n}:{RAFT_PORT}" for n in test["nodes"])


class RaftisDB(db_ns.DB, db_ns.LogFiles):
    def __init__(self, version: str = "v2.0.4"):
        self.version = version

    def setup(self, test, node):
        url = test.get(
            "tarball",
            f"https://github.com/Qihoo360/floyd/releases/download/"
            f"{self.version}/raftis-{self.version}.tar.gz")
        cu.install_archive(test, node, url, DIR)
        cu.start_daemon(test, node, f"{DIR}/raftis",
                        initial_cluster(test), str(node), RAFT_PORT,
                        "data", CLIENT_PORT,
                        logfile=LOGFILE, pidfile=PIDFILE, chdir=DIR)

    def teardown(self, test, node):
        cu.stop_daemon(test, node, PIDFILE, cmd="raftis")
        control.exec(test, node, "rm", "-rf", DIR)

    def log_files(self, test, node):
        return [f"{DIR}/data/LOG"]


class RaftisClient(client_ns.Client):
    def __init__(self, node=None, timeout: float = 5.0):
        self.node = node
        self.timeout = timeout
        self.conn: Optional[RespClient] = None

    def open(self, test, node):
        c = RaftisClient(node, self.timeout)
        host, port = (node.rsplit(":", 1) if ":" in str(node)
                      else (str(node), CLIENT_PORT))
        c.conn = RespClient(host, int(port), self.timeout)
        return c

    def close(self, test):
        if self.conn:
            self.conn.close()

    def invoke(self, test, op: Op) -> Op:
        crash = "fail" if op.f == "read" else "info"
        try:
            if op.f == "read":
                v = self.conn.execute("GET", KEY)
                return op.replace(type="ok",
                                  value=int(v) if v is not None else None)
            if op.f == "write":
                self.conn.execute("SET", KEY, op.value)
                return op.replace(type="ok")
            if op.f == "cas":
                old, new = op.value
                self.conn.execute("WATCH", KEY)
                cur = self.conn.execute("GET", KEY)
                if cur is None or int(cur) != old:
                    self.conn.execute("UNWATCH")
                    return op.replace(type="fail")
                out = self.conn.execute_many(
                    [("MULTI",), ("SET", KEY, new), ("EXEC",)])
                return op.replace(
                    type="ok" if out[-1] is not None else "fail")
            raise ValueError(f"unknown op {op.f!r}")
        except RespError as e:
            return op.replace(type=crash, error=str(e)[:80])
        except (TimeoutError, OSError) as e:
            if self.conn:
                self.conn.close()
            return op.replace(type=crash, error=type(e).__name__)


def r_w_gen():
    """Reads and writes only (raftis.clj:121-123 uses gen/mix [r w])."""
    return gen.mix([wl.r, wl.w])


def raftis_test(opts: dict) -> dict:
    test = noop_test()
    test.update({
        "name": "raftis",
        "db": RaftisDB(),
        "client": RaftisClient(),
        "nemesis": nemesis.partition_random_halves(),
        "model": CASRegister(0),
        "checker": compose({
            "perf": perf(),
            "linear": linearizable(CASRegister(0),
                                   backend=opts.get("backend", "gpu"),
                                   device=opts.get("device")),
        }),
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(gen.stagger(1 / 10, r_w_gen()),
                        gen.seq(_nemesis_cycle()))),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


def _nemesis_cycle():
    while True:
        yield gen.sleep(5)
        yield gen.once({"type": "info", "f": "start"})
        yield gen.sleep(5)
        yield gen.once({"type": "info", "f": "stop"})


def main(argv=None):
    """The reference's command line: ``test`` runs :func:`raftis_test`,
    ``serve`` the results browser (``python -m
    jepsen_tpu_torch.suites.raftis test|serve ...``)."""
    from jepsen_tpu_torch import cli
    cli.main(cli.merge_commands(cli.single_test_cmd(raftis_test),
                                cli.serve_cmd()), argv)


if __name__ == "__main__":
    main()
