"""ZooKeeper suite — CAS register over a ZK ensemble.

Rebuild of zookeeper/src/jepsen/zookeeper.clj: apt-installed ensemble with
per-node myid + zoo.cfg server lines (zookeeper.clj:20-71), a single
``/jepsen`` register driven with version-checked sets (the reference uses
an avout distributed atom; ZK's conditional ``set -v <version>`` is the
same primitive), random-halves partitions, linearizability against
CASRegister(0).

The port's copy of ``jepsen_tpu.suites.zookeeper``, with one difference:
the linearizability check runs on the card (``backend`` "gpu", the
default) unless the options name the CPU (``backend: "cpu"`` for the host
search, ``device: "cpu"`` for the kernels' plain versions).
"""

from __future__ import annotations

import re
from typing import Optional

from jepsen_tpu_torch import client as client_ns
from jepsen_tpu_torch import control
from jepsen_tpu_torch import db as db_ns
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import nemesis
from jepsen_tpu_torch.checker import compose, perf
from jepsen_tpu_torch.checker.wgl import linearizable
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.os import debian
from jepsen_tpu_torch.suites import workloads as wl
from jepsen_tpu_torch.testing import noop_test

VERSION = "3.4.5+dfsg-2"
ZKCLI = "/usr/share/zookeeper/bin/zkCli.sh"
ZNODE = "/jepsen"

ZOO_CFG = """tickTime=2000
initLimit=10
syncLimit=5
dataDir=/var/lib/zookeeper
clientPort=2181
"""


def node_ids(test: dict) -> dict:
    """node -> integer id (zookeeper.clj:19-25)."""
    return {n: i for i, n in enumerate(test["nodes"])}


def zoo_cfg_servers(test: dict) -> str:
    """server.<id>=<node>:2888:3888 lines (zookeeper.clj:32-38)."""
    return "\n".join(f"server.{i}={n}:2888:3888"
                     for n, i in node_ids(test).items())


class ZKDB(db_ns.DB, db_ns.LogFiles):
    def __init__(self, version: str = VERSION):
        self.version = version

    def setup(self, test, node):
        debian.install(test, node, {"zookeeper": self.version,
                                    "zookeeper-bin": self.version,
                                    "zookeeperd": self.version})
        with control.sudo():
            control.execute(
                test, node,
                f"echo {node_ids(test)[node]} > /etc/zookeeper/conf/myid")
            cfg = ZOO_CFG + zoo_cfg_servers(test) + "\n"
            control.execute(
                test, node,
                f"echo {control.escape(cfg)} > /etc/zookeeper/conf/zoo.cfg")
            control.exec(test, node, "service", "zookeeper", "restart")

    def teardown(self, test, node):
        with control.sudo():
            control.exec(test, node, "service", "zookeeper", "stop")
            control.execute(test, node,
                            "rm -rf /var/lib/zookeeper/version-* "
                            "/var/log/zookeeper/*")

    def log_files(self, test, node):
        return ["/var/log/zookeeper/zookeeper.log"]


class ZKClient(client_ns.Client):
    """Versioned CAS over zkCli: reads parse dataVersion, cas does a
    conditional ``set <path> <new> <version>`` which ZK rejects (exit
    nonzero, 'version No is not valid') when the version moved."""

    def __init__(self, node=None, timeout: float = 5.0):
        self.node = node
        self.timeout = timeout

    def open(self, test, node):
        return ZKClient(node, self.timeout)

    def setup(self, test):
        # the register exists with initial value 0 (model CASRegister(0))
        node = test["nodes"][0]
        try:
            self._cli(test, node, f"create {ZNODE} 0")
        except control.RemoteError:
            pass

    def _cli(self, test, node, command: str) -> str:
        return control.execute(
            test, node,
            f"{ZKCLI} -server {node}:2181 {control.escape(command)}")

    def _get(self, test) -> Optional[tuple]:
        """-> (value, version)."""
        out = self._cli(test, self.node, f"get {ZNODE}")
        m = re.search(r"dataVersion = (\d+)", out)
        if not m:
            return None
        lines = [ln for ln in out.splitlines()
                 if ln and not re.match(r"^[a-zA-Z]+ =|^\[|^Connecting|"
                                        r"^Welcome|^JLine|^WATCHER|^\d{4}-",
                                        ln)]
        value = None
        if lines:
            try:
                value = int(lines[-1].strip())
            except ValueError:
                value = None
        return value, int(m.group(1))

    def invoke(self, test, op: Op) -> Op:
        crash = "fail" if op.f == "read" else "info"
        try:
            if op.f == "read":
                got = self._get(test)
                if got is None:
                    return op.replace(type="fail", error="no-node")
                return op.replace(type="ok", value=got[0])
            if op.f == "write":
                self._cli(test, self.node, f"set {ZNODE} {op.value}")
                return op.replace(type="ok")
            if op.f == "cas":
                old, new = op.value
                got = self._get(test)
                if got is None or got[0] != old:
                    return op.replace(type="fail")
                try:
                    self._cli(test, self.node,
                              f"set {ZNODE} {new} {got[1]}")
                    return op.replace(type="ok")
                except control.RemoteError:
                    return op.replace(type="fail")
            raise ValueError(f"unknown op {op.f!r}")
        except control.RemoteError as e:
            return op.replace(type=crash, error=str(e)[:100])


def zk_test(opts: dict) -> dict:
    """The test map (zookeeper.clj:106-129)."""
    test = noop_test()
    test.update({
        "name": "zookeeper",
        "os": debian.os(),
        "db": ZKDB(opts.get("version", VERSION)),
        "client": ZKClient(),
        "nemesis": nemesis.partition_random_halves(),
        "model": CASRegister(0),
        "checker": compose({
            "perf": perf(),
            "linear": linearizable(CASRegister(0),
                                   backend=opts.get("backend", "gpu"),
                                   device=opts.get("device")),
        }),
        "generator": gen.time_limit(
            opts.get("time-limit", 15),
            gen.clients(
                gen.stagger(1, wl.register_gen()),
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
    """The reference's command line: ``test`` runs :func:`zk_test`,
    ``serve`` the results browser (``python -m
    jepsen_tpu_torch.suites.zookeeper test|serve ...``)."""
    from jepsen_tpu_torch import cli
    cli.main(cli.merge_commands(cli.single_test_cmd(zk_test),
                                cli.serve_cmd()), argv)


if __name__ == "__main__":
    main()
