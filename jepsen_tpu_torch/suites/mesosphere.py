"""Mesosphere (mesos) cluster DB — the scheduler substrate for chronos.

Rebuild of chronos/src/jepsen/mesosphere.clj: a ZooKeeper ensemble
(mesosphere.clj:136-140 composes jepsen.zookeeper's db), the mesosphere
apt repo + mesos package (install! 26-36), /etc/mesos/zk + master quorum
config (configure! 48-57), and mesos-master on the first ``MASTER_COUNT``
sorted nodes / mesos-slave on the rest, both under start-stop-daemon
(start-master! 59-89, start-slave! 91-121). Teardown killall -9s both and
clears work/log dirs (stop-master!/stop-slave!/db 123-166).

The port's copy of ``jepsen_tpu.suites.mesosphere``, on the port's
control plane, its Debian support and zookeeper's ``ZKDB``. It has no
``SUITES`` row of its own: chronos starts it."""

from __future__ import annotations

from typing import List

from jepsen_tpu_torch import control
from jepsen_tpu_torch import db as db_ns
from jepsen_tpu_torch.control import util as cu
from jepsen_tpu_torch.os import debian
from jepsen_tpu_torch.suites.zookeeper import ZKDB
from jepsen_tpu_torch.util import majority

#: How many master nodes should we run? (mesosphere.clj:17)
MASTER_COUNT = 3

MASTER_PIDFILE = "/var/run/mesos/master.pid"
SLAVE_PIDFILE = "/var/run/mesos/slave.pid"
MASTER_DIR = "/var/lib/mesos/master"
SLAVE_DIR = "/var/lib/mesos/slave"
LOG_DIR = "/var/log/mesos"
MASTER_BIN = "/usr/sbin/mesos-master"
SLAVE_BIN = "/usr/sbin/mesos-slave"


def zk_uri(test: dict) -> str:
    """zk://n1:2181,...,n5:2181/mesos (mesosphere.clj:38-46)."""
    hosts = ",".join(f"{n}:2181" for n in test["nodes"])
    return f"zk://{hosts}/mesos"


def master_nodes(test: dict) -> List:
    """The first MASTER_COUNT sorted nodes run masters
    (mesosphere.clj:66-67); the rest run slaves (98-99)."""
    return sorted(test["nodes"], key=str)[:MASTER_COUNT]


def is_master(test: dict, node) -> bool:
    return node in master_nodes(test)


def install(test, node, version: str) -> None:
    """Mesosphere apt repo + mesos package + dirs (mesosphere.clj:26-36)."""
    debian.add_repo(test, node, "mesosphere",
                    "deb http://repos.mesosphere.io/debian wheezy main",
                    keyserver="keyserver.ubuntu.com", key="E56151BF")
    debian.install(test, node, {"mesos": version})
    with control.sudo():
        for d in ("/var/run/mesos", MASTER_DIR, SLAVE_DIR):
            control.exec(test, node, "mkdir", "-p", d)


def configure(test, node) -> None:
    """Write /etc/mesos/zk and the master quorum (mesosphere.clj:48-57) —
    mesos itself is started by hand, but chronos reads these files."""
    with control.sudo():
        control.execute(
            test, node,
            f"echo {control.escape(zk_uri(test))} > /etc/mesos/zk")
        control.execute(
            test, node,
            f"echo {majority(MASTER_COUNT)} > /etc/mesos-master/quorum")


def start_master(test, node) -> None:
    """mesos-master under start-stop-daemon, GLOG_v=1, quorum wired to the
    ZK ensemble (mesosphere.clj:59-89). No-op on slave nodes."""
    if not is_master(test, node):
        return
    with control.sudo():
        cu.start_daemon(
            test, node, "/usr/bin/env",
            "GLOG_v=1", MASTER_BIN,
            f"--hostname={node}",
            f"--log_dir={LOG_DIR}",
            f"--quorum={majority(MASTER_COUNT)}",
            "--registry_fetch_timeout=120secs",
            "--registry_store_timeout=5secs",
            f"--work_dir={MASTER_DIR}",
            "--offer_timeout=30secs",
            f"--zk={zk_uri(test)}",
            logfile=f"{LOG_DIR}/master.stdout",
            pidfile=MASTER_PIDFILE,
            chdir=MASTER_DIR)


def start_slave(test, node) -> None:
    """mesos-slave on non-master nodes (mesosphere.clj:91-121)."""
    if is_master(test, node):
        return
    with control.sudo():
        cu.start_daemon(
            test, node, SLAVE_BIN,
            f"--hostname={node}",
            f"--log_dir={LOG_DIR}",
            "--recovery_timeout=30secs",
            f"--work_dir={SLAVE_DIR}",
            f"--master={zk_uri(test)}",
            logfile=f"{LOG_DIR}/slave.stdout",
            pidfile=SLAVE_PIDFILE,
            chdir=SLAVE_DIR)


def stop_master(test, node) -> None:
    """killall -9 mesos-master + pidfile cleanup (mesosphere.clj:123-127)."""
    with control.sudo():
        cu.stop_daemon(test, node, MASTER_PIDFILE, cmd="mesos-master")


def stop_slave(test, node) -> None:
    with control.sudo():
        cu.stop_daemon(test, node, SLAVE_PIDFILE, cmd="mesos-slave")


class MesosDB(db_ns.DB, db_ns.LogFiles):
    """The composed cluster DB (mesosphere.clj:129-166): ZK ensemble under
    a mesos master/slave split."""

    def __init__(self, version: str = "0.23.0-1.0.debian81",
                 zk_version: str = "3.4.5+dfsg-2"):
        self.version = version
        self.zk = ZKDB(zk_version)

    def setup(self, test, node):
        self.zk.setup(test, node)
        install(test, node, self.version)
        configure(test, node)
        start_master(test, node)
        start_slave(test, node)

    def teardown(self, test, node):
        stop_slave(test, node)
        stop_master(test, node)
        with control.sudo():
            control.execute(test, node,
                            f"rm -rf {MASTER_DIR}/* {SLAVE_DIR}/* "
                            f"{LOG_DIR}/*")
        self.zk.teardown(test, node)

    def log_files(self, test, node):
        try:
            logs = cu.ls_full(test, node, LOG_DIR)
        except control.RemoteError:
            logs = []
        return self.zk.log_files(test, node) + logs
