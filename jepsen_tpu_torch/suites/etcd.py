"""etcd suite — the canonical CAS-register test.

Rebuild of etcd/src/jepsen/etcd.clj: install + run an etcd cluster over the
control plane, drive independent CAS registers through etcd's HTTP v2 keys
API, partition the network with random halves, and check per-key
linearizability (10 threads/key, 1/30 s stagger, 300 ops/key — the shapes
at etcd.clj:167-179).

The HTTP client uses only the stdlib (urllib) — the data plane is etcd's
wire API, not SSH (SURVEY §3.2: CONTROL->DB boundary).

The port's copy of ``jepsen_tpu.suites.etcd``, with one difference:
the linearizability check runs on the card (``backend`` "gpu", the
default) unless the options name the CPU (``backend: "cpu"`` for the host
search, ``device: "cpu"`` for the kernels' plain versions).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Optional

from jepsen_tpu_torch import client as client_ns
from jepsen_tpu_torch import db as db_ns
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import independent, nemesis
from jepsen_tpu_torch.checker import compose, perf
from jepsen_tpu_torch.checker.wgl import linearizable
from jepsen_tpu_torch.control import util as cu
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.suites import workloads as wl
from jepsen_tpu_torch.testing import noop_test

VERSION = "v3.1.5"
DIR = "/opt/etcd"
LOGFILE = f"{DIR}/etcd.log"
PIDFILE = f"{DIR}/etcd.pid"
CLIENT_PORT = 2379
PEER_PORT = 2380


def peer_url(node) -> str:
    return f"http://{node}:{PEER_PORT}"


def client_url(node) -> str:
    node = str(node)
    if ":" in node:  # host:port node names (local fakes, port-forwards)
        return f"http://{node}"
    return f"http://{node}:{CLIENT_PORT}"


def initial_cluster(test: dict) -> str:
    """node1=http://node1:2380,... (etcd.clj db initial-cluster)."""
    return ",".join(f"{n}={peer_url(n)}" for n in test["nodes"])


class EtcdDB(db_ns.DB, db_ns.LogFiles):
    """etcd lifecycle: tarball install, daemonized start with static
    bootstrap, teardown wipes the data dir (etcd.clj db)."""

    def __init__(self, version: str = VERSION):
        self.version = version

    def tarball_url(self) -> str:
        return (f"https://storage.googleapis.com/etcd/{self.version}/"
                f"etcd-{self.version}-linux-amd64.tar.gz")

    def setup(self, test, node):
        cu.install_archive(test, node, test.get("tarball",
                                                self.tarball_url()), DIR)
        cu.start_daemon(
            test, node, f"{DIR}/etcd",
            "--name", str(node),
            "--listen-peer-urls", peer_url(node),
            "--listen-client-urls", f"http://0.0.0.0:{CLIENT_PORT}",
            "--advertise-client-urls", client_url(node),
            "--initial-cluster-state", "new",
            "--initial-advertise-peer-urls", peer_url(node),
            "--initial-cluster", initial_cluster(test),
            logfile=LOGFILE, pidfile=PIDFILE, chdir=DIR)

    def teardown(self, test, node):
        cu.stop_daemon(test, node, PIDFILE, cmd="etcd")
        from jepsen_tpu_torch import control
        control.exec(test, node, "rm", "-rf", f"{DIR}/default.etcd",
                     LOGFILE)

    def log_files(self, test, node):
        return [LOGFILE]


class EtcdClient(client_ns.Client):
    """CAS register over etcd's HTTP v2 keys API. Values are [k v] tuples
    from the independent generator; error taxonomy follows
    etcd.clj:100-135: reads crash as fail (they can be retried safely),
    writes/cas crash as info (indeterminate)."""

    def __init__(self, node=None, timeout: float = 5.0):
        self.node = node
        self.timeout = timeout

    def open(self, test, node):
        return EtcdClient(node, self.timeout)

    def _key_url(self, k) -> str:
        return (f"{client_url(self.node)}/v2/keys/"
                f"{urllib.parse.quote(str(k))}")

    def _request(self, url: str, method: str = "GET",
                 data: Optional[dict] = None):
        body = urllib.parse.urlencode(data).encode() if data else None
        req = urllib.request.Request(url, data=body, method=method)
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read().decode())

    def invoke(self, test, op: Op) -> Op:
        k, v = op.value
        crash = "fail" if op.f == "read" else "info"
        try:
            if op.f == "read":
                out = self._request(self._key_url(k) + "?quorum=false")
                value = out.get("node", {}).get("value")
                value = int(value) if value is not None else None
                return op.replace(type="ok",
                                  value=independent.tuple_(k, value))
            if op.f == "write":
                self._request(self._key_url(k), "PUT", {"value": v})
                return op.replace(type="ok")
            if op.f == "cas":
                old, new = v
                try:
                    self._request(self._key_url(k), "PUT",
                                  {"value": new, "prevValue": old,
                                   "prevExist": "true"})
                    return op.replace(type="ok")
                except urllib.error.HTTPError as e:
                    if e.code in (404, 412):  # missing key / cas mismatch
                        return op.replace(type="fail")
                    raise
            raise ValueError(f"unknown op {op.f!r}")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return op.replace(type="fail", error="not-found")
            return op.replace(type=crash, error=f"http-{e.code}")
        except (TimeoutError, OSError) as e:
            return op.replace(type=crash, error=f"{type(e).__name__}")


def etcd_test(opts: dict) -> dict:
    """The canonical test map (etcd.clj:148-180)."""
    test = noop_test()
    test.update({
        "name": "etcd",
        "db": EtcdDB(opts.get("version", VERSION)),
        "client": EtcdClient(),
        "nemesis": nemesis.partition_random_halves(),
        "model": CASRegister(),
        "checker": compose({
            "perf": perf(),
            "indep": independent.checker(
                linearizable(CASRegister(),
                             backend=opts.get("backend", "gpu"),
                             device=opts.get("device"))),
        }),
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(
                independent.concurrent_generator(
                    opts.get("threads-per-key", 10),
                    _keys(),
                    lambda k: gen.limit(opts.get("ops-per-key", 300),
                                        gen.stagger(1 / 30,
                                                    wl.register_gen()))),
                gen.seq(_nemesis_cycle()))),
    })
    if opts.get("os") == "debian":
        from jepsen_tpu_torch.os import debian
        test["os"] = debian.os()
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


def _keys():
    import itertools
    return itertools.count()


def _nemesis_cycle():
    """sleep 5 / start / sleep 5 / stop forever (etcd.clj:174-178)."""
    while True:
        yield gen.sleep(5)
        yield gen.once({"type": "info", "f": "start"})
        yield gen.sleep(5)
        yield gen.once({"type": "info", "f": "stop"})


def main(argv=None):
    """The reference's command line: ``test`` runs :func:`etcd_test`,
    ``serve`` the results browser (``python -m
    jepsen_tpu_torch.suites.etcd test|serve ...``)."""
    from jepsen_tpu_torch import cli
    cli.main(cli.merge_commands(cli.single_test_cmd(etcd_test),
                                cli.serve_cmd()), argv)


if __name__ == "__main__":
    main()
