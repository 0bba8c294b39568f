"""Consul suite — CAS register over the HTTP KV API.

Rebuild of consul/src/jepsen/consul.clj: single-register CAS via consul's
index-based check-and-set (consul.clj:102-145) — a read returns
(value, ModifyIndex); cas re-reads, compares the value, and PUTs with
?cas=<index>. Values ride as JSON.

The port's copy of ``jepsen_tpu.suites.consul``, with one difference:
the linearizability check runs on the card (``backend`` "gpu", the
default) unless the options name the CPU (``backend: "cpu"`` for the host
search, ``device: "cpu"`` for the kernels' plain versions).
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request
from typing import Any, Optional, Tuple

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
from jepsen_tpu_torch.suites import workloads as wl
from jepsen_tpu_torch.testing import noop_test

KEY = "jepsen"
PORT = 8500
PIDFILE = "/var/run/consul.pid"
LOGFILE = "/var/log/consul.log"
DIR = "/opt/consul"


def kv_url(node, key: str = KEY) -> str:
    node = str(node)
    authority = node if ":" in node else f"{node}:{PORT}"
    return f"http://{authority}/v1/kv/{key}"


class ConsulDB(db_ns.DB, db_ns.LogFiles):
    """consul agent -server with bootstrap-expect = cluster size
    (consul.clj db)."""

    def __init__(self, version: str = "0.5.2"):
        self.version = version

    def setup(self, test, node):
        url = test.get(
            "tarball",
            f"https://releases.hashicorp.com/consul/{self.version}/"
            f"consul_{self.version}_linux_amd64.zip")
        cu.install_archive(test, node, url, DIR)
        nodes = test["nodes"]
        join = " ".join(f"-retry-join {n}" for n in nodes if n != node)
        cu.start_daemon(
            test, node, f"{DIR}/consul",
            "agent", "-server", "-data-dir", "/var/lib/consul",
            "-bind", str(node), "-client", "0.0.0.0",
            "-bootstrap-expect", len(nodes), *join.split(),
            logfile=LOGFILE, pidfile=PIDFILE, chdir=DIR)

    def teardown(self, test, node):
        cu.stop_daemon(test, node, PIDFILE, cmd="consul")
        control.exec(test, node, "rm", "-rf", "/var/lib/consul", LOGFILE)

    def log_files(self, test, node):
        return [LOGFILE]


class ConsulClient(client_ns.Client):
    """Index-based CAS register (consul.clj:95-145)."""

    def __init__(self, node=None, timeout: float = 5.0):
        self.node = node
        self.timeout = timeout

    def open(self, test, node):
        return ConsulClient(node, self.timeout)

    def setup(self, test):
        self._put(kv_url(test["nodes"][0]), json.dumps(None))

    def _request(self, url: str, method: str = "GET",
                 body: Optional[bytes] = None):
        req = urllib.request.Request(url, data=body, method=method)
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return resp.read()

    def _put(self, url: str, value: str) -> bool:
        out = self._request(url, "PUT", value.encode())
        return out.strip() == b"true"

    def _get(self) -> Tuple[Any, int]:
        """-> (decoded value, modify index); raises on missing key."""
        raw = self._request(kv_url(self.node))
        row = json.loads(raw.decode())[0]
        encoded = row.get("Value")
        value = (json.loads(base64.b64decode(encoded).decode())
                 if encoded else None)
        return value, row["ModifyIndex"]

    def invoke(self, test, op: Op) -> Op:
        crash = "fail" if op.f == "read" else "info"
        try:
            if op.f == "read":
                value, _ = self._get()
                return op.replace(type="ok", value=value)
            if op.f == "write":
                ok = self._put(kv_url(self.node), json.dumps(op.value))
                return op.replace(type="ok" if ok else "fail")
            if op.f == "cas":
                old, new = op.value
                value, index = self._get()
                if value != old:
                    return op.replace(type="fail")
                ok = self._put(kv_url(self.node) + f"?cas={index}",
                               json.dumps(new))
                return op.replace(type="ok" if ok else "fail")
            raise ValueError(f"unknown op {op.f!r}")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return op.replace(type="fail", error="no-key")
            return op.replace(type=crash, error=f"http-{e.code}")
        except (TimeoutError, OSError) as e:
            return op.replace(type=crash, error=type(e).__name__)


def consul_test(opts: dict) -> dict:
    test = noop_test()
    test.update({
        "name": "consul",
        "db": ConsulDB(),
        "client": ConsulClient(),
        "nemesis": nemesis.partition_random_halves(),
        "model": CASRegister(),
        "checker": compose({
            "perf": perf(),
            "linear": linearizable(CASRegister(),
                                   backend=opts.get("backend", "gpu"),
                                   device=opts.get("device")),
        }),
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(gen.stagger(1 / 10, wl.register_gen()))),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


def main(argv=None):
    """The reference's command line: ``test`` runs :func:`consul_test`,
    ``serve`` the results browser (``python -m
    jepsen_tpu_torch.suites.consul test|serve ...``)."""
    from jepsen_tpu_torch import cli
    cli.main(cli.merge_commands(cli.single_test_cmd(consul_test),
                                cli.serve_cmd()), argv)


if __name__ == "__main__":
    main()
