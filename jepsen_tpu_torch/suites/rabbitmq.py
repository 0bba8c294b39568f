"""RabbitMQ suite — mirrored queue + distributed semaphore.

Rebuild of rabbitmq/src/jepsen/rabbitmq.clj: a durable queue with
publisher confirms (enqueue acks only after broker confirmation,
rabbitmq.clj:148-166), fail-safe dequeues, drains that write completions
directly into the live history (168-181), plus the semaphore/mutex
workload built from a single queued token (186-260). The data plane is
the RabbitMQ management HTTP API (publish with routed=true as the
confirm signal; get with ack mode) — the reference uses AMQP via langohr,
same observable semantics at the queue level.

The port's copy of ``jepsen_tpu.suites.rabbitmq``, with one difference:
the linearizability check (the mutex test's) runs on the card (``backend``
"gpu", the default) unless the options name the CPU (``backend:
"cpu"`` for the host search, ``device: "cpu"`` for the kernels' plain
versions).
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request
from typing import Any, Optional

from jepsen_tpu_torch import codec, control, core
from jepsen_tpu_torch import client as client_ns
from jepsen_tpu_torch import db as db_ns
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import nemesis
from jepsen_tpu_torch.checker import compose, total_queue
from jepsen_tpu_torch.checker.wgl import linearizable
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.models import Mutex, UnorderedQueue
from jepsen_tpu_torch.os import debian
from jepsen_tpu_torch.testing import noop_test
from jepsen_tpu_torch.util import relative_time_nanos

QUEUE = "jepsen.queue"
SEMAPHORE = "jepsen.semaphore"
MGMT_PORT = 15672
VHOST = "%2f"


def _mgmt(node, path: str) -> str:
    node = str(node)
    authority = node if ":" in node else f"{node}:{MGMT_PORT}"
    return f"http://{authority}/api/{path}"


class RabbitDB(db_ns.DB, db_ns.LogFiles):
    """apt install + mirrored-queue ha policy (rabbitmq.clj:55-84)."""

    def setup(self, test, node):
        debian.install(test, node, ["rabbitmq-server"])
        with control.sudo():
            control.exec(test, node, "service", "rabbitmq-server", "start")
            control.exec(test, node, "rabbitmq-plugins", "enable",
                         "rabbitmq_management")
            if node == test["nodes"][0]:
                control.exec(
                    test, node, "rabbitmqctl", "set_policy", "ha-maj",
                    "jepsen.", control.Lit(
                        "'{\"ha-mode\": \"exactly\", \"ha-params\": 3, "
                        "\"ha-sync-mode\": \"automatic\"}'"))

    def teardown(self, test, node):
        with control.sudo():
            control.execute(test, node,
                            "rabbitmqctl stop_app || true")
            control.execute(test, node,
                            "service rabbitmq-server stop || true")

    def log_files(self, test, node):
        return [f"/var/log/rabbitmq/rabbit@{node}.log"]


class RabbitClient(client_ns.Client):
    def __init__(self, node=None, timeout: float = 5.0,
                 user: str = "guest", password: str = "guest"):
        self.node = node
        self.timeout = timeout
        self.auth = base64.b64encode(
            f"{user}:{password}".encode()).decode()

    def _request(self, url: str, method: str = "GET",
                 payload: Optional[dict] = None) -> Any:
        body = json.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(url, data=body, method=method)
        req.add_header("Authorization", f"Basic {self.auth}")
        req.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            data = resp.read()
            return json.loads(data.decode()) if data.strip() else None


class QueueClient(RabbitClient):
    """Queue ops with publisher confirms (rabbitmq.clj:126-181)."""

    def open(self, test, node):
        c = QueueClient(node, self.timeout)
        try:
            c._request(_mgmt(node, f"queues/{VHOST}/{QUEUE}"), "PUT",
                       {"durable": True, "auto_delete": False})
        except (urllib.error.URLError, OSError):
            pass
        return c

    def _enqueue(self, value) -> bool:
        out = self._request(
            _mgmt(self.node, f"exchanges/{VHOST}/amq.default/publish"),
            "POST",
            {"routing_key": QUEUE, "payload":
             codec.encode(value).decode(), "payload_encoding": "string",
             "properties": {"delivery_mode": 2}})
        # routed=false means the broker did NOT take responsibility —
        # the publisher-confirm failure case
        return bool(out and out.get("routed"))

    def _dequeue(self):
        out = self._request(
            _mgmt(self.node, f"queues/{VHOST}/{QUEUE}/get"), "POST",
            {"count": 1, "ackmode": "ack_requeue_false",
             "encoding": "auto"})
        if not out:
            return None
        return codec.decode(out[0]["payload"].encode())

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "enqueue":
                ok = self._enqueue(op.value)
                return op.replace(type="ok" if ok else "fail")
            if op.f == "dequeue":
                v = self._dequeue()
                if v is None:
                    return op.replace(type="fail", error="exhausted")
                return op.replace(type="ok", value=v)
            if op.f == "drain":
                while True:
                    inv = Op(type="invoke", f="dequeue", value=None,
                             process=op.process,
                             time=relative_time_nanos())
                    core.conj_op(test, inv)
                    v = self._dequeue()
                    core.conj_op(test, inv.replace(
                        type="fail" if v is None else "ok", value=v,
                        time=relative_time_nanos()))
                    if v is None:
                        return op.replace(type="ok", value="exhausted")
            raise ValueError(f"unknown op {op.f!r}")
        except urllib.error.HTTPError as e:
            return op.replace(type="fail" if op.f != "enqueue" else "info",
                              error=f"http-{e.code}")
        except (TimeoutError, OSError) as e:
            # All transport errors are indeterminate here: enqueue may or
            # may not have landed, and the management-API get acks (removes)
            # the message before the response travels back — a lost response
            # means the message may be gone yet unobserved, so a determinate
            # 'fail' would be unsound (unlike rabbitmq.clj:102-109, whose
            # AMQP client leaves the delivery un-acked and redeliverable).
            return op.replace(type="info", error=type(e).__name__)


class SemaphoreClient(RabbitClient):
    """A mutex as a single queued token: acquire = unacked get, release =
    requeue (rabbitmq.clj:186-260)."""

    _seeded = {}

    def open(self, test, node):
        c = SemaphoreClient(node, self.timeout)
        c._held = False
        key = id(test)
        try:
            c._request(_mgmt(node, f"queues/{VHOST}/{SEMAPHORE}"), "PUT",
                       {"durable": True, "auto_delete": False})
            if not SemaphoreClient._seeded.get(key):
                SemaphoreClient._seeded[key] = True
                c._request(
                    _mgmt(node, f"exchanges/{VHOST}/amq.default/publish"),
                    "POST", {"routing_key": SEMAPHORE, "payload": "token",
                             "payload_encoding": "string",
                             "properties": {"delivery_mode": 2}})
        except (urllib.error.URLError, OSError):
            pass
        return c

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "acquire":
                if self._held:
                    return op.replace(type="fail", error="already-held")
                out = self._request(
                    _mgmt(self.node, f"queues/{VHOST}/{SEMAPHORE}/get"),
                    "POST", {"count": 1, "ackmode": "ack_requeue_false",
                             "encoding": "auto"})
                if out:
                    self._held = True
                    return op.replace(type="ok")
                return op.replace(type="fail", error="no-token")
            if op.f == "release":
                if not self._held:
                    return op.replace(type="fail", error="not-held")
                self._held = False
                self._request(
                    _mgmt(self.node,
                          f"exchanges/{VHOST}/amq.default/publish"),
                    "POST", {"routing_key": SEMAPHORE, "payload": "token",
                             "payload_encoding": "string",
                             "properties": {"delivery_mode": 2}})
                return op.replace(type="ok")
            raise ValueError(f"unknown op {op.f!r}")
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            return op.replace(type="info", error=type(e).__name__)


def rabbitmq_test(opts: dict) -> dict:
    """Queue test (rabbitmq_test.clj:46-77 shape)."""
    test = noop_test()
    test.update({
        "name": "rabbitmq",
        "os": debian.os(),
        "db": RabbitDB(),
        "client": QueueClient(),
        "nemesis": nemesis.partition_random_halves(),
        "model": UnorderedQueue(),
        "checker": compose({"queue": total_queue()}),
        "generator": gen.phases(
            gen.time_limit(
                opts.get("time-limit", 60),
                gen.clients(gen.queue_gen(),
                            gen.seq(_nemesis_cycle()))),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.sleep(5),
            gen.clients(gen.each(lambda: gen.once({"f": "drain"})))),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


def mutex_test(opts: dict) -> dict:
    """Semaphore-as-mutex test (rabbitmq.clj:262-281 shape)."""
    def acquire_release():
        while True:
            yield gen.once({"f": "acquire"})
            yield gen.once({"f": "release"})

    test = rabbitmq_test(opts)
    test.update({
        "name": "rabbitmq-mutex",
        "client": SemaphoreClient(),
        "model": Mutex(),
        "checker": compose({
            "linear": linearizable(Mutex(),
                                   backend=opts.get("backend", "gpu"),
                                   device=opts.get("device"))}),
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(gen.each(lambda: gen.seq(acquire_release())))),
    })
    return test


def _nemesis_cycle():
    while True:
        yield gen.sleep(5)
        yield gen.once({"type": "info", "f": "start"})
        yield gen.sleep(5)
        yield gen.once({"type": "info", "f": "stop"})


def main(argv=None):
    """The reference's command line: ``test`` runs :func:`rabbitmq_test`,
    ``serve`` the results browser (``python -m
    jepsen_tpu_torch.suites.rabbitmq test|serve ...``)."""
    from jepsen_tpu_torch import cli
    cli.main(cli.merge_commands(cli.single_test_cmd(rabbitmq_test),
                                cli.serve_cmd()), argv)


if __name__ == "__main__":
    main()
