"""Client protocol: how workers talk to the system under test.

Rebuild of jepsen.client (jepsen/src/jepsen/client.clj:7-22). A client is
specialized to a node when opened; invoke! applies an operation and returns
its completion. The port's copy of ``jepsen_tpu.client``.
"""

from __future__ import annotations

from typing import Optional

from jepsen_tpu_torch.history import Op


class Client:
    """Lifecycle (client.clj:7-22):

    - open(test, node) -> client bound to a node (may return self or a copy)
    - setup(test)      -> one-time data initialization
    - invoke(test, op) -> completion Op (type ok/fail/info)
    - teardown(test)
    - close(test)      -> release connections
    """

    def open(self, test: dict, node) -> "Client":
        return self

    def setup(self, test: dict) -> None:
        pass

    def invoke(self, test: dict, op: Op) -> Op:
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        pass

    def close(self, test: dict) -> None:
        pass


class NoopClient(Client):
    """Does nothing (client.clj:24-31)."""

    def invoke(self, test, op):
        return op.replace(type="ok")


def noop() -> NoopClient:
    return NoopClient()
