"""OS preparation protocol (reference jepsen.os, os.clj:4-8); the port's
copy of ``jepsen_tpu.os``."""

from __future__ import annotations


class OS:
    def setup(self, test: dict, node) -> None:
        """Prepare the node's operating system."""

    def teardown(self, test: dict, node) -> None:
        pass


class NoopOS(OS):
    pass


def noop() -> NoopOS:
    return NoopOS()
