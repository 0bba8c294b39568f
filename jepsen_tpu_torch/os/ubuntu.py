"""Ubuntu OS prep — the cockroach suite's box flavor.

Rebuild of cockroachdb/src/jepsen/os/ubuntu.clj: debian's hostfile fixup
and package machinery, plus the cockroach-specific package set (tcpdump,
rsyslog, logrotate for the suite's capture/log tooling) and stopping the
ntp service so the clock nemeses own the clock (ubuntu.clj:13-39). The
port's copy of ``jepsen_tpu.os.ubuntu``."""

from __future__ import annotations

from jepsen_tpu_torch import control
from jepsen_tpu_torch import os as os_ns
from jepsen_tpu_torch.os import debian

PACKAGES = ["wget", "curl", "vim", "man-db", "faketime", "unzip",
            "ntpdate", "iptables", "iputils-ping", "rsyslog", "tcpdump",
            "logrotate"]


class UbuntuOS(os_ns.OS):
    def setup(self, test, node):
        debian.setup_hostfile(test, node)
        debian.maybe_update(test, node)
        debian.install(test, node, PACKAGES)
        with control.sudo():
            # the clock nemeses must own the clock (ubuntu.clj:36)
            try:
                control.exec(test, node, "service", "ntp", "stop")
            except control.RemoteError:
                pass
        net = test.get("net")
        if net is not None:
            try:
                net.heal(test)
            except Exception:  # noqa: BLE001 — heal is best-effort here
                pass

    def teardown(self, test, node):
        pass


def os() -> UbuntuOS:
    return UbuntuOS()
