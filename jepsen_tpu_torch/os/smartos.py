"""SmartOS node preparation.

Rebuild of jepsen.os.smartos (jepsen/src/jepsen/os/smartos.clj): pkgin
package management and the standard tool install; network faults on
SmartOS use the ipfilter backend (:class:`jepsen_tpu_torch.net.IPFilterNet`).
The port's copy of ``jepsen_tpu.os.smartos``."""

from __future__ import annotations

import logging
from typing import Iterable, Set

from jepsen_tpu_torch import control
from jepsen_tpu_torch.os import OS

log = logging.getLogger("jepsen.os.smartos")

BASE_PACKAGES = ["wget", "curl", "vim", "unzip", "gtar", "rsyslog"]


def installed(test: dict, node, pkgs: Iterable[str]) -> Set[str]:
    """Which packages are installed, via pkgin list
    (smartos.clj installed)."""
    out = control.execute(test, node, "pkgin list", check=False)
    have = set()
    for line in out.splitlines():
        name = line.split()[0] if line.split() else ""
        # strip trailing -<version>
        if "-" in name:
            have.add(name.rsplit("-", 1)[0])
    want = set(map(str, pkgs))
    return want & have


def install(test: dict, node, pkgs: Iterable[str]) -> None:
    """pkgin -y install missing packages (smartos.clj install)."""
    want = set(map(str, pkgs))
    missing = want - installed(test, node, want)
    if missing:
        with control.sudo():
            control.exec(test, node, "pkgin", "-y", "install",
                         *sorted(missing))


class SmartOS(OS):
    """smartos.clj:109-132."""

    def setup(self, test, node):
        log.info("%s setting up smartos", node)
        install(test, node, BASE_PACKAGES)

    def teardown(self, test, node):
        pass


def os() -> SmartOS:
    return SmartOS()
