"""IP and hostname utilities on nodes.

Rebuild of jepsen.control.net (jepsen/src/jepsen/control/net.clj); the
port's copy of ``jepsen_tpu.control.net``."""

from __future__ import annotations

import re
from typing import Optional

from jepsen_tpu_torch import control


def reachable(test: dict, from_node, target) -> bool:
    """Can from_node ping target? (control/net.clj:7-11)"""
    try:
        control.exec(test, from_node, "ping", "-w", 1, "-c", 1, str(target))
        return True
    except control.RemoteError:
        return False


def local_ip(test: dict, node) -> Optional[str]:
    """The node's own IP (control/net.clj:13-18)."""
    out = control.execute(
        test, node,
        "hostname -I | awk '{print $1}'", check=False)
    out = out.strip().split()[0] if out.strip() else ""
    return out or None


def ip(test: dict, on_node, hostname) -> Optional[str]:
    """Resolve hostname as seen from on_node via getent
    (control/net.clj:20-30)."""
    out = control.execute(
        test, on_node, f"getent hosts {control.escape(str(hostname))}",
        check=False)
    m = re.match(r"^\s*([0-9a-fA-F.:]+)\s", out or "")
    return m.group(1) if m else None
