"""Network manipulation backends.

Rebuild of jepsen.net (jepsen/src/jepsen/net.clj): a small protocol —
drop/heal/slow/flaky/fast — with a Linux iptables+tc backend, a SmartOS
ipfilter backend, and a noop. All effects run through the control plane
(:mod:`jepsen_tpu_torch.control`), so the dummy session mode records rather
than executes them — grudge *planning* stays pure data (see
:mod:`jepsen_tpu_torch.nemesis`). The port's copy of ``jepsen_tpu.net``.
"""

from __future__ import annotations

from typing import Optional

from jepsen_tpu_torch import control

TC = "/sbin/tc"


class Net:
    """Network-manipulation protocol (net.clj:9-20)."""

    def drop(self, test: dict, src, dest) -> None:
        """Drop traffic from src as seen at dest."""
        raise NotImplementedError

    def heal(self, test: dict) -> None:
        """End all traffic drops, restore fast operation."""
        raise NotImplementedError

    def slow(self, test: dict, opts: Optional[dict] = None) -> None:
        """Delay packets: opts {mean (ms), variance (ms), distribution}."""
        raise NotImplementedError

    def flaky(self, test: dict) -> None:
        """Introduce randomized packet loss."""
        raise NotImplementedError

    def fast(self, test: dict) -> None:
        """Remove packet loss and delays."""
        raise NotImplementedError


class NoopNet(Net):
    """Does nothing (net.clj:24-32)."""

    def drop(self, test, src, dest):
        pass

    def heal(self, test):
        pass

    def slow(self, test, opts=None):
        pass

    def flaky(self, test):
        pass

    def fast(self, test):
        pass


def _node_ip(test: dict, node) -> str:
    """Resolve a node's IP on the *dest* node's view; falls back to the name
    (control/net.clj:20-30 uses getent on the remote side)."""
    ips = test.get("node-ips") or {}
    return ips.get(node, str(node))


class IptablesNet(Net):
    """Default Linux backend: iptables DROP rules + tc netem
    (net.clj:34-75). ``device`` is the interface tc shapes (the
    reference hardcodes eth0; containers and test rigs differ)."""

    def __init__(self, device: str = "eth0"):
        self.device = device

    def drop(self, test, src, dest):
        with control.sudo():
            control.exec(test, dest, "iptables", "-A", "INPUT",
                         "-s", _node_ip(test, src), "-j", "DROP", "-w")

    def heal(self, test):
        def heal_node(t, node):
            with control.sudo():
                control.exec(t, node, "iptables", "-F", "-w")
                control.exec(t, node, "iptables", "-X", "-w")
        control.on_nodes(test, heal_node)

    def slow(self, test, opts=None):
        opts = opts or {}
        mean = opts.get("mean", 50)
        variance = opts.get("variance", 10)
        dist = opts.get("distribution", "normal")

        def slow_node(t, node):
            with control.sudo():
                control.exec(t, node, TC, "qdisc", "add", "dev", self.device,
                             "root", "netem", "delay", f"{mean}ms",
                             f"{variance}ms", "distribution", dist)
        control.on_nodes(test, slow_node)

    def flaky(self, test):
        def flake_node(t, node):
            with control.sudo():
                control.exec(t, node, TC, "qdisc", "add", "dev", self.device,
                             "root", "netem", "loss", "20%", "75%")
        control.on_nodes(test, flake_node)

    def fast(self, test):
        def fast_node(t, node):
            with control.sudo():
                try:
                    control.exec(t, node, TC, "qdisc", "del", "dev",
                                 self.device, "root")
                except control.RemoteError as e:
                    # no qdisc installed is fine (net.clj:69-75).
                    # iproute2 2.x prints "No such file or directory";
                    # 5.x+ prints "Cannot delete qdisc with handle of
                    # zero" — found by the real-tc test, exactly the
                    # message drift a dummy transcript cannot catch.
                    err = e.err or ""
                    if ("No such file or directory" not in err
                            and "handle of zero" not in err):
                        raise
        control.on_nodes(test, fast_node)


class IPFilterNet(Net):
    """SmartOS ipfilter backend (net.clj:77-109). The tc-based
    slow/flaky/fast paths are shared with IptablesNet and need the same
    ``device``."""

    def __init__(self, device: str = "eth0"):
        self.device = device

    def drop(self, test, src, dest):
        with control.sudo():
            control.execute(
                test, dest,
                f"echo block in from {_node_ip(test, src)} to any | ipf -f -")

    def heal(self, test):
        def heal_node(t, node):
            with control.sudo():
                control.exec(t, node, "ipf", "-Fa")
        control.on_nodes(test, heal_node)

    def slow(self, test, opts=None):
        IptablesNet.slow(self, test, opts)

    def flaky(self, test):
        IptablesNet.flaky(self, test)

    def fast(self, test):
        IptablesNet.fast(self, test)


def noop() -> NoopNet:
    return NoopNet()


def iptables(device: str = "eth0") -> IptablesNet:
    return IptablesNet(device)


def ipfilter(device: str = "eth0") -> IPFilterNet:
    return IPFilterNet(device)
