"""Debian node preparation.

Rebuild of jepsen.os.debian (jepsen/src/jepsen/os/debian.clj): hostfile
loopback fixup, apt package management (with version pinning and a
once-a-day update throttle), repo/key management, and the standard tool
install on setup. The port's copy of ``jepsen_tpu.os.debian``.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Union

from jepsen_tpu_torch import control
from jepsen_tpu_torch.control import RemoteError
from jepsen_tpu_torch.control import util as cu
from jepsen_tpu_torch.os import OS

log = logging.getLogger("jepsen.os.debian")

#: Standard tooling every DB node gets (debian.clj:148-163).
BASE_PACKAGES = [
    "wget", "curl", "vim", "man-db", "faketime", "ntpdate", "unzip",
    "iptables", "psmisc", "tar", "bzip2", "iputils-ping", "iproute2",
    "rsyslog", "logrotate",
]


def setup_hostfile(test: dict, node) -> None:
    """Ensure /etc/hosts maps 127.0.0.1 to localhost (debian.clj:12-25)."""
    hosts = control.exec(test, node, "cat", "/etc/hosts")
    lines = hosts.splitlines()
    fixed = ["127.0.0.1\tlocalhost" if re.match(r"^127\.0\.0\.1\t", ln)
             else ln for ln in lines]
    if lines != fixed:
        with control.sudo():
            control.execute(
                test, node,
                f"echo {control.escape(chr(10).join(fixed))} > /etc/hosts")


def time_since_last_update(test: dict, node) -> int:
    """Seconds since the last apt-get update (debian.clj:27-31)."""
    now = int(control.exec(test, node, "date", "+%s") or 0)
    out = control.execute(
        test, node, "stat -c %Y /var/cache/apt/pkgcache.bin || echo 0",
        check=False)
    try:
        last = int(out.split()[-1])
    except (ValueError, IndexError):
        last = 0
    return now - last


def update(test: dict, node) -> None:
    with control.sudo():
        control.exec(test, node, "apt-get", "update")


def maybe_update(test: dict, node) -> None:
    """apt-get update at most once a day (debian.clj:38-42)."""
    if time_since_last_update(test, node) > 86400:
        update(test, node)


def installed(test: dict, node, pkgs: Iterable[str]) -> Set[str]:
    """Which of pkgs are installed (debian.clj:44-54)."""
    pkgs = sorted(set(map(str, pkgs)))
    if not pkgs:
        return set()
    out = control.execute(
        test, node, "dpkg --get-selections " + control.escape(*pkgs),
        check=False)
    have = set()
    for line in out.splitlines():
        parts = line.split()
        if len(parts) >= 2 and parts[1] == "install":
            have.add(parts[0].split(":")[0])
    return have


def installed_version(test: dict, node, pkg: str) -> Optional[str]:
    """Installed version of pkg, or None (debian.clj:71-77)."""
    out = control.exec(test, node, "apt-cache", "policy", pkg)
    m = re.search(r"Installed: (\S+)", out)
    v = m.group(1) if m else None
    return None if v in (None, "(none)") else v


def install(test: dict, node,
            pkgs: Union[Sequence[str], Dict[str, str]]) -> None:
    """Ensure packages are installed; a dict pins versions
    (debian.clj:79-98)."""
    if isinstance(pkgs, dict):
        for pkg, version in pkgs.items():
            if installed_version(test, node, pkg) != version:
                with control.sudo():
                    control.exec(test, node, "apt-get", "install", "-y",
                                 "--force-yes", f"{pkg}={version}")
        return
    want = set(map(str, pkgs))
    missing = want - installed(test, node, want)
    if missing:
        with control.sudo():
            control.exec(test, node, "apt-get", "install", "-y",
                         "--force-yes", *sorted(missing))


def uninstall(test: dict, node, pkgs: Union[str, Sequence[str]]) -> None:
    """Purge packages (debian.clj:56-61)."""
    if isinstance(pkgs, str):
        pkgs = [pkgs]
    have = installed(test, node, pkgs)
    if have:
        with control.sudo():
            control.exec(test, node, "apt-get", "remove", "--purge", "-y",
                         *sorted(have))


def add_key(test: dict, node, keyserver: str, key: str) -> None:
    """Receive an apt key (debian.clj:100-106)."""
    with control.sudo():
        control.exec(test, node, "apt-key", "adv", "--keyserver", keyserver,
                     "--recv", key)


def add_repo(test: dict, node, repo_name: str, apt_line: str,
             keyserver: Optional[str] = None,
             key: Optional[str] = None) -> None:
    """Add an apt repo + optional key; updates if newly added
    (debian.clj:108-119)."""
    list_file = f"/etc/apt/sources.list.d/{repo_name}.list"
    if cu.exists(test, node, list_file):
        return
    if keyserver or key:
        add_key(test, node, keyserver, key)
    with control.sudo():
        control.execute(
            test, node,
            f"echo {control.escape(apt_line)} > {control.escape(list_file)}")
    update(test, node)


class DebianOS(OS):
    """Standard debian node prep (debian.clj:137-167)."""

    def setup(self, test, node):
        log.info("%s setting up debian", node)
        setup_hostfile(test, node)
        maybe_update(test, node)
        install(test, node, BASE_PACKAGES)
        net = test.get("net")
        if net is not None:
            try:
                net.heal(test)
            except RemoteError:
                log.warning("net heal failed during OS setup")

    def teardown(self, test, node):
        pass


def os() -> DebianOS:
    return DebianOS()
