"""Remote sysadmin helpers for scripting DB installations.

Rebuild of jepsen.control.util (jepsen/src/jepsen/control/util.clj):
existence probes, tarball download/extract with corrupt-archive retry,
user management, grep-kill, and start-stop-daemon process management.
All functions take (test, node) explicitly (the reference threads the node
through dynamic vars). The port's copy of ``jepsen_tpu.control.util``."""

from __future__ import annotations

import random
import re
from typing import Any, List, Optional, Sequence

from jepsen_tpu_torch import control
from jepsen_tpu_torch.control import Lit, RemoteError

TMP_DIR_BASE = "/tmp/jepsen"


def exists(test: dict, node, path: str) -> bool:
    """Is a path present? (util.clj exists?)"""
    try:
        control.exec(test, node, "stat", path)
        return True
    except RemoteError:
        return False


def ls(test: dict, node, directory: str = ".") -> List[str]:
    """Directory entries, dotfiles included (util.clj ls)."""
    out = control.exec(test, node, "ls", "-A", directory)
    return [line for line in out.splitlines() if line.strip()]


def ls_full(test: dict, node, directory: str) -> List[str]:
    """ls with dir prepended (util.clj ls-full)."""
    d = directory if directory.endswith("/") else directory + "/"
    return [d + e for e in ls(test, node, d)]


def tmp_dir(test: dict, node) -> str:
    """A fresh temporary directory under /tmp/jepsen (util.clj tmp-dir!).
    Bounded probing (the dummy control plane answers every stat with
    success, so an unbounded retry-on-collision loop would never end)."""
    d = f"{TMP_DIR_BASE}/{random.randrange(2**31)}"
    for _ in range(10):
        if not exists(test, node, d):
            break
        d = f"{TMP_DIR_BASE}/{random.randrange(2**31)}"
    control.exec(test, node, "mkdir", "-p", d)
    return d


def wget(test: dict, node, url: str, force: bool = False) -> str:
    """Download url on the node (skipping if present); returns the
    filename (util.clj:52-70)."""
    filename = url.rstrip("/").rsplit("/", 1)[-1]
    if force:
        control.exec(test, node, "rm", "-f", filename)
    if not exists(test, node, filename):
        control.exec(test, node, "wget", "--tries", 20, "--waitretry", 60,
                     "--retry-connrefused", "--dns-timeout", 60,
                     "--connect-timeout", 60, "--read-timeout", 60, url)
    return filename


def install_archive(test: dict, node, url: str, dest: str,
                    force: bool = False, _retries: int = 1) -> str:
    """Fetch a tarball/zip URL (file:// or http(s)://, cached in
    /tmp/jepsen) and extract it to dest; a sole top-level directory is
    collapsed into dest (util.clj:72-141). Retries once on a corrupt
    (unexpected-EOF) download."""
    m = re.match(r"file://(.+)", url)
    local_file = m.group(1) if m else None
    if local_file:
        archive = local_file
    else:
        control.exec(test, node, "mkdir", "-p", TMP_DIR_BASE)
        with control.cd(TMP_DIR_BASE):
            archive = f"{TMP_DIR_BASE}/{wget(test, node, url, force)}"
    td = tmp_dir(test, node)

    control.exec(test, node, "rm", "-rf", dest)
    parent = control.exec(test, node, "dirname", dest) or "/"
    control.exec(test, node, "mkdir", "-p", parent)

    try:
        with control.cd(td):
            if archive.endswith(".zip"):
                control.exec(test, node, "unzip", archive)
            else:
                control.exec(test, node, "tar", "xf", archive)
            roots = ls(test, node, td)
            assert roots, "archive contained no files"
            if len(roots) == 1:
                control.exec(test, node, "mv", f"{td}/{roots[0]}", dest)
            else:
                control.exec(test, node, "mv", td, dest)
    except RemoteError as e:
        # truncation signatures across tool generations: the
        # reference-era JVM stream said "Unexpected EOF"; GNU gzip says
        # "unexpected end of file"; bsdtar says "Truncated input".
        # (Found by tests/test_install_real.py against real tar+gzip —
        # the old exact match never fired on modern hosts.)
        # match the TOOL's stderr only — str(e) embeds the command line
        # (archive paths could contain these words) and stdout
        msg = (e.err or "").lower()
        if ("unexpected eof" in msg or "unexpected end of file" in msg
                or "truncated" in msg):
            if local_file:
                raise RuntimeError(
                    f"local archive {local_file} on node {node} is "
                    f"corrupt: unexpected EOF") from e
            if _retries > 0:
                control.exec(test, node, "rm", "-rf", archive)
                return install_archive(test, node, url, dest, force,
                                       _retries - 1)
        raise
    finally:
        control.exec(test, node, "rm", "-rf", td)
    return dest


def ensure_user(test: dict, node, username: str) -> str:
    """Make sure a user exists (util.clj:150-157)."""
    try:
        with control.sudo():
            control.exec(test, node, "adduser", "--disabled-password",
                         "--gecos", Lit("''"), username)
    except RemoteError as e:
        if "already exists" not in str(e):
            raise
    return username


def grepkill(test: dict, node, pattern: str, signal: int = 9) -> None:
    """Kill processes matching pattern (util.clj:159-174).

    ``ps auxww``, not ``ps aux``: procps honors an inherited $COLUMNS
    even when piped, truncating the command column — a pattern beyond
    column ~80 then silently matches nothing (found by
    tests/test_nemesis_real.py running under pytest, which exports
    COLUMNS)."""
    try:
        control.execute(
            test, node,
            f"ps auxww | grep {control.escape(pattern)} | grep -v grep "
            f"| awk '{{print $2}}' | xargs kill -{signal}")
    except RemoteError as e:
        # empty kill list exits nonzero; that's fine
        if (e.err or "").strip() and "usage" not in (e.err or "").lower():
            raise


def start_daemon(test: dict, node, bin_path: str, *args,
                 logfile: str, pidfile: str,
                 chdir: str = "/", background: bool = True,
                 make_pidfile: bool = True, match_executable: bool = True,
                 match_process_name: bool = False,
                 process_name: Optional[str] = None) -> None:
    """Start a daemon under start-stop-daemon, appending stdout/stderr to
    logfile (util.clj:176-204)."""
    control.execute(
        test, node,
        f"echo \"`date +'%Y-%m-%d %H:%M:%S'` Jepsen starting "
        f"{control.escape(bin_path, *args)}\" >> "
        f"{control.escape(logfile)}")
    tokens: List[Any] = ["start-stop-daemon", "--start"]
    if background:
        tokens += ["--background", "--no-close"]
    if make_pidfile:
        tokens += ["--make-pidfile"]
    if match_executable:
        tokens += ["--exec", bin_path]
    if match_process_name:
        tokens += ["--name",
                   process_name or bin_path.rstrip("/").rsplit("/", 1)[-1]]
    tokens += ["--pidfile", pidfile, "--chdir", chdir, "--oknodo",
               "--startas", bin_path, "--", *args]
    control.execute(
        test, node,
        control.escape(*tokens) + f" >> {control.escape(logfile)} 2>&1")


def stop_daemon(test: dict, node, pidfile: str,
                cmd: Optional[str] = None) -> None:
    """Kill a daemon by pidfile, or by command name (util.clj:206-219)."""
    if cmd is not None:
        for c in ((f"killall -9 -w {control.escape(cmd)}"),
                  (f"rm -rf {control.escape(pidfile)}")):
            try:
                control.execute(test, node, c)
            except RemoteError:
                pass
        return
    if exists(test, node, pidfile):
        pid = control.exec(test, node, "cat", pidfile)
        for c in (f"kill -9 {control.escape(pid)}",
                  f"rm -rf {control.escape(pidfile)}"):
            try:
                control.execute(test, node, c)
            except RemoteError:
                pass
