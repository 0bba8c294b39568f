"""The remote control plane: run commands on DB nodes.

Rebuild of jepsen.control (jepsen/src/jepsen/control.clj). The reference
drives nodes over SSH via clj-ssh/JSch with dynamic-var session state, a
shell-escaping DSL, sudo/cd wrappers, parallel fan-out and scp
(control.clj:15-361). Here:

- sessions are OpenSSH subprocesses with ControlMaster multiplexing (one
  master connection per node, commands ride it — the moral equivalent of the
  reference's persistent JSch session at control.clj:254-281);
- ``dummy`` mode records commands without any network (control.clj:15,
  274-276), used by unit tests;
- ``local`` mode executes on the local machine — the seam single-machine
  integration tests and the docker environment use;
- per-thread context (node binding, sudo/cd stacks) mirrors the reference's
  dynamic vars (control.clj:15-26).

Sysadmin helpers (daemons, tarballs, grepkill) live in
:mod:`jepsen_tpu_torch.control.util`. The port's copy of
``jepsen_tpu.control``.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence, Union

from jepsen_tpu_torch.util import real_pmap, retry

DEFAULT_SSH = {
    "username": "root",
    "port": 22,
    "private-key-path": None,
    "password": None,
    "strict-host-key-checking": False,
    "dummy": False,
    "mode": None,  # None -> ssh; "dummy"; "local"
    "connect-timeout": 10,
}


class Lit:
    """A literal string that must not be shell-escaped (control.clj `lit`)."""

    def __init__(self, s: str):
        self.s = s

    def __str__(self):
        return self.s


def escape(*args: Any) -> str:
    """Build a shell command from tokens, quoting anything unsafe
    (control.clj:53-96). Lists are flattened; Lit passes through raw."""
    out: List[str] = []
    for a in args:
        if a is None:
            continue
        if isinstance(a, (list, tuple)):
            out.append(escape(*a))
        elif isinstance(a, Lit):
            out.append(str(a))
        else:
            s = str(a)
            if s and all(c.isalnum() or c in "-_./=:@%+,^" for c in s):
                out.append(s)
            else:
                out.append(shlex.quote(s))
    return " ".join(out)


class RemoteError(RuntimeError):
    def __init__(self, node, cmd, rc, out, err):
        super().__init__(
            f"command failed on {node} (exit {rc}): {cmd}\n"
            f"stdout: {out!r}\nstderr: {err!r}")
        self.node = node
        self.cmd = cmd
        self.rc = rc
        self.out = out
        self.err = err


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------


class Session:
    """A connection to one node."""

    def __init__(self, node, opts: dict):
        self.node = node
        self.opts = opts

    def execute(self, cmd: str, stdin: Optional[str] = None,
                timeout: Optional[float] = None):
        raise NotImplementedError

    def upload(self, local: str, remote: str):
        raise NotImplementedError

    def download(self, remote: str, local: str):
        raise NotImplementedError

    def open(self):
        pass

    def close(self):
        pass


class SSHSession(Session):
    """OpenSSH subprocess with a shared ControlMaster socket per node
    (the persistent-session equivalent of control.clj:254-281)."""

    def _base_args(self) -> List[str]:
        o = self.opts
        args = ["ssh",
                "-o", "ControlMaster=auto",
                "-o", f"ControlPath=/tmp/jepsen-cm-{o['username']}@%h:%p",
                "-o", "ControlPersist=60",
                "-o", f"ConnectTimeout={o.get('connect-timeout', 10)}",
                "-o", "BatchMode=yes",
                "-p", str(o.get("port", 22))]
        if not o.get("strict-host-key-checking", False):
            args += ["-o", "StrictHostKeyChecking=no",
                     "-o", "UserKnownHostsFile=/dev/null",
                     "-o", "LogLevel=ERROR"]
        if o.get("private-key-path"):
            args += ["-i", o["private-key-path"]]
        return args

    def _target(self) -> str:
        return f"{self.opts['username']}@{self.node}"

    def open(self):
        # establish the master connection (retried by session_pool)
        rc, out, err = self.execute("true")
        if rc != 0:
            raise RemoteError(self.node, "true", rc, out, err)

    def execute(self, cmd, stdin=None, timeout=None):
        p = subprocess.run(
            self._base_args() + [self._target(), cmd],
            input=stdin, capture_output=True, text=True,
            timeout=timeout or self.opts.get("command-timeout", 600))
        return p.returncode, p.stdout, p.stderr

    def _scp(self, src: str, dst: str):
        o = self.opts
        args = ["scp", "-q", "-r",
                "-o", f"ControlPath=/tmp/jepsen-cm-{o['username']}@%h:%p",
                "-P", str(o.get("port", 22))]
        if not o.get("strict-host-key-checking", False):
            args += ["-o", "StrictHostKeyChecking=no",
                     "-o", "UserKnownHostsFile=/dev/null",
                     "-o", "LogLevel=ERROR"]
        if o.get("private-key-path"):
            args += ["-i", o["private-key-path"]]
        p = subprocess.run(args + [src, dst], capture_output=True, text=True)
        if p.returncode != 0:
            raise RemoteError(self.node, f"scp {src} {dst}", p.returncode,
                              p.stdout, p.stderr)

    def upload(self, local, remote):
        self._scp(local, f"{self._target()}:{remote}")

    def download(self, remote, local):
        self._scp(f"{self._target()}:{remote}", local)

    def close(self):
        # tear down the control master
        subprocess.run(self._base_args() + ["-O", "exit", self._target()],
                       capture_output=True, text=True)


class LocalSession(Session):
    """Run commands on the local machine (single-box integration tests and
    the docker control-node environment)."""

    def execute(self, cmd, stdin=None, timeout=None):
        p = subprocess.run(["/bin/sh", "-c", cmd], input=stdin,
                           capture_output=True, text=True, timeout=timeout)
        return p.returncode, p.stdout, p.stderr

    def upload(self, local, remote):
        subprocess.run(["cp", "-r", local, remote], check=True)

    def download(self, remote, local):
        subprocess.run(["cp", "-r", remote, local], check=True)


class DummySession(Session):
    """Records commands, returns empty output (control.clj *dummy* mode,
    control.clj:15,274-276)."""

    def __init__(self, node, opts):
        super().__init__(node, opts)
        self.log: List[str] = []
        self.responses: Dict[str, str] = opts.get("dummy-responses", {})

    def execute(self, cmd, stdin=None, timeout=None):
        self.log.append(cmd)
        for pat, resp in self.responses.items():
            if pat in cmd:
                if isinstance(resp, tuple):  # scripted (rc, out, err)
                    return resp
                return 0, resp, ""
        return 0, "", ""

    def upload(self, local, remote):
        self.log.append(f"UPLOAD {local} -> {remote}")

    def download(self, remote, local):
        self.log.append(f"DOWNLOAD {remote} -> {local}")


def make_session(node, ssh_opts: dict) -> Session:
    opts = {**DEFAULT_SSH, **(ssh_opts or {})}
    mode = opts.get("mode") or ("dummy" if opts.get("dummy") else "ssh")
    if mode == "dummy":
        return DummySession(node, opts)
    if mode == "local":
        return LocalSession(node, opts)
    return SSHSession(node, opts)


# ---------------------------------------------------------------------------
# Per-thread command context (dynamic vars, control.clj:15-26)
# ---------------------------------------------------------------------------

_ctx = threading.local()


def _get(name, default=None):
    return getattr(_ctx, name, default)


@contextmanager
def _bound(name, value):
    prev = _get(name)
    setattr(_ctx, name, value)
    try:
        yield
    finally:
        setattr(_ctx, name, prev)


@contextmanager
def sudo(user: str = "root"):
    """Wrap commands in sudo -u user (control.clj:98-106, 235-240)."""
    with _bound("sudo", user):
        yield


@contextmanager
def cd(directory: str):
    """Prepend cd dir && (control.clj:231-234)."""
    with _bound("dir", directory):
        yield


@contextmanager
def trace():
    """Log commands before running (control.clj:18, 248-252)."""
    with _bound("trace", True):
        yield


def wrap_cmd(cmd: str) -> str:
    """Apply cd/sudo wrappers from the current context
    (control.clj:98-106)."""
    d = _get("dir")
    if d:
        cmd = f"cd {shlex.quote(d)} && {cmd}"
    u = _get("sudo")
    if u:
        cmd = f"sudo -S -u {shlex.quote(u)} sh -c {shlex.quote(cmd)}"
    return cmd


# ---------------------------------------------------------------------------
# Session pool + public API
# ---------------------------------------------------------------------------


def _sessions(test: dict) -> Dict[Any, Session]:
    return test.setdefault("_sessions", {})


def get_session(test: dict, node) -> Session:
    ss = _sessions(test)
    s = ss.get(node)
    if s is None:
        s = make_session(node, test.get("ssh"))
        ss[node] = s
    return s


@contextmanager
def session_pool(test: dict):
    """Open one session per node in parallel, close them at the end
    (core.clj:453-462 with-ssh + with-resources)."""
    nodes = test.get("nodes") or []
    ssh_opts = test.get("ssh") or {}
    mode = ssh_opts.get("mode") or ("dummy" if ssh_opts.get("dummy")
                                    else "ssh")
    no_network = mode in ("dummy", "local") or not nodes \
        or test.get("no-ssh")
    try:
        if not no_network:
            def open_one(node):
                s = get_session(test, node)
                retry(1.0, s.open, retries=5)
                return s
            real_pmap(open_one, nodes)
        else:
            for node in nodes:
                get_session(test, node)
        yield test
    finally:
        for s in _sessions(test).values():
            try:
                s.close()
            except Exception:  # noqa: BLE001
                pass
        test["_sessions"] = {}


def execute(test: dict, node, cmd: str, stdin: Optional[str] = None,
            check: bool = True) -> str:
    """Run a raw shell string on node; returns trimmed stdout
    (the engine under exec, with ssh retry semantics of
    control.clj:140-160)."""
    session = get_session(test, node)
    # Local mode already-as-root: sudo-to-root is a no-op, and minimal
    # images (containers) often have no sudo binary at all — the cd
    # wrapper still applies.
    skip_sudo = (isinstance(session, LocalSession)
                 and _get("sudo") == "root"
                 and getattr(os, "geteuid", lambda: -1)() == 0)
    if skip_sudo:
        with _bound("sudo", None):
            cmd = wrap_cmd(cmd)
    else:
        cmd = wrap_cmd(cmd)
    if _get("trace"):
        print(f"[control {node}] {cmd}")
    attempts = 2
    for attempt in range(attempts):
        rc, out, err = session.execute(cmd, stdin=stdin)
        if rc == 255 and attempt < attempts - 1:
            # ssh transport error: reconnect and retry (control.clj:144-160)
            time.sleep(0.5)
            continue
        break
    if check and rc != 0:
        raise RemoteError(node, cmd, rc, out, err)
    return out.strip()


def exec(test: dict, node, *args, stdin: Optional[str] = None) -> str:
    """Shell-escaped exec on node (control.clj:162-181)."""
    return execute(test, node, escape(*args), stdin=stdin)


def upload(test: dict, node, local: str, remote: str) -> None:
    """scp local -> node:remote (control.clj:190-205)."""
    retry(1.0, lambda: get_session(test, node).upload(local, remote),
          retries=3)


def download(test: dict, node, remote: str, local: str) -> None:
    """scp node:remote -> local (control.clj:207-217)."""
    retry(1.0, lambda: get_session(test, node).download(remote, local),
          retries=3)


def on_nodes(test: dict, f, nodes: Optional[Sequence] = None) -> dict:
    """Apply f(test, node) in parallel over nodes; returns {node: result}
    (control.clj:337-353)."""
    nodes = list(nodes if nodes is not None else (test.get("nodes") or []))
    return dict(zip(nodes, real_pmap(lambda n: f(test, n), nodes)))


def on_many(test: dict, nodes: Sequence, f) -> dict:
    """Apply f(node) in parallel (control.clj:325-335)."""
    nodes = list(nodes)
    return dict(zip(nodes, real_pmap(f, nodes)))
