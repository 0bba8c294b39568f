"""Small suites: logcabin, robustirc, rethinkdb, ravendb, mongodb-rocks.

Reference counterparts:
- logcabin/: linearizable CAS register over a Raft KV, driven with the
  logcabin client binary (logcabin.clj)
- robustirc/: a grow-only set written as IRC messages and read back from
  the channel log (robustirc.clj:213-215) — the client here speaks the
  IRC wire protocol over a stdlib socket
- rethinkdb/: per-key document CAS with a write/read-acks matrix and a
  reconfigure nemesis (rethinkdb.clj, document_cas.clj:146-148)
- ravendb/: register over the HTTP document API (ravendb suite)
- mongodb-rocks/: the mongodb document-cas test re-parameterized for the
  RocksDB storage engine (mongodb_rocks.clj:5)

The port's copy of ``jepsen_tpu.suites.small``, with one difference: the
registers' linearizability checks (logcabin, rethinkdb, ravendb, and
mongodb-rocks' keyed document CAS) run on the card (``backend`` "gpu",
the default) unless the options name the CPU (``backend: "cpu"`` for the
host search, ``device: "cpu"`` for the kernels' plain versions). The
reference has no ``main`` here, and neither has the port: ``run --suite
NAME`` runs each row.
"""

from __future__ import annotations

import json
import re
import socket
import subprocess
import tempfile
import threading
import urllib.error
import urllib.request
from typing import Any, List, Optional

from jepsen_tpu_torch import client as client_ns
from jepsen_tpu_torch import control
from jepsen_tpu_torch import db as db_ns
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import nemesis
from jepsen_tpu_torch.checker import compose, perf, set_checker
from jepsen_tpu_torch.checker.wgl import linearizable
from jepsen_tpu_torch.control import util as cu
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.suites import workloads as wl
from jepsen_tpu_torch.testing import noop_test

# ---------------------------------------------------------------------------
# LogCabin
# ---------------------------------------------------------------------------


#: the LogCabin node's working directory: the root user's home, as in
#: logcabin.clj
LOGCABIN_HOME = "/root"
LOGCABIN_CONF = f"{LOGCABIN_HOME}/logcabin.conf"
LOGCABIN_BIN = f"{LOGCABIN_HOME}/LogCabin"
LOGCABIN_LOG = f"{LOGCABIN_HOME}/logcabin.log"
LOGCABIN_PID = f"{LOGCABIN_HOME}/logcabin.pid"


class LogCabinDB(db_ns.DB, db_ns.Primary, db_ns.LogFiles):
    """LogCabin node lifecycle (logcabin.clj:23-160): built FROM SOURCE
    on the node (git clone + scons — the raft KV ships no packages),
    per-node serverId/listenAddresses config, daemon start; the primary
    bootstraps the first membership and then reconfigures the cluster
    to all nodes with the Reconfigure example binary."""

    def setup(self, test, node):
        from jepsen_tpu_torch.os import debian
        debian.install(test, node, ["git-core", "protobuf-compiler",
                                    "libprotobuf-dev", "libcrypto++-dev",
                                    "g++", "scons"])
        with control.sudo():
            control.execute(
                test, node,
                "[ -d /logcabin ] || (cd / && git clone --depth 1 "
                "https://github.com/logcabin/logcabin.git && "
                "cd /logcabin && git submodule update --init)")
            control.execute(test, node, "cd /logcabin && scons")
            for b in ("LogCabin", "Examples/Reconfigure",
                      "Examples/TreeOps"):
                control.execute(test, node,
                                f"cp -f /logcabin/build/{b} "
                                f"{LOGCABIN_HOME}")
            # index-based: unique and integer for ANY node naming
            # (logcabin.clj:48-50 assumes n<digits>; IPs would break it)
            sid = str(test["nodes"].index(node) + 1)
            control.execute(
                test, node,
                f"printf 'serverId = {sid}\\nlistenAddresses = "
                f"{node}:5254\\n' > {LOGCABIN_CONF}")
            if node == test["nodes"][0]:
                # first node bootstraps the initial one-member cluster
                control.execute(
                    test, node,
                    f"cd {LOGCABIN_HOME} && {LOGCABIN_BIN} -c {LOGCABIN_CONF} "
                    f"-l {LOGCABIN_LOG} --bootstrap")
            control.execute(
                test, node,
                f"cd {LOGCABIN_HOME} && {LOGCABIN_BIN} -c {LOGCABIN_CONF} "
                f"-d -l {LOGCABIN_LOG} -p {LOGCABIN_PID}")

    def setup_primary(self, test, node):
        """Grow the membership from the bootstrap node to every node
        (logcabin.clj:102-115 reconfigure!)."""
        addrs = " ".join(f"{n}:5254" for n in test["nodes"])
        cluster = ",".join(f"{n}:5254" for n in test["nodes"])
        with control.sudo():
            control.execute(
                test, node,
                f"cd {LOGCABIN_HOME} && ./Reconfigure -c {cluster} set "
                f"{addrs}")

    def teardown(self, test, node):
        cu.grepkill(test, node, "LogCabin")
        control.execute(test, node,
                        f"rm -rf {LOGCABIN_PID} {LOGCABIN_HOME}/storage "
                        f"|| true")

    def log_files(self, test, node):
        return [LOGCABIN_LOG]


class LogCabinClient(client_ns.Client):
    """CAS register via the logcabin CLI's conditional write
    (logcabin.clj client)."""

    KEY = "/jepsen"

    def __init__(self, node=None):
        self.node = node

    def open(self, test, node):
        c = LogCabinClient()
        c.node = node
        return c

    def _cli(self, test, *args, stdin=None):
        cluster = ",".join(f"{n}:5254" for n in test["nodes"])
        return control.exec(test, self.node, "logcabin",
                            "--cluster", cluster, *args, stdin=stdin)

    def invoke(self, test, op: Op) -> Op:
        crash = "fail" if op.f == "read" else "info"
        try:
            if op.f == "read":
                out = self._cli(test, "read", self.KEY)
                v = int(out) if out.strip() else None
                return op.replace(type="ok", value=v)
            if op.f == "write":
                self._cli(test, "write", self.KEY, stdin=str(op.value))
                return op.replace(type="ok")
            if op.f == "cas":
                old, new = op.value
                try:
                    self._cli(test, "write", "--condition",
                              f"{self.KEY}:{old}", self.KEY,
                              stdin=str(new))
                    return op.replace(type="ok")
                except control.RemoteError as e:
                    # Only LogCabin's exact condition-mismatch message is a
                    # determinate fail; transport/timeout errors may have
                    # applied the write and must stay indeterminate
                    # (logcabin.clj:152-154 anchors the same message and
                    # :236-240 rethrows everything unmatched).
                    msg = f"{e.err or ''} {e.out or ''}"
                    if re.search(
                            r"LogCabin::Client::Exception: Path '.*' has "
                            r"value '.*', not '.*' as required", msg):
                        return op.replace(type="fail")
                    raise
            raise ValueError(f"unknown op {op.f!r}")
        except control.RemoteError as e:
            return op.replace(type=crash, error=str(e)[:80])


def logcabin_test(opts: dict) -> dict:
    test = noop_test()
    test.update({
        "name": "logcabin",
        "db": LogCabinDB(),
        "client": LogCabinClient(),
        "nemesis": nemesis.partition_random_halves(),
        "model": CASRegister(),
        "checker": compose({
            "perf": perf(),
            "linear": linearizable(CASRegister(),
                                   backend=opts.get("backend", "gpu"),
                                   device=opts.get("device"))}),
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(gen.stagger(1 / 10, wl.register_gen()),
                        gen.seq(_cycle()))),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


# ---------------------------------------------------------------------------
# RobustIRC
# ---------------------------------------------------------------------------


class RobustIRCDB(db_ns.DB):
    """robustirc.clj:23-84: go-get build on the node, shared TLS cert,
    primary starts -singlenode, the rest join it. The reference
    serializes the two waves with core barriers; here the primary's
    daemon starts in setup (first node in node order is the primary)
    and joiners point at it."""

    def __init__(self):
        self._cert_lock = threading.Lock()
        self._cert_dir: Optional[str] = None

    def _cert_pair(self, test):
        """One shared self-signed cert/key pair per test, generated on the
        control host and uploaded to every node. The reference ships a
        single pre-generated resources/cert.pem to all nodes
        (robustirc.clj:40-42); per-node certs would break joining — a
        joiner's -tls_ca_file must verify the PRIMARY's TLS endpoint, so
        every node has to trust the same certificate."""
        with self._cert_lock:
            if self._cert_dir is None:
                import atexit
                import shutil
                d = tempfile.mkdtemp(prefix="jepsen-robustirc-")
                sans = ",".join(f"DNS:{n}" for n in test["nodes"])
                pr = subprocess.run(
                    ["openssl", "req", "-x509", "-newkey", "rsa:2048",
                     "-nodes", "-keyout", f"{d}/key.pem",
                     "-out", f"{d}/cert.pem", "-days", "30",
                     "-subj", "/CN=jepsen",
                     "-addext", f"subjectAltName={sans}"],
                    capture_output=True, text=True)
                if pr.returncode != 0:
                    shutil.rmtree(d, ignore_errors=True)
                    raise RuntimeError(
                        f"cert generation failed: {pr.stderr.strip()}")
                # Key material is cleaned at process exit, NOT in per-node
                # teardown: db.cycle runs teardown-then-setup concurrently
                # per node on this shared instance, and freeing the pair in
                # one node's teardown while another node's setup is mid-
                # upload would hand the cluster two different certs.
                atexit.register(shutil.rmtree, d, ignore_errors=True)
                self._cert_dir = d
            return f"{self._cert_dir}/cert.pem", f"{self._cert_dir}/key.pem"

    def setup(self, test, node):
        from jepsen_tpu_torch.os import debian
        primary = test["nodes"][0]
        cert, key = self._cert_pair(test)
        control.upload(test, node, cert, "/tmp/cert.pem")
        control.upload(test, node, key, "/tmp/key.pem")
        with control.sudo():
            control.execute(test, node, "killall robustirc || true")
            debian.install(test, node, ["golang-go", "mercurial"])
            control.execute(
                test, node,
                "env GOPATH=~/gocode go get -u "
                "github.com/robustirc/robustirc")
            control.execute(test, node,
                            "rm -rf /var/lib/robustirc && "
                            "mkdir -p /var/lib/robustirc")
            role = ("-singlenode" if node == primary
                    else f"-join={primary}:13001")
            control.execute(
                test, node,
                "/sbin/start-stop-daemon --start --background "
                "--exec ~/gocode/bin/robustirc -- "
                f"-listen={node}:13001 -network_password=secret "
                f"-network_name=jepsen -tls_cert_path=/tmp/cert.pem "
                f"-tls_ca_file=/tmp/cert.pem "
                f"-tls_key_path=/tmp/key.pem {role}")

    def teardown(self, test, node):
        with control.sudo():
            control.execute(test, node, "killall robustirc || true")


RAVEN_DIR = "/opt/ravendb"


class RavenDB(db_ns.DB, db_ns.Primary, db_ns.LogFiles):
    """ravendb.clj:30-130: tarball install, daemon start, license
    activation over the admin HTTP API, and the leader linking every
    follower into the cluster."""

    def __init__(self, version: str = "4.0.0"):
        self.version = version

    def _url(self, node):
        return f"http://{node}:8080"

    def setup(self, test, node):
        from jepsen_tpu_torch.os import debian
        with control.sudo():
            control.execute(test, node, "killall Raven.Server || true")
            debian.install(test, node, ["libunwind8", "ca-certificates",
                                        "curl", "libicu-dev"])
            cu.install_archive(
                test, node,
                test.get("tarball",
                         f"https://daily-builds.s3.amazonaws.com/"
                         f"RavenDB-{self.version}-linux-x64.tar.bz2"),
                RAVEN_DIR)
            cu.start_daemon(
                test, node, f"{RAVEN_DIR}/Server/Raven.Server",
                "--ServerUrl", f"http://0.0.0.0:8080",
                "--PublicServerUrl", self._url(node),
                "--License.Eula.Accepted", "true",
                logfile=f"{RAVEN_DIR}/raven.log",
                pidfile=f"{RAVEN_DIR}/raven.pid", chdir=RAVEN_DIR)

    def setup_primary(self, test, node):
        """Leader links each follower (ravendb.clj:81-90 link-to!)."""
        for other in test["nodes"]:
            if other == node:
                continue
            control.execute(
                test, node,
                f"curl -L -X PUT -d '' "
                f"'{self._url(node)}/admin/cluster/node?"
                f"url={self._url(other)}&assignedCores=1'")

    def teardown(self, test, node):
        cu.stop_daemon(test, node, f"{RAVEN_DIR}/raven.pid",
                       cmd="Raven.Server")
        control.execute(test, node, f"rm -rf {RAVEN_DIR} || true")

    def log_files(self, test, node):
        return [f"{RAVEN_DIR}/raven.log"]


class IRCClient(client_ns.Client):
    """Set-over-IRC: add = PRIVMSG an integer to the channel, read =
    collect the channel backlog (robustirc.clj:213-215). Speaks minimal
    IRC over a stdlib socket."""

    CHANNEL = "#jepsen"

    def __init__(self, node=None, port: int = 6667, timeout: float = 5.0):
        self.node = node
        self.port = port
        self.timeout = timeout
        self.sock: Optional[socket.socket] = None
        self._rf = None
        self.seen: List[int] = []

    def open(self, test, node):
        c = IRCClient(node, self.port, self.timeout)
        return c

    def _connect(self):
        host = str(self.node)
        if ":" in host:
            host, port = host.rsplit(":", 1)
        else:
            port = self.port
        self.sock = socket.create_connection((host, int(port)),
                                             self.timeout)
        self.sock.settimeout(self.timeout)
        self._rf = self.sock.makefile("rb")
        nick = f"jepsen{id(self) % 10000}"
        self.sock.sendall(
            f"NICK {nick}\r\nUSER {nick} 0 * :jepsen\r\n"
            f"JOIN {self.CHANNEL}\r\n".encode())

    def _pump(self, deadline_lines: int = 50):
        """Read pending lines, answering PINGs and collecting channel
        messages."""
        for _ in range(deadline_lines):
            try:
                line = self._rf.readline()
            except (TimeoutError, OSError):
                return
            if not line:
                return
            text = line.decode("utf-8", "replace").strip()
            if text.startswith("PING"):
                self.sock.sendall(
                    ("PONG" + text[4:] + "\r\n").encode())
            if f"PRIVMSG {self.CHANNEL}" in text:
                payload = text.rsplit(":", 1)[-1].strip()
                if payload.isdigit():
                    self.seen.append(int(payload))

    def close(self, test):
        if self.sock:
            try:
                self.sock.close()
            finally:
                self.sock = None

    def invoke(self, test, op: Op) -> Op:
        try:
            if self.sock is None:
                self._connect()
            if op.f == "add":
                self.sock.sendall(
                    f"PRIVMSG {self.CHANNEL} :{int(op.value)}\r\n"
                    .encode())
                return op.replace(type="ok")
            if op.f == "read":
                self._pump()
                return op.replace(type="ok", value=sorted(set(self.seen)))
            raise ValueError(f"unknown op {op.f!r}")
        except (TimeoutError, OSError) as e:
            self.close(test)
            t = "fail" if op.f == "read" else "info"
            return op.replace(type=t, error=type(e).__name__)


def robustirc_test(opts: dict) -> dict:
    import itertools
    counter = itertools.count()

    def add(test, process):
        return {"type": "invoke", "f": "add", "value": next(counter)}

    test = noop_test()
    test.update({
        "name": "robustirc",
        "db": RobustIRCDB(),
        "client": IRCClient(),
        "nemesis": nemesis.partition_random_halves(),
        "checker": compose({"set": set_checker()}),
        "generator": gen.phases(
            gen.time_limit(opts.get("time-limit", 60),
                           gen.clients(gen.stagger(1 / 5, add),
                                       gen.seq(_cycle()))),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.sleep(10),
            gen.clients(gen.each(
                lambda: gen.once({"f": "read", "value": None})))),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


# ---------------------------------------------------------------------------
# RethinkDB
# ---------------------------------------------------------------------------


class RethinkDB(db_ns.DB, db_ns.LogFiles):
    """rethinkdb.clj db: apt install, join flags, admin over the first
    node; optional faketime wrapper around the binary
    (rethinkdb.clj:33-50: each daemon start gets a random clock offset
    and rate warp, the cheap way to run every node on a different
    clock)."""

    def __init__(self, faketime: bool = False):
        self.faketime = faketime

    def setup(self, test, node):
        import random as _r

        from jepsen_tpu_torch import faketime as ft
        from jepsen_tpu_torch.os import debian
        debian.install(test, node, ["rethinkdb"])
        if self.faketime:
            ft.wrap(test, node, "/usr/bin/rethinkdb",
                    init_offset=_r.randrange(100),
                    rate=1 + _r.random() / 10)
        joins = " ".join(f"--join {n}:29015" for n in test["nodes"]
                         if n != node)
        cu.start_daemon(test, node, "/usr/bin/rethinkdb",
                        "--bind", "all", *joins.split(),
                        logfile="/var/log/rethinkdb.log",
                        pidfile="/var/run/rethinkdb.pid", chdir="/var/lib")

    def teardown(self, test, node):
        cu.stop_daemon(test, node, "/var/run/rethinkdb.pid",
                       cmd="rethinkdb")
        control.execute(test, node,
                        "rm -rf /var/lib/rethinkdb_data || true")

    def log_files(self, test, node):
        return ["/var/log/rethinkdb.log"]


def reconfigure_nemesis():
    """rethinkdb.clj reconfigure nemesis: shuffle replicas/primaries via
    the admin API on a random node."""
    import random as _r

    class Reconfigure(nemesis.Nemesis):
        def invoke(self, test, op):
            node = _r.choice(test["nodes"])
            shards = _r.randrange(1, 5)
            replicas = _r.randrange(1, len(test["nodes"]) + 1)
            control.execute(
                test, node,
                f"rethinkdb admin --join {node}:29015 reconfigure "
                f"jepsen.cas --shards {shards} --replicas {replicas} "
                f"|| true")
            return op.replace(type="info",
                              value={"shards": shards,
                                     "replicas": replicas})

    return Reconfigure()


def reconfigure_grudge(nodes, new_primary):
    """A partition likely to strand the outgoing topology
    (rethinkdb.clj:234-249): half the cluster (never containing the new
    primary) against the rest — or, half the time, a plain random
    bisection; occasionally no partition at all."""
    import random as _r
    nodes = list(nodes)
    if _r.random() < 0.5:
        others = [n for n in nodes if n != new_primary]
        _r.shuffle(others)
        side1 = set(others[:len(nodes) // 2])
        side2 = [n for n in nodes if n not in side1]
        return nemesis.complete_grudge([sorted(side1), side2])
    _r.shuffle(nodes)
    return nemesis.complete_grudge(nemesis.bisect(nodes))


def aggressive_reconfigure_nemesis(db: str = "jepsen", table: str = "cas"):
    """rethinkdb.clj:251-331: each op picks a fresh random
    primary+replica set, reconfigures the table, HEALS the network, then
    applies a partition computed to strand the old topology — the
    combination that actually broke RethinkDB's guarantees. Stateful:
    the previous grudge feeds the next one."""
    import random as _r

    class AggressiveReconfigure(nemesis.Nemesis):
        def __init__(self):
            self.state = {"primary": None, "replicas": [], "grudge": {}}

        def invoke(self, test, op):
            nodes = list(test["nodes"])
            size = _r.randrange(1, len(nodes) + 1)
            replicas = _r.sample(nodes, size)
            primary = _r.choice(replicas)
            grudge = reconfigure_grudge(nodes, primary)
            control.execute(
                test, primary,
                f"rethinkdb admin --join {primary}:29015 reconfigure "
                f"{db}.{table} --shards 1 "
                f"--replicas {len(replicas)} || true")
            net = test.get("net")
            if net is not None:
                net.heal(test)
            nemesis.partition(test, grudge)
            self.state = {"primary": primary, "replicas": replicas,
                          "grudge": grudge}
            return op.replace(type="info", value=dict(self.state))

        def teardown(self, test):
            net = test.get("net")
            if net is not None:
                net.heal(test)

    return AggressiveReconfigure()


class RethinkClient(client_ns.Client):
    """Document CAS via ReQL executed with the driver on the *node* (the
    control plane ships a short python snippet; document_cas.clj:146-148
    does the same update-if-current logic via the JVM driver)."""

    def __init__(self, node=None, write_acks: str = "majority",
                 read_mode: str = "majority"):
        self.node = node
        self.write_acks = write_acks
        self.read_mode = read_mode

    def open(self, test, node):
        return RethinkClient(node, self.write_acks, self.read_mode)

    def setup(self, test):
        """Apply the acks matrix to the cluster (document_cas.clj
        set-write-acks!, :30-37): update the table_config row, spinning
        is the caller's retry policy."""
        self.node = self.node or test["nodes"][0]
        self._reql(
            test,
            "r.db('rethinkdb').table('table_config')"
            ".filter({'db': 'jepsen', 'name': 'cas'})"
            f".update({{'write_acks': '{self.write_acks}', "
            "'durability': 'hard'}).run(c)")

    def _reql(self, test, expr: str) -> str:
        script = (
            "import json, rethinkdb as r\n"
            f"c = r.connect('{self.node}', 28015)\n"
            f"print(json.dumps({expr}))\n")
        return control.execute(
            test, self.node, f"python3 -c {control.escape(script)}")

    def invoke(self, test, op: Op) -> Op:
        crash = "fail" if op.f == "read" else "info"
        try:
            if op.f == "read":
                out = self._reql(
                    test,
                    "r.db('jepsen').table('cas', read_mode="
                    f"'{self.read_mode}').get(0).run(c)")
                doc = json.loads(out or "null")
                return op.replace(type="ok",
                                  value=doc.get("v") if doc else None)
            if op.f == "write":
                self._reql(
                    test,
                    "r.db('jepsen').table('cas').insert("
                    f"{{'id': 0, 'v': {int(op.value)}}}, "
                    "conflict='replace').run(c)")
                return op.replace(type="ok")
            if op.f == "cas":
                old, new = op.value
                try:
                    out = self._reql(
                        test,
                        "r.db('jepsen').table('cas').get(0).update("
                        f"lambda row: r.branch(row['v'].eq({int(old)}), "
                        f"{{'v': {int(new)}}}, r.error('abort')), "
                        "return_changes=True).run(c)")
                except control.RemoteError as e:
                    # Only the deliberate r.error('abort') — surfaced by the
                    # driver as a ReqlUserError — is a determinate fail.
                    # A bare 'abort' substring would also match OS-level
                    # 'connection abort' transport errors, which must stay
                    # indeterminate.
                    if "ReqlUserError" in f"{e.err or ''} {e.out or ''}":
                        return op.replace(type="fail")
                    raise
                # ReQL may collect update-function errors into the result
                # instead of raising: errors>0 + first_error 'abort' is the
                # same determinate precondition failure.
                res = json.loads(out or "{}")
                if res.get("errors"):
                    if "abort" in str(res.get("first_error", "")):
                        return op.replace(type="fail")
                    return op.replace(type="info",
                                      error=str(res.get("first_error"))[:80])
                return op.replace(
                    type="ok" if res.get("replaced") else "fail")
            raise ValueError(f"unknown op {op.f!r}")
        except control.RemoteError as e:
            return op.replace(type=crash, error=str(e)[:80])


def rethinkdb_test(opts: dict) -> dict:
    """Document CAS with the write/read-acks matrix (rethinkdb.clj,
    document_cas.clj) and a reconfigure nemesis."""
    wa = opts.get("write-acks", "majority")
    rm = opts.get("read-mode", "majority")
    aggressive = opts.get("aggressive-reconfigure", False)
    test = noop_test()
    test.update({
        "name": f"rethinkdb-write-{wa}-read-{rm}"
                + ("-aggressive" if aggressive else ""),
        "db": RethinkDB(faketime=opts.get("faketime", False)),
        "client": RethinkClient(write_acks=wa, read_mode=rm),
        "nemesis": (aggressive_reconfigure_nemesis() if aggressive
                    else reconfigure_nemesis()),
        "model": CASRegister(),
        "checker": compose({
            "perf": perf(),
            "linear": linearizable(CASRegister(),
                                   backend=opts.get("backend", "gpu"),
                                   device=opts.get("device"))}),
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(gen.stagger(1 / 10, wl.register_gen()),
                        gen.seq(_cycle()))),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


def rethinkdb_aggressive_test(opts: dict) -> dict:
    """The acks-matrix CAS test under the aggressive reconfigure+
    partition nemesis (rethinkdb.clj:251-331)."""
    return rethinkdb_test({**opts, "aggressive-reconfigure": True})


# ---------------------------------------------------------------------------
# RavenDB
# ---------------------------------------------------------------------------


class RavenClient(client_ns.Client):
    """Register over the RavenDB HTTP document API (ravendb suite)."""

    def __init__(self, node=None, port: int = 8080, timeout: float = 5.0):
        self.node = node
        self.port = port
        self.timeout = timeout

    def open(self, test, node):
        return RavenClient(node, self.port, self.timeout)

    def _url(self, path):
        node = str(self.node)
        authority = node if ":" in node else f"{node}:{self.port}"
        return f"http://{authority}{path}"

    def invoke(self, test, op: Op) -> Op:
        crash = "fail" if op.f == "read" else "info"
        try:
            if op.f == "read":
                try:
                    with urllib.request.urlopen(
                            self._url("/databases/jepsen/docs?id=register"),
                            timeout=self.timeout) as resp:
                        doc = json.loads(resp.read().decode())
                    return op.replace(type="ok",
                                      value=doc.get("value"))
                except urllib.error.HTTPError as e:
                    if e.code == 404:
                        return op.replace(type="ok", value=None)
                    raise
            if op.f == "write":
                body = json.dumps({"value": op.value}).encode()
                req = urllib.request.Request(
                    self._url("/databases/jepsen/docs?id=register"),
                    data=body, method="PUT",
                    headers={"Content-Type": "application/json"})
                urllib.request.urlopen(req, timeout=self.timeout)
                return op.replace(type="ok")
            raise ValueError(f"unknown op {op.f!r}")
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            return op.replace(type=crash, error=type(e).__name__)


def ravendb_test(opts: dict) -> dict:
    test = noop_test()
    test.update({
        "name": "ravendb",
        "db": RavenDB(),
        "client": RavenClient(),
        "nemesis": nemesis.partition_random_halves(),
        "model": CASRegister(),
        "checker": compose({
            "perf": perf(),
            "linear": linearizable(CASRegister(),
                                   backend=opts.get("backend", "gpu"),
                                   device=opts.get("device"))}),
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(gen.stagger(1 / 10, gen.mix([wl.r, wl.w])),
                        gen.seq(_cycle()))),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


# ---------------------------------------------------------------------------
# MongoDB + RocksDB storage engine
# ---------------------------------------------------------------------------


def mongodb_rocks_test(opts: dict) -> dict:
    """mongodb_rocks.clj: the document-cas test with storage engine
    rocksdb."""
    from jepsen_tpu_torch.suites import mongodb

    class RocksMongoDB(mongodb.MongoDB):
        def setup(self, test, node):
            from jepsen_tpu_torch.os import debian as _d
            _d.install(test, node, ["mongodb-org"])
            conf = ("storage:\n  engine: rocksdb\n"
                    "replication:\n  replSetName: jepsen\n")
            with control.sudo():
                control.execute(
                    test, node,
                    f"echo {control.escape(conf)} >> /etc/mongod.conf")
                control.exec(test, node, "service", "mongod", "start")

    test = mongodb.document_cas_test(opts)
    test["name"] = "mongodb-rocks-document-cas"
    test["db"] = RocksMongoDB()
    return test


def _cycle():
    while True:
        yield gen.sleep(5)
        yield gen.once({"type": "info", "f": "start"})
        yield gen.sleep(5)
        yield gen.once({"type": "info", "f": "stop"})
