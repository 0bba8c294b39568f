#!/usr/bin/env python3
"""In-process servers that speak the wire protocols of the port's suites,
for runs on a machine that has no database binaries.

``EtcdFake`` is an etcd v2-keys store behind N HTTP listeners, one a
member, so that N node names reach N members of one cluster: ``GET
/v2/keys/<k>`` (404, errorCode 100, for a missing key) and ``PUT
/v2/keys/<k>`` with ``value`` and, for a compare-and-set, ``prevValue``
and ``prevExist`` (404 for a missing key, 412, errorCode 101, for another
value), every write applied to the one store under its lock. In
``stale_reads`` mode a ``?quorum=false`` read is answered by the member's
own replica instead, which applies the cluster's writes ``delay_s``
seconds after they were acknowledged (member 0, the leader, at once): a
read served by a lagging follower returns a value that a completed write
has already replaced. That is etcd's own finding under Jepsen, and what
``examples/localkv/kvnode.py --read-local`` does.

``ShimFake`` is the hazelcast suite's server shim (the line protocol of
``jepsen_tpu_torch/suites/resources/HazelcastShim.java``) over one
in-memory member: ``LOCK`` is a ``tryLock`` owned by the connection and
reentrant, ``UNLOCK`` by a connection that does not hold the lock is
``FAIL``, ``ID`` counts, ``MAPCAS`` with ``NIL`` is a put-if-absent, and
the queues are FIFO.

``CliFake`` is the data plane of the suites that run their database's
own command-line client on the nodes: cockroachdb's ``cockroach sql -e
STATEMENT``, aerospike's ``aql -c STATEMENT`` (with ``asinfo``'s roster
and statistics) and mongodb's ``mongosh --eval JS`` (with
``rs.status()``). Its :meth:`CliFake.sessions` are control-plane
sessions, one a node, to put in a test map's ``_sessions`` before
``core.run`` under ``ssh`` mode ``dummy``: they record every other
command, as the dummy control plane does, answer it from ``responses``
(the dummy control plane's scripted replies), and interpret those three
commands against one in-memory store (the cockroachdb registers table,
aerospike's generation-counted records and counter, mongodb's ``cas``
documents and accounts). A seeded ``timeout_p`` of the writes and CAS's
is answered with the client's timeout or broken connection, and half of
those are applied all the same, so the history holds crashed ops. In
``stale_reads`` mode the first node is mongodb's primary: the others
refuse writes and linearizable reads with ``not master`` and serve
other reads from a replica that applies the primary's writes ``delay_s``
late.

The same sessions interpret four more command-line data planes:
logcabin's ``logcabin --cluster ... read|write [--condition K:V] K`` (the
value written on standard input; a condition that does not hold is
LogCabin's ``Path '...' has value '...', not '...' as required``),
rethinkdb's ``python3 -c`` ReQL snippets (the ``table_config`` update, a
read under a read mode, the insert and the branch update, against one
document: in ``stale_reads`` mode the first node is the primary and an
``outdated`` read on another node is served by a replica ``delay_s``
late), and the SQL of galera's and percona's ``mysql --batch
--skip-column-names -e`` and postgres-rds's ``psql -c`` (the bank's
accounts, the set's rows and the dirty-read table). Seeded timeouts
answer logcabin, rethinkdb and mysql writes too.

``RavenFake`` is RavenDB's document API behind N HTTP listeners over one
document store: ``GET /databases/<db>/docs?id=<id>`` (404 for a missing
document) and ``PUT`` of a JSON document; a seeded ``error_p`` of the
PUTs is answered 503, and half of those are applied all the same.
``IrcFake`` is a line-protocol IRC server behind N listeners over one
channel log: ``JOIN`` replays the channel's messages, and a ``PRIVMSG``
to a channel is logged and relayed to every member, its sender too.

``ChronosFake`` is chronos's scheduler API behind N HTTP listeners
(``POST /scheduler/iso8601``, ``GET /scheduler/jobs``), whose schedule
writes each run's logfile on a slave node as the job's command would,
on a clock of the caller's (a test runs it faster than the wall clock);
``CliFake(..., chronos=fake)`` answers ``ls`` and ``cat`` of those
logfiles, and a switch drops or delays one due run.

``DUMMY_RESPONSES`` holds, per suite, the dummy control plane's replies
that let the suite's database lifecycle be recorded from its install to
its start (``run --ssh-mode dummy --dummy-responses FILE``).

The module uses the standard library only. Run as a script, it starts
one fake, prints ``{"nodes": [...]}`` on a line and serves until its
standard input closes (in a terminal: until Ctrl-C) or it is
terminated::

    python3 tools/torch_suite_fakes.py etcd --members 5 [--stale-reads]
    python3 tools/torch_suite_fakes.py hazelcast --members 5

(``CliFake`` has no listener, and ``RavenFake``, ``IrcFake`` and
``ChronosFake`` are started in the process that runs the test.)
"""

import argparse
import datetime
import json
import random
import re
import shlex
import signal
import socketserver
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

HOST = "127.0.0.1"

#: suite -> command substring -> the dummy control plane's reply (stdout,
#: or [exit, stdout, stderr]): the archive's one top-level directory and
#: the install directory's parent, so that ``install_archive`` goes on to
#: the start; no cached download
DUMMY_RESPONSES = {
    "etcd": {"stat ": [1, "", "no such file"],
             "ls -A": "etcd-v3.1.5-linux-amd64", "dirname": "/opt"},
    "hazelcast": {},
    "cockroachdb": {"stat ": [1, "", "no such file"],
                    "ls -A": "cockroach-v1.0.linux-amd64",
                    "dirname": "/opt"},
    # the roster dance's and the replica set's answers for five nodes
    "aerospike": {
        "roster:namespace": "roster=A1,A2,A3,A4,A5:pending_roster=A1,A2,"
                            "A3,A4,A5:observed_nodes=A1,A2,A3,A4,A5",
        "asinfo -v statistics": "cluster_size=5;migrate_allowed=true;"
                                "migrate_partitions_remaining=0"},
    "mongodb": {"rs.status()": json.dumps({"set": "jepsen", "members": [
        {"name": f"n{i}:27017",
         "stateStr": "PRIMARY" if i == 1 else "SECONDARY"}
        for i in range(1, 6)]})},
    "logcabin": {},
    "rethinkdb": {},
    "ravendb": {"stat ": [1, "", "no such file"],
                "ls -A": "RavenDB-4.0.0", "dirname": "/opt"},
    "galera": {},
    "tidb": {"stat ": [1, "", "no such file"],
             "ls -A": "tidb-latest-linux-amd64", "dirname": "/opt"},
}
DUMMY_RESPONSES["mongodb-rocks"] = DUMMY_RESPONSES["mongodb"]


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # fifty workers connect at once: the default backlog of 5 drops SYNs
    request_queue_size = 256


class EtcdFake:
    """N HTTP listeners over one etcd v2-keys store."""

    def __init__(self, members: int = 5, stale_reads: bool = False,
                 delay_s: float = 0.5):
        self.members = members
        self.stale_reads = stale_reads
        self.delay_s = delay_s
        self.lock = threading.Lock()
        #: key -> its value (a string, as etcd keeps it)
        self.store = {}
        #: key -> [(acknowledged at, value)], for the replicas' reads
        self.log = {}
        self.servers = []
        self.stats = {"reads": 0, "stale": 0, "writes": 0, "cas": 0}

    def replica_value(self, member: int, key: str):
        """The value member ``member``'s replica holds: the last write
        acknowledged ``delay_s`` ago or earlier (the leader's is the
        store's)."""
        if member == 0:
            return self.store.get(key)
        cutoff = time.monotonic() - self.delay_s
        value = None
        for t, v in self.log.get(key, ()):
            if t > cutoff:
                break
            value = v
        return value

    def _handler(self, member: int):
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _key(self):
                path = urllib.parse.urlparse(self.path).path
                return urllib.parse.unquote(path[len("/v2/keys/"):])

            def _reply(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _missing(self, k):
                return self._reply(404, {"errorCode": 100,
                                         "message": "Key not found",
                                         "cause": f"/{k}"})

            def do_GET(self):  # noqa: N802
                k = self._key()
                query = urllib.parse.parse_qs(
                    urllib.parse.urlparse(self.path).query)
                local = query.get("quorum") == ["false"]
                with fake.lock:
                    fake.stats["reads"] += 1
                    v = fake.store.get(k)
                    if local and fake.stale_reads:
                        r = fake.replica_value(member, k)
                        fake.stats["stale"] += r != v
                        v = r
                if v is None:
                    return self._missing(k)
                return self._reply(200, {"action": "get", "node": {
                    "key": f"/{k}", "value": v}})

            def do_PUT(self):  # noqa: N802
                k = self._key()
                n = int(self.headers.get("Content-Length", 0))
                form = dict(urllib.parse.parse_qsl(
                    self.rfile.read(n).decode()))
                with fake.lock:
                    cur = fake.store.get(k)
                    if "prevValue" in form or "prevExist" in form:
                        fake.stats["cas"] += 1
                        if cur is None:
                            return self._missing(k)
                        if "prevValue" in form \
                                and cur != form["prevValue"]:
                            return self._reply(412, {
                                "errorCode": 101,
                                "message": "Compare failed",
                                "cause": f"[{form['prevValue']} != {cur}]"})
                    else:
                        fake.stats["writes"] += 1
                    v = form["value"]
                    fake.store[k] = v
                    fake.log.setdefault(k, []).append((time.monotonic(), v))
                return self._reply(200, {"action": "set", "node": {
                    "key": f"/{k}", "value": v}})

        return Handler

    def start(self) -> list:
        """Start the listeners; their ``host:port`` node names."""
        for m in range(self.members):
            s = _HTTPServer((HOST, 0), self._handler(m))
            threading.Thread(target=s.serve_forever, daemon=True).start()
            self.servers.append(s)
        return self.nodes()

    def nodes(self) -> list:
        return [f"{HOST}:{s.server_address[1]}" for s in self.servers]

    def stop(self) -> None:
        for s in self.servers:
            s.shutdown()
            s.server_close()
        self.servers = []


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    request_queue_size = 256


class ShimFake:
    """The hazelcast shim's line protocol over one in-memory member,
    behind N listeners."""

    def __init__(self, members: int = 5):
        self.members = members
        self.lock = threading.Lock()
        #: lock name -> [owning connection, hold count]
        self.locks = {}
        self.ids = {"LONG": 0, "REF": 0, "GEN": 0}
        self.maps = {}
        self.queues = {}
        self.servers = []

    def dispatch(self, conn, t) -> str:
        with self.lock:
            verb = t[0] if t else ""
            if verb == "LOCK":
                held = self.locks.get(t[1])
                if held is None:
                    self.locks[t[1]] = [conn, 1]
                    return "OK"
                if held[0] is conn:
                    held[1] += 1
                    return "OK"
                return "FAIL"
            if verb == "UNLOCK":
                held = self.locks.get(t[1])
                if held is None or held[0] is not conn:
                    return "FAIL"
                held[1] -= 1
                if held[1] == 0:
                    del self.locks[t[1]]
                return "OK"
            if verb == "ID" and t[1] in self.ids:
                self.ids[t[1]] += 1
                return str(self.ids[t[1]])
            if verb == "MAPPUT":
                self.maps[(t[1], t[2])] = t[3]
                return "OK"
            if verb == "MAPGET":
                return self.maps.get((t[1], t[2]), "NIL")
            if verb == "MAPCAS":
                cur = self.maps.get((t[1], t[2]))
                if (cur is None) != (t[3] == "NIL") or \
                        (cur is not None and cur != t[3]):
                    return "FAIL"
                self.maps[(t[1], t[2])] = t[4]
                return "OK"
            if verb == "QOFFER":
                self.queues.setdefault(t[1], []).append(t[2])
                return "OK"
            if verb == "QPOLL":
                q = self.queues.setdefault(t[1], [])
                return q.pop(0) if q else "NIL"
            return "ERR unknown command"

    def start(self) -> list:
        fake = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                conn = object()
                while True:
                    try:
                        line = self.rfile.readline()
                    except OSError:
                        return
                    if not line:
                        return
                    reply = fake.dispatch(conn, line.decode().split())
                    self.wfile.write((reply + "\n").encode())
                    self.wfile.flush()

        for _ in range(self.members):
            s = _TCPServer((HOST, 0), Handler)
            threading.Thread(target=s.serve_forever, daemon=True).start()
            self.servers.append(s)
        return self.nodes()

    def nodes(self) -> list:
        return [f"{HOST}:{s.server_address[1]}" for s in self.servers]

    def stop(self) -> None:
        for s in self.servers:
            s.shutdown()
            s.server_close()
        self.servers = []


class RavenFake:
    """RavenDB's document API behind N HTTP listeners over one store."""

    def __init__(self, members: int = 5, error_p: float = 0.0,
                 seed: int = 0):
        self.members = members
        self.error_p = error_p
        self.rng = random.Random(seed)
        self.lock = threading.Lock()
        #: (database, id) -> the document
        self.docs = {}
        #: [method, status, times left]: scripted replies, applying
        #: nothing, taken before the store is consulted
        self.scripted = []
        self.servers = []
        self.stats = {"reads": 0, "writes": 0, "errors": 0,
                      "applied-errors": 0}

    def script(self, method: str, status: int, times: int = 1) -> None:
        """Answer the next ``times`` requests of ``method`` with
        ``status`` and apply nothing."""
        with self.lock:
            self.scripted.append([method, status, times])

    def _scripted(self, method):
        with self.lock:
            for entry in self.scripted:
                if entry[0] == method and entry[2] > 0:
                    entry[2] -= 1
                    return entry[1]
        return None

    def _handler(self):
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _doc_key(self):
                url = urllib.parse.urlparse(self.path)
                parts = url.path.strip("/").split("/")
                query = urllib.parse.parse_qs(url.query)
                if len(parts) != 3 or parts[0] != "databases" \
                        or parts[2] != "docs" or "id" not in query:
                    return None
                return parts[1], query["id"][0]

            def _reply(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                key = self._doc_key()
                if key is None:
                    return self._reply(400, {"Message": "bad route"})
                status = fake._scripted("GET")
                if status is not None:
                    return self._reply(status, {"Message": "scripted"})
                with fake.lock:
                    fake.stats["reads"] += 1
                    doc = fake.docs.get(key)
                if doc is None:
                    return self._reply(404, {"Message": "not found"})
                return self._reply(200, doc)

            def do_PUT(self):  # noqa: N802
                key = self._doc_key()
                n = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(n).decode() or "null")
                if key is None or not isinstance(doc, dict):
                    return self._reply(400, {"Message": "bad request"})
                status = fake._scripted("PUT")
                if status is not None:
                    return self._reply(status, {"Message": "scripted"})
                with fake.lock:
                    fake.stats["writes"] += 1
                    failed = (fake.error_p > 0
                              and fake.rng.random() < fake.error_p)
                    applied = not failed or fake.rng.random() < 0.5
                    if failed:
                        fake.stats["errors"] += 1
                        fake.stats["applied-errors"] += applied
                    if applied:
                        fake.docs[key] = doc
                if failed:
                    return self._reply(503, {"Message": "Service "
                                                        "Unavailable"})
                return self._reply(201, {"Id": key[1]})

        return Handler

    def start(self) -> list:
        """Start the listeners; their ``host:port`` node names."""
        for _ in range(self.members):
            s = _HTTPServer((HOST, 0), self._handler())
            threading.Thread(target=s.serve_forever, daemon=True).start()
            self.servers.append(s)
        return self.nodes()

    def nodes(self) -> list:
        return [f"{HOST}:{s.server_address[1]}" for s in self.servers]

    def stop(self) -> None:
        for s in self.servers:
            s.shutdown()
            s.server_close()
        self.servers = []


class IrcFake:
    """A line-protocol IRC server behind N listeners over one channel
    log."""

    def __init__(self, members: int = 5):
        self.members = members
        self.lock = threading.Lock()
        #: channel -> [message lines]; channel -> {connection's writer}
        self.log = {}
        self.joined = {}
        self.servers = []
        self.stats = {"messages": 0, "joins": 0}

    def _send(self, wfile, line):
        try:
            wfile.write((line + "\r\n").encode())
            wfile.flush()
        except OSError:
            pass

    def start(self) -> list:
        fake = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                nick = "anon"
                channels = []
                try:
                    while True:
                        try:
                            raw = self.rfile.readline()
                        except OSError:
                            return
                        if not raw:
                            return
                        line = raw.decode("utf-8", "replace").strip()
                        verb, _, rest = line.partition(" ")
                        if verb == "NICK":
                            nick = rest.strip()
                        elif verb == "PING":
                            fake._send(self.wfile, "PONG " + rest)
                        elif verb == "JOIN":
                            ch = rest.strip()
                            with fake.lock:
                                fake.stats["joins"] += 1
                                fake.joined.setdefault(ch, set()).add(
                                    self.wfile)
                                backlog = list(fake.log.get(ch, ()))
                            channels.append(ch)
                            for msg in backlog:
                                fake._send(self.wfile, msg)
                        elif verb == "PRIVMSG":
                            ch = rest.split(" ", 1)[0]
                            msg = f":{nick} {line}"
                            with fake.lock:
                                fake.stats["messages"] += 1
                                fake.log.setdefault(ch, []).append(msg)
                                members = list(fake.joined.get(ch, ()))
                            for w in members:
                                fake._send(w, msg)
                finally:
                    with fake.lock:
                        for ch in channels:
                            fake.joined.get(ch, set()).discard(self.wfile)

        for _ in range(self.members):
            s = _TCPServer((HOST, 0), Handler)
            threading.Thread(target=s.serve_forever, daemon=True).start()
            self.servers.append(s)
        return self.nodes()

    def nodes(self) -> list:
        return [f"{HOST}:{s.server_address[1]}" for s in self.servers]

    def stop(self) -> None:
        for s in self.servers:
            s.shutdown()
            s.server_close()
        self.servers = []


#: where chronos's runs write their logfiles on the nodes (chronos.JOB_DIR)
CHRONOS_JOB_DIR = "/tmp/chronos-test/"
_ISO_SCHEDULE = re.compile(r"R(\d+)/(\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ)"
                           r"/PT(\d+)S$")


def _date_ins(t: float) -> str:
    """``date -u -Ins`` of POSIX seconds ``t``, with the comma of a locale
    that writes one."""
    whole = int(t // 1)
    stamp = datetime.datetime.fromtimestamp(whole, datetime.timezone.utc)
    return (stamp.strftime("%Y-%m-%dT%H:%M:%S")
            + f",{int(round((t - whole) * 1e9)) % 1000000000:09d}+00:00")


class ChronosFake:
    """Chronos's scheduler API behind N HTTP listeners, and the run
    logfiles its schedule writes on the nodes.

    ``POST /scheduler/iso8601`` registers a job from the client's
    ``{"name", "schedule": "R<count>/<start>/PT<interval>S", "epsilon":
    "PT<s>S", "command": "sleep <duration>"}`` (204); ``GET
    /scheduler/jobs`` lists the jobs. The k-th run of a job begins at its
    schedule's start plus k intervals plus a seeded scheduler lag of 1 to
    2 s (the schedule has whole seconds, so a run never begins before the
    job's own start), on one of the slaves (the nodes after the first
    three, as mesos places them), and lasts the job's duration. At any
    instant of ``clock`` the runs begun so far are on their nodes as
    logfiles under ``CHRONOS_JOB_DIR`` in the format of the suite's
    ``run_command`` (name, begin, end; a run still going has no end
    line): :meth:`ls` and :meth:`cat` answer the suite's ``ls`` and
    ``cat`` through ``CliFake(..., chronos=fake)``. With ``fault``
    "drop" the first run of the first job registered never happens;
    with "delay" it begins ``epsilon`` + 6 s late, past the checker's
    forgiveness."""

    def __init__(self, members: int = 5, clock=time.time, fault=None,
                 seed: int = 0):
        assert fault in (None, "drop", "delay"), fault
        self.members = members
        self.clock = clock
        self.fault = fault
        self.rng = random.Random(seed)
        self.lock = threading.Lock()
        #: name -> {"start", "interval", "count", "epsilon", "duration",
        #: "lags": [s]}, in registration order
        self.jobs = {}
        self.servers = []
        self.stats = {"jobs": 0, "reads": 0}

    def _handler(self):
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code, obj=None):
                body = b"" if obj is None else json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path.rstrip("/") != "/scheduler/jobs":
                    return self._reply(404, {"message": "not found"})
                with fake.lock:
                    fake.stats["reads"] += 1
                    jobs = [dict(name=str(n), **{k: v for k, v in j.items()
                                                 if k != "lags"})
                            for n, j in fake.jobs.items()]
                return self._reply(200, jobs)

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length", 0))
                try:
                    doc = json.loads(self.rfile.read(n).decode())
                    m = _ISO_SCHEDULE.match(doc["schedule"])
                    eps = re.fullmatch(r"PT(\d+)S", doc["epsilon"])
                    dur = re.fullmatch(r"sleep (\d+)", doc["command"])
                    name = int(doc["name"])
                except (ValueError, KeyError, TypeError):
                    m = eps = dur = None
                if self.path != "/scheduler/iso8601" or not (m and eps
                                                            and dur):
                    return self._reply(400, {"message": "bad job"})
                start = datetime.datetime.strptime(
                    m.group(2), "%Y-%m-%dT%H:%M:%SZ").replace(
                    tzinfo=datetime.timezone.utc).timestamp()
                with fake.lock:
                    fake.stats["jobs"] += 1
                    count = int(m.group(1))
                    fake.jobs[name] = {
                        "start": start, "interval": int(m.group(3)),
                        "count": count, "epsilon": int(eps.group(1)),
                        "duration": int(dur.group(1)),
                        "lags": [1.0 + fake.rng.random()
                                 for _ in range(count)]}
                return self._reply(204)

        return Handler

    def runs(self, now=None) -> list:
        """(node, filename, name, begin, end or None) of every run begun
        by ``now`` (default: the clock)."""
        now = self.clock() if now is None else now
        slaves = sorted(self.nodes(), key=str)
        slaves = slaves[3:] or slaves
        out = []
        with self.lock:
            first = next(iter(self.jobs), None)
            for name, j in self.jobs.items():
                for k in range(j["count"]):
                    begin = j["start"] + k * j["interval"] + j["lags"][k]
                    if name == first and k == 0 and self.fault:
                        if self.fault == "drop":
                            continue
                        begin += j["epsilon"] + 6
                    if begin > now:
                        break
                    end = begin + j["duration"]
                    out.append((slaves[(name + k) % len(slaves)],
                                f"tmp.{name}-{k}", name, begin,
                                end if end <= now else None))
        return out

    def ls(self, node):
        """``ls -A CHRONOS_JOB_DIR`` on ``node``: (rc, stdout, stderr)."""
        names = [f for n, f, *_ in self.runs() if n == node]
        return 0, "\n".join(names) + ("\n" if names else ""), ""

    def cat(self, node, path):
        """``cat`` of one run logfile on ``node``."""
        for n, f, name, begin, end in self.runs():
            if n == node and CHRONOS_JOB_DIR + f == path:
                lines = [str(name), _date_ins(begin)]
                if end is not None:
                    lines.append(_date_ins(end))
                return 0, "\n".join(lines) + "\n", ""
        return 1, "", f"cat: {path}: No such file or directory"

    def start(self) -> list:
        """Start the listeners; their ``host:port`` node names."""
        for _ in range(self.members):
            s = _HTTPServer((HOST, 0), self._handler())
            threading.Thread(target=s.serve_forever, daemon=True).start()
            self.servers.append(s)
        return self.nodes()

    def nodes(self) -> list:
        return [f"{HOST}:{s.server_address[1]}" for s in self.servers]

    def stop(self) -> None:
        for s in self.servers:
            s.shutdown()
            s.server_close()
        self.servers = []


#: the cockroachdb register table's statements (cockroachdb.RegisterClient)
_SQL_SELECT = re.compile(r"SELECT val FROM registers WHERE id = (-?\d+)$")
_SQL_UPSERT = re.compile(r"UPSERT INTO registers \(id, val\) VALUES "
                         r"\((-?\d+), (-?\d+)\)$")
_SQL_CAS = re.compile(r"UPDATE registers SET val = (-?\d+) WHERE id = "
                      r"(-?\d+) AND val = (-?\d+) RETURNING val$")
#: aerospike's aql statements (aerospike.CasRegisterClient, CounterClient)
_AQL_SELECT = re.compile(r"SELECT value FROM (\w+)\.(\w+) WHERE PK = "
                         r"(-?\d+)$")
_AQL_INSERT = re.compile(r"INSERT INTO (\w+)\.(\w+) \(PK, value\) VALUES "
                         r"\((-?\d+), (-?\d+)\)(?: WITH gen_equal = "
                         r"(\d+))?$")
_AQL_ADD = re.compile(r"EXECUTE add\.add\('value', (-?\d+)\) ON "
                      r"(\w+)\.(\w+) WHERE PK = (-?\d+)$")
#: mongosh's scripts (mongodb.DocumentCASClient, TransferClient)
_JS_FIND = re.compile(r"\.cas\.find\(\{_id: (-?\d+)\}\)\.readConcern\("
                      r"'(\w+)'\)")
_JS_UPDATE = re.compile(r"\.cas\.update\(\{_id: (-?\d+)\}, \{\$set: "
                        r"\{value: (-?\d+)\}\}")
_JS_CAS = re.compile(r"\.cas\.findAndModify\(\{query: \{_id: (-?\d+), "
                     r"value: (-?\d+)\}, update: \{\$set: \{value: "
                     r"(-?\d+)\}\}\}\)")
_JS_OPEN = re.compile(r"\.accounts\.update\(\{_id: (\d+)\}, \{"
                      r"\$setOnInsert: \{balance: (-?\d+)\}\}")
_JS_TRANSFER = re.compile(r"from: (\d+), to: (\d+), amount: (\d+)\}")
#: LogCabin's answer to a condition that does not hold
#: (small.LogCabinClient)
LOGCABIN_MISMATCH = ("Exiting due to LogCabin::Client::Exception: Path "
                     "'{path}' has value '{value}', not '{want}' as "
                     "required")
#: rethinkdb's ReQL snippets (small.RethinkClient)
_REQL_NODE = re.compile(r"r\.connect\('([^']*)', 28015\)")
_REQL_ACKS = re.compile(r"table\('table_config'\)\.filter\(\{'db': "
                        r"'(\w+)', 'name': '(\w+)'\}\)\.update\(\{"
                        r"'write_acks': '(\w+)'")
_REQL_READ = re.compile(r"table\('cas', read_mode='(\w+)'\)\.get\("
                        r"(-?\d+)\)\.run\(c\)")
_REQL_INSERT = re.compile(r"table\('cas'\)\.insert\(\{'id': (-?\d+), "
                          r"'v': (-?\d+)\}, conflict='replace'\)")
_REQL_CAS = re.compile(r"table\('cas'\)\.get\((-?\d+)\)\.update\("
                       r"lambda row: r\.branch\(row\['v'\]\.eq\((-?\d+)"
                       r"\), \{'v': (-?\d+)\}, r\.error\('abort'\)\)")
#: the SQL of galera's, percona's and postgres-rds's clients
_MY_SEED = re.compile(r"INSERT (?:IGNORE )?INTO (accounts|dirty) VALUES "
                      r"\((-?\d+), (-?\d+)\)")
_MY_DEBIT = re.compile(r"UPDATE accounts SET balance = balance - (\d+) "
                       r"WHERE id = (\d+) AND balance >= (\d+)")
_MY_CREDIT = re.compile(r"UPDATE accounts SET balance = balance \+ (\d+) "
                        r"WHERE id = (\d+)")
_MY_SET_ADD = re.compile(r"INSERT INTO sets \(value\) VALUES (?:\()?"
                         r"(-?\d+)")
_MY_DIRTY = re.compile(r"UPDATE dirty SET x = (-?\d+) WHERE id = (-?\d+)")

#: the clients' answers to a write that timed out or lost its connection
TIMEOUTS = {
    "cockroachdb": "Error: read tcp: connection reset by peer",
    "aerospike": "Error: (9) AEROSPIKE_ERR_TIMEOUT: timeout",
    "mongodb": "MongoNetworkTimeoutError: connection timed out",
    "logcabin": "Exiting due to LogCabin::Client::Exception: "
                "Client-specified timeout elapsed",
    "rethinkdb": "rethinkdb.errors.ReqlTimeoutError: Could not connect "
                 "to the server, operation timed out.",
    "mysql": "ERROR 2013 (HY000): Lost connection to MySQL server during "
             "query",
    "psql": "psql: error: server closed the connection unexpectedly",
}
NOT_MASTER = "MongoServerError: not master and secondaryOk=false"


class CliSession:
    """A control-plane session on one node of a :class:`CliFake`: the
    dummy session's interface (``execute``, ``upload``, ``download``,
    ``close``, ``log``)."""

    def __init__(self, fake, node):
        self.fake = fake
        self.node = node
        #: the commands this node ran that are not a data-plane command
        self.log = []

    def execute(self, cmd, stdin=None, timeout=None):
        reply = self.fake.data_plane(self.node, cmd, stdin)
        if reply is not None:
            return reply
        self.log.append(cmd)
        for pat, resp in self.fake.responses.items():
            if pat in cmd:
                if isinstance(resp, (list, tuple)):
                    return tuple(resp)
                return 0, resp, ""
        return 0, "", ""

    def upload(self, local, remote):
        self.log.append(f"UPLOAD {local} -> {remote}")

    def download(self, remote, local):
        self.log.append(f"DOWNLOAD {remote} -> {local}")

    def close(self):
        pass


class CliFake:
    """The command-line data planes of the cockroachdb, aerospike and
    mongodb suites over one in-memory store (module docstring)."""

    def __init__(self, nodes, responses=None, timeout_p: float = 0.0,
                 seed: int = 0, stale_reads: bool = False,
                 delay_s: float = 0.5, chronos=None):
        self.nodes = [str(n) for n in nodes]
        #: a ChronosFake whose run logfiles ``ls`` and ``cat`` read
        self.chronos = chronos
        self.responses = {k: v for k, v in (responses or {}).items()}
        self.timeout_p = timeout_p
        self.rng = random.Random(seed)
        self.stale_reads = stale_reads
        self.delay_s = delay_s
        self.lock = threading.Lock()
        #: cockroachdb: id -> val
        self.registers = {}
        #: aerospike: (set, pk) -> [value, generation]
        self.records = {}
        #: mongodb: _id -> value; _id -> [(acknowledged at, value)]
        self.docs = {}
        self.doc_log = {}
        self.accounts = {}
        #: logcabin: path -> value; rethinkdb: id -> v, and its log
        self.tree = {}
        self.rdocs = {}
        self.rdoc_log = {}
        self.write_acks = None
        #: mysql and psql: the accounts, the set's rows, the dirty table
        self.sql_accounts = {}
        self.sql_set = []
        self.sql_dirty = {}
        #: [pattern, (rc, out, err), times left]: scripted data-plane
        #: replies, taken before the store is consulted
        self.scripted = []
        self.stats = {"reads": 0, "writes": 0, "cas": 0, "timeouts": 0,
                      "applied-timeouts": 0, "stale": 0, "not-master": 0,
                      "generation": 0}

    def sessions(self) -> dict:
        """One session a node, for a test map's ``_sessions``."""
        return {n: CliSession(self, n) for n in self.nodes}

    def script(self, pattern: str, reply, times: int = 1) -> None:
        """Answer the next ``times`` data-plane commands that contain
        ``pattern`` with ``reply`` (rc, stdout, stderr), applying
        nothing."""
        with self.lock:
            self.scripted.append([pattern, tuple(reply), times])

    # -- dispatch -----------------------------------------------------------

    def data_plane(self, node, cmd, stdin=None):
        """(rc, stdout, stderr) of a data-plane command; None for any
        other command."""
        try:
            argv = shlex.split(cmd)
        except ValueError:
            return None
        if self.chronos is not None and argv[:2] == ["ls", "-A"] \
                and argv[2:] == [CHRONOS_JOB_DIR]:
            return self.chronos.ls(node)
        if self.chronos is not None and argv[:1] == ["cat"] \
                and len(argv) == 2 and argv[1].startswith(CHRONOS_JOB_DIR):
            return self.chronos.cat(node, argv[1])
        if len(argv) > 2 and argv[0].endswith("cockroach") \
                and argv[1] == "sql" and "-e" in argv:
            kind, body = "cockroachdb", argv[argv.index("-e") + 1]
        elif argv[:1] == ["aql"] and "-c" in argv:
            kind, body = "aerospike", argv[argv.index("-c") + 1]
        elif argv[:1] == ["mongosh"] and "--eval" in argv:
            kind, body = "mongodb", argv[argv.index("--eval") + 1]
        elif argv[:1] == ["logcabin"] and "--cluster" in argv:
            kind = "logcabin"
            body = " ".join(argv[argv.index("--cluster") + 2:])
        elif argv[:2] == ["python3", "-c"] and len(argv) == 3 \
                and "rethinkdb as r" in argv[2]:
            kind, body = "rethinkdb", argv[2]
        elif argv[:1] == ["mysql"] and "-e" in argv:
            kind, body = "mysql", argv[argv.index("-e") + 1]
        elif argv[:1] == ["psql"] and "-c" in argv:
            kind, body = "psql", argv[argv.index("-c") + 1]
        else:
            return None
        with self.lock:
            for entry in self.scripted:
                if entry[0] in body and entry[2] > 0:
                    entry[2] -= 1
                    return entry[1]
            if kind == "logcabin":
                return self._logcabin(node, body, stdin)
            return getattr(self, "_" + kind)(node, body)

    def _timed_out(self, kind):
        """Whether this write times out; with half of those it is applied
        all the same (the caller's ``apply``)."""
        if self.timeout_p <= 0 or self.rng.random() >= self.timeout_p:
            return None
        self.stats["timeouts"] += 1
        applied = self.rng.random() < 0.5
        self.stats["applied-timeouts"] += applied
        return applied, (1, "", TIMEOUTS[kind])

    # -- cockroach sql --------------------------------------------------------

    def _cockroachdb(self, node, stmt):
        stmt = stmt.strip()
        if stmt.startswith("CREATE TABLE"):
            return 0, "", ""
        m = _SQL_SELECT.match(stmt)
        if m:
            self.stats["reads"] += 1
            v = self.registers.get(int(m.group(1)))
            return 0, "val\n" + ("" if v is None else f"{v}\n"), ""
        m = _SQL_UPSERT.match(stmt)
        if m:
            self.stats["writes"] += 1
            t = self._timed_out("cockroachdb")
            if t is None or t[0]:
                self.registers[int(m.group(1))] = int(m.group(2))
            return t[1] if t else (0, "", "")
        m = _SQL_CAS.match(stmt)
        if m:
            self.stats["cas"] += 1
            new, k, old = (int(g) for g in m.groups())
            hit = self.registers.get(k) == old
            t = self._timed_out("cockroachdb")
            if hit and (t is None or t[0]):
                self.registers[k] = new
            if t:
                return t[1]
            return 0, "val\n" + (f"{new}\n" if hit else ""), ""
        return 1, "", f"ERROR: the fake does not run {stmt!r}"

    # -- aerospike aql --------------------------------------------------------

    def _aerospike(self, node, stmt):
        stmt = stmt.strip()
        m = _AQL_SELECT.match(stmt)
        if m:
            self.stats["reads"] += 1
            rec = self.records.get((m.group(2), int(m.group(3))))
            if rec is None:
                return 0, "Error: (2) AEROSPIKE_ERR_RECORD_NOT_FOUND\n", ""
            return 0, (f"+-------+\n| value |\n+-------+\n"
                       f"| {rec[0]:<5} |\n+-------+\n"
                       f'{{"gen": {rec[1]}}}\n'), ""
        m = _AQL_INSERT.match(stmt)
        if m:
            key = (m.group(2), int(m.group(3)))
            rec = self.records.get(key)
            predicate = m.group(5)
            self.stats["cas" if predicate is not None else "writes"] += 1
            if predicate is not None and (rec is None
                                          or rec[1] != int(predicate)):
                self.stats["generation"] += 1
                return 1, "", ("Error: (3) AEROSPIKE_ERR_RECORD_GENERATION "
                               "FAIL_GENERATION")
            t = self._timed_out("aerospike")
            if t is None or t[0]:
                self.records[key] = [int(m.group(4)),
                                     (rec[1] if rec else 0) + 1]
            return t[1] if t else (0, "OK, 1 record affected.\n", "")
        m = _AQL_ADD.match(stmt)
        if m:
            self.stats["writes"] += 1
            key = (m.group(3), int(m.group(4)))
            rec = self.records.setdefault(key, [0, 0])
            t = self._timed_out("aerospike")
            if t is None or t[0]:
                rec[0] += int(m.group(1))
                rec[1] += 1
            return t[1] if t else (0, "", "")
        return 1, "", f"Error: the fake does not run {stmt!r}"

    # -- mongosh ----------------------------------------------------------------

    def _primary(self):
        return self.nodes[0]

    def _replica_value(self, log, k):
        cutoff = time.monotonic() - self.delay_s
        value = None
        for t, v in log.get(k, ()):
            if t > cutoff:
                break
            value = v
        return value

    def _set_doc(self, k, v):
        self.docs[k] = v
        self.doc_log.setdefault(k, []).append((time.monotonic(), v))

    def _mongodb(self, node, js):
        if "rs.status()" in js:
            return 0, json.dumps({"set": "jepsen", "members": [
                {"_id": i, "name": f"{n}:27017",
                 "stateStr": "PRIMARY" if n == self._primary()
                 else "SECONDARY", "self": n == node}
                for i, n in enumerate(self.nodes)]}), ""
        if "rs.initiate(" in js or "rs.reconfig(" in js:
            return 0, '{ ok: 1 }', ""
        if "rs.conf()" in js:
            return 0, json.dumps({"_id": "jepsen", "version": 1,
                                  "members": [{"_id": i,
                                               "host": f"{n}:27017"}
                                              for i, n in
                                              enumerate(self.nodes)]}), ""
        secondary = self.stale_reads and node != self._primary()
        m = _JS_FIND.search(js)
        if m:
            self.stats["reads"] += 1
            k, concern = int(m.group(1)), m.group(2)
            if secondary and concern == "linearizable":
                self.stats["not-master"] += 1
                return 1, "", NOT_MASTER
            v = self.docs.get(k)
            if secondary:
                r = self._replica_value(self.doc_log, k)
                self.stats["stale"] += r != v
                v = r
            return 0, json.dumps([] if v is None
                                 else [{"_id": k, "value": v}]), ""
        m = _JS_UPDATE.search(js) or _JS_CAS.search(js)
        if m:
            cas = len(m.groups()) == 3
            self.stats["cas" if cas else "writes"] += 1
            if secondary:
                self.stats["not-master"] += 1
                return 1, "", NOT_MASTER
            k = int(m.group(1))
            hit = not cas or self.docs.get(k) == int(m.group(2))
            t = self._timed_out("mongodb")
            if hit and (t is None or t[0]):
                self._set_doc(k, int(m.group(3 if cas else 2)))
            if t:
                return t[1]
            if not cas:
                return 0, 'WriteResult({ "nMatched" : 1 })', ""
            return 0, (json.dumps({"_id": k, "value": int(m.group(2))})
                       if hit else "null"), ""
        m = _JS_OPEN.search(js)
        if m:
            self.accounts.setdefault(int(m.group(1)), int(m.group(2)))
            return 0, "", ""
        if ".accounts.find()" in js:
            self.stats["reads"] += 1
            return 0, json.dumps([{"_id": i, "balance": b} for i, b in
                                  sorted(self.accounts.items())]), ""
        m = _JS_TRANSFER.search(js)
        if m and "insertOne" in js:
            self.stats["writes"] += 1
            frm, to, amount = (int(g) for g in m.groups())
            if self.accounts.get(frm, 0) < amount:
                return 0, "FAIL", ""
            self.accounts[frm] -= amount
            self.accounts[to] = self.accounts.get(to, 0) + amount
            return 0, "OK", ""
        return 1, "", f"MongoServerError: the fake does not run {js!r}"


    # -- logcabin --------------------------------------------------------------

    def _logcabin(self, node, body, stdin):
        argv = body.split()
        if argv[:1] == ["read"] and len(argv) == 2:
            self.stats["reads"] += 1
            v = self.tree.get(argv[1])
            return 0, "" if v is None else f"{v}\n", ""
        if argv[:1] == ["write"] and stdin is not None:
            cond = None
            if len(argv) == 4 and argv[1] == "--condition":
                cond = argv[2].rsplit(":", 1)
            elif len(argv) != 2:
                return 1, "", f"Usage: the fake does not run {body!r}"
            path = argv[-1]
            value = stdin.strip()
            self.stats["cas" if cond else "writes"] += 1
            if cond is not None and self.tree.get(cond[0], "") != cond[1]:
                return 1, "", LOGCABIN_MISMATCH.format(
                    path=cond[0], value=self.tree.get(cond[0], ""),
                    want=cond[1])
            t = self._timed_out("logcabin")
            if t is None or t[0]:
                self.tree[path] = value
            return t[1] if t else (0, "", "")
        return 1, "", f"Usage: the fake does not run {body!r}"

    # -- rethinkdb ReQL -------------------------------------------------------

    def _rethinkdb(self, node, script):
        m = _REQL_ACKS.search(script)
        if m:
            self.write_acks = m.group(3)
            return 0, json.dumps({"replaced": 1, "errors": 0}) + "\n", ""
        m = _REQL_READ.search(script)
        if m:
            self.stats["reads"] += 1
            mode, k = m.group(1), int(m.group(2))
            v = self.rdocs.get(k)
            conn = _REQL_NODE.search(script)
            if mode == "outdated" and self.stale_reads and conn \
                    and conn.group(1) != self._primary():
                r = self._replica_value(self.rdoc_log, k)
                self.stats["stale"] += r != v
                v = r
            doc = None if v is None else {"id": k, "v": v}
            return 0, json.dumps(doc) + "\n", ""
        m = _REQL_INSERT.search(script)
        if m:
            self.stats["writes"] += 1
            t = self._timed_out("rethinkdb")
            if t is None or t[0]:
                self._set_rdoc(int(m.group(1)), int(m.group(2)))
            return t[1] if t else (0, json.dumps({
                "inserted": 0, "replaced": 1, "errors": 0}) + "\n", "")
        m = _REQL_CAS.search(script)
        if m:
            self.stats["cas"] += 1
            k, old, new = (int(g) for g in m.groups())
            if k not in self.rdocs:
                return 0, json.dumps({"skipped": 1, "replaced": 0,
                                      "errors": 0}) + "\n", ""
            if self.rdocs[k] != old:
                return 0, json.dumps({"replaced": 0, "errors": 1,
                                      "first_error": "abort"}) + "\n", ""
            t = self._timed_out("rethinkdb")
            if t is None or t[0]:
                self._set_rdoc(k, new)
            return t[1] if t else (0, json.dumps({
                "replaced": 1, "errors": 0}) + "\n", "")
        return 1, "", ("rethinkdb.errors.ReqlCompileError: the fake does "
                       f"not run {script!r}")

    def _set_rdoc(self, k, v):
        self.rdocs[k] = v
        self.rdoc_log.setdefault(k, []).append((time.monotonic(), v))

    # -- mysql and psql -------------------------------------------------------

    def _sql_family(self, stmts):
        """The statements of one ``-e``/``-c`` (a transaction is one):
        the output's rows, tab-separated."""
        rows = []
        debited = None
        for stmt in stmts:
            if stmt.startswith(("CREATE", "SET SESSION", "BEGIN", "COMMIT",
                                "SELECT x FROM dirty WHERE")):
                continue
            m = _MY_SEED.match(stmt)
            if m:
                table = (self.sql_accounts if m.group(1) == "accounts"
                         else self.sql_dirty)
                table.setdefault(int(m.group(2)), int(m.group(3)))
                continue
            if stmt.startswith("SELECT balance FROM accounts"):
                self.stats["reads"] += 1
                rows += [[str(b)] for _, b in
                         sorted(self.sql_accounts.items())]
                continue
            if stmt == "SELECT value FROM sets":
                self.stats["reads"] += 1
                rows += [[str(v)] for v in self.sql_set]
                continue
            if stmt == "SELECT x FROM dirty":
                self.stats["reads"] += 1
                rows += [[str(x)] for _, x in sorted(self.sql_dirty.items())]
                continue
            m = _MY_DEBIT.match(stmt)
            if m:
                self.stats["writes"] += 1
                amount, frm = int(m.group(1)), int(m.group(2))
                debited = self.sql_accounts.get(frm, 0) >= amount
                if debited:
                    self.sql_accounts[frm] -= amount
                continue
            m = _MY_CREDIT.match(stmt)
            if m:
                if debited:
                    to = int(m.group(2))
                    self.sql_accounts[to] = self.sql_accounts.get(to, 0) + \
                        int(m.group(1))
                continue
            if stmt == "SELECT ROW_COUNT()":
                rows.append(["1" if debited else "0"])
                continue
            m = _MY_SET_ADD.match(stmt)
            if m:
                self.stats["writes"] += 1
                self.sql_set.append(int(m.group(1)))
                continue
            m = _MY_DIRTY.match(stmt)
            if m:
                self.sql_dirty[int(m.group(2))] = int(m.group(1))
                continue
            return None
        return rows

    def _sql_run(self, kind, body):
        stmts = [x.strip() for x in body.split(";") if x.strip()]
        writes = any(x.startswith(("UPDATE", "INSERT INTO sets"))
                     for x in stmts)
        before = (dict(self.sql_accounts), list(self.sql_set),
                  dict(self.sql_dirty))
        rows = self._sql_family(stmts)
        if rows is None:
            self.sql_accounts, self.sql_set, self.sql_dirty = before
            return 1, "", f"ERROR: the fake does not run {body!r}"
        t = self._timed_out(kind) if writes else None
        if t is not None and not t[0]:
            self.sql_accounts, self.sql_set, self.sql_dirty = before
        if t:
            return t[1]
        return 0, "".join("\t".join(r) + "\n" for r in rows), ""

    def _mysql(self, node, body):
        return self._sql_run("mysql", body)

    def _psql(self, node, body):
        return self._sql_run("psql", body)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("suite", choices=("etcd", "hazelcast"))
    ap.add_argument("--members", type=int, default=5)
    ap.add_argument("--stale-reads", action="store_true",
                    help="etcd: serve ?quorum=false reads from lagging "
                         "replicas")
    ap.add_argument("--delay-s", type=float, default=0.5,
                    help="etcd --stale-reads: the followers' lag")
    args = ap.parse_args(argv)
    if args.suite == "etcd":
        fake = EtcdFake(args.members, args.stale_reads, args.delay_s)
    else:
        fake = ShimFake(args.members)
    nodes = fake.start()
    signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
    print(json.dumps({"nodes": nodes}), flush=True)
    try:
        if sys.stdin.isatty():
            signal.pause()  # in a terminal: serve until Ctrl-C
        else:
            sys.stdin.read()    # serve until the parent closes our stdin
    except KeyboardInterrupt:
        pass
    finally:
        if isinstance(fake, EtcdFake):
            print(json.dumps({"stats": fake.stats}), flush=True)
        fake.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
