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

``DUMMY_RESPONSES`` holds, per suite, the dummy control plane's replies
that let the suite's database lifecycle be recorded from its install to
its start (``run --ssh-mode dummy --dummy-responses FILE``).

The module uses the standard library only. Run as a script, it starts
one fake, prints ``{"nodes": [...]}`` on a line and serves until its
standard input closes (in a terminal: until Ctrl-C) or it is
terminated::

    python3 tools/torch_suite_fakes.py etcd --members 5 [--stale-reads]
    python3 tools/torch_suite_fakes.py hazelcast --members 5
"""

import argparse
import json
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
}


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
