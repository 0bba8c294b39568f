"""Elasticsearch suite — sets and dirty reads.

Rebuild of elasticsearch/src/jepsen/system/elasticsearch*: documents
indexed over HTTP; the dirty-read checker (dirty_read.clj:106-157)
compares normal reads against per-node *strong reads* taken after
recovery: a read of a doc absent from every strong read is dirty, an
acked write absent from all strong reads is lost, and nodes must agree.

The port's copy of ``jepsen_tpu.suites.elasticsearch``. Its checks (dirty
read, set) run on the host, as in the reference."""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Set

from jepsen_tpu_torch import client as client_ns
from jepsen_tpu_torch import db as db_ns
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import nemesis
from jepsen_tpu_torch.checker import Checker, compose, set_checker
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.os import debian
from jepsen_tpu_torch.testing import noop_test

PORT = 9200
INDEX = "jepsen"


def _url(node, path):
    node = str(node)
    authority = node if ":" in node else f"{node}:{PORT}"
    return f"http://{authority}{path}"


class ESDB(db_ns.DB, db_ns.LogFiles):
    def setup(self, test, node):
        from jepsen_tpu_torch import control
        debian.install(test, node, ["elasticsearch"])
        hosts = ", ".join(f'"{n}"' for n in test["nodes"])
        cfg = (f"discovery.zen.ping.unicast.hosts: [{hosts}]\n"
               f"network.host: 0.0.0.0\n"
               f"cluster.name: jepsen\n")
        with control.sudo():
            control.execute(
                test, node,
                f"echo {control.escape(cfg)} >> "
                f"/etc/elasticsearch/elasticsearch.yml")
            control.exec(test, node, "service", "elasticsearch", "restart")

    def teardown(self, test, node):
        from jepsen_tpu_torch import control
        with control.sudo():
            control.execute(test, node,
                            "service elasticsearch stop || true")
            control.execute(test, node,
                            "rm -rf /var/lib/elasticsearch/* || true")

    def log_files(self, test, node):
        return ["/var/log/elasticsearch/jepsen.log"]


class ESClient(client_ns.Client):
    """write = index doc by id; read = get by id; strong-read = refresh +
    match_all scan (dirty_read.clj client)."""

    def __init__(self, node=None, timeout: float = 5.0):
        self.node = node
        self.timeout = timeout

    def open(self, test, node):
        return ESClient(node, self.timeout)

    def _req(self, path, method="GET", payload=None):
        body = json.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(_url(self.node, path), data=body,
                                     method=method,
                                     headers={"Content-Type":
                                              "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read().decode() or "null")

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "write":
                out = self._req(
                    f"/{INDEX}/doc/{int(op.value)}"
                    "?consistency=quorum", "PUT", {"v": int(op.value)})
                ok = out.get("created") or out.get("result") == "created" \
                    or out.get("_version")
                return op.replace(type="ok" if ok else "fail")
            if op.f == "read":
                try:
                    out = self._req(f"/{INDEX}/doc/{int(op.value)}")
                except urllib.error.HTTPError as e:
                    if e.code == 404:
                        return op.replace(type="fail", error="not-found")
                    raise
                return (op.replace(type="ok") if out.get("found")
                        else op.replace(type="fail", error="not-found"))
            if op.f == "strong-read":
                self._req(f"/{INDEX}/_refresh", "POST")
                out = self._req(f"/{INDEX}/_search?size=10000", "POST",
                                {"query": {"match_all": {}}})
                hits = out.get("hits", {}).get("hits", [])
                vals = sorted(int(h["_id"]) for h in hits)
                return op.replace(type="ok", value=set(vals))
            raise ValueError(f"unknown op {op.f!r}")
        except urllib.error.HTTPError as e:
            crash = "fail" if op.f != "write" else "info"
            return op.replace(type=crash, error=f"http-{e.code}")
        except (TimeoutError, OSError) as e:
            crash = "fail" if op.f != "write" else "info"
            return op.replace(type=crash, error=type(e).__name__)


class DirtyReadChecker(Checker):
    """Strong-read set algebra (dirty_read.clj:106-157)."""

    def check(self, test, history, opts=None):
        ok = [o for o in history if o.is_ok]
        writes = {o.value for o in ok if o.f == "write"}
        reads = {o.value for o in ok if o.f == "read"}
        strong = [set(o.value) for o in ok if o.f == "strong-read"
                  and o.value is not None]
        if not strong:
            return {"valid": "unknown", "error": "no strong reads"}
        on_all = set.intersection(*strong)
        on_some = set.union(*strong)
        dirty = reads - on_some
        lost = writes - on_some
        some_lost = writes - on_all
        nodes_agree = on_all == on_some
        return {
            "valid": bool(nodes_agree and not dirty and not lost),
            "nodes-agree": nodes_agree,
            "read-count": len(reads),
            "on-all-count": len(on_all),
            "on-some-count": len(on_some),
            "not-on-all": sorted(on_some - on_all, key=repr),
            "dirty": sorted(dirty, key=repr),
            "lost": sorted(lost, key=repr),
            "some-lost": sorted(some_lost, key=repr),
        }


def dirty_read_checker() -> DirtyReadChecker:
    return DirtyReadChecker()


def dirty_read_test(opts: dict) -> dict:
    """rw-generator probing in-flight writes, final strong read per client
    (dirty_read.clj:159+)."""
    import itertools
    import random as _r
    counter = itertools.count()
    recent: list = []

    def write(test, process):
        v = next(counter)
        recent.append(v)
        del recent[:-100]
        return {"type": "invoke", "f": "write", "value": v}

    def read(test, process):
        if not recent:
            return {"type": "invoke", "f": "write", "value": next(counter)}
        return {"type": "invoke", "f": "read",
                "value": _r.choice(recent)}

    test = noop_test()
    test.update({
        "name": "elasticsearch-dirty-read",
        "os": debian.os(),
        "db": ESDB(),
        "client": ESClient(),
        "nemesis": nemesis.partition_random_halves(),
        "checker": compose({"dirty-read": dirty_read_checker()}),
        "generator": gen.phases(
            gen.time_limit(
                opts.get("time-limit", 60),
                gen.clients(gen.mix([write, read]),
                            gen.seq(_nemesis_cycle()))),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.sleep(10),
            gen.clients(gen.each(
                lambda: gen.once({"f": "strong-read", "value": None})))),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


def sets_test(opts: dict) -> dict:
    """elasticsearch/sets.clj: unique docs indexed under the partition
    nemesis, then a refreshed match_all scan checked with set algebra
    (lost documents are ES's classic failure mode)."""
    import itertools
    counter = itertools.count()

    def add(test, process):
        return {"type": "invoke", "f": "write", "value": next(counter)}

    class SetReadClient(ESClient):
        """Maps the set workload's ops onto the ES client: add = index
        doc, read = strong (refreshed) scan returning the id set."""

        def open(self, test, node):
            return SetReadClient(node, self.timeout)

        def invoke(self, test, op):
            if op.f == "add":
                return super().invoke(test, op.replace(f="write")) \
                    .replace(f="add")
            if op.f == "read":
                out = super().invoke(test, op.replace(f="strong-read"))
                val = sorted(out.value) if out.value is not None else None
                return out.replace(f="read", value=val)
            return super().invoke(test, op)

    test = noop_test()
    test.update({
        "name": "elasticsearch-set",
        "os": debian.os(),
        "db": ESDB(),
        "client": SetReadClient(),
        "nemesis": nemesis.partition_random_halves(),
        "checker": compose({"set": set_checker()}),
        "generator": gen.phases(
            gen.time_limit(
                opts.get("time-limit", 60),
                gen.clients(gen.stagger(1 / 10, add),
                            gen.seq(_nemesis_cycle()))),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.sleep(opts.get("recovery-time", 5)),
            gen.clients(gen.once({"f": "read", "value": None}))),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


def _nemesis_cycle():
    while True:
        yield gen.sleep(10)
        yield gen.once({"type": "info", "f": "start"})
        yield gen.sleep(10)
        yield gen.once({"type": "info", "f": "stop"})


# ---------------------------------------------------------------------------
# Cluster introspection + ES-specific nemeses (core.clj:181-367)
# ---------------------------------------------------------------------------


def primaries(nodes, timeout: float = 5.0) -> dict:
    """node -> the node it believes is the current primary (master), via
    each node's own /_cluster/state (core.clj:181-202); None when the
    node is unreachable or has no master."""
    from jepsen_tpu_torch.util import real_pmap

    def one(node):
        try:
            req = urllib.request.Request(_url(node, "/_cluster/state"))
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                state = json.loads(resp.read().decode())
            master = state.get("master_node")
            name = state.get("nodes", {}).get(master, {}).get("name")
            return node, name
        except (urllib.error.URLError, OSError, ValueError):
            return node, None

    return dict(real_pmap(one, list(nodes)))


def self_primaries(nodes) -> list:
    """Nodes that think they themselves are the primary
    (core.clj:204-211) — the split-brain candidates."""
    return [n for n, p in primaries(nodes).items() if p == str(n)]


def mostly_small_nonempty_subset(xs):
    """A random subset with log-decreasing size (core.clj:323-342):
    mostly one or two elements, occasionally many, never zero."""
    import math
    import random as _r
    xs = list(xs)
    if not xs:
        return xs
    k = int(math.exp(_r.random() * math.log(len(xs) + 1)))
    _r.shuffle(xs)
    return xs[:max(1, k)]


def isolate_self_primaries_nemesis():
    """Partition every self-proclaimed primary into its own island, the
    rest of the cluster together (core.clj:344-353) — the classic ES
    split-brain amplifier."""
    def grudge(nodes):
        ps = self_primaries(nodes)
        rest = [n for n in nodes if n not in ps]
        return nemesis.complete_grudge([rest] + [[p] for p in ps])
    return nemesis.partitioner(grudge)


def _crash_start(test, node):
    from jepsen_tpu_torch import control
    with control.sudo():
        control.execute(test, node, "killall -9 java || true")
    return ["killed", str(node)]


def _crash_stop(test, node):
    from jepsen_tpu_torch import control
    with control.sudo():
        control.exec(test, node, "service", "elasticsearch", "start")
    return ["restarted", str(node)]


def crash_nemesis():
    """kill -9 a log-small random subset of nodes, restart on stop
    (core.clj:355-360)."""
    return nemesis.node_start_stopper(
        mostly_small_nonempty_subset, _crash_start, _crash_stop)


def crash_primary_nemesis():
    """kill -9 one random self-primary (core.clj:362-367)."""
    import random as _r

    def targeter(nodes):
        ps = self_primaries(nodes)
        return [_r.choice(ps)] if ps else []
    return nemesis.node_start_stopper(targeter, _crash_start, _crash_stop)


# ---------------------------------------------------------------------------
# CAS (MVCC) set client + the create-test nemesis variants (sets.clj)
# ---------------------------------------------------------------------------


class CASSetClient(ESClient):
    """A set as ONE document updated with version-guarded (MVCC) CAS
    read/modify/write cycles (sets.clj:96-160 CASSetClient): add = get
    doc + put values+[v] with ?version=N (conflict -> fail, timeout ->
    info); read = refresh + get, returning the sorted value list."""

    DOC = "0"

    def open(self, test, node):
        return CASSetClient(node, self.timeout)

    def setup(self, test):
        # initial empty set document (sets.clj:112-113); 409 = already
        # created by another worker's setup
        try:
            self._req(f"/{INDEX}/cas-sets/{self.DOC}?op_type=create",
                      "PUT", {"values": []})
        except urllib.error.HTTPError as e:
            if e.code != 409:
                raise

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "add":
                path = f"/{INDEX}/cas-sets/{self.DOC}"
                try:
                    cur = self._req(path + "?preference=_primary")
                except urllib.error.HTTPError as e:
                    if e.code == 404:
                        return op.replace(type="fail",
                                          error="doc-not-found")
                    raise
                if not cur.get("found"):
                    return op.replace(type="fail", error="doc-not-found")
                version = cur["_version"]
                values = list(cur.get("_source", {}).get("values", []))
                values.append(op.value)
                try:
                    self._req(f"{path}?version={version}", "PUT",
                              {"values": values})
                except urllib.error.HTTPError as e:
                    if e.code == 409:
                        return op.replace(type="fail", error="conflict")
                    raise
                return op.replace(type="ok")
            if op.f == "read":
                self._req(f"/{INDEX}/_refresh", "POST")
                cur = self._req(f"/{INDEX}/cas-sets/{self.DOC}"
                                "?preference=_primary")
                vals = sorted(cur.get("_source", {}).get("values", []))
                return op.replace(type="ok", value=vals)
            raise ValueError(f"unknown op {op.f!r}")
        except (TimeoutError, OSError) as e:
            crash = "info" if op.f == "add" else "fail"
            return op.replace(type=crash, error=type(e).__name__)


def _recover():
    """Stop the nemesis, then let the cluster settle (sets.clj:170-176)."""
    return gen.nemesis(gen.phases(
        gen.once({"type": "info", "f": "stop"}),
        gen.sleep(20)))


def _read_once():
    return gen.clients(gen.once({"f": "read", "value": None}))


def _create_set_test(opts: dict, variant: str, nem_client,
                     sleep_start: float, sleep_stop: float,
                     time_limit: int, client=None) -> dict:
    """Shared shape of the sets.clj create-* tests (sets.clj:185-272):
    staggered unique adds under a start/stop nemesis cycle, recover,
    one final read, set-algebra checker."""
    import itertools
    counter = itertools.count()

    def add(test, process):
        return {"type": "invoke", "f": "add", "value": next(counter)}

    base = sets_test(opts)

    def cycle():
        while True:
            yield gen.sleep(sleep_start)
            yield gen.once({"type": "info", "f": "start"})
            yield gen.sleep(sleep_stop)
            yield gen.once({"type": "info", "f": "stop"})

    base.update({
        "name": f"elasticsearch-set-{variant}",
        "nemesis": nem_client,
        "generator": gen.phases(
            gen.time_limit(
                opts.get("time-limit", time_limit),
                gen.clients(gen.stagger(1 / 10, add), gen.seq(cycle()))),
            _recover(),
            _read_once()),
    })
    if client is not None:
        base["client"] = client
    return base


def set_isolate_primaries_test(opts: dict) -> dict:
    """create-isolate-primaries-test (sets.clj:196-213)."""
    return _create_set_test(opts, "isolate-primaries",
                            isolate_self_primaries_nemesis(), 30, 200, 800)


def set_pause_test(opts: dict) -> dict:
    """create-pause-test (sets.clj:215-233): SIGSTOP a random
    self-primary's JVM."""
    import random as _r

    def targeter(nodes):
        ps = self_primaries(nodes)
        return [_r.choice(ps)] if ps else []
    return _create_set_test(
        opts, "pause", nemesis.hammer_time("java", targeter=targeter),
        10, 120, 600)


def set_crash_test(opts: dict) -> dict:
    """create-crash-test (sets.clj:235-252): rapid kill/restart churn."""
    return _create_set_test(opts, "crash", crash_nemesis(), 1, 1, 600)


def set_bridge_test(opts: dict) -> dict:
    """create-bridge-test (sets.clj:254-272): intersecting majority
    rings."""
    import random as _r

    def grudge(nodes):
        nodes = list(nodes)
        _r.shuffle(nodes)
        return nemesis.bridge(nodes)
    return _create_set_test(opts, "bridge", nemesis.partitioner(grudge),
                            10, 120, 600)


def set_cas_test(opts: dict) -> dict:
    """The MVCC CAS-document set under the partition nemesis
    (sets.clj:160 cas-set-client)."""
    t = sets_test(opts)
    t["name"] = "elasticsearch-set-cas"
    t["client"] = CASSetClient()
    return t


def main(argv=None):
    """The reference's command line: ``test`` runs :func:`dirty_read_test`,
    ``serve`` the results browser (``python -m
    jepsen_tpu_torch.suites.elasticsearch test|serve ...``)."""
    from jepsen_tpu_torch import cli
    cli.main(cli.merge_commands(cli.single_test_cmd(dirty_read_test),
                                cli.serve_cmd()), argv)


if __name__ == "__main__":
    main()
