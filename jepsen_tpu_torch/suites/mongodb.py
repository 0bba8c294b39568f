"""MongoDB suite — document CAS and two-phase bank transfers.

Rebuild of mongodb-smartos/src/jepsen/mongodb_smartos/: document-level
compare-and-set via findAndModify (document_cas.clj) across a
read/write-concern matrix, and the classic two-phase-commit account
transfer from the MongoDB manual (transfer.clj) checked against a custom
stepped model of account balances (the reference imports its own knossos
Model there; :class:`AccountsModel` is the equivalent).

Data plane: the mongo shell (``mongosh``/``mongo --eval``) over the
control plane, emitting/parsing JSON.

The port's copy of ``jepsen_tpu.suites.mongodb``, with one difference:
the document CAS's linearizability check runs on the card (``backend``
"gpu", the default) unless the options name the CPU (``backend: "cpu"``
for the host search, ``device: "cpu"`` for the kernels' plain versions).
The transfer's ``AccountsModel`` has no word kernel, so its check is
answered on the host, labelled ``fallback-from: "gpu"``, unless the
options ask for ``backend: "cpu"``."""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

from jepsen_tpu_torch import client as client_ns
from jepsen_tpu_torch import control
from jepsen_tpu_torch import db as db_ns
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import independent, nemesis
from jepsen_tpu_torch.checker import compose, perf
from jepsen_tpu_torch.checker.wgl import linearizable
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.models.core import Model, inconsistent
from jepsen_tpu_torch.os import debian
from jepsen_tpu_torch.suites import workloads as wl
from jepsen_tpu_torch.testing import noop_test

#: Write-concern matrix the reference sweeps (document_cas.clj tests).
WRITE_CONCERNS = ["unacknowledged", "acknowledged", "journaled",
                  "majority"]
READ_CONCERNS = ["local", "majority", "linearizable"]


def mongo_eval(test: dict, node, js: str, port: int = 27017) -> str:
    """Run a JS expression in the mongo shell, return stdout."""
    return control.execute(
        test, node,
        f"mongosh --quiet --host {control.escape(str(node))} "
        f"--port {port} --eval {control.escape(js)}")


class MongoDB(db_ns.DB, db_ns.Primary, db_ns.LogFiles):
    """Replica-set install + initiation on the primary
    (mongodb core.clj db)."""

    def __init__(self, version: str = "3.4"):
        self.version = version

    def setup(self, test, node):
        debian.install(test, node, ["mongodb-org"])
        conf = ("replication:\n  replSetName: jepsen\n"
                "net:\n  bindIp: 0.0.0.0\n")
        with control.sudo():
            control.execute(
                test, node,
                f"echo {control.escape(conf)} >> /etc/mongod.conf")
            control.exec(test, node, "service", "mongod", "start")

    def setup_primary(self, test, node):
        replica_set_initiate(test, node)
        await_join(test, node, test["nodes"])
        await_primary(test, node)

    def teardown(self, test, node):
        with control.sudo():
            control.execute(test, node, "service mongod stop || true")
            control.execute(test, node, "rm -rf /var/lib/mongodb/* || true")

    def log_files(self, test, node):
        return ["/var/log/mongodb/mongod.log"]


# ---------------------------------------------------------------------------
# Replica-set orchestration (mongodb core.clj:123-303)
# ---------------------------------------------------------------------------


def replica_set_status(test, node) -> dict:
    """Parsed rs.status() (core.clj:123-126); JSON.stringify makes the
    shell's extended-JSON output parseable."""
    import json as _json
    out = mongo_eval(test, node, "JSON.stringify(rs.status())")
    return _json.loads(out)


def replica_set_initiate(test, node):
    """rs.initiate with the full member list (core.clj:128-149)."""
    members = ", ".join(
        f'{{_id: {i}, host: "{n}:27017"}}'
        for i, n in enumerate(test["nodes"]))
    return mongo_eval(test, node,
                      f"rs.initiate({{_id: 'jepsen', "
                      f"members: [{members}]}})")


def replica_set_config(test, node) -> dict:
    """Parsed rs.conf() (core.clj:156-162)."""
    import json as _json
    out = mongo_eval(test, node, "JSON.stringify(rs.conf())")
    return _json.loads(out)


def replica_set_reconfigure(test, node, conf: dict):
    """rs.reconfig with a bumped config version (core.clj:164-167)."""
    import json as _json
    conf = dict(conf)
    conf["version"] = int(conf.get("version", 0)) + 1
    return mongo_eval(test, node,
                      f"rs.reconfig({_json.dumps(conf)}, {{force: true}})")


def primaries(test, nodes) -> list:
    """Nodes reporting themselves PRIMARY in rs.status()
    (core.clj:175-182): during partitions more than one node can claim
    the title — exactly what the checkers are hunting."""
    out = []
    for node in nodes:
        try:
            st = replica_set_status(test, node)
        except Exception:  # noqa: BLE001 — unreachable node: no claim
            continue
        for m in st.get("members", []):
            if m.get("self") and m.get("stateStr") == "PRIMARY":
                out.append(node)
    return out


def primary(test, node):
    """The primary as seen from one node, or None (core.clj:184-203)."""
    try:
        st = replica_set_status(test, node)
    except Exception:  # noqa: BLE001
        return None
    for m in st.get("members", []):
        if m.get("stateStr") == "PRIMARY":
            return str(m.get("name", "")).split(":")[0] or None
    return None


def await_primary(test, node, timeout: float = 300.0):
    """Spin until an elected primary is visible from ``node``
    (core.clj:228-232)."""
    import time as _t
    deadline = _t.time() + timeout
    while _t.time() < deadline:
        if primary(test, node):
            return
        _t.sleep(1)
    raise TimeoutError(f"no mongodb primary visible from {node} "
                       f"after {timeout}s")


def await_join(test, node, nodes, timeout: float = 300.0):
    """Spin until every member is in a healthy replica-set state
    (core.clj:234-249: PRIMARY/SECONDARY/ARBITER)."""
    import time as _t
    healthy = {"PRIMARY", "SECONDARY", "ARBITER"}
    deadline = _t.time() + timeout
    while _t.time() < deadline:
        try:
            st = replica_set_status(test, node)
            states = [m.get("stateStr") for m in st.get("members", [])]
            if len(states) == len(nodes) and \
                    all(s in healthy for s in states):
                return
        except Exception:  # noqa: BLE001 — not initiated yet
            pass
        _t.sleep(1)
    raise TimeoutError(f"replica set did not converge after {timeout}s")


class DocumentCASClient(client_ns.Client):
    """Per-key document CAS via findAndModify (document_cas.clj:146-148)
    under configurable read/write concerns."""

    def __init__(self, write_concern: str = "majority",
                 read_concern: str = "linearizable", node=None):
        self.write_concern = write_concern
        self.read_concern = read_concern
        self.node = node

    def open(self, test, node):
        c = DocumentCASClient(self.write_concern, self.read_concern)
        c.node = node
        return c

    def _wc(self) -> str:
        if self.write_concern == "unacknowledged":
            return "{w: 0}"
        if self.write_concern == "acknowledged":
            return "{w: 1}"
        if self.write_concern == "journaled":
            return "{w: 1, j: true}"
        return f'{{w: "{self.write_concern}"}}'

    def invoke(self, test, op: Op) -> Op:
        k, v = op.value
        crash = "fail" if op.f == "read" else "info"
        try:
            if op.f == "read":
                out = mongo_eval(
                    test, self.node,
                    f"JSON.stringify(db.getSiblingDB('jepsen').cas"
                    f".find({{_id: {int(k)}}})"
                    f".readConcern('{self.read_concern}').toArray())")
                rows = json.loads(out or "[]")
                value = rows[0]["value"] if rows else None
                return op.replace(type="ok",
                                  value=independent.tuple_(k, value))
            if op.f == "write":
                mongo_eval(
                    test, self.node,
                    f"db.getSiblingDB('jepsen').cas.update("
                    f"{{_id: {int(k)}}}, "
                    f"{{$set: {{value: {int(v)}}}}}, "
                    f"{{upsert: true, writeConcern: {self._wc()}}})")
                return op.replace(type="ok")
            if op.f == "cas":
                old, new = v
                out = mongo_eval(
                    test, self.node,
                    f"JSON.stringify(db.getSiblingDB('jepsen').cas"
                    f".findAndModify({{query: {{_id: {int(k)}, "
                    f"value: {int(old)}}}, "
                    f"update: {{$set: {{value: {int(new)}}}}}}}))")
                found = json.loads(out or "null")
                return op.replace(type="ok" if found else "fail")
            raise ValueError(f"unknown op {op.f!r}")
        except control.RemoteError as e:
            msg = f"{e.err or ''} {e.out or ''}"
            if "not master" in msg or "NotMaster" in msg:
                return op.replace(type="fail", error="not-primary")
            return op.replace(type=crash, error=msg.strip()[:80])
        except ValueError as e:
            return op.replace(type=crash, error=str(e)[:80])


class AccountsModel(Model):
    """Stepped model of bank accounts for the transfer workload — the
    custom knossos model the reference plugs into its linearizable checker
    (transfer.clj:34, core.clj:390-391).

    Ops: transfer {from, to, amount} (fails if it would overdraw);
    read -> tuple of balances."""

    def __init__(self, balances: Tuple[int, ...]):
        self.balances = tuple(balances)

    def step(self, op: Op) -> Model:
        if op.f == "transfer":
            v = op.value
            frm, to, amt = v["from"], v["to"], v["amount"]
            if self.balances[frm] < amt:
                return inconsistent(
                    f"transfer of {amt} would overdraw account {frm} "
                    f"({self.balances[frm]})")
            b = list(self.balances)
            b[frm] -= amt
            b[to] += amt
            return AccountsModel(tuple(b))
        if op.f == "read":
            if op.value is None or tuple(op.value) == self.balances:
                return self
            return inconsistent(
                f"read {op.value!r} but balances are {self.balances!r}")
        return inconsistent(f"unknown op f={op.f!r}")

    def __eq__(self, other):
        return (isinstance(other, AccountsModel)
                and self.balances == other.balances)

    def __hash__(self):
        return hash(("AccountsModel", self.balances))

    def __repr__(self):
        return f"AccountsModel({list(self.balances)!r})"


class TransferClient(client_ns.Client):
    """Two-phase-commit transfers (transfer.clj p0..p5): create a pending
    txn document, apply both sides with $inc guarded on the txn state,
    then mark it done. Reads sum the accounts collection."""

    def __init__(self, n: int = 2, starting: int = 10, node=None):
        self.n = n
        self.starting = starting
        self.node = node

    def open(self, test, node):
        c = TransferClient(self.n, self.starting)
        c.node = node
        return c

    def setup(self, test):
        node = test["nodes"][0]
        for i in range(self.n):
            mongo_eval(test, node,
                       f"db.getSiblingDB('jepsen').accounts.update("
                       f"{{_id: {i}}}, {{$setOnInsert: "
                       f"{{balance: {self.starting}}}}}, {{upsert: true}})")

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "read":
                out = mongo_eval(
                    test, self.node,
                    "JSON.stringify(db.getSiblingDB('jepsen').accounts"
                    ".find().sort({_id: 1}).toArray())")
                rows = json.loads(out or "[]")
                return op.replace(type="ok",
                                  value=[r["balance"] for r in rows])
            if op.f == "transfer":
                v = op.value
                js = (
                    "var db2 = db.getSiblingDB('jepsen');"
                    f"var t = {{state: 'pending', from: {v['from']}, "
                    f"to: {v['to']}, amount: {v['amount']}}};"
                    "var r = db2.txns.insertOne(t);"
                    "var id = r.insertedId;"
                    f"var deb = db2.accounts.updateOne("
                    f"{{_id: {v['from']}, balance: "
                    f"{{$gte: {v['amount']}}}, pendingTxns: "
                    f"{{$ne: id}}}}, {{$inc: {{balance: -{v['amount']}}}, "
                    f"$push: {{pendingTxns: id}}}});"
                    "if (deb.modifiedCount != 1) {"
                    "  db2.txns.updateOne({_id: id}, "
                    "    {$set: {state: 'canceled'}});"
                    "  print('FAIL');"
                    "} else {"
                    f"  db2.accounts.updateOne({{_id: {v['to']}, "
                    f"pendingTxns: {{$ne: id}}}}, "
                    f"{{$inc: {{balance: {v['amount']}}}, "
                    f"$push: {{pendingTxns: id}}}});"
                    "  db2.txns.updateOne({_id: id}, "
                    "    {$set: {state: 'done'}});"
                    "  db2.accounts.updateMany({}, "
                    "    {$pull: {pendingTxns: id}});"
                    "  print('OK');"
                    "}")
                out = mongo_eval(test, self.node, js)
                return op.replace(
                    type="ok" if "OK" in out else "fail")
            raise ValueError(f"unknown op {op.f!r}")
        except control.RemoteError as e:
            t = "fail" if op.f == "read" else "info"
            return op.replace(type=t, error=str(e)[:80])


def document_cas_test(opts: dict) -> dict:
    """Per-key document CAS across the concern matrix
    (document_cas.clj)."""
    import itertools
    test = noop_test()
    test.update({
        "name": f"mongodb-document-cas-"
                f"w{opts.get('write-concern', 'majority')}-"
                f"r{opts.get('read-concern', 'linearizable')}",
        "os": debian.os(),
        "db": MongoDB(),
        "client": DocumentCASClient(
            opts.get("write-concern", "majority"),
            opts.get("read-concern", "linearizable")),
        "nemesis": nemesis.partition_random_halves(),
        "model": CASRegister(),
        "checker": compose({
            "perf": perf(),
            "indep": independent.checker(
                linearizable(CASRegister(),
                             backend=opts.get("backend", "gpu"),
                             device=opts.get("device"))),
        }),
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(
                independent.concurrent_generator(
                    opts.get("threads-per-key", 5), itertools.count(),
                    lambda k: gen.limit(
                        opts.get("ops-per-key", 100),
                        gen.stagger(1 / 10, wl.register_gen()))),
                gen.seq(_nemesis_cycle()))),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


def transfer_test(opts: dict) -> dict:
    """Two-phase-commit bank (transfer.clj) checked against
    AccountsModel."""
    n = opts.get("accounts", 2)
    starting = opts.get("starting-balance", 10)
    model = AccountsModel(tuple([starting] * n))
    test = document_cas_test(opts)
    test.update({
        "name": "mongodb-transfer",
        "client": TransferClient(n, starting),
        "model": model,
        "checker": compose({
            "perf": perf(),
            "linear": linearizable(model,
                                   backend=opts.get("backend", "gpu"),
                                   device=opts.get("device")),
        }),
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(
                gen.stagger(1 / 10, gen.mix(
                    [wl.bank_read, wl.bank_diff_transfer(n, starting)])),
                gen.seq(_nemesis_cycle()))),
    })
    return test


def _nemesis_cycle():
    while True:
        yield gen.sleep(5)
        yield gen.once({"type": "info", "f": "start"})
        yield gen.sleep(5)
        yield gen.once({"type": "info", "f": "stop"})


#: the workloads ``run --workload`` selects (the reference's ``main``)
WORKLOADS = {"document-cas": document_cas_test, "transfer": transfer_test}


def main(argv=None):
    """The reference's command line: ``test`` runs the document CAS, or
    with ``--workload transfer`` the transfer, under the client's
    ``--write-concern`` and ``--read-concern``; ``serve`` the results
    browser."""
    from jepsen_tpu_torch import cli

    def opt_spec(p):
        p.add_argument("--workload", default="document-cas",
                       choices=["document-cas", "transfer"])
        p.add_argument("--write-concern", default="majority",
                       choices=WRITE_CONCERNS)
        p.add_argument("--read-concern", default="linearizable",
                       choices=READ_CONCERNS)

    def test_fn(opts):
        fn = (transfer_test if opts.get("workload") == "transfer"
              else document_cas_test)
        return fn({**opts,
                   "write-concern": opts.get("write_concern", "majority"),
                   "read-concern": opts.get("read_concern",
                                            "linearizable")})

    cli.main(cli.merge_commands(
        cli.single_test_cmd(test_fn, opt_spec=opt_spec),
        cli.serve_cmd()), argv)


if __name__ == "__main__":
    main()
