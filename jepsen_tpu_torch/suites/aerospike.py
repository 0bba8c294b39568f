"""Aerospike suite — generation-CAS registers and counters.

Rebuild of aerospike/src/aerospike/core.clj: deb-package install
(core.clj:213-240), roster/recluster orchestration through asinfo/asadm
on the primary (core.clj:256-278), a CAS register implemented as
read-then-generation-checked-write (core.clj:381-394), a counter via
bin-add, and the error taxonomy macro mapping timeouts/connection errors
to indeterminate for non-idempotent ops (core.clj:402-441).

The data plane is the ``aql`` CLI over the control plane (the reference
uses the Java client; generation-checked writes are expressed with aql's
generation predicates).

The clustering behavior this suite probes is specified formally in
``resources/aerospike_clustering.tla`` (counterpart of the reference's
aerospike/spec/aerospike.tla) and exhaustively model-checked in Python
by tests/test_aerospike_tla.py — including the bridge-partition
dual-majority hazard that motivates the bridge nemesis.

The port's copy of ``jepsen_tpu.suites.aerospike``, with its own copy of
the specification, and one difference: the CAS register's
linearizability check runs on the card (``backend`` "gpu", the default)
unless the options name the CPU (``backend: "cpu"`` for the host search,
``device: "cpu"`` for the kernels' plain versions)."""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

from jepsen_tpu_torch import client as client_ns
from jepsen_tpu_torch import control
from jepsen_tpu_torch import db as db_ns
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import independent, nemesis
from jepsen_tpu_torch.checker import compose, counter, perf
from jepsen_tpu_torch.checker.wgl import linearizable
from jepsen_tpu_torch.control import util as cu
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.os import debian
from jepsen_tpu_torch.suites import workloads as wl
from jepsen_tpu_torch.testing import noop_test

NAMESPACE = "jepsen"
SET = "registers"

#: f's that can safely fail without altering state (core.clj:402-409).
IDEMPOTENT_FS = {"read"}


def asinfo(test: dict, node, command: str) -> str:
    """asinfo -v '<command>' (core.clj roster orchestration)."""
    return control.execute(
        test, node, f"asinfo -v {control.escape(command)}")


def roster_set(test: dict, node, observed: str) -> str:
    """asinfo roster-set on the primary (core.clj:256-266)."""
    return asinfo(test, node,
                  f"roster-set:namespace={NAMESPACE};nodes={observed}")


def recluster(test: dict, node) -> str:
    return control.execute(test, node, "asadm -e 'asinfo -v recluster:'")


def observed_nodes(test: dict, node) -> str:
    out = asinfo(test, node, f"roster:namespace={NAMESPACE}")
    m = re.search(r"observed_nodes=([^:;\s]+)", out)
    return m.group(1) if m else ""


# ---------------------------------------------------------------------------
# Info parsing + roster convergence (core.clj:52-98, 139-195)
# ---------------------------------------------------------------------------


def _maybe_number(s: str):
    try:
        return int(s)
    except ValueError:
        try:
            return float(s)
        except ValueError:
            return s


def server_info(test: dict, node, key: str = "statistics") -> dict:
    """Parse an asinfo k=v;k=v response into a dict with numbers coerced
    (core.clj:82-98 server-info + the kv-split family 52-75)."""
    out = asinfo(test, node, key).strip()
    info = {}
    for kv in out.split(";"):
        if "=" in kv:
            k, v = kv.split("=", 1)
            info[k] = _maybe_number(v)
    return info


def roster(test: dict, node) -> dict:
    """roster:namespace=... parsed to {field: [node-ids]}
    (core.clj:139-147): fields split on colons, node lists on commas;
    'null' means empty."""
    out = asinfo(test, node, f"roster:namespace={NAMESPACE}").strip()
    parsed = {}
    for field in out.split(":"):
        if "=" not in field:
            continue
        k, v = field.split("=", 1)
        parsed[k] = [] if v in ("", "null") else v.split(",")
    return parsed


def _poll(fn, pred, tries: int = 30, sleep: float = 1.0):
    """Call fn until pred(result) holds; the reference's poll macro
    (core.clj:156-167): 30 one-second tries then RuntimeError."""
    import time as _t
    for i in range(tries):
        result = fn()
        if pred(result):
            return result
        _t.sleep(sleep)
    raise TimeoutError(f"aerospike poll timed out after {tries} tries")


def wait_for_all_nodes_observed(test: dict, node) -> list:
    """Spin until the roster has observed every node (core.clj:169-173);
    returns the observed node-id list (roster-set consumes it)."""
    want = len(test["nodes"])
    return _poll(lambda: roster(test, node).get("observed_nodes", []),
                 lambda r: len(r) == want)


def wait_for_all_nodes_pending(test: dict, node) -> list:
    """core.clj:175-179: the pending roster carries every node."""
    want = len(test["nodes"])
    return _poll(lambda: roster(test, node).get("pending_roster", []),
                 lambda r: len(r) == want)


def wait_for_all_nodes_active(test: dict, node) -> list:
    """core.clj:181-185: the active roster carries every node."""
    want = len(test["nodes"])
    return _poll(lambda: roster(test, node).get("roster", []),
                 lambda r: len(r) == want)


def wait_for_migrations(test: dict, node) -> dict:
    """core.clj:187-195: partition migrations quiesced."""
    return _poll(
        lambda: server_info(test, node),
        lambda s: (s.get("migrate_allowed") == "true"
                   and s.get("migrate_partitions_remaining") == 0))


class AerospikeDB(db_ns.DB, db_ns.Primary, db_ns.LogFiles):
    """deb install, config upload, service start + roster on primary
    (core.clj:213-278)."""

    def setup(self, test, node):
        debian.install(test, node, ["aerospike-server-community",
                                    "aerospike-tools"])
        with control.sudo():
            control.exec(test, node, "mkdir", "-p", "/var/log/aerospike")
            control.exec(test, node, "service", "aerospike", "start")

    def setup_primary(self, test, node):
        """The full roster dance (core.clj:264-277): wait for the
        cluster to observe every node, set the roster to exactly that
        list, wait for it to go pending, recluster, then wait for the
        active roster and for migrations to quiesce."""
        observed = wait_for_all_nodes_observed(test, node)
        roster_set(test, node, ",".join(observed))
        wait_for_all_nodes_pending(test, node)
        recluster(test, node)
        wait_for_all_nodes_active(test, node)
        wait_for_migrations(test, node)

    def teardown(self, test, node):
        with control.sudo():
            control.execute(test, node, "service aerospike stop || true")
            control.execute(test, node,
                            "rm -rf /opt/aerospike/data/* || true")

    def log_files(self, test, node):
        return ["/var/log/aerospike/aerospike.log"]


def kill_nemesis():
    """SIGKILL asd on random nodes (core.clj:508-514)."""
    import random as _r
    return nemesis.node_start_stopper(
        lambda ns: _r.choice(ns) if ns else None,
        lambda t, n: (cu.grepkill(t, n, "asd"), "killed")[1],
        lambda t, n: (control.exec(t, n, "service", "aerospike", "start"),
                      "started")[1])


def with_errors(op: Op, exc: Exception) -> Op:
    """Error taxonomy (core.clj:402-441): idempotent ops fail, others are
    indeterminate; generation mismatches and missing records are definite
    failures either way."""
    msg = str(exc)
    if re.search(r"generation|FAIL_GENERATION", msg, re.I):
        return op.replace(type="fail", error="generation-mismatch")
    if re.search(r"not.?found", msg, re.I):
        return op.replace(type="fail", error="not-found")
    if re.search(r"forbidden", msg, re.I):
        return op.replace(type="fail", error="forbidden")
    t = "fail" if op.f in IDEMPOTENT_FS else "info"
    if re.search(r"timeout|timed.?out", msg, re.I):
        return op.replace(type=t, error="timeout")
    return op.replace(type=t, error=msg[:80])


class AqlClient(client_ns.Client):
    def __init__(self, node=None):
        self.node = node

    def open(self, test, node):
        c = type(self)()
        c.node = node
        return c

    def _aql(self, test, statement: str) -> str:
        return control.execute(
            test, self.node,
            f"aql -h {control.escape(str(self.node))} "
            f"-c {control.escape(statement)}")


class CasRegisterClient(AqlClient):
    """Generation CAS over independent keys (core.clj:444-476): read
    returns (value, generation); cas re-reads and writes with a
    generation-equal predicate."""

    def _read(self, test, k):
        out = self._aql(test,
                        f"SELECT value FROM {NAMESPACE}.{SET} "
                        f"WHERE PK = {int(k)}")
        m = re.search(r"\|\s*(-?\d+)\s*\|", out)
        gen_m = re.search(r"gen[\"']?\s*[:=]\s*(\d+)", out)
        value = int(m.group(1)) if m else None
        generation = int(gen_m.group(1)) if gen_m else None
        return value, generation

    def invoke(self, test, op: Op) -> Op:
        k, v = op.value
        try:
            if op.f == "read":
                value, _ = self._read(test, k)
                return op.replace(type="ok",
                                  value=independent.tuple_(k, value))
            if op.f == "write":
                self._aql(test,
                          f"INSERT INTO {NAMESPACE}.{SET} (PK, value) "
                          f"VALUES ({int(k)}, {int(v)})")
                return op.replace(type="ok")
            if op.f == "cas":
                old, new = v
                value, generation = self._read(test, k)
                if value is None:
                    return op.replace(type="fail", error="not-found")
                if value != old:
                    return op.replace(type="fail", error="value-mismatch")
                # generation predicate: write succeeds only if unchanged
                self._aql(test,
                          f"INSERT INTO {NAMESPACE}.{SET} (PK, value) "
                          f"VALUES ({int(k)}, {int(new)}) "
                          f"WITH gen_equal = {generation}")
                return op.replace(type="ok")
            raise ValueError(f"unknown op {op.f!r}")
        except control.RemoteError as e:
            return with_errors(op, e)


class CounterClient(AqlClient):
    """Counter via bin add (core.clj add! / counter workload)."""

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "add":
                self._aql(test,
                          f"EXECUTE add.add('value', {int(op.value)}) ON "
                          f"{NAMESPACE}.counters WHERE PK = 0")
                return op.replace(type="ok")
            if op.f == "read":
                out = self._aql(test,
                                f"SELECT value FROM {NAMESPACE}.counters "
                                f"WHERE PK = 0")
                m = re.search(r"\|\s*(-?\d+)\s*\|", out)
                return op.replace(type="ok",
                                  value=int(m.group(1)) if m else 0)
            raise ValueError(f"unknown op {op.f!r}")
        except control.RemoteError as e:
            return with_errors(op, e)


def cas_register_test(opts: dict) -> dict:
    """Independent CAS registers, 100-worker shape (core.clj:566-575)."""
    import itertools
    test = noop_test()
    test.update({
        "name": "aerospike-cas-register",
        "os": debian.os(),
        "db": AerospikeDB(),
        "client": CasRegisterClient(),
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


def counter_test(opts: dict) -> dict:
    """Counter workload with interval-bound checking (core.clj:577-590)."""
    import random as _r

    def add(test, process):
        return {"type": "invoke", "f": "add", "value": 1}

    def read(test, process):
        return {"type": "invoke", "f": "read", "value": None}

    test = cas_register_test(opts)
    test.update({
        "name": "aerospike-counter",
        "client": CounterClient(),
        "model": None,
        "checker": compose({"counter": counter()}),
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.clients(gen.mix([add, add, read]),
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
WORKLOADS = {"cas-register": cas_register_test, "counter": counter_test}


def main(argv=None):
    """The reference's command line: ``test`` runs the CAS register, or
    with ``--workload counter`` the counter; ``serve`` the results
    browser."""
    from jepsen_tpu_torch import cli

    def opt_spec(p):
        p.add_argument("--workload", default="cas-register",
                       choices=["cas-register", "counter"])

    def test_fn(opts):
        fn = (counter_test if opts.get("workload") == "counter"
              else cas_register_test)
        return fn(opts)

    cli.main(cli.merge_commands(
        cli.single_test_cmd(test_fn, opt_spec=opt_spec),
        cli.serve_cmd()), argv)


if __name__ == "__main__":
    main()
