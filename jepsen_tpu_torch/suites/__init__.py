"""Test suites of the port: ``<name>_test(opts) -> test map``
constructors, by name.

The port has every suite of ``jepsen_tpu.suites``: the two local-kv
suites (:mod:`.localkv`), whose nodes are real local
processes, the three sqlite suites (:mod:`.sqlitedb`), whose system is
the real SQLite engine, the wire-protocol suites of the register, mutex
and queue families: etcd, consul, zookeeper, raftis, disque, rabbitmq (a
queue and a mutex) and hazelcast (seven workloads), the suites whose data
plane is a command run over the control plane: cockroachdb (eight
workloads, with the clock nemeses), aerospike (a CAS register and a
counter) and mongodb (a document CAS and a transfer), and the rest:
logcabin, rethinkdb and ravendb (one CAS or read/write register a run),
mongodb-rocks, robustirc (:mod:`.small`), galera (:mod:`.galera`), tidb,
percona, mysql-cluster, postgres-rds and crate (:mod:`.sql_family`) and
elasticsearch (:mod:`.elasticsearch`), and chronos (:mod:`.chronos`, a
job scheduler on a mesos cluster, :mod:`.mesosphere`). Their
linearizability check runs on the card unless the options ask for the CPU
(``backend: "cpu"``, or ``device: "cpu"``); the set, bank, dirty-read,
version-divergence and chronos schedule checks run on the host.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict

#: name -> (module, constructor attribute)
SUITES = {
    "etcd": ("etcd", "etcd_test"),
    "zookeeper": ("zookeeper", "zk_test"),
    "consul": ("consul", "consul_test"),
    "disque": ("disque", "disque_test"),
    "raftis": ("raftis", "raftis_test"),
    "rabbitmq": ("rabbitmq", "rabbitmq_test"),
    "rabbitmq-mutex": ("rabbitmq", "mutex_test"),
    "hazelcast": ("hazelcast", "hazelcast_test"),
    "cockroachdb": ("cockroachdb", "register_test"),
    "cockroachdb-bank": ("cockroachdb", "bank_test"),
    "cockroachdb-sets": ("cockroachdb", "sets_test"),
    "cockroachdb-comments": ("cockroachdb", "comments_test"),
    "cockroachdb-monotonic": ("cockroachdb", "monotonic_test"),
    "cockroachdb-sequential": ("cockroachdb", "sequential_test"),
    "cockroachdb-g2": ("cockroachdb", "g2_test"),
    "cockroachdb-bank-multitable": ("cockroachdb",
                                    "bank_multitable_test"),
    "aerospike": ("aerospike", "cas_register_test"),
    "aerospike-counter": ("aerospike", "counter_test"),
    "mongodb": ("mongodb", "document_cas_test"),
    "mongodb-transfer": ("mongodb", "transfer_test"),
    "local-kv": ("localkv", "localkv_test"),
    "local-kv-unsafe": ("localkv", "localkv_unsafe_test"),
    "sqlite-register": ("sqlitedb", "sqlite_register_test"),
    "sqlite-bank": ("sqlitedb", "sqlite_bank_test"),
    "sqlite-register-toctou": ("sqlitedb", "sqlite_register_toctou_test"),
    "galera": ("galera", "dirty_reads_test"),
    "galera-set": ("galera", "sets_test"),
    "galera-bank": ("galera", "bank_test"),
    "mongodb-rocks": ("small", "mongodb_rocks_test"),
    "elasticsearch": ("elasticsearch", "dirty_read_test"),
    "elasticsearch-set": ("elasticsearch", "sets_test"),
    "elasticsearch-set-cas": ("elasticsearch", "set_cas_test"),
    "elasticsearch-set-isolate-primaries":
        ("elasticsearch", "set_isolate_primaries_test"),
    "elasticsearch-set-pause": ("elasticsearch", "set_pause_test"),
    "elasticsearch-set-crash": ("elasticsearch", "set_crash_test"),
    "elasticsearch-set-bridge": ("elasticsearch", "set_bridge_test"),
    "tidb": ("sql_family", "tidb_bank_test"),
    "tidb-register": ("sql_family", "tidb_register_test"),
    "tidb-sets": ("sql_family", "tidb_sets_test"),
    "percona": ("sql_family", "percona_dirty_reads_test"),
    "percona-set": ("sql_family", "percona_sets_test"),
    "percona-bank": ("sql_family", "percona_bank_test"),
    "mysql-cluster": ("sql_family", "mysql_cluster_bank_test"),
    "postgres-rds": ("sql_family", "postgres_rds_bank_test"),
    "crate": ("sql_family", "crate_version_divergence_test"),
    "crate-lost-updates": ("sql_family", "crate_lost_updates_test"),
    "crate-dirty-read": ("sql_family", "crate_dirty_read_test"),
    "logcabin": ("small", "logcabin_test"),
    "robustirc": ("small", "robustirc_test"),
    "rethinkdb": ("small", "rethinkdb_test"),
    "rethinkdb-aggressive": ("small", "rethinkdb_aggressive_test"),
    "ravendb": ("small", "ravendb_test"),
    "chronos": ("chronos", "chronos_test"),
}


def registry() -> Dict[str, Callable[[dict], dict]]:
    """Suite name -> test constructor."""
    out: Dict[str, Callable[[dict], dict]] = {}
    for name, (mod, attr) in SUITES.items():
        m = importlib.import_module(f"jepsen_tpu_torch.suites.{mod}")
        out[name] = getattr(m, attr)
    return out

