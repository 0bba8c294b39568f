"""The register workload the local-kv suites draw from: the port's copy
of the register ops of ``jepsen_tpu.suites.workloads`` (read, write of
0-4, cas of two values in 0-4; reference etcd.clj:144-146). They draw
from the module-level ``random``, as the reference's do."""

from __future__ import annotations

import random

from jepsen_tpu_torch import generator as gen


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randrange(5), random.randrange(5))}


def register_gen():
    """The canonical mixed register workload."""
    return gen.mix([r, w, cas])
