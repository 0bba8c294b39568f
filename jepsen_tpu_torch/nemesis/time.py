"""Clock-fault toolkit: compile C++ helpers on nodes, then drive them.

Rebuild of jepsen.nemesis.time (jepsen/src/jepsen/nemesis/time.clj): the
precision clock faults (one-shot bumps, monotonic-anchored strobes) need
real syscalls and must run even when the node's package manager is broken,
so they stay tiny native binaries (resources/bump_time.cc,
strobe_time.cc, adj_time.cc) uploaded and compiled *on the DB node* with
the system compiler (time.clj:11-27), then invoked over the control
plane.

Inventory note: the reference also ships strobe-time-experiment.c
(jepsen/resources/strobe-time-experiment.c, 205 LoC) — an earlier
prototype of the SAME monotonic-anchored strobe algorithm that does not
compile as written (`int64_t nanos timespec_to_nanos(...)` at :30,
`null` at :145). Its working idea — alternate wall = monotonic + offset
/ + offset + delta from a single anchor, restore, print the adjustment
count — is exactly what resources/strobe_time.cc implements, so the
experiment is deliberately subsumed rather than rebuilt as a second
binary.

The port's copy of ``jepsen_tpu.nemesis.time``, with its own copies of
the three helpers' sources under ``resources/`` beside it.
"""

from __future__ import annotations

import math
import os
import random
from typing import Optional

from jepsen_tpu_torch import control
from jepsen_tpu_torch.nemesis import Nemesis

RESOURCE_DIR = os.path.join(os.path.dirname(__file__), "resources")
REMOTE_DIR = "/opt/jepsen"

#: helper name -> local source file
HELPERS = {
    "bump-time": "bump_time.cc",
    "strobe-time": "strobe_time.cc",
    "adj-time": "adj_time.cc",
}


def compile_helper(test: dict, node, source: str, bin_name: str) -> str:
    """Upload a C++ source and compile it to /opt/jepsen/<bin> on node with
    the node's compiler (time.clj:11-27)."""
    with control.sudo():
        control.exec(test, node, "mkdir", "-p", REMOTE_DIR)
        control.exec(test, node, "chmod", "a+rwx", REMOTE_DIR)
    remote_src = f"{REMOTE_DIR}/{bin_name}.cc"
    control.upload(test, node, source, remote_src)
    with control.sudo(), control.cd(REMOTE_DIR):
        control.exec(test, node, "g++", "-O2", "-o", bin_name,
                     f"{bin_name}.cc")
    return f"{REMOTE_DIR}/{bin_name}"


def install(test: dict, node=None) -> None:
    """Upload + compile the clock helpers (time.clj:35-42) on one node, or
    every node when node is None."""
    def install_one(t, n):
        for bin_name, src in HELPERS.items():
            compile_helper(t, n, os.path.join(RESOURCE_DIR, src), bin_name)
    if node is not None:
        install_one(test, node)
    else:
        control.on_nodes(test, install_one)


def reset_time(test: dict, node) -> None:
    """Reset a node's clock via NTP (time.clj:44-48)."""
    with control.sudo():
        control.exec(test, node, "ntpdate", "-b",
                     test.get("ntp-server", "pool.ntp.org"))


def bump_time(test: dict, node, delta_ms: float) -> None:
    """Jump the node's wall clock by delta milliseconds (time.clj:50-53)."""
    with control.sudo():
        control.exec(test, node, f"{REMOTE_DIR}/bump-time", delta_ms)


def slew_time(test: dict, node, delta_ms: float) -> None:
    """Gradually slew the node's clock by delta milliseconds via
    adjtime(2) — smooth drift rather than a jump (reference
    cockroachdb/resources/adjtime.c:1-19, compiled by auto.clj:122-140)."""
    with control.sudo():
        control.exec(test, node, f"{REMOTE_DIR}/adj-time", delta_ms)


def strobe_time(test: dict, node, delta_ms: float, period_ms: float,
                duration_s: float) -> None:
    """Oscillate the node's clock by +delta every period for duration
    (time.clj:55-59)."""
    with control.sudo():
        control.exec(test, node, f"{REMOTE_DIR}/strobe-time", delta_ms,
                     period_ms, duration_s)


class ClockNemesis(Nemesis):
    """Clock manipulator (time.clj:61-91). Ops:

    - f='reset',  value=[node, ...]
    - f='bump',   value={node: delta_ms, ...}
    - f='strobe', value={node: {'delta': ms, 'period': ms,
                                'duration': s}, ...}
    """

    def setup(self, test):
        install(test)
        control.on_nodes(test, reset_time)
        return self

    def invoke(self, test, op):
        if op.f == "reset":
            control.on_nodes(test, reset_time, nodes=op.value)
        elif op.f == "bump":
            plan = op.value or {}
            control.on_nodes(
                test, lambda t, n: bump_time(t, n, plan[n]),
                nodes=list(plan))
        elif op.f == "strobe":
            plan = op.value or {}
            control.on_nodes(
                test,
                lambda t, n: strobe_time(t, n, plan[n]["delta"],
                                         plan[n]["period"],
                                         plan[n]["duration"]),
                nodes=list(plan))
        else:
            raise ValueError(f"clock nemesis got unknown f={op.f!r}")
        return op

    def teardown(self, test):
        control.on_nodes(test, reset_time)


def clock_nemesis() -> ClockNemesis:
    return ClockNemesis()


# ---------------------------------------------------------------------------
# Randomized fault generators (time.clj:93-126)
# ---------------------------------------------------------------------------


def random_nonempty_subset(coll):
    """A uniformly sized, shuffled, nonempty subset (util.clj
    random-nonempty-subset)."""
    coll = list(coll)
    if not coll:
        return []
    k = random.randint(1, len(coll))
    return random.sample(coll, k)


def reset_gen(test, process):
    """Reset clocks on a random nonempty node subset (time.clj:93-97)."""
    return {"type": "info", "f": "reset",
            "value": random_nonempty_subset(test.get("nodes") or [])}


def bump_gen(test, process):
    """Bump clocks -262..+262 s, exponentially distributed
    (time.clj:99-107)."""
    nodes = random_nonempty_subset(test.get("nodes") or [])
    return {"type": "info", "f": "bump",
            "value": {n: random.choice([-1, 1])
                      * math.pow(2, 2 + random.random() * 16)
                      for n in nodes}}


def strobe_gen(test, process):
    """Strobe clocks: delta 4 ms..262 s, period 1 ms..1 s, duration 0..32 s
    (time.clj:109-119)."""
    nodes = random_nonempty_subset(test.get("nodes") or [])
    return {"type": "info", "f": "strobe",
            "value": {n: {"delta": math.pow(2, 2 + random.random() * 16),
                          "period": math.pow(2, random.random() * 10),
                          "duration": random.random() * 32}
                      for n in nodes}}


def clock_gen():
    """A random mix of reset/bump/strobe ops (time.clj:121-126)."""
    from jepsen_tpu_torch import generator as gen
    return gen.mix([reset_gen, bump_gen, strobe_gen])
