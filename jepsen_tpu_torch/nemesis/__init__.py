"""Fault injection.

Rebuild of jepsen.nemesis (jepsen/src/jepsen/nemesis.clj): the Nemesis
protocol plus the library of faults — network partitions driven by *grudge*
maps (node -> set of nodes it refuses traffic from), clock scrambling,
process pause/kill via a node start/stopper, and file truncation.

Grudge *planning* is pure data (bisect/split_one/complete_grudge/bridge/
majorities_ring are plain functions over node lists) and is tested with no
network at all (reference nemesis_test.clj); only partition()/snub_nodes()
touch the control plane. The port's copy of ``jepsen_tpu.nemesis``; its
metrics go to the port's registry.
"""

from __future__ import annotations

import random
import threading
import time as _time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

from jepsen_tpu_torch import control
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.obs import metrics as obs_metrics
from jepsen_tpu_torch.util import majority

#: 1 while a nemesis-injected fault window is open (a non-heal op
#: completed and no heal-class op has since), 0 otherwise — lets a
#: dashboard overlay fault windows on latency/throughput series.
_FAULT_ACTIVE = obs_metrics.gauge(
    "jtpu_fault_active",
    "1 while a nemesis fault window is open, 0 after a heal-class op")
_FAULT_OPS = obs_metrics.counter(
    "jtpu_nemesis_ops_total", "nemesis ops completed, labeled by f")

# ---------------------------------------------------------------------------
# Protocol
# ---------------------------------------------------------------------------

#: Op f values whose successful completion claims to have healed the
#: fault — the Partitioner heals on 'stop', explicit healers use 'heal'.
HEAL_FS = frozenset({"stop", "heal"})


class Nemesis:
    """Fault-injection protocol (nemesis.clj:9-12). setup returns the
    nemesis ready to be invoked (possibly a new object).

    Post-fault convergence: set :attr:`heal_probe` to a callable
    ``(test, op) -> {"verified": bool, ...}`` and the nemesis worker
    will run it after every successful heal-class op (``f`` in
    :attr:`heal_fs`), recording a ``heal-verified`` / ``heal-failed``
    info op in the history — a heal that *returned* is not the same as
    a cluster that *converged*, and checkers/humans deserve to see
    which fault windows never really closed.
    """

    #: f values treated as heals (override per nemesis if needed).
    heal_fs: frozenset = HEAL_FS
    #: Optional convergence probe; see :func:`client_ping_probe`.
    heal_probe = None

    def setup(self, test: dict) -> "Nemesis":
        return self

    def invoke(self, test: dict, op: Op) -> Op:
        return op

    def teardown(self, test: dict) -> None:
        pass

    def note_fault_op(self, op: Op) -> None:
        """Telemetry hook (called by the nemesis worker after every
        completed nemesis op): flips the fault-active gauge — this layer
        owns the heal-classification (``heal_fs``), so it decides when a
        fault window opens and closes."""
        if op.f is None:
            return
        _FAULT_OPS.inc(f=str(op.f))
        _FAULT_ACTIVE.set(0.0 if op.f in (self.heal_fs or ()) else 1.0)

    def verify_heal(self, test: dict, op: Op) -> Optional[dict]:
        """Run the heal probe for a completed nemesis op, or None when
        the op is not a heal / no probe is configured."""
        if self.heal_probe is None or op.f not in (self.heal_fs or ()):
            return None
        return self.heal_probe(test, op)


class Noop(Nemesis):
    """Does nothing (nemesis.clj noop)."""


def noop() -> Noop:
    return Noop()


# ---------------------------------------------------------------------------
# Partitions: grudges are data
# ---------------------------------------------------------------------------


def bisect(coll: Sequence) -> List[List]:
    """Cut a sequence in half; smaller half first (nemesis.clj:60-63)."""
    coll = list(coll)
    mid = len(coll) // 2
    return [coll[:mid], coll[mid:]]


def split_one(coll: Sequence, loner: Any = None) -> List[List]:
    """Split one node (random unless given) off from the rest
    (nemesis.clj:65-70)."""
    coll = list(coll)
    if loner is None:
        loner = random.choice(coll)
    return [[loner], [x for x in coll if x != loner]]


def complete_grudge(components: Iterable[Iterable]) -> Dict[Any, set]:
    """Grudge in which no node can talk outside its component
    (nemesis.clj:72-84)."""
    components = [set(c) for c in components]
    universe = set().union(*components) if components else set()
    grudge: Dict[Any, set] = {}
    for component in components:
        for node in component:
            grudge[node] = universe - component
    return grudge


def bridge(nodes: Sequence) -> Dict[Any, set]:
    """Cut the network in half but keep one bridge node with uninterrupted
    bidirectional connectivity to both halves (nemesis.clj:86-97)."""
    components = bisect(nodes)
    b = components[1][0]
    grudge = complete_grudge(components)
    del grudge[b]  # bridge snubs no one
    return {node: others - {b} for node, others in grudge.items()}


def majorities_ring(nodes: Sequence) -> Dict[Any, set]:
    """Every node sees a majority, but no node sees the *same* majority as
    any other (nemesis.clj:136-157): shuffle nodes into a ring, take the n
    windows of size majority(n), key each window by its middle node, and
    snub everything outside the window."""
    universe = set(nodes)
    n = len(nodes)
    m = majority(n)
    ring = list(nodes)
    random.shuffle(ring)
    grudge = {}
    for i in range(n):
        window = [ring[(i + j) % n] for j in range(m)]
        grudge[window[len(window) // 2]] = universe - set(window)
    return grudge


def snub_nodes(test: dict, dest, sources: Iterable) -> None:
    """Drop all packets from sources as seen at dest (nemesis.clj:47-50)."""
    net = test.get("net")
    if net is None:
        return
    for src in sources or ():
        net.drop(test, src, dest)


def partition(test: dict, grudge: Dict[Any, Iterable]) -> None:
    """Apply a grudge map. Does not heal first: repeated calls are
    cumulative (nemesis.clj:52-58)."""
    control.on_nodes(test,
                     lambda t, node: snub_nodes(t, node, grudge.get(node)))


class Partitioner(Nemesis):
    """start -> cut links per (grudge_fn nodes); stop -> heal
    (nemesis.clj:99-117)."""

    def __init__(self, grudge_fn: Callable[[Sequence], Dict[Any, set]]):
        self.grudge_fn = grudge_fn

    def _heal(self, test):
        net = test.get("net")
        if net is not None:
            net.heal(test)

    def setup(self, test):
        self._heal(test)
        return self

    def invoke(self, test, op):
        if op.f == "start":
            grudge = self.grudge_fn(test.get("nodes") or [])
            partition(test, grudge)
            return op.replace(value=f"Cut off {grudge!r}")
        if op.f == "stop":
            self._heal(test)
            return op.replace(value="fully connected")
        raise ValueError(f"partitioner got unknown op f={op.f!r}")

    def teardown(self, test):
        self._heal(test)


def partitioner(grudge_fn) -> Partitioner:
    return Partitioner(grudge_fn)


def partition_halves() -> Partitioner:
    """First half | second half (nemesis.clj:119-124)."""
    return Partitioner(lambda nodes: complete_grudge(bisect(nodes)))


def partition_random_halves() -> Partitioner:
    """Random halves (nemesis.clj:126-129)."""
    def grudge(nodes):
        nodes = list(nodes)
        random.shuffle(nodes)
        return complete_grudge(bisect(nodes))
    return Partitioner(grudge)


def partition_random_node() -> Partitioner:
    """Isolate one random node (nemesis.clj:131-134)."""
    return Partitioner(lambda nodes: complete_grudge(split_one(nodes)))


def partition_majorities_ring() -> Partitioner:
    """Intersecting-majorities ring (nemesis.clj:153-157)."""
    return Partitioner(majorities_ring)


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------


def _route(fs, f):
    """Routing rule -> new f or None (nemesis.clj compose docstring):
    a set passes members through unchanged; a dict renames; a callable
    decides itself."""
    if isinstance(fs, (set, frozenset)):
        return f if f in fs else None
    if isinstance(fs, dict):
        return fs.get(f)
    if callable(fs):
        return fs(f)
    raise TypeError(f"unroutable fs spec: {fs!r}")


class Compose(Nemesis):
    """Route ops to child nemeses by f (nemesis.clj:159-197). Takes a dict
    of routing-spec -> nemesis, or — since dict routing specs (f renames)
    are unhashable in Python — an iterable of (spec, nemesis) pairs."""

    def __init__(self, nemeses):
        items = nemeses.items() if isinstance(nemeses, dict) else nemeses
        self.nemeses: List[tuple] = [(fs, n) for fs, n in items]

    def setup(self, test):
        self.nemeses = [(fs, n.setup(test) or n) for fs, n in self.nemeses]
        return self

    def invoke(self, test, op):
        for fs, n in self.nemeses:
            f2 = _route(fs, op.f)
            if f2 is not None:
                out = n.invoke(test, op.replace(f=f2))
                return out.replace(f=op.f)
        raise ValueError(f"no nemesis can handle f={op.f!r}")

    def teardown(self, test):
        for fs, n in self.nemeses:
            n.teardown(test)

    def verify_heal(self, test, op):
        """Route the probe like invoke: the child that handled the op
        decides whether it was a heal (seeing the renamed f). A probe
        set on the Compose itself takes precedence and applies to every
        heal-class f, whichever child handled it."""
        if self.heal_probe is not None:
            return Nemesis.verify_heal(self, test, op)
        for fs, n in self.nemeses:
            f2 = _route(fs, op.f)
            if f2 is not None:
                return n.verify_heal(test, op.replace(f=f2))
        return None


def compose(nemeses) -> Compose:
    return Compose(nemeses)


# ---------------------------------------------------------------------------
# Post-fault convergence probes
# ---------------------------------------------------------------------------


def client_ping_probe(deadline_s: float = 5.0, policy=None,
                      op_f: str = "read", ok_types=("ok",)):
    """A heal probe that pings every node through the test's client.

    After a heal, each node gets up to ``deadline_s`` seconds of
    open/invoke/close attempts under the resilience layer's retry
    policy (jittered capped-exponential backoff,
    :class:`jepsen_tpu_torch.resilience.RetryPolicy`): a node counts as
    converged once a ``op_f`` invocation completes with a type in
    ``ok_types``. Returns the probe callable to assign to
    ``nemesis.heal_probe``; its result dict lands in the history as the
    ``heal-verified`` / ``heal-failed`` op's value, per-node attempt
    counts and errors included."""

    def probe(test: dict, op: Op) -> dict:
        from jepsen_tpu_torch.resilience import (RetryPolicy,
                                           retry_until_deadline)
        pol = policy or RetryPolicy()
        t0 = _time.monotonic()
        nodes = list(test.get("nodes") or [])
        results: Dict[Any, dict] = {}
        all_ok = True
        for node in nodes:
            def ping(node=node):
                client = test["client"].open(test, node)
                try:
                    comp = client.invoke(
                        test, Op(type="invoke", f=op_f, value=None,
                                 process="heal-probe"))
                    return comp is not None and comp.type in ok_types
                finally:
                    try:
                        client.close(test)
                    except Exception:  # noqa: BLE001
                        pass

            ok, attempts, err = retry_until_deadline(ping, deadline_s,
                                                     policy=pol)
            rec = {"ok": ok, "attempts": attempts}
            if not ok and err:
                rec["error"] = err
            results[node] = rec
            all_ok = all_ok and ok
        return {"verified": all_ok, "deadline-s": deadline_s,
                "elapsed-s": round(_time.monotonic() - t0, 3),
                "nodes": results}

    return probe


# ---------------------------------------------------------------------------
# Clock faults (coarse; precise helpers live in jepsen_tpu_torch.nemesis.time)
# ---------------------------------------------------------------------------


def set_time(test: dict, node, t: float) -> None:
    """Set a node's wall clock to POSIX seconds t (nemesis.clj set-time!)."""
    with control.sudo():
        control.exec(test, node, "date", "+%s", "-s", f"@{int(t)}")


class ClockScrambler(Nemesis):
    """Randomizes node clocks within a +/- dt second window
    (nemesis.clj:204-219)."""

    def __init__(self, dt: float):
        self.dt = dt

    def invoke(self, test, op):
        def scramble(t, node):
            offset = random.randint(-int(self.dt), int(self.dt))
            set_time(t, node, _time.time() + offset)
            return offset
        return op.replace(value=control.on_nodes(test, scramble))

    def teardown(self, test):
        control.on_nodes(test,
                         lambda t, node: set_time(t, node, _time.time()))


def clock_scrambler(dt: float) -> ClockScrambler:
    return ClockScrambler(dt)


# ---------------------------------------------------------------------------
# Process faults
# ---------------------------------------------------------------------------


class NodeStartStopper(Nemesis):
    """start -> run start_fn(test, node) on targeter-chosen nodes;
    stop -> stop_fn on the same nodes (nemesis.clj:221-256). Targeter takes
    the node list and returns one node or a collection; results become the
    op value, e.g. {'n1': ['killed', 'java']}."""

    def __init__(self, targeter, start_fn, stop_fn):
        self.targeter = targeter
        self.start_fn = start_fn
        self.stop_fn = stop_fn
        self._nodes: Optional[list] = None
        self._lock = threading.Lock()

    def invoke(self, test, op):
        with self._lock:
            if op.f == "start":
                targets = self.targeter(list(test.get("nodes") or []))
                if targets is None:
                    return op.replace(type="info", value="no-target")
                if not isinstance(targets, (list, tuple, set, frozenset)):
                    targets = [targets]
                targets = list(targets)
                if self._nodes is not None:
                    return op.replace(
                        type="info",
                        value=f"nemesis already disrupting {self._nodes!r}")
                self._nodes = targets
                value = control.on_many(
                    test, targets, lambda n: self.start_fn(test, n))
                return op.replace(type="info", value=value)
            if op.f == "stop":
                if self._nodes is None:
                    return op.replace(type="info", value="not-started")
                value = control.on_many(
                    test, self._nodes, lambda n: self.stop_fn(test, n))
                self._nodes = None
                return op.replace(type="info", value=value)
            raise ValueError(f"node-start-stopper got f={op.f!r}")


def node_start_stopper(targeter, start_fn, stop_fn) -> NodeStartStopper:
    return NodeStartStopper(targeter, start_fn, stop_fn)


def _rand_node(nodes):
    return random.choice(nodes) if nodes else None


def hammer_time(process: str, targeter=_rand_node) -> NodeStartStopper:
    """SIGSTOP the process on start, SIGCONT on stop
    (nemesis.clj:258-272)."""
    def start(test, node):
        with control.sudo():
            control.exec(test, node, "killall", "-s", "STOP", process)
        return ["paused", process]

    def stop(test, node):
        with control.sudo():
            control.exec(test, node, "killall", "-s", "CONT", process)
        return ["resumed", process]

    return NodeStartStopper(targeter, start, stop)


class TruncateFile(Nemesis):
    """f='truncate', value={node: {'file': path, 'drop': bytes}}: drop the
    last bytes from files (nemesis.clj:274-300)."""

    def invoke(self, test, op):
        assert op.f == "truncate"
        plan = op.value or {}

        def truncate(t, node):
            spec = plan[node]
            path, drop = spec["file"], spec["drop"]
            assert isinstance(path, str) and isinstance(drop, int)
            with control.sudo():
                control.exec(t, node, "truncate", "-c", "-s", f"-{drop}",
                             path)
        control.on_nodes(test, truncate, nodes=list(plan))
        return op


def truncate_file() -> TruncateFile:
    return TruncateFile()
