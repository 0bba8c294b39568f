"""Op-scheduling DSL: generators and their combinators.

Rebuild of jepsen.generator (jepsen/src/jepsen/generator.clj). A generator
yields one operation per ``op(test, process)`` call; workers loop pulling ops
until the generator returns None. Generators are *stateful and thread-safe*:
many worker threads pull from the same instance concurrently.

Threads vs processes (generator.clj:40-71): a *thread* is a stable identity
(0..concurrency-1 or 'nemesis'); a *process* is incarnation p where
``thread = p mod concurrency`` — crashed processes are reincarnated as
``p + concurrency`` on the same thread. Barrier-style combinators
(synchronize/phases/each/reserve) operate on threads; the *current scope* of
threads is a dynamic binding (``threads_bound``), narrowed by routing
combinators like ``on`` and ``reserve`` exactly as the reference's
``*threads*`` var (generator.clj:40-55).

Everything-is-a-generator coercions (generator.clj:25-38): None is the empty
generator; a dict is an infinite generator of that op; a callable is invoked
with (test, process).

The port's copy of ``jepsen_tpu.generator``: it draws from the
module-level ``random`` as that module does, so one seed drives both to
the same ops.
"""

from __future__ import annotations

import random
import threading
from typing import Any, Callable, Iterable, Optional, Sequence, Union

from jepsen_tpu_torch.history import INVOKE, NEMESIS, Op
from jepsen_tpu_torch.util import relative_time_nanos, sleep as _sleep

# ---------------------------------------------------------------------------
# Thread scoping (the *threads* dynamic var, generator.clj:40-55)
# ---------------------------------------------------------------------------

_tls = threading.local()


def current_threads():
    """The set of thread ids the current generator context covers."""
    return getattr(_tls, "threads", None)


class threads_bound:
    """Context manager binding the current thread-scope (like Clojure
    ``binding`` on *threads*)."""

    def __init__(self, threads):
        self.threads = frozenset(threads) if threads is not None else None

    def __enter__(self):
        self.prev = getattr(_tls, "threads", None)
        _tls.threads = self.threads
        return self

    def __exit__(self, *exc):
        _tls.threads = self.prev
        return False


def all_threads(test: dict):
    """Default scope: every worker thread plus the nemesis
    (core.clj:466-467)."""
    return frozenset(range(test.get("concurrency", 1))) | {NEMESIS}


def process_to_thread(process, test: dict):
    """thread = process mod concurrency; nemesis maps to itself
    (generator.clj:57-62)."""
    if process == NEMESIS:
        return NEMESIS
    return process % test.get("concurrency", 1)


def process_to_node(process, test: dict):
    """Which node a process talks to: process mod #nodes
    (generator.clj:64-71, core.clj:349-352)."""
    nodes = test.get("nodes", [])
    if not nodes:
        return None
    return nodes[process % len(nodes)]


# ---------------------------------------------------------------------------
# Protocol + coercions
# ---------------------------------------------------------------------------


class Generator:
    """Base generator. Subclasses implement op(test, process)."""

    def op(self, test: dict, process) -> Optional[Op]:
        raise NotImplementedError

    # Fluent helpers (Python affordance over the reference's ->> threading)
    def limit(self, n: int) -> "Generator":
        return Limit(n, self)

    def time_limit(self, dt: float) -> "Generator":
        return TimeLimit(dt, self)

    def stagger(self, dt: float) -> "Generator":
        return Stagger(dt, self)

    def delay(self, dt: float) -> "Generator":
        return Delay(dt, self)

    def then(self, nxt: Union["Generator", dict, None]) -> "Generator":
        """self, then nxt (phase change with a barrier in between) —
        reference `then` (generator.clj:426-430) composed as phases."""
        return Phases(self, nxt)

    def filter(self, pred) -> "Generator":
        return Filter(pred, self)


GenLike = Union[Generator, dict, None, Callable, Sequence]


def gen(g: GenLike) -> Generator:
    """Coerce anything into a Generator (generator.clj:25-38)."""
    if g is None:
        return Void()
    if isinstance(g, Generator):
        return g
    if isinstance(g, (dict, Op)):
        return MapGen(g)
    if callable(g):
        return FnGen(g)
    if isinstance(g, (list, tuple)):
        return SeqGen(g)
    raise TypeError(f"cannot coerce {g!r} to a generator")


class Void(Generator):
    """Always None: the exhausted generator (nil extension)."""

    def op(self, test, process):
        return None


class MapGen(Generator):
    """A dict/Op literal: yields a fresh copy of that op on every call
    (APersistentMap extension, generator.clj:29-31)."""

    def __init__(self, template: Union[dict, Op]):
        self.template = (template.to_dict() if isinstance(template, Op)
                         else dict(template))

    def op(self, test, process):
        d = dict(self.template)
        d.setdefault("type", INVOKE)
        return Op.from_dict(d)


class FnGen(Generator):
    """A function (test, process) -> op-ish (AFn extension,
    generator.clj:33-35). Zero-arg functions are also accepted; arity is
    determined once from the signature so errors inside the function
    propagate instead of being mistaken for arity mismatches."""

    def __init__(self, f: Callable):
        self.f = f
        import inspect
        try:
            n_params = len([
                p for p in inspect.signature(f).parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                and p.default is p.empty])
        except (ValueError, TypeError):
            n_params = 2
        self.zero_arg = n_params == 0

    def op(self, test, process):
        out = self.f() if self.zero_arg else self.f(test, process)
        if out is None or isinstance(out, Op):
            return out
        return gen(out).op(test, process) if isinstance(out, Generator) \
            else Op.from_dict({**out, "type": out.get("type", INVOKE)})


# ---------------------------------------------------------------------------
# Timing combinators
# ---------------------------------------------------------------------------


class Delay(Generator):
    """Sleep dt seconds before every op (generator.clj:97-110)."""

    def __init__(self, dt: float, g: GenLike):
        self.dt = dt
        self.g = gen(g)

    def op(self, test, process):
        _sleep(self.dt)
        return self.g.op(test, process)


class DelayTil(Generator):
    """Emit ops aligned to multiples of dt seconds since test start, so
    invocations across threads land at the same instant — 'for triggering
    race conditions' (generator.clj:112-135)."""

    def __init__(self, dt: float, g: GenLike):
        self.dt = dt
        self.g = gen(g)

    def op(self, test, process):
        dt_ns = int(self.dt * 1e9)
        now = relative_time_nanos()
        wait = (dt_ns - (now % dt_ns)) % dt_ns
        if wait:
            _sleep(wait / 1e9)
        return self.g.op(test, process)


class Stagger(Generator):
    """Uniform random delay in [0, dt) before each op, mean dt/2
    (generator.clj:137-141)."""

    def __init__(self, dt: float, g: GenLike):
        self.dt = dt
        self.g = gen(g)

    def op(self, test, process):
        _sleep(random.random() * self.dt)
        return self.g.op(test, process)


class Sleep(Generator):
    """Sleeps dt seconds, then yields None (generator.clj:143-146)."""

    def __init__(self, dt: float):
        self.dt = dt

    def op(self, test, process):
        _sleep(self.dt)
        return None


# ---------------------------------------------------------------------------
# Structural combinators
# ---------------------------------------------------------------------------


class Limit(Generator):
    """At most n ops total, across all threads (generator.clj:271-278)."""

    def __init__(self, n: int, g: GenLike):
        self.remaining = n
        self.g = gen(g)
        self.lock = threading.Lock()

    def op(self, test, process):
        with self.lock:
            if self.remaining <= 0:
                return None
            self.remaining -= 1
        return self.g.op(test, process)


class Once(Limit):
    """Exactly one op total (generator.clj:148-151)."""

    def __init__(self, g: GenLike):
        super().__init__(1, g)


class TimeLimit(Generator):
    """Ops until dt seconds have elapsed since the first op request
    (generator.clj:280-291)."""

    def __init__(self, dt: float, g: GenLike):
        self.dt = dt
        self.g = gen(g)
        self.deadline: Optional[int] = None
        self.lock = threading.Lock()

    def op(self, test, process):
        with self.lock:
            if self.deadline is None:
                self.deadline = relative_time_nanos() + int(self.dt * 1e9)
        if relative_time_nanos() >= self.deadline:
            return None
        return self.g.op(test, process)


class SeqGen(Generator):
    """A sequence of generators; draws from the head until it's exhausted,
    then moves on (generator.clj:195-206). One shared cursor across
    threads."""

    def __init__(self, gens: Iterable[GenLike]):
        # Lazy, like the reference's (gen/seq (cycle ...)): infinite
        # sequences of generators are materialized one at a time.
        self._iter = iter(gens)
        self.gens: list = []
        self.i = 0
        self.lock = threading.RLock()

    def _get(self, i):
        """Materialize up to index i; None past the end. Call with lock."""
        while len(self.gens) <= i:
            try:
                self.gens.append(gen(next(self._iter)))
            except StopIteration:
                return None
        return self.gens[i]

    def op(self, test, process):
        while True:
            with self.lock:
                g = self._get(self.i)
            if g is None:
                return None
            out = g.op(test, process)
            if out is not None:
                return out
            with self.lock:
                # advance only if nobody else already did
                if self._get(self.i) is g:
                    self.i += 1


def concat(*gens: GenLike) -> Generator:
    """Generators in order, without barriers (generator.clj:360-370)."""
    return SeqGen(gens)


class Mix(Generator):
    """Random choice among generators per op (generator.clj:217-224).
    Exhausted members do NOT end the mix; it ends when the chosen one
    returns None (matching the reference, which never removes members)."""

    def __init__(self, gens: Sequence[GenLike]):
        self.gens = [gen(g) for g in gens]

    def op(self, test, process):
        if not self.gens:
            return None
        return random.choice(self.gens).op(test, process)


class Each(Generator):
    """An independent copy of the underlying generator per *thread*
    (generator.clj:171-193). Takes a zero-arg constructor so copies are
    genuinely independent."""

    def __init__(self, gen_fn: Callable[[], GenLike]):
        self.gen_fn = gen_fn
        self.per_thread: dict = {}
        self.lock = threading.Lock()

    def op(self, test, process):
        t = process_to_thread(process, test)
        with self.lock:
            g = self.per_thread.get(t)
            if g is None:
                g = gen(self.gen_fn())
                self.per_thread[t] = g
        return g.op(test, process)


class Filter(Generator):
    """Ops matching pred only; pulls until a match or exhaustion
    (generator.clj:293-303)."""

    def __init__(self, pred: Callable[[Op], bool], g: GenLike):
        self.pred = pred
        self.g = gen(g)

    def op(self, test, process):
        while True:
            out = self.g.op(test, process)
            if out is None or self.pred(out):
                return out


# ---------------------------------------------------------------------------
# Thread routing
# ---------------------------------------------------------------------------


class On(Generator):
    """Only threads matching pred draw from g (others see None); rebinds the
    thread scope to the matching subset so nested barriers see only them
    (generator.clj:305-313)."""

    def __init__(self, pred: Callable[[Any], bool], g: GenLike):
        self.pred = pred
        self.g = gen(g)

    def op(self, test, process):
        t = process_to_thread(process, test)
        if not self.pred(t):
            return None
        scope = current_threads()
        if scope is None:
            scope = all_threads(test)
        with threads_bound({x for x in scope if self.pred(x)}):
            return self.g.op(test, process)


def on_threads(pred, g) -> On:
    return On(pred, g)


def nemesis(g: GenLike, client_gen: GenLike = None) -> Generator:
    """Nemesis thread sees g; clients see client_gen (or nothing) —
    generator.clj:372-380."""
    if client_gen is None:
        return On(lambda t: t == NEMESIS, g)
    return Any_([On(lambda t: t == NEMESIS, g),
                 On(lambda t: t != NEMESIS, client_gen)])


def clients(g: GenLike, nemesis_gen: GenLike = None) -> Generator:
    """Client threads see g; nemesis sees nemesis_gen (or nothing) —
    generator.clj:382-385."""
    if nemesis_gen is None:
        return On(lambda t: t != NEMESIS, g)
    return Any_([On(lambda t: t != NEMESIS, g),
                 On(lambda t: t == NEMESIS, nemesis_gen)])


class Any_(Generator):
    """First non-None op from the given generators, in order."""

    def __init__(self, gens: Sequence[GenLike]):
        self.gens = [gen(g) for g in gens]

    def op(self, test, process):
        for g in self.gens:
            out = g.op(test, process)
            if out is not None:
                return out
        return None


class Reserve(Generator):
    """reserve(n1, g1, n2, g2, ..., default): the first n1 worker threads
    draw from g1, the next n2 from g2, ..., remaining threads (and the
    nemesis) from default. Each range gets a narrowed thread scope
    (generator.clj:315-358)."""

    def __init__(self, *args: Any):
        if len(args) % 2 == 0:
            raise ValueError("reserve requires a trailing default generator")
        *pairs, default = args
        self.counts = [int(pairs[i]) for i in range(0, len(pairs), 2)]
        self.gens = [gen(pairs[i + 1]) for i in range(0, len(pairs), 2)]
        self.default = gen(default)

    def op(self, test, process):
        t = process_to_thread(process, test)
        scope = current_threads() or all_threads(test)
        workers = sorted(x for x in scope if x != NEMESIS)
        lo = 0
        if t != NEMESIS:
            for cnt, g in zip(self.counts, self.gens):
                rng = workers[lo:lo + cnt]
                if t in rng:
                    with threads_bound(rng):
                        return g.op(test, process)
                lo += cnt
        rest = set(workers[lo:]) | ({NEMESIS} if NEMESIS in scope else set())
        with threads_bound(rest):
            return self.default.op(test, process)


def reserve(*args) -> Reserve:
    return Reserve(*args)


# ---------------------------------------------------------------------------
# Synchronization
# ---------------------------------------------------------------------------


class Await(Generator):
    """Blocks all ops until f() returns truthy once, then passes through to g
    (generator.clj:387-400)."""

    def __init__(self, f: Callable[[], Any], g: GenLike = None):
        self.f = f
        self.g = gen(g)
        self.done = threading.Event()
        self.lock = threading.Lock()

    def op(self, test, process):
        if not self.done.is_set():
            with self.lock:
                if not self.done.is_set():
                    self.f()
                    self.done.set()
            self.done.wait()
        return self.g.op(test, process)


class Synchronize(Generator):
    """Waits for every thread in scope to arrive before any draws from g
    (generator.clj:402-418). A thread 'arrives' the first time it asks for
    an op. Blocks indefinitely like the reference — a slow thread (long
    nemesis sleep, slow DB recovery) must not abort the run."""

    def __init__(self, g: GenLike):
        self.g = gen(g)
        self.cond = threading.Condition()
        self.arrived: set = set()
        self.released = False

    def op(self, test, process):
        t = process_to_thread(process, test)
        scope = current_threads() or all_threads(test)
        with self.cond:
            if not self.released:
                self.arrived.add(t)
                if self.arrived >= set(scope):
                    self.released = True
                    self.cond.notify_all()
                else:
                    while not self.released:
                        self.cond.wait(timeout=1)
        return self.g.op(test, process)


def synchronize(g: GenLike) -> Synchronize:
    return Synchronize(g)


barrier = synchronize  # generator.clj:441-444


class Phases(Generator):
    """Generators run as globally-synchronized phases: every thread must
    exhaust phase i and arrive before any thread starts phase i+1
    (generator.clj:420-424)."""

    def __init__(self, *gens: GenLike):
        self.phases = [Synchronize(g) for g in gens]
        self.cond = threading.Condition()
        self.cur = 0
        self.finished: set = set()

    def op(self, test, process):
        t = process_to_thread(process, test)
        scope = current_threads() or all_threads(test)
        while True:
            with self.cond:
                i = self.cur
            if i >= len(self.phases):
                return None
            out = self.phases[i].op(test, process)
            if out is not None:
                return out
            # this thread sees phase i exhausted; wait for all in scope
            with self.cond:
                self.finished.add((i, t))
                done = {x for (j, x) in self.finished if j == i}
                if done >= set(scope):
                    if self.cur == i:
                        self.cur = i + 1
                    self.cond.notify_all()
                else:
                    while self.cur == i:
                        self.cond.wait(timeout=1)


def phases(*gens: GenLike) -> Phases:
    return Phases(*gens)


def then_(nxt: GenLike, first: GenLike) -> Generator:
    """Reference `then` (generator.clj:426-430): designed for ->> pipelines,
    so the *continuation* comes first: then_(b, a) == a, then b."""
    return Phases(first, nxt)


# ---------------------------------------------------------------------------
# Built-in workload generators
# ---------------------------------------------------------------------------


class CasGen(Generator):
    """Random read/write/cas mix against a 5-valued register
    (generator.clj:226-239)."""

    def __init__(self, values: int = 5):
        self.values = values

    def op(self, test, process):
        f = random.choice(["read", "write", "cas"])
        if f == "read":
            v = None
        elif f == "write":
            v = random.randrange(self.values)
        else:
            v = (random.randrange(self.values), random.randrange(self.values))
        return Op(type=INVOKE, f=f, value=v)


def cas_gen(values: int = 5) -> CasGen:
    return CasGen(values)


class QueueGen(Generator):
    """Random enqueue/dequeue mix; enqueues carry sequential ids
    (generator.clj:241-252)."""

    def __init__(self):
        self.counter = 0
        self.lock = threading.Lock()

    def op(self, test, process):
        if random.random() < 0.5:
            with self.lock:
                v = self.counter
                self.counter += 1
            return Op(type=INVOKE, f="enqueue", value=v)
        return Op(type=INVOKE, f="dequeue")


def queue_gen() -> QueueGen:
    return QueueGen()


class DrainQueue(Generator):
    """Emits dequeue ops forever; used (with limit/time_limit or client-side
    empty detection) to drain a queue at test end (generator.clj:254-269)."""

    def op(self, test, process):
        return Op(type=INVOKE, f="dequeue")


def drain_queue() -> DrainQueue:
    return DrainQueue()


def start_stop(t1: float, t2: float) -> Generator:
    """Nemesis rhythm: sleep t1, start, sleep t2, stop, forever
    (generator.clj:208-215)."""

    class _StartStop(Generator):
        def __init__(self):
            self.state = 0
            self.lock = threading.Lock()

        def op(self, test, process):
            with self.lock:
                s = self.state
                self.state += 1
            if s % 2 == 0:
                _sleep(t1)
                return Op(type=INVOKE, f="start")
            _sleep(t2)
            return Op(type=INVOKE, f="stop")

    return _StartStop()


def once(g: GenLike) -> Once:
    return Once(g)


def mix(gens: Sequence[GenLike]) -> Mix:
    return Mix(gens)


def limit(n: int, g: GenLike) -> Limit:
    return Limit(n, g)


def time_limit(dt: float, g: GenLike) -> TimeLimit:
    return TimeLimit(dt, g)


def stagger(dt: float, g: GenLike) -> Stagger:
    return Stagger(dt, g)


def delay(dt: float, g: GenLike) -> Delay:
    return Delay(dt, g)


def delay_til(dt: float, g: GenLike) -> DelayTil:
    return DelayTil(dt, g)


def sleep(dt: float) -> Sleep:
    return Sleep(dt)


def each(gen_fn: Callable[[], GenLike]) -> Each:
    return Each(gen_fn)


def filter_gen(pred, g: GenLike) -> Filter:
    return Filter(pred, g)


def await_gen(f: Callable[[], Any], g: GenLike = None) -> Await:
    return Await(f, g)


def seq(gens: Iterable[GenLike]) -> SeqGen:
    return SeqGen(gens)


# ---------------------------------------------------------------------------
# Validation (generator.clj:446-457)
# ---------------------------------------------------------------------------


def op_and_validate(g: Generator, test: dict, process) -> Optional[Op]:
    """Pull an op and check the invariants core relies on
    (core.clj:157-163 / generator.clj:446-457)."""
    out = g.op(test, process)
    if out is None:
        return None
    if isinstance(out, dict):
        out = Op.from_dict({**out, "type": out.get("type", INVOKE)})
    if not isinstance(out, Op):
        raise TypeError(f"generator produced non-op {out!r}")
    if out.type not in (INVOKE, "info", "sleep"):
        raise ValueError(f"generator produced op with type {out.type!r}; "
                         "workers may only invoke")
    return out
