"""Test lifecycle orchestrator.

Rebuild of jepsen.core (jepsen/src/jepsen/core.clj). ``run(test)`` is the
entry point: set up OS and DB on every node, spawn one worker thread per
logical process plus a nemesis thread, pull operations from the generator,
apply them through clients, record everything into a history, then run the
checker over the indexed history and persist results.

A *test* is a plain dict (core.clj:382-402) with keys:

  name, nodes, concurrency, os, db, client, nemesis, generator, model,
  checker, ssh/control, store-dir, ...

Key invariants preserved from the reference:
- op completion must keep type ∈ {ok, fail, info}, same f and process
  (core.clj:157-163);
- a worker whose op is indeterminate (info or thrown) abandons its logical
  process and reincarnates as ``p + concurrency`` on the same thread with a
  fresh client (core.clj:168-217);
- nemesis ops are interleaved into every active history
  (core.clj:281-283,296-299), which is what makes independent/keyed runs
  see fault windows;
- the history list append under a single lock is the serialization point
  (core.clj:43-47).

The port's copy of ``jepsen_tpu.core``. Its spans, metrics, live progress,
search analytics and trace sink are the port's :mod:`jepsen_tpu_torch.obs`;
the checker a test names runs wherever that checker was built to run (the
suites' ``linearizable`` on the card unless asked for the CPU).
"""

from __future__ import annotations

import logging
import threading
import traceback
from typing import Any, Dict, List, Optional

from jepsen_tpu_torch import client as client_ns
from jepsen_tpu_torch import control
from jepsen_tpu_torch import db as db_ns
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checker import check_safe
from jepsen_tpu_torch.history import History, INFO, NEMESIS, Op
from jepsen_tpu_torch.obs import metrics as obs_metrics
from jepsen_tpu_torch.util import (real_pmap, relative_time_nanos, timeout,
                             with_relative_time)

log = logging.getLogger("jepsen")

_OP_TIMEOUTS = obs_metrics.counter(
    "jtpu_op_timeouts_total",
    "client ops that exceeded the op-timeout budget and became :info")
_OP_CRASHES = obs_metrics.counter(
    "jtpu_op_crashes_total",
    "client ops that crashed indeterminate (process reincarnated)")
_NEMESIS_WEDGED = obs_metrics.counter(
    "jtpu_nemesis_wedged_total",
    "nemesis threads abandoned at the run's join deadline")
_ABANDONED_THREADS = obs_metrics.gauge(
    "jtpu_abandoned_threads",
    "hung client-op threads abandoned by with_op_timeout and still "
    "leaked in the process")
_abandoned_lock = threading.Lock()
_abandoned_n = 0


def _note_abandoned_thread() -> int:
    """Count a with_op_timeout leak. The daemonized thread is never
    joined, so the count only grows — which is the point: long soak
    runs read it (``# leaked-threads:`` in analyze) to see executor
    leakage that per-op counters hide."""
    global _abandoned_n
    with _abandoned_lock:
        _abandoned_n += 1
        _ABANDONED_THREADS.set(_abandoned_n)
        return _abandoned_n


def abandoned_threads() -> int:
    """Hung op threads abandoned (not joined) so far in this process."""
    with _abandoned_lock:
        return _abandoned_n


class OpTimeout(Exception):
    """A client op exceeded the test's ``op-timeout`` budget. Raised by
    :func:`with_op_timeout` so the worker's indeterminate-op path handles
    it like any other client crash: record ``info``, reincarnate."""


_OP_TIMED_OUT = object()  # sentinel: distinguishable from any completion


def with_op_timeout(seconds: float, f, *args):
    """Bound a client operation (reference jepsen.util:275-286 ``timeout``,
    which client code wraps around invocations; here the worker applies it
    uniformly when the test sets ``op-timeout``).

    Runs ``f`` in a worker thread; if it does not return within
    ``seconds``, raises :class:`OpTimeout`. Like the reference's
    future-cancel, the hung thread is abandoned (daemon), not killed —
    the caller must treat the op as indeterminate, which is exactly what
    the worker's info/reincarnation path does: one stuck connection can
    no longer stall a whole run."""
    out = timeout(seconds * 1000.0, _OP_TIMED_OUT, f, *args)
    if out is _OP_TIMED_OUT:
        _OP_TIMEOUTS.inc()
        _note_abandoned_thread()
        raise OpTimeout(f"operation exceeded the {seconds}s op-timeout; "
                        f"treating it as indeterminate")
    return out


def synchronize(test: dict) -> None:
    """Block this thread until all nodes' setup threads reach this point
    (core.clj:36-41; the CyclicBarrier in :barrier)."""
    b = test.get("barrier")
    if b is not None:
        b.wait()


def primary(test: dict):
    """The conventional primary node: the first one (core.clj:49-52)."""
    nodes = test.get("nodes") or []
    return nodes[0] if nodes else None


def conj_op(test: dict, op: Op, stamp: bool = False) -> Op:
    """Append an op to every active history under the lock — THE
    serialization point (core.clj:43-47). The same lock orders the tee
    into the write-ahead journal, so the WAL's record order IS the
    append order: a run killed at any instant recovers to a prefix of
    what the clean run appended. ``stamp`` sets the op's time under the
    lock (an invocation's: the op starts after it is recorded)."""
    with test["_history_lock"]:
        if stamp:
            op.time = relative_time_nanos()
        for h in test["_active_histories"]:
            h.append(op)
        j = test.get("_journal")
        if j is not None:
            j.append(op)  # never raises; a failed journal disables itself
    return op


def _fill_op(test: dict, op: Op, process) -> Op:
    """A fresh copy of a generated op for ``process``; ``conj_op(...,
    stamp=True)`` gives it its time."""
    return op.replace(process=process)


def _time_order(history: History) -> None:
    """Order a recorded history by its op times, in place (stable: equal
    times keep their append order).

    An invocation is stamped when it is appended, before its client call
    starts, and a completion as its client call returns, before it waits
    to be appended: each op took effect inside its [invoke, completion]
    times, so the time order is a sound history of the run. The append
    order is sound too, but looser: in one interpreter a completion can
    wait for the interpreter lock while the other workers append hundreds
    of ops, so an op that took microseconds looks concurrent with all of
    them, past the window the device search holds
    (``tools/torch_runner_windows.py`` counts both)."""
    history.sort(key=lambda o: o.time)


class Worker:
    """One logical-process worker (core.clj:219-265). The node is pinned to
    the *thread* at spawn (core.clj:349-355) — reincarnated processes stay
    on the same node."""

    def __init__(self, test: dict, barrier: threading.Barrier,
                 thread_id: int):
        self.test = test
        self.barrier = barrier
        self.thread = thread_id
        self.process = thread_id
        nodes = test.get("nodes") or [None]
        self._node = nodes[thread_id % len(nodes)]
        self.error: Optional[BaseException] = None

    def node(self):
        return self._node

    def run(self):
        test = self.test
        try:
            with gen.threads_bound(gen.all_threads(test)):
                client = test["client"].open(test, self.node())
                try:
                    self.barrier.wait()  # all clients ready (core.clj:231)
                    g = test["generator"]
                    while True:
                        op = gen.op_and_validate(g, test, self.process)
                        if op is None:
                            break
                        op = _fill_op(test, op, self.process)
                        conj_op(test, op, stamp=True)
                        client = self._invoke_and_complete(client, op)
                finally:
                    try:
                        client.close(test)
                    except Exception:  # noqa: BLE001
                        pass
                    # wait for everyone before teardown (core.clj:259)
                    try:
                        self.barrier.wait()
                    except threading.BrokenBarrierError:
                        pass
        except Exception as e:  # noqa: BLE001 (core.clj:255-256)
            self.error = e
            self.barrier.abort()
            log.error("Worker %s crashed: %s", self.thread,
                      traceback.format_exc())

    def _invoke_and_complete(self, client, op: Op):
        """Apply op via the client; handle ok/fail/info/throw
        (core.clj:143-217). Returns the client to use next (a fresh one if
        the process crashed)."""
        test = self.test
        op_timeout = test.get("op-timeout")
        try:
            with obs.span("client.invoke", f=op.f, process=op.process):
                if op_timeout:
                    completion = with_op_timeout(op_timeout,
                                                 client.invoke, test, op)
                else:
                    completion = client.invoke(test, op)
                # stamped as the client returns, before the span's record
                # is written and the completion waits to be appended
                done = relative_time_nanos()
            if (completion is None
                    or completion.type not in ("ok", "fail", "info")
                    or completion.f != op.f
                    or completion.process != op.process):
                raise RuntimeError(
                    f"invalid completion {completion!r} for op {op!r}")
            completion = completion.replace(time=done)
            conj_op(test, completion)
            if completion.type in ("ok", "fail"):
                return client  # determinate: process continues
            crashed_err = None
        except Exception as e:  # noqa: BLE001
            # indeterminate: we don't know if the op took place
            crashed_err = e
            _OP_CRASHES.inc(f=str(op.f))
            info = op.replace(type=INFO, time=relative_time_nanos(),
                              error=f"{type(e).__name__}: {e}")
            conj_op(test, info)
            log.warning("Process %s crashed in %s: %s", self.process,
                        op.f, e)
        # info path: abandon this process, reincarnate as p + concurrency
        # with a fresh client (core.clj:174-217). A hung connection's
        # close can hang too — bound it like the op itself.
        try:
            if op_timeout:
                with_op_timeout(op_timeout, client.close, test)
            else:
                client.close(test)
        except Exception:  # noqa: BLE001
            pass
        self.process += test["concurrency"]
        return test["client"].open(test, self.node())


class _BoundedWorker(Worker):
    """A logical process as a schedulable state machine instead of a
    dedicated OS thread — the bounded-executor driver mode
    (``test["driver-threads"]``) that lets one host sustain thousands of
    logical processes feeding a stream (doc/serve.md "Streaming API").
    Same invariants as :class:`Worker`: pinned node, ok/fail continue,
    info/throw reincarnates as ``p + concurrency`` on a fresh client."""

    def __init__(self, test: dict, thread_id: int):
        super().__init__(test, barrier=None, thread_id=thread_id)
        self.client = None
        self.done = False

    def open(self) -> None:
        self.client = self.test["client"].open(self.test, self.node())

    def step(self) -> bool:
        """Pull one op from the generator and drive it to completion.
        False when the generator is exhausted for this process."""
        op = gen.op_and_validate(self.test["generator"], self.test,
                                 self.process)
        if op is None:
            return False
        op = _fill_op(self.test, op, self.process)
        conj_op(self.test, op, stamp=True)
        self.client = self._invoke_and_complete(self.client, op)
        return True

    def close(self) -> None:
        try:
            if self.client is not None:
                self.client.close(self.test)
        except Exception:  # noqa: BLE001
            pass


def _run_bounded(test: dict, n: int, k: int) -> None:
    """Drive ``n`` logical processes on ``k`` pool threads: round-robin
    scheduling through a work queue, so every process makes progress and
    no process's ops reorder (a logical process is only ever on one pool
    thread at a time — the queue hands it out and takes it back). The
    first worker error stops scheduling, closes every client, and
    re-raises — matching the threaded mode's crash propagation."""
    import queue as queue_mod
    workers = [_BoundedWorker(test, i) for i in range(n)]
    for w in workers:
        w.open()
    work: queue_mod.Queue = queue_mod.Queue()
    for w in workers:
        work.put(w)
    stop = threading.Event()
    errors: List[BaseException] = []
    err_lock = threading.Lock()

    def pool_loop() -> None:
        with gen.threads_bound(gen.all_threads(test)):
            while not stop.is_set():
                try:
                    w = work.get_nowait()
                except queue_mod.Empty:
                    return
                try:
                    alive = w.step()
                except Exception as e:  # noqa: BLE001
                    with err_lock:
                        errors.append(e)
                    stop.set()
                    log.error("Bounded worker %s crashed: %s", w.thread,
                              traceback.format_exc())
                    return
                if alive:
                    work.put(w)
                else:
                    w.done = True

    threads = [threading.Thread(target=pool_loop, daemon=True,
                                name=f"jepsen-driver-{i}")
               for i in range(k)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for w in workers:
        w.close()
    if errors:
        raise errors[0]


def _probe_heal(test: dict, nemesis, op: Op) -> None:
    """Post-fault convergence probe: after a heal-class nemesis op
    completes, run the nemesis's ``heal_probe`` (if configured) and
    record the outcome as a ``heal-verified`` / ``heal-failed`` info op
    — so checkers and humans can see fault windows that never really
    closed, instead of trusting that 'heal returned' means 'healed'."""
    verify = getattr(nemesis, "verify_heal", None)
    if verify is None:
        return
    try:
        with obs.span("nemesis.heal_probe", f=op.f):
            res = verify(test, op)
    except Exception as e:  # noqa: BLE001 — a broken probe is a finding
        res = {"verified": False, "error": f"{type(e).__name__}: {e}"}
    if res is None:
        return
    verified = bool(res.get("verified"))
    if not verified:
        log.warning("post-heal convergence probe FAILED after %s: %r",
                    op.f, res)
    conj_op(test, Op(
        type=INFO, f="heal-verified" if verified else "heal-failed",
        value=res, process=NEMESIS, time=relative_time_nanos(),
        error=None if verified else res.get("error",
                                            "cluster did not converge")))


def _nemesis_worker(test: dict, stop: threading.Event):
    """The privileged nemesis process (core.clj:267-309)."""
    nemesis = test.get("nemesis")
    g = test["generator"]
    with gen.threads_bound(gen.all_threads(test)):
        while not stop.is_set():
            try:
                op = gen.op_and_validate(g, test, NEMESIS)
            except Exception:  # noqa: BLE001
                log.error("Nemesis generator crashed: %s",
                          traceback.format_exc())
                break
            if op is None:
                break
            # nemesis ops are recorded as :info both ways (core.clj:292) —
            # they never pair as invoke/ok, so checkers and the packed
            # encoder skip them structurally
            op = _fill_op(test, op, NEMESIS).replace(type=INFO)
            conj_op(test, op, stamp=True)
            try:
                with obs.span("nemesis.invoke", f=op.f):
                    completion = (nemesis.invoke(test, op) if nemesis
                                  else op)
                completion = completion.replace(
                    type=INFO, process=NEMESIS, time=relative_time_nanos())
                conj_op(test, completion)
                if nemesis is not None:
                    # fault-active gauge: the nemesis layer decides what
                    # counts as a heal (heal_fs routing lives there)
                    note = getattr(nemesis, "note_fault_op", None)
                    if note is not None:
                        note(completion)
                    _probe_heal(test, nemesis, completion)
            except Exception as e:  # noqa: BLE001 (core.clj:301-306)
                conj_op(test, op.replace(
                    type=INFO, time=relative_time_nanos(),
                    error=f"{type(e).__name__}: {e}"))
                log.warning("Nemesis crashed invoking %s: %s", op.f, e)


def run_case(test: dict) -> History:
    """Run the workload phase: nemesis + workers over the generator;
    returns the raw history (core.clj:331-365)."""
    with obs.span("core.run_case", name=str(test.get("name"))):
        return _run_case(test)


def _run_case(test: dict) -> History:
    history = History()
    test.setdefault("_history_lock", threading.Lock())
    test.setdefault("_active_histories", [])
    with test["_history_lock"]:
        test["_active_histories"].append(history)

    nemesis_obj = test.get("nemesis")
    if nemesis_obj is not None:
        with obs.span("nemesis.setup"):
            nemesis_obj.setup(test)
    stop = threading.Event()
    nemesis_thread = threading.Thread(
        target=_nemesis_worker, args=(test, stop), daemon=True,
        name="jepsen-nemesis")
    nemesis_thread.start()

    try:
        with obs.span("core.workload",
                      concurrency=test["concurrency"]):
            n = test["concurrency"]
            k = int(test.get("driver-threads") or 0)
            if 0 < k < n:
                _run_bounded(test, n, k)
            else:
                barrier = threading.Barrier(n)
                workers = [Worker(test, barrier, i) for i in range(n)]
                threads = [threading.Thread(target=w.run, daemon=True,
                                            name=f"jepsen-worker-{i}")
                           for i, w in enumerate(workers)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                for w in workers:
                    if w.error is not None:
                        raise w.error
    finally:
        # This block is the run's safety net: it executes whether the
        # main phase finished cleanly or a worker raised above, so
        # nemesis teardown AND network healing always run — a crashed
        # worker must not leave the cluster partitioned.
        with obs.span("core.teardown"):
            stop.set()
            join_s = test.get("nemesis-join-timeout", 30)
            nemesis_thread.join(timeout=join_s)
            if nemesis_thread.is_alive():
                # The nemesis missed its join deadline: it is wedged
                # inside an invocation. Abandon the (daemon) thread but
                # make the leak VISIBLE — loudly in the log and as an
                # info op in the history, so checkers and humans can
                # see the fault window never formally closed.
                log.error(
                    "Nemesis thread missed its %ss join deadline; "
                    "recording :nemesis-wedged and abandoning the "
                    "thread", join_s)
                _NEMESIS_WEDGED.inc()
                conj_op(test, Op(
                    type=INFO, f="nemesis-wedged", value=None,
                    process=NEMESIS, time=relative_time_nanos(),
                    error=f"nemesis thread still running after "
                          f"the {join_s}s join timeout"))
            if nemesis_obj is not None:
                try:
                    nemesis_obj.teardown(test)
                except Exception:  # noqa: BLE001
                    log.warning("Nemesis teardown failed: %s",
                                traceback.format_exc())
            net = test.get("net")
            if net is not None:
                try:
                    net.heal(test)
                except Exception:  # noqa: BLE001
                    log.warning("net.heal failed during teardown: %s",
                                traceback.format_exc())
            # Under the lock: a wedged nemesis thread abandoned above
            # may still be appending through conj_op — an unlocked
            # remove races with its iteration over the
            # active-history list.
            with test["_history_lock"]:
                test["_active_histories"].remove(history)
    _time_order(history)
    return history


def with_os(test: dict):
    """Context: OS setup before, teardown after (core.clj:77-84)."""
    class _Ctx:
        def __enter__(self_):
            os_ = test.get("os")
            if os_ is not None:
                control.on_nodes(test, os_.setup)
            return self_

        def __exit__(self_, *exc):
            os_ = test.get("os")
            if os_ is not None and not test.get("leave-db-running"):
                control.on_nodes(test, os_.teardown)
            return False
    return _Ctx()


def with_db(test: dict):
    """Context: DB cycled (teardown+setup) before, torn down after; primary
    setup on the first node (core.clj:127-141, 86-92). On entry failure,
    logs are snarfed (core.clj:135-139)."""
    class _Ctx:
        def __enter__(self_):
            db = test.get("db")
            if db is not None:
                try:
                    control.on_nodes(test, lambda t, n: db_ns.cycle(db, t, n))
                    if isinstance(db, db_ns.Primary):
                        db.setup_primary(test, primary(test))
                except Exception:
                    snarf_logs(test)
                    raise
            return self_

        def __exit__(self_, *exc):
            db = test.get("db")
            if db is not None:
                snarf_logs(test)
                if not test.get("leave-db-running"):
                    control.on_nodes(test, db.teardown)
            return False
    return _Ctx()


def snarf_logs(test: dict) -> None:
    """Download DB log files from every node into the store directory
    (core.clj:94-125). No-op without a store dir or LogFiles impl."""
    db = test.get("db")
    store_dir = test.get("store-dir")
    if not (store_dir and isinstance(db, db_ns.LogFiles)):
        return
    import os as _os

    def snarf(t, node):
        files = db.log_files(t, node) or []
        dest_dir = _os.path.join(store_dir, str(node))
        _os.makedirs(dest_dir, exist_ok=True)
        for f in files:
            try:
                control.download(test, node, f,
                                 _os.path.join(dest_dir,
                                               _os.path.basename(f)))
            except Exception:  # noqa: BLE001
                log.warning("couldn't snarf %s from %s", f, node)

    try:
        control.on_nodes(test, snarf)
    except Exception:  # noqa: BLE001
        log.warning("log snarfing failed: %s", traceback.format_exc())


def prepare_test(test: dict) -> dict:
    """Fill in defaults (tests.clj noop-test / core.clj:435-450)."""
    t = dict(test)
    t.setdefault("name", "noop")
    t.setdefault("nodes", ["n1", "n2", "n3", "n4", "n5"])
    t.setdefault("concurrency", len(t["nodes"]))
    t.setdefault("client", client_ns.noop())
    t.setdefault("generator", gen.Void())
    if not isinstance(t["generator"], gen.Generator):
        t["generator"] = gen.gen(t["generator"])
    t["_history_lock"] = threading.Lock()
    t["_active_histories"] = []
    t["barrier"] = (threading.Barrier(len(t["nodes"]))
                    if t["nodes"] else None)
    return t


def run(test: dict) -> dict:
    """Run a complete test; returns the test dict augmented with :history
    and :results (core.clj:381-491)."""
    import time as _time
    test = prepare_test(test)
    test["start-time"] = _time.time()

    store = None
    if test.get("store-dir", "__auto__") is not None:
        try:
            from jepsen_tpu_torch import store as store_ns
            store = store_ns
            store_ns.prepare_dir(test)
            store_ns.start_logging(test)
            # Crash safety: mark the run live, and tee every recorded op
            # into the write-ahead journal so a run killed at any
            # instant loses at most one unsynced op and stays checkable
            # via the `recover` subcommand (doc/resilience.md).
            store_ns.write_state(test, "running")
            from jepsen_tpu_torch import journal as journal_ns
            test["_journal"] = journal_ns.open_journal(test["store-dir"])
            # Telemetry rides alongside the WAL: spans stream to
            # trace.jsonl as they close, so a killed run's timeline is
            # recoverable too; live search progress goes to
            # progress.json and the per-level search analytics to
            # searchstats.json in the same directory.
            obs.start_run(test["store-dir"])
        except ImportError:
            store = None

    try:
        with obs.span("core.run", name=str(test.get("name"))):
            with control.session_pool(test):
                client = test["client"]
                with with_os(test), with_db(test):
                    with with_relative_time():
                        with obs.span("client.setup"):
                            client.setup(test)
                        try:
                            history = run_case(test)
                        finally:
                            with obs.span("client.teardown"):
                                client.teardown(test)
                history.index()
                test["history"] = history
                if store:
                    with obs.span("store.save"):
                        store.save_1(test)
                    store.write_state(test, "analyzing")
                checker = test.get("checker")
                if checker is not None:
                    with obs.span("checker.check",
                                  ops=len(history)):
                        test["results"] = check_safe(checker, test,
                                                     history)
                else:
                    test["results"] = {"valid": True}
                if store:
                    store.save_2(test)
                    store.write_state(test, "done")
                    store.stop_logging(test)
    finally:
        # The WAL survives on disk either way; close() just fsyncs the
        # tail. On a crash path run.state stays 'running', which is
        # exactly what makes the run discoverable by `recover`.
        journal = test.pop("_journal", None)
        if journal is not None:
            journal.close()
        # metrics.json after the run span closed (so the snapshot sees
        # it), then every sink detaches. Both are gated on the JTPU_TRACE
        # switch: with it off, neither artifact exists.
        try:
            obs.finish_run()
        except OSError as e:
            log.warning("couldn't write metrics.json: %s", e)
    log.info("Test %s: valid=%s", test.get("name"),
             test["results"].get("valid"))
    return test
