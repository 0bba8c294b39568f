"""The port's fold checkers and HTML timeline against the JAX package's,
on the CPU.

Each checker of ``jepsen_tpu_torch.checker.basic`` (set, counter, queue
over an unordered and a FIFO queue model, total-queue, unique-ids) and
the drain expansion give a result dict equal to the reference's on the
same history: the reference test's fixtures, and histories of several
processes drawn from a numpy seed (crashed and failed ops, drains whose
value is a collection, duplicated and never-attempted elements, ids that
are not numbers). ``timeline.html`` is byte for byte the reference's,
with fault bands, a history key and a subdirectory; ``process_index``,
``pairs`` and ``fault_windows`` agree too.
"""

import numpy as np
import pytest
import torch

from jepsen_tpu.checker import basic as jb
from jepsen_tpu.checker import timeline as jt
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.models import FIFOQueue as JFIFOQueue
from jepsen_tpu.models import UnorderedQueue as JUnorderedQueue

from jepsen_tpu_torch import checker as pc
from jepsen_tpu_torch.checker import basic as pb
from jepsen_tpu_torch.checker import timeline as pt
from jepsen_tpu_torch.history import NEMESIS, History, Op
from jepsen_tpu_torch.models import FIFOQueue, UnorderedQueue

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

#: name -> (the port's checker, the reference's), fresh each call
CHECKERS = {
    "set": (pb.set_checker, jb.set_checker),
    "counter": (pb.counter, jb.counter),
    "queue-unordered": (lambda: pb.queue(UnorderedQueue()),
                        lambda: jb.queue(JUnorderedQueue())),
    "queue-fifo": (lambda: pb.queue(FIFOQueue()),
                   lambda: jb.queue(JFIFOQueue())),
    "total-queue": (pb.total_queue, jb.total_queue),
    "unique-ids": (pb.unique_ids, jb.unique_ids),
}


def both(rows):
    """The same rows ``(process, type, f, value[, error])`` as a history
    of each package."""
    ours, theirs = History(), JHistory()
    for i, row in enumerate(rows):
        p, t, f, v = row[:4]
        err = row[4] if len(row) > 4 else None
        ours.append(Op(type=t, f=f, value=v, process=p, time=i * 1_000_000,
                       index=i, error=err))
        theirs.append(JOp(type=t, f=f, value=v, process=p,
                          time=i * 1_000_000, index=i, error=err))
    return ours, theirs


def same(name, rows):
    ours, theirs = both(rows)
    mine, ref = CHECKERS[name]
    a = mine().check({}, ours)
    b = ref().check({}, theirs)
    assert a == b, (name, a, b)
    return a


# -- the reference test's fixtures ------------------------------------------

FIXTURES = [
    ("set", [(0, "invoke", "add", 0), (0, "ok", "add", 0),
             (1, "invoke", "add", 1), (1, "ok", "add", 1),
             (2, "invoke", "read", None), (2, "ok", "read", [0, 1])], True),
    ("set", [(0, "invoke", "add", 0), (0, "ok", "add", 0),
             (2, "invoke", "read", None), (2, "ok", "read", [])], False),
    ("set", [(0, "invoke", "add", 0), (0, "info", "add", 0),
             (2, "invoke", "read", None), (2, "ok", "read", [0])], True),
    ("set", [(2, "invoke", "read", None), (2, "ok", "read", [99])], False),
    ("set", [(0, "invoke", "add", 0), (0, "ok", "add", 0)], "unknown"),
    ("queue-unordered", [], True),
    ("queue-unordered", [(0, "invoke", "dequeue", None),
                         (0, "ok", "dequeue", 1)], False),
    ("queue-unordered", [(0, "invoke", "enqueue", 1), (0, "ok", "enqueue", 1),
                         (1, "invoke", "dequeue", None),
                         (1, "ok", "dequeue", 1)], True),
    ("queue-unordered", [(0, "invoke", "enqueue", 1),
                         (0, "info", "enqueue", 1),
                         (1, "invoke", "dequeue", None),
                         (1, "ok", "dequeue", 1)], True),
    ("queue-unordered", [(0, "invoke", "enqueue", 1), (0, "ok", "enqueue", 1),
                         (1, "invoke", "drain", None),
                         (1, "ok", "drain", [1])], True),
    ("queue-unordered", [(1, "invoke", "drain", None),
                         (1, "ok", "drain", [9])], False),
    ("total-queue", [(0, "invoke", "enqueue", 1), (0, "ok", "enqueue", 1)],
     False),
    ("total-queue", [(0, "invoke", "dequeue", None),
                     (0, "ok", "dequeue", 7)], False),
    ("total-queue", [(0, "invoke", "enqueue", 1), (0, "ok", "enqueue", 1),
                     (1, "invoke", "dequeue", None), (1, "ok", "dequeue", 1),
                     (2, "invoke", "dequeue", None), (2, "ok", "dequeue", 1)],
     False),
    ("total-queue", [(0, "invoke", "enqueue", 1), (0, "info", "enqueue", 1),
                     (1, "invoke", "dequeue", None),
                     (1, "ok", "dequeue", 1)], True),
    ("total-queue", [(0, "invoke", "enqueue", 1), (0, "ok", "enqueue", 1),
                     (1, "invoke", "dequeue", None),
                     (1, "ok", "dequeue", 1)], True),
    ("total-queue", [(0, "invoke", "enqueue", "a"), (0, "ok", "enqueue", "a"),
                     (0, "invoke", "enqueue", "b"), (0, "ok", "enqueue", "b"),
                     (1, "invoke", "drain", None),
                     (1, "ok", "drain", ["a", "b"])], True),
    ("total-queue", [(0, "invoke", "enqueue", "a"), (0, "ok", "enqueue", "a"),
                     (1, "invoke", "drain", None), (1, "ok", "drain", [])],
     False),
    ("counter", [(0, "invoke", "add", 1), (0, "ok", "add", 1),
                 (1, "invoke", "read", None), (1, "ok", "read", 1)], True),
    ("counter", [(0, "invoke", "add", 1), (0, "ok", "add", 1),
                 (1, "invoke", "read", None), (1, "ok", "read", 5)], False),
    ("counter", [(0, "invoke", "add", 2), (1, "invoke", "read", None),
                 (1, "ok", "read", 2), (0, "ok", "add", 2),
                 (2, "invoke", "read", None), (2, "ok", "read", 2)], True),
    ("counter", [(0, "invoke", "add", 10), (0, "info", "add", 10),
                 (1, "invoke", "read", None), (1, "ok", "read", 10),
                 (2, "invoke", "read", None), (2, "ok", "read", 0)], True),
    ("counter", [(0, "invoke", "add", 5), (0, "fail", "add", 5),
                 (1, "invoke", "read", None), (1, "ok", "read", 5)], False),
    ("counter", [(0, "invoke", "add", -3), (0, "ok", "add", -3),
                 (1, "invoke", "read", None), (1, "ok", "read", -3)], True),
    ("unique-ids", [(0, "invoke", "generate", None),
                    (0, "ok", "generate", 1),
                    (1, "invoke", "generate", None),
                    (1, "ok", "generate", 2)], True),
    ("unique-ids", [(0, "invoke", "generate", None),
                    (0, "ok", "generate", 1),
                    (1, "invoke", "generate", None),
                    (1, "ok", "generate", 1)], False),
    ("unique-ids", [], True),
]


@pytest.mark.parametrize("name,rows,valid", FIXTURES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(FIXTURES)])
def test_reference_fixtures(name, rows, valid):
    assert same(name, rows)["valid"] == valid


# -- seeded histories of several processes ----------------------------------

def interleave(rng, n_procs, n_ops, invoke, complete):
    """Rows of ``n_procs`` processes, each with at most one op open: at
    each step a random process invokes (``invoke(rng, p)`` -> (f, value))
    or completes its open op (``complete(rng, p, f, value)`` -> (type,
    value)); ops still open at the end stay open."""
    rows, open_ = [], {}
    for _ in range(n_ops):
        p = int(rng.integers(n_procs))
        if p in open_:
            f, v = open_.pop(p)
            t, cv = complete(rng, p, f, v)
            rows.append((p, t, f, cv))
        else:
            f, v = invoke(rng, p)
            open_[p] = (f, v)
            rows.append((p, "invoke", f, v))
    return rows


def _type(rng, crash_p=0.1, fail_p=0.1):
    x = rng.random()
    return "info" if x < crash_p else "fail" if x < crash_p + fail_p \
        else "ok"


def set_rows(rng):
    n_vals = int(rng.integers(1, 40))

    def invoke(rng, p):
        return "add", int(rng.integers(n_vals))

    def complete(rng, p, f, v):
        return _type(rng), v
    rows = interleave(rng, 4, int(rng.integers(10, 80)), invoke, complete)
    if rng.random() < 0.9:
        # the final read: the ok adds and some crashed ones, then maybe a
        # lost element or one never attempted
        seen = {v for _, t, _, v in rows if t == "ok"}
        seen |= {v for _, t, _, v in rows if t == "info"
                 and rng.random() < 0.5}
        x = rng.random()
        if x < 0.25 and seen:
            seen.discard(sorted(seen)[int(rng.integers(len(seen)))])
        elif x < 0.4:
            seen.add(100 + int(rng.integers(5)))
        seen = sorted(seen)
        if rng.random() < 0.3:
            seen = [f"s{v}" for v in seen]     # not numbers
        rows += [(9, "invoke", "read", None), (9, "ok", "read", seen)]
    return rows


def counter_rows(rng):
    def invoke(rng, p):
        if rng.random() < 0.4:
            return "read", None
        return "add", int(rng.integers(-4, 6))

    def complete(rng, p, f, v):
        if f == "read":
            if rng.random() < 0.1:
                return "fail", None
            return "ok", int(rng.integers(-6, 14))
        return _type(rng), v
    return interleave(rng, 5, int(rng.integers(10, 120)), invoke, complete)


def queue_rows(rng):
    """A queue shared by the processes: an enqueue lands at its completion
    (an ok one always, a crashed one half the time), a dequeue takes the
    head, a drain everything; a final drain empties it. With probability
    ``bad`` a dequeue returns a value of its own instead."""
    n_vals = int(rng.integers(1, 12))
    bad = 0.0 if rng.random() < 0.5 else 0.1
    q = []

    def invoke(rng, p):
        x = rng.random()
        if x < 0.5:
            return "enqueue", int(rng.integers(n_vals))
        return ("drain" if x < 0.6 else "dequeue"), None

    def complete(rng, p, f, v):
        t = _type(rng)
        if f == "enqueue":
            if t == "ok" or (t == "info" and rng.random() < 0.5):
                q.append(v)
            return t, v
        if t != "ok":
            return t, None
        if f == "drain":
            out = list(q)
            q.clear()
            return t, out
        if rng.random() < bad or not q:
            return t, int(rng.integers(n_vals + 2))
        return t, q.pop(0)
    rows = interleave(rng, 4, int(rng.integers(4, 60)), invoke, complete)
    return rows + [(9, "invoke", "drain", None), (9, "ok", "drain", list(q))]


def ids_rows(rng):
    strings = rng.random() < 0.25

    def invoke(rng, p):
        return "generate", None

    def complete(rng, p, f, v):
        x = int(rng.integers(30))
        return _type(rng), (f"id{x}" if strings else x)
    return interleave(rng, 5, int(rng.integers(2, 80)), invoke, complete)


ROWS = {"set": set_rows, "counter": counter_rows,
        "queue-unordered": queue_rows, "queue-fifo": queue_rows,
        "total-queue": queue_rows, "unique-ids": ids_rows}


@pytest.mark.parametrize("name", sorted(ROWS))
@pytest.mark.parametrize("seed", range(6))
def test_seeded_histories(name, seed):
    verdicts = set()
    for k in range(20):
        rng = np.random.default_rng(1000 * seed + k)
        verdicts.add(str(same(name, ROWS[name](rng))["valid"]))
    assert verdicts   # every history compared


def test_seeded_histories_reach_both_verdicts():
    for name, make in ROWS.items():
        verdicts = {str(same(name, make(np.random.default_rng(s)))["valid"])
                    for s in range(60)}
        assert {"True", "False"} <= verdicts, (name, verdicts)


@pytest.mark.parametrize("seed", range(4))
def test_drain_expansion(seed):
    ours, theirs = both(queue_rows(np.random.default_rng(seed)))
    a = pb.expand_queue_drain_ops(ours)
    b = jb.expand_queue_drain_ops(theirs)
    assert [o.to_dict() for o in a] == [o.to_dict() for o in b]
    assert not any(o.f == "drain" for o in a)


def test_the_package_exports_the_basic_checkers():
    for name in ("set_checker", "counter", "queue", "total_queue",
                 "unique_ids", "SetChecker", "Counter", "QueueChecker",
                 "TotalQueue", "UniqueIds"):
        assert getattr(pc, name) is getattr(pb, name)


# -- the timeline -------------------------------------------------------------

def nemesis_rows(with_heal=True, probe=False):
    rows = [(0, "invoke", "read", None), (0, "ok", "read", 1),
            (NEMESIS, "info", "start", None),
            (NEMESIS, "info", "start", "cut"),
            (1, "invoke", "write", 2), (1, "fail", "write", 2, "timeout")]
    if probe:
        rows.append((NEMESIS, "info", "heal-verified", {}))
    if with_heal:
        rows += [(NEMESIS, "info", "stop", None),
                 (NEMESIS, "info", "stop", "healed"),
                 (0, "invoke", "read", None), (0, "ok", "read", 2)]
    return rows


def timeline_rows(rng):
    """A register history of 4 clients with a nemesis cycling start/stop,
    ops left open at the end."""
    def invoke(rng, p):
        f = ["read", "write", "cas"][int(rng.integers(3))]
        v = (None if f == "read" else int(rng.integers(5)) if f == "write"
             else (int(rng.integers(5)), int(rng.integers(5))))
        return f, v

    def complete(rng, p, f, v):
        t = _type(rng)
        return t, (int(rng.integers(5)) if f == "read" and t == "ok" else v)
    rows = interleave(rng, 4, int(rng.integers(5, 60)), invoke, complete)
    out = []
    for i, row in enumerate(rows):
        out.append(row)
        if i % 9 == 4:
            f = "start" if (i // 9) % 2 == 0 else "stop"
            out += [(NEMESIS, "info", f, None),
                    (NEMESIS, "info", f, "done" if f == "stop" else "cut")]
    return out


def same_page(tmp_path, rows, name="tl", opts=None):
    ours, theirs = both(rows)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ra = pt.html().check({"store-dir": str(tmp_path / "a"), "name": name},
                         ours, opts)
    rb = jt.html().check({"store-dir": str(tmp_path / "b"), "name": name},
                         theirs, opts)
    assert ra == rb == {"valid": True}
    sub = [str(s) for s in (opts or {}).get("subdirectory") or []]
    page = (tmp_path / "a").joinpath(*sub, "timeline.html").read_bytes()
    assert page == (tmp_path / "b").joinpath(*sub,
                                             "timeline.html").read_bytes()
    assert pt.process_index(ours) == jt.process_index(theirs)
    assert pt.fault_windows(ours) == jt.fault_windows(theirs)
    pa = [(si, inv.to_dict(), ei, None if c is None else c.to_dict())
          for si, inv, ei, c in pt.pairs(ours)]
    pb_ = [(si, inv.to_dict(), ei, None if c is None else c.to_dict())
           for si, inv, ei, c in jt.pairs(theirs)]
    assert pa == pb_
    return page.decode()


@pytest.mark.parametrize("with_heal,probe", [(True, False), (False, False),
                                             (True, True)])
def test_timeline_of_the_reference_fixtures(tmp_path, with_heal, probe):
    page = same_page(tmp_path, nemesis_rows(with_heal, probe))
    assert page.count('class="fault"') == 1


@pytest.mark.parametrize("seed", range(5))
def test_timeline_of_seeded_histories(tmp_path, seed):
    opts = ({"history-key": seed, "subdirectory": ["independent", seed]}
            if seed % 2 else None)
    page = same_page(tmp_path, timeline_rows(np.random.default_rng(seed)),
                     name=f"reg <{seed}>", opts=opts)
    assert "op " in page


def test_timeline_without_a_store_dir_skips():
    assert pt.html().check({}, History()) == jt.html().check({}, JHistory())
