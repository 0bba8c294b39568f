"""History simulators for tests and the chip smoke run.

Counterparts of ``simulate_register_history``, ``corrupt_one_read`` and
``wide_history`` in ``jepsen_tpu.testing``: each draws from a
``random.Random`` built from the ``seed`` it is given, so the same seed
yields the same history as the JAX package's copy. ``crash_writes`` is
the port's own.
"""

from __future__ import annotations

import random

from jepsen_tpu_torch.history import History, Op


def simulate_register_history(n_ops: int, n_procs: int = 5, n_vals: int = 8,
                              seed: int = 0, cas_p: float = 0.2,
                              crash_p: float = 0.0,
                              overlap_p: float = 0.6) -> History:
    """A concurrent CAS-register history, linearizable by construction:
    each op takes effect at a random commit instant between its
    invocation and completion. ``crash_p`` turns completions into 'info'
    (the crashed process is replaced by ``p + n_procs``); a low
    ``overlap_p`` gives mostly sequential, staggered histories."""
    rng = random.Random(seed)
    h = History()
    value = None
    free = list(range(n_procs))
    in_flight = []  # [process, op, committed?]
    invoked = 0
    t = 0
    while invoked < n_ops or in_flight:
        can_invoke = free and invoked < n_ops
        if can_invoke and (not in_flight or rng.random() < overlap_p):
            p = free.pop(rng.randrange(len(free)))
            r = rng.random()
            if r < cas_p:
                f, v = "cas", (rng.randrange(n_vals), rng.randrange(n_vals))
            elif r < cas_p + (1 - cas_p) / 2:
                f, v = "write", rng.randrange(n_vals)
            else:
                f, v = "read", None
            h.append(Op(type="invoke", f=f, value=v, process=p, time=t))
            in_flight.append([p, h[-1], False])
            invoked += 1
        else:
            entry = rng.choice(in_flight)
            p, inv_op, committed = entry
            if not committed:
                if inv_op.f == "write":
                    value = inv_op.value
                    entry[2] = ("ok", inv_op.value)
                elif inv_op.f == "cas":
                    old, new = inv_op.value
                    if value == old:
                        value = new
                        entry[2] = ("ok", inv_op.value)
                    else:
                        entry[2] = ("fail", inv_op.value)
                else:
                    entry[2] = ("ok", value)
                # complete immediately half the time, else stay in flight
                if rng.random() >= 0.5:
                    continue
            typ, val = entry[2]
            in_flight.remove(entry)
            if crash_p and rng.random() < crash_p:
                h.append(Op(type="info", f=inv_op.f, value=inv_op.value,
                            process=p, time=t))
                free.append(p + n_procs)
            else:
                h.append(Op(type=typ, f=inv_op.f, value=val, process=p,
                            time=t))
                free.append(p)
        t += 1
    return h


def corrupt_one_read(history, rng: random.Random, bogus=99) -> History:
    """Flip one random ok-read completion to a bogus value; identity when
    the sampled row is not a corruptible read."""
    rows = list(history)
    if rows:
        i = rng.randrange(len(rows))
        o = rows[i]
        if o.type == "ok" and o.f == "read" and o.value is not None:
            rows[i] = o.replace(value=bogus)
    return History.of(rows)


def crash_writes(history, count: int) -> History:
    """The history with its first ``count`` ok writes reported as 'info'
    instead: a write that took effect may be reported as crashed, so the
    history stays linearizable and gains crashed ops."""
    rows = list(history)
    for i in [i for i, o in enumerate(rows)
              if o.type == "ok" and o.f == "write"][:count]:
        rows[i] = rows[i].replace(type="info")
    return History(rows)


def wide_history(n_procs=100, rounds=2, write_frac=0.12, seed=0,
                 corrupt=False) -> History:
    """Rounds of ``n_procs`` fully overlapping register ops: every op of a
    round is invoked before any completes, so the search needs a window of
    about ``n_procs`` offsets. Linearizable unless ``corrupt``, which sets
    the last ok read to a never-written value."""
    rng = random.Random(seed)
    h = History()
    value = None
    t = 0
    nextv = 0
    for _ in range(rounds):
        ops = []
        for p in range(n_procs):
            if rng.random() < write_frac:
                f, v = "write", nextv
                nextv += 1
            else:
                f, v = "read", None
            h.append(Op(type="invoke", f=f, value=v, process=p, time=t))
            t += 1
            ops.append((p, f, v))
        rng.shuffle(ops)                   # commit order
        comps = []
        for p, f, v in ops:
            if f == "write":
                value = v
                comps.append((p, "ok", f, v))
            else:
                comps.append((p, "ok", f, value))
        rng.shuffle(comps)                 # return order, independent
        for p, typ, f, v in comps:
            h.append(Op(type=typ, f=f, value=v, process=p, time=t))
            t += 1
    if corrupt:
        rows = list(h)
        for i in range(len(rows) - 1, -1, -1):
            o = rows[i]
            if o.type == "ok" and o.f == "read":
                rows[i] = o.replace(value=10**6)
                break
        h = History.of(rows)
    return h
