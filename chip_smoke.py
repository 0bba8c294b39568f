#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the search kernels from ``jepsen_tpu_torch/csrc`` with nvcc, holds
each kernel bit for bit against its plain PyTorch version on the card and
times both: at the single-history headline shape and at a wide shape (one
key, lex tie-break; the sort's tile pass and five merge passes), at the
keyed batch's first rungs (256 keys, both tie-breaks), at the rung its
window-deferred keys run on (lex, R = 37,376 rows: four merge passes), at
each model's first rung, and at the mutex history's second rung (one
merge pass); there it also counts the CUDA launches one call of each
kernel makes, as the C entry points count them, against the count the
shape predicts. Each state holds the kernels its level launches: K3
``group_scan`` only on the wide rungs of a search with crashed ops (on
the narrow ones K4 scans the group starts in its shared memory, and is
held against both plain versions); at each state K5 ``seg_active``
standing alone, and K4 ending a level pair with K5's step, as the
segment graph runs it. Then it drives both paths end to end, counting
each kernel's launches on each: the 10k-op CAS-register headline history through
``linearizable(CASRegister())``, its first segment held against
the plain versions, an invalid history (its first segments held against
the plain versions, and a smaller one refuted on both), a wide history;
the keyed batch through
``independent.checker(linearizable(CASRegister()))``: 256 keys x 2,000 ops
staggered and dense, cold and warm, an etcd-shaped batch with one
corrupted key, and a mixed sub-batch held against the plain versions; and
the other model families (mutex, unordered queue, FIFO queue, set, no-op):
each kernel held against its plain version at a live state of each
model's 10,000-op history, each history through ``linearizable(<Model>())``
cold and warm, a corrupted copy refuted, and 1,000-op histories on the
kernels and on their plain versions (whole up to 256 levels, else their
first 256); and the serve daemon's gangs: each
kernel held against its plain version at a gang's state (8 same-bucket
2,000-op register histories), the gang against the same 8 histories
checked one by one, and the daemon (``serve.run_daemon`` on port 0)
answering register requests from 4 tenants in gangs, beside the
headline, its corrupted copy, a mutex history, a request past its
deadline and a poisoned gang member; and the host engines behind the
facade: the native C++ engine built from ``jepsen_tpu_torch/native`` with
g++, the headline through ``linearizable(CASRegister(), backend="cpu")``
timed beside the device's warm seconds (with the card and the host CPU),
the corrupted headline and the etcd batch on both, a ``competition``
race, histories the device leaves UNKNOWN ending in the native engine
after K1-K4 ran, and ``linear.svg`` written for an invalid history; and
streams: the daemon's ``/stream`` routes taking 10,000-op register
histories in 1,000-event chunks (crash-free with a duplicate and a
reordered chunk; the headline, whose first crash pins the watermark; its
corrupted copy, refuted before its last chunk; a stream whose daemon is
stopped after a checkpoint and resumed by a new one), each verdict
against the offline check on the card, and a lock-step stream on the
kernels against the same stream on their plain versions; and the plan
gate: the headline's ``plan`` entry, each footprint against what a fresh
engine allocates (``torch.cuda.memory_allocated``), a pool seeded under a
pinned byte budget and an oversized rung rejected before any allocation;
and the test runner: ``core.run`` of the 10,000-op atom test (first and
second), its store, its verdict against the native engine's, 2,000-op and
local-kv histories on the kernels against the plain route, the local-kv
suite's three kvnode daemons under hammer-time, the unsafe suite refuted,
``analyze`` in its own process, and ``recover`` of a run SIGKILLed
mid-workload, each check on the card; and the sqlite tier: the real
SQLite engine's register suite under the lock hammer (its check held
against the plain route on the card and the native engine), its toctou
suite refuted with ``linear.svg`` and explained, and its bank suite;
and the wire-protocol suites through ``python -m jepsen_tpu_torch run``
against the in-process fakes of ``tools/torch_suite_fakes.py``: etcd at
its canonical shapes on 50 workers for 15 s (its keyed check held
against the plain route on the card, the native engine and ``analyze``
of its store), etcd against lagging replicas refuted, and the hazelcast
lock checked as a ``Mutex``; and the keyed CAS-register suites whose data
plane is a command on the nodes, each through ``core.run`` with the
command-line fake's sessions: aerospike at 100 workers and cockroachdb's
register under a clock-skew nemesis, valid with crashed ops in their
histories (held against the plain route, the native engine and
``analyze``), and mongodb against lagging secondaries, valid with
linearizable reads and refuted with local ones; and the single registers
of the small suites, through ``core.run``: logcabin with 33-128 crashed
ops left open in its one history (a crashed mask of two to four words),
ravendb against 503s, rethinkdb with majority reads valid and with
outdated reads from a lagging replica refuted, each held against the
plain route on the card and the native engine (logcabin's store against
``analyze``), and mongodb-rocks' keyed document CAS; and the command
line, each step a ``python -m jepsen_tpu_torch`` process: the daemon
under ``serve --batch-max 4 --batch-wait-ms 50 --auth-token T`` checking
8 same-bucket histories in gangs of at most 4 (each verdict that of a
lone check, a POST without the token refused with 401, the kernels'
launches read from its ``/metrics``), a local-kv run under ``run
--watch`` followed by ``watch`` while in flight, ``stream --store`` of
the runner's local-kv run against ``analyze --profile`` of it, and ``trace
summary|request|find|export`` over the daemon's directory and over the
profiled search (naming K1, K2 and K4); and the port's CI tools, each a
process on the card: the randomized differential soak (45 s from a fixed
seed, no mismatch, device and keyed rounds), the chaos matrix's scenarios
that touch the device, the profiling gate (K1, K2 and K4 under host
spans) and the serve gate; and, last, the segment watchdog:
an injected wedge continued on the CPU, a real GPU-side stall ended by a
0.5 s deadline, a second check answered at once while the card still
spins, and the warm headline with a deadline beside it without one.
Every phase is a hard assertion.

It prints each phase's seconds, the card's ``nvidia-smi`` name and power
limit, one JSON line of per-kernel numbers and, last, ``{"ok": true,
"device": {...}}``. Without a CUDA device it exits non-zero and prints no
result.

Run from the repository root: ``python3 chip_smoke.py``.
"""

import contextlib
import gc
import json
import os
import random
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

#: the headline history (the bench's cas-register-10k-op-linearize shape)
HEADLINE = dict(n_ops=10000, n_procs=5, n_vals=16, seed=42, crash_p=0.002)
HEADLINE_RUNG = (128, 32, 8)
#: levels run before the kernels are held against their plain versions
HEADLINE_WARM_LEVELS = 300
#: the headline's segments run on the kernels and on the plain versions
#: (three took 29.5 s of the smoke)
HEADLINE_PLAIN_SEGMENTS = 1
#: a 2,000-op history with one corrupted read (refuted on the third rung)
INVALID = dict(n_ops=2000, n_procs=5, n_vals=16, seed=16)
#: its search's first INVALID_PLAIN_SEGMENTS segments of PLAIN_SEGMENT_LEVELS
#: levels run on the kernels and on the plain versions (its whole plain run
#: took 61.9-85.9 s of the smoke)
INVALID_PLAIN_SEGMENTS = 2
PLAIN_SEGMENT_LEVELS = 256
#: a 500-op history with one corrupted read that the search refutes on its
#: first rung, run whole on the kernels and on the plain versions
INVALID_SMALL = dict(n_ops=500, n_procs=5, n_vals=16, seed=28)
#: a one-client history of the headline's length: every op is forced, so
#: the first level's one forced run (K1's warp walk) crosses the whole
#: history
SEQUENTIAL = dict(n_ops=10000, n_procs=1, n_vals=16, seed=42)
#: the wide history (needed window > 64: four mask words)
WIDE = dict(n_procs=100, rounds=2, seed=5)
WIDE_RUNG = (512, 128, 512)
WIDE_WINDOW = 128
WIDE_WARM_LEVELS = 8
#: ok writes of the wide history turned into crashes, so that CR > 0
WIDE_CRASHED_WRITES = 6

#: the keyed headline (bench.py's accelerator shape): 256 keys x 2,000 ops,
#: key k drawn from seed 7000 + k, staggered and dense
KEYS, KEY_OPS = 256, 2000
KEYED = {"staggered": dict(crash_p=0.0, overlap_p=0.05),
         "dense": dict(crash_p=0.001)}
#: the keyed rungs on CUDA where the kernels are held against their plain
#: versions: (state, keys, rung, crash width, levels run first,
#: tie-breaks, only the keys whose needed window exceeds 32). The first
#: rungs take every key of the crash width; the dense headline's
#: window-deferred keys go on to (512, 64, 512), where the lex sort runs
KEYED_COHORTS = (
    ("staggered", "staggered", (128, 32, 8), 0, 3, ("lex", "hash"), False),
    ("dense", "dense", (128, 32, 16), 8, 200, ("lex", "hash"), False),
    ("dense wide", "dense", (512, 64, 512), 8, 300, ("lex",), True))
#: the etcd suite's shape: 10 threads and 300 ops a key, staggered
ETCD = dict(keys=64, n_ops=300, n_procs=10, n_vals=5, overlap_p=0.05)
#: the sub-batch run with the kernels and with their plain versions, and
#: its two window-deferred keys: wide_history(40, 2, seed) with two ok
#: writes crashed (needed window 40, crash width 8)
MIXED_KEYS, MIXED_OPS = 8, 500
MIXED_WIDE_SEEDS = (1, 2)
WIDE_RUNG_KEYED = (512, 64, 512)

#: the other model families' full-size histories: state tag -> (model
#: class, simulator, its arguments). The mutex is the hazelcast lock or
#: rabbitmq semaphore (one client per node on 5 nodes, each looping
#: acquire/release); the unordered queue disque's or rabbitmq's with
#: unique values and consumers that keep up; the FIFO queue a strict queue
#: within the 7-slot ring; the set the sets workload (unique adds, one
#: final read), its crashed adds all taking effect (with a crashed add
#: whose effect was lost, the pool search goes UNKNOWN on every wide rung:
#: tools/probe_torch_models.py); the no-op model takes the headline
#: register history
MODEL_HISTORIES = {
    "mutex": ("Mutex", "simulate_mutex_history",
              dict(n_ops=10000, n_procs=5, seed=42, crash_p=0.002)),
    "uqueue": ("UnorderedQueue", "simulate_queue_history",
               dict(n_ops=10000, n_procs=5, seed=42, backlog=8,
                    fifo=False)),
    "fifo": ("FIFOQueue", "simulate_queue_history",
             dict(n_ops=10000, n_procs=3, seed=42, backlog=2, fifo=True)),
    "set": ("SetModel", "simulate_set_history",
            dict(n_adds=10000, n_procs=5, seed=42, crash_p=0.002,
                 lost_p=0.0)),
    "noop": ("NoOp", "simulate_register_history", HEADLINE),
}
#: models whose corrupted copy the pool search does not refute: the set's
#: final read that misses an element fails at every state, and the beam
#: spends the level budget walking the earlier interleavings (UNKNOWN, on
#: the reference as here). Its copy runs on its first rung only, and must
#: not be decided True
MODEL_UNREFUTED = ("set",)
#: levels run before the kernels are held against their plain versions
MODEL_WARM_LEVELS = 300
#: the size of the histories run on the kernels and on the plain versions
MODEL_PLAIN_OPS = 1000
#: the plain versions run a search whole up to this many levels; a longer
#: one is held for its first MODEL_PLAIN_LEVELS levels, in segments of
#: PLAIN_SEGMENT_LEVELS, carry against carry (the whole runs took 41.9-70.8
#: s of the smoke, the set's UNKNOWN copy 32 s of it)
MODEL_PLAIN_LEVELS = 256

#: the serve phase: register requests of 2,000 ops (seeds 9000 + i) from
#: 4 tenants, in gangs of up to 8
SERVE = dict(n_ops=2000, n_procs=5, n_vals=16, crash_p=0.002)
SERVE_SEED, SERVE_REQUESTS, SERVE_TENANTS, SERVE_BATCH_MAX = 9000, 16, 4, 8
#: how long a gang's leader waits for its bucket's members: long enough
#: that the requests POSTed meanwhile fill its gang
SERVE_WAIT_MS = 1000.0
#: the deadline member's deadline, seconds
SERVE_DEADLINE_S = 0.001
#: the gang whose kernels are held against their plain versions, and which
#: is timed against its members checked one by one
GANG_SIZE, GANG_RUNG, GANG_WARM_LEVELS, GANG_REPS = 8, (128, 32, 8), 300, 3
#: the result fields a served verdict shares with the serial check's
VERDICT = ("valid", "levels", "max-linearized-prefix", "final-states",
           "frontier-op")

#: the host engines phase: repeats of each timed native headline check;
#: histories the device search leaves UNKNOWN, each with the result the
#: JAX package's facade (backend="cpu", its native engine) gives on it on
#: the CPU: the far-write history (its write 129 offsets past the first
#: read, beyond the device's 128-offset window) valid and refuted, and a
#: set history whose crashed adds all lost their effect (the beam is
#: truncated on every rung)
HOST_REPS = 5
FAR_WRITE_REFERENCE = {
    7: {"valid": True, "configs-explored": 132},
    8: {"valid": False, "configs-explored": 3, "max-linearized-prefix": 0,
        "final-states": [-1, 1]}}
LOST_ADD = dict(n_adds=1000, n_procs=5, seed=1, crash_p=0.005, lost_p=1.0)
LOST_ADD_REFERENCE = {"valid": True, "configs-explored": 29179}

#: the stream phase: histories POSTed to the daemon's /stream routes in
#: chunks of STREAM_CHUNK ops: the headline's shape without crashes (every
#: stable prefix checked online), the headline itself (its first crash
#: pins the watermark: the rest is checked at close) and its corrupted
#: copy (refuted before the last chunk is sent); the crash-free history
#: again, its daemon killed after a checkpoint at level > 0 once
#: STREAM_KILL_AFTER chunks are in, resumed by a new daemon; and
#: STREAM_PLAIN_OPS ops streamed in lock step on the kernels and on their
#: plain versions
STREAM_FREE = dict(HEADLINE, crash_p=0.0)
STREAM_CHUNK = 1000
STREAM_KILL_AFTER = 5
STREAM_PLAIN_OPS, STREAM_PLAIN_CHUNK = 1000, 100
#: the kernels whose launches the stream line counts
STREAM_KERNELS = ("expand", "sort_rows", "group_scan", "dedup_truncate")

#: the plan phase: the explicit rung that cannot fit PLAN_OOM_LIMIT bytes,
#: and the repeats of the timed gate
PLAN_OOM_RUNG, PLAN_OOM_LIMIT = (16384, 32, 1024), 200_000
PLAN_GATE_REPS = 200
#: the watchdog phase: a 2,000-op register history wedged (through the
#: fault seam) at segment WEDGE_SEGMENT under a WATCH_DEADLINE_S
#: watchdog, and its checkpoint resumed by the caller on the CPU; a
#: GPU-side spin of STALL_S seconds before the headline's first segment,
#: which the watchdog's STALL_DEADLINE_S deadline overruns; and the warm
#: headline with a WATCH_DEADLINE_S deadline and without, WATCH_REPS
#: times each in turns
WEDGE_HISTORY = dict(n_ops=2000, n_procs=5, n_vals=16, seed=9000,
                     crash_p=0.002)
WEDGE_SEGMENT = 2
STALL_S, STALL_DEADLINE_S = 3.0, 0.5
WATCH_DEADLINE_S, WATCH_REPS = 30.0, 3

#: H100 SXM peaks from its datasheet: HBM bytes/s, and the
#: non-tensor 32-bit rate, against which the integer work is counted
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
#: GPU-side delay before a timed launch, so the window holds device time
#: only (about 2.5 ms at H100 clocks, many times the host's enqueue of one
#: call; each timed call waits it REPS times)
SLEEP_CYCLES = 5_000_000
REPS = 30
#: back-to-back launches of one kernel in the CUDA graph that times it as
#: a graph node (the segment graph's level runs its kernels so)
GRAPH_LAUNCHES = 64
GRAPH_REPS = 7
#: a plain version slower than this (ms) is timed SLOW_REPS times
SLOW_MS, SLOW_REPS = 200.0, 3

#: the segment loop phase: the levels each state's segment may run on the
#: graph loop and on the plain route (the host loop runs the levels the
#: graph ran), from the state the kernels are held at (the plain route's
#: levels at the keyed states were most of the phase at 128; PERF.md §6
#: has its seconds on an H100 at 128, 16 and 8); the state whose lane 0
#: is cancelled first
LOOP_LEVELS = 8
LOOP_CANCELLED = ("gang",)
#: the path each state's per-level times stand for in the summary
LOOP_PATHS = {"headline": "headline", "keyed": "keyed dense hash",
              "models": "model_mutex", "serve": "gang"}

SOURCE = "jepsen_tpu_torch/csrc/search.cu"
#: the state and path each kernel's line in the kernels JSON is read at,
#: where not the headline's: the hash sort runs on the keyed first rungs
#: only, K3 as a launch of its own on the wide rungs of a search with
#: crashed ops (the keyed path's window-deferred keys)
MAIN_STATE = {"sort_rows_hash": ("keyed staggered hash", "keyed"),
              "group_scan": ("keyed dense wide lex", "keyed")}
KERNELS = ("expand", "sort_rows", "sort_rows_hash", "group_scan",
           "dedup_truncate", "seg_active")
REPLACES = {
    "expand": "jepsen_tpu/checker/tpu.py:377",
    "sort_rows": "jepsen_tpu/checker/tpu.py:581",
    "sort_rows_hash": "jepsen_tpu/checker/tpu.py:563",
    "group_scan": "jepsen_tpu/checker/tpu.py:605",
    "dedup_truncate": "jepsen_tpu/checker/tpu.py:589",
    "seg_active": "jepsen_tpu/checker/tpu.py:681",
}


@contextlib.contextmanager
def phase(name, seconds):
    t0 = time.perf_counter()
    yield
    seconds[name] = time.perf_counter() - t0
    print(f"phase {name}: {seconds[name]:.2f} s", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, prep):
    """Median device time of ``fn(*prep())``: a GPU-side sleep holds the
    stream while the host enqueues, so the events bracket device work."""
    times = []
    for _ in range(REPS):
        args = prep()
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, args):
    """Median device ms of one launch of ``fn(*args)`` inside a CUDA graph
    of GRAPH_LAUNCHES back-to-back launches of it alone, the graph
    replayed behind a device-side sleep. ``fn`` runs once first, outside
    the capture, where its shared-memory grant is made."""
    fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(GRAPH_LAUNCHES):
            fn(*args)
    graph.replay()
    times = []
    for _ in range(GRAPH_REPS):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_LAUNCHES)
    del graph
    return statistics.median(times)


def host_ms(fn, prep):
    """Median wall time of ``fn(*prep())`` from a synchronised start to a
    synchronised end (the plain versions synchronise inside); of
    SLOW_REPS runs where the first takes over SLOW_MS."""
    times = []
    for _ in range(REPS):
        if len(times) == SLOW_REPS and times[0] > SLOW_MS:
            break
        args = prep()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sort_name(shape):
    return "sort_rows" if shape.tiebreak == "lex" else "sort_rows_hash"


def check_and_time(lv, parity, plain_times=True):
    """One level from ``lv``'s state, stage by stage: each kernel against
    its plain version from identical inputs (tolerance 0), then both
    timed from those inputs, the kernel also as a graph node
    (:func:`graph_ms`; each launch of it on the same buffers does the
    same work, but K2's re-sorts its sorted output). Without
    ``plain_times`` the plain versions are compared but not timed."""
    from jepsen_tpu_torch.kernels import search as K
    out = {}
    for name, kern, plain, state, err in lv.walk():
        if name == "sort_rows":
            name = sort_name(lv.shape)
        assert err == 0, f"{name}: kernel and plain version disagree"
        # the CUDA launches one call makes, as the C side counts them
        before = K.grid_launches_total[name]
        kern(*parity.copy_state(*state))
        per_call = K.grid_launches_total[name] - before
        assert per_call == K.grid_launches(name, lv.shape), (name, per_call)
        out[name] = {
            "max_abs_err": err,
            "cuda_launches_per_call": per_call,
            "ms": device_ms(kern, lambda: parity.copy_state(*state)),
            "graph_ms": graph_ms(kern, parity.copy_state(*state)),
            "plain_ms": (host_ms(plain, lambda: parity.copy_state(*state))
                         if plain_times else None),
            "library_ms": None,
        }
        if name.startswith("sort_rows"):
            # one PyTorch call as a yardstick: a stable sort of each key's
            # first two comparator words packed in one int64 (no single
            # call sorts on the whole row)
            rows = state[1].rows
            second = (K.row_hash_plain(rows, lv.shape.MW)
                      if lv.shape.tiebreak == "hash"
                      else rows[..., 1].to(torch.int64) + 2**31)
            key = rows[..., 0].to(torch.int64) * 2**32 + second
            out[name]["library_ms"] = device_ms(
                lambda k: torch.sort(k, dim=1, stable=True),
                lambda: (key.clone(),))
        if name == "group_scan":
            # the same scan as one PyTorch call: cummax over each key's
            # [R] int32 vector of group starts (tpu.py:605)
            rows = state[1].rows[:, :lv.shape.R]
            iota = torch.arange(rows.shape[1], device=rows.device,
                                dtype=torch.int32)
            v = torch.where(K._same_grp(rows, lv.shape.MW), 0, iota)
            out[name]["library_ms"] = device_ms(
                lambda x: torch.cummax(x, 1), lambda: (v,))
    add_bounds(out, lv)
    return out


def add_bounds(out, lv):
    """The least time the card could take for each kernel's work on this
    state (those the level launched, in ``out``): bytes (each input read
    once, each output written once) over HBM bandwidth, against integer
    operations over the 32-bit rate, both from the level's cost model
    (``kernels/cost.py``) with the column entries this state's expanded
    rows touch counted live. Where K4 scans the group starts itself, the
    scan's operations are K4's too, and it reads no starts: the rows it
    scans are the rows it reads anyway."""
    from jepsen_tpu_torch.kernels import cost as kcost
    sh = lv.shape
    B, E, W = sh.B, sh.E, sh.W
    k_e = lv.carry.pool.k[:, :E].to(torch.int64)
    window = (k_e[..., None] + torch.arange(W, device=k_e.device)).clamp(
        0, sh.n - 1)
    window = window + sh.n * torch.arange(B, device=k_e.device)[:, None,
                                                                None]
    touched = int(torch.unique(window).numel())
    stage = kcost.level_cost(sh, touched)
    dedup = stage["dedup"]
    if sh.CR and "group_scan" not in out:
        dedup = (dedup[0] - B * sh.R * 4,
                 dedup[1] + stage["group_starts"][1])
    work = {"expand": stage["expand"], sort_name(sh): stage["sort"],
            "group_scan": stage["group_starts"], "dedup_truncate": dedup}
    for name, (nbytes, nops) in work.items():
        if name not in out:
            continue
        tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_OPS_S * 1e3
        out[name].update(bound_ms=max(tb, to),
                         bound_by="bytes" if tb >= to else "operations",
                         bytes=nbytes, ops=nops)


def print_kernels(tag, lv, live, warm, res):
    from jepsen_tpu_torch.kernels import search as K
    sh = lv.shape
    print(f"kernels at {tag}: B={sh.B} rung=({sh.C}, {sh.W}, {sh.E}) "
          f"tiebreak={sh.tiebreak} n={sh.n} CR={sh.CR} MW={sh.MW} "
          f"R={sh.R} RP={sh.RP} NK={sh.NK} sort_tile={K.tile_rows(sh)} "
          f"sort_merge_passes={K.sort_passes(sh)} live={live} after {warm} "
          f"levels")
    for name, r in res.items():
        print(f"  {name:15s} err={r['max_abs_err']} "
              f"cuda_launches/call={r['cuda_launches_per_call']} "
              f"ms={r['ms']:.4f} graph_ms={r['graph_ms']:.4f} "
              f"plain_ms={r['plain_ms']} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']})"
              + (f" library_ms={r['library_ms']:.4f}"
                 if r["library_ms"] is not None else ""), flush=True)


def carries_equal(a, b):
    return len(a) == len(b) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


def hold_segments(tag, cols_np, rung, dev, segments, iters,
                  model="cas-register"):
    """The first ``segments`` segments of ``iters`` levels of a search
    from ``cols_np`` on ``rung``, on the kernels and on their plain
    versions, every lane of the carry held equal after each. Returns the
    level the plain route reached."""
    from jepsen_tpu_torch import interop
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.kernels import parity
    lvs = {name: parity.Level(cols_np, rung, dev, model=model)
           for name in ("kernels", "plain")}
    for i in range(segments):
        seg = {}
        for name, ops in (("kernels", G.KERNELS), ("plain", G.PLAIN)):
            lv = lvs[name]
            t0 = time.perf_counter()
            G.run_segment(lv.cols, lv.carry, lv.scratch, lv.shape, lv.nr,
                          iters, ops)
            seg[name] = interop.carry_to_numpy(lv.carry)
            print(f"{tag} segment {i + 1} ({name}): "
                  f"{time.perf_counter() - t0:.3f} s, "
                  f"level={int(seg[name][8])}", flush=True)
        assert carries_equal(seg["kernels"], seg["plain"]), \
            f"{tag} segment {i + 1}"
    return int(seg["plain"][8])


def cohort_cols(histories, cr, wide):
    """A keyed cohort's columns: the register histories of crash width
    ``cr`` (with ``wide``, only those whose needed window exceeds 32),
    padded to the batch's required width."""
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops.encode import pack_with_init
    packs = [pack_with_init(h, CASRegister()) for h in histories]
    breq = G._bucket(max(p.n_required for p, _ in packs))
    return [G._split_packed(p, breq, cr, k) for p, k in packs
            if (G._crash_width(p.n - p.n_required) or 0) == cr
            and (not wide or G._window_needed(p) > 32)]


def model_state(tag, dev):
    """(model, kernel, history, packed, columns, ladder) of the model
    family ``tag`` at full size."""
    from jepsen_tpu_torch import models, testing
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.ops.encode import pack_with_init
    cls, sim, kw = MODEL_HISTORIES[tag]
    model = getattr(models, cls)()
    h = getattr(testing, sim)(**kw)
    packed, kernel = pack_with_init(h, model)
    cols = G._split_packed(packed, G._bucket(packed.n_required),
                           G._crash_width(packed.n - packed.n_required),
                           kernel)
    return (model, kernel, h, packed, cols,
            G._ladder_for(G._window_needed(packed), dev))


def serve_members():
    """The serve phase's register requests, each (history, packed,
    kernel, bucket): (the requests; their count per bucket; the main
    bucket; further members of it, the deadline member and the poison
    member first; the gang of GANG_SIZE of the main bucket)."""
    from jepsen_tpu_torch import testing
    from jepsen_tpu_torch.checker.engine import Engine
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops.encode import pack_with_init

    def member(seed):
        h = testing.simulate_register_history(seed=seed, **SERVE)
        p, kernel = pack_with_init(h, CASRegister())
        return h, p, kernel, Engine.bucket_key(p, kernel)

    regs = [member(SERVE_SEED + i) for i in range(SERVE_REQUESTS)]
    counts = {}
    for r in regs:
        counts[r[3]] = counts.get(r[3], 0) + 1
    main = max(counts, key=counts.get)
    # the deadline member, the poison member and the gang of GANG_SIZE:
    # further seeds of the requests' main bucket
    extra, seed = [], SERVE_SEED + SERVE_REQUESTS
    while len(extra) < 2 + max(0, GANG_SIZE - counts[main]):
        m = member(seed)
        if m[3] == main:
            extra.append(m)
        seed += 1
    gang8 = ([r for r in regs if r[3] == main] + extra[2:])[:GANG_SIZE]
    return regs, counts, main, extra, gang8


def load_state(dst, src):
    """Copy the (carry, scratch) ``src`` into the buffers of ``dst``."""
    for a, b in zip(dst, src):
        for name in vars(a):
            x = getattr(a, name)
            if x is not None:
                x.copy_(getattr(b, name))


def check_seg_active(lv):
    """K5 standing alone, the step of the host loop's route
    (``run_segment`` on other ops than the kernels): against its plain
    version at ``lv``'s scalars over segment words below, at and past
    their bound (tolerance 0), then timed beside its plain version and
    ``torch.any`` over the same keys' active flags."""
    from jepsen_tpu_torch.kernels import parity
    from jepsen_tpu_torch.kernels import search as K
    scal, lmax, B = lv.carry.scal.clone(), lv.shape.lmax, lv.shape.B
    dev = scal.device
    err = 0
    for run, bound in ((0, 2), (0, 1024), (1022, 1024), (5, 4)):
        seg = torch.tensor([run, bound, 9, 0], dtype=torch.int32,
                           device=dev)
        a, b = seg.clone(), seg.clone()
        K.seg_active(scal, lmax, a)
        K.seg_active_plain(scal, lmax, b)
        err = max(err, parity.max_abs_err([a], [b]))
    assert err == 0, "seg_active: kernel and plain version disagree"
    seg = torch.tensor([0, 1024, 0, 0], dtype=torch.int32, device=dev)
    act = K.active(scal, lmax)
    nbytes = B * K.NSCAL * 4 + 16
    nops = B * 5
    tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_OPS_S * 1e3
    return {"max_abs_err": err, "cuda_launches_per_call": 1,
            "ms": device_ms(lambda x: K.seg_active(scal, lmax, x),
                            lambda: (seg.clone(),)),
            "graph_ms": graph_ms(lambda x: K.seg_active(scal, lmax, x),
                                 (seg.clone(),)),
            "plain_ms": host_ms(lambda x: K.seg_active_plain(scal, lmax, x),
                                lambda: (seg.clone(),)),
            "library_ms": device_ms(torch.any, lambda: (act,)),
            "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "bytes": nbytes, "ops": nops}


#: segment words (levels run, bound) the pair's end is held at: below,
#: at and past the bound
SEG_CASES = ((0, 2), (0, 1024), (1022, 1024), (5, 4))


def check_pair_end(lv, plain_times=True):
    """K5's step where the main path runs it: K4 ending a level pair (the
    segment graph's second K4, K5's step in its tail) against
    ``dedup_truncate_plain`` and then ``seg_active_plain``, from the inputs
    of ``lv``'s next K4 and over segment words below, at and past their
    bound (tolerance 0); then timed alone and as a graph node (the segment
    graph runs it so), beside K4's graph node without the step, with the
    bound of K4's work and the step's (:func:`add_bounds`, the segment
    words read and written, and at B > 1 each key's ticket). No one
    PyTorch call computes K4 and the step."""
    from jepsen_tpu_torch.kernels import parity
    from jepsen_tpu_torch.kernels import search as K
    err, state = lv.pair_end(SEG_CASES)
    assert err == 0, "dedup_truncate ending a pair: kernel and plain differ"
    seg = torch.tensor([0, 1 << 30, 0, 0], dtype=torch.int32,
                       device=lv.carry.scal.device)
    kern = lv.dedup_call(K.dedup_truncate, seg)
    before = K.grid_launches_total["dedup_truncate"]
    kern(*parity.copy_state(*state))
    per_call = K.grid_launches_total["dedup_truncate"] - before
    assert per_call == K.grid_launches("dedup_truncate", lv.shape), per_call
    out = {"dedup_truncate": {}}
    if K.group_scan_runs(lv.shape):
        out["group_scan"] = {}
    add_bounds(out, lv)
    B = lv.shape.B
    nbytes = out["dedup_truncate"]["bytes"] + 2 * 4 * K.NSEG + (
        8 * B if B > 1 else 0)
    nops = out["dedup_truncate"]["ops"] + 5 * B
    tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_OPS_S * 1e3
    plain = lv.dedup_call(K.dedup_truncate_plain, seg)
    return {"max_abs_err": err, "cuda_launches_per_call": per_call,
            "ms": device_ms(kern, lambda: parity.copy_state(*state)),
            "graph_ms": graph_ms(kern, parity.copy_state(*state)),
            "dedup_graph_ms": graph_ms(lv.dedup_call(K.dedup_truncate),
                                       parity.copy_state(*state)),
            "plain_ms": (host_ms(plain, lambda: parity.copy_state(*state))
                         if plain_times else None),
            "library_ms": None, "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "bytes": nbytes, "ops": nops}


def segment_loop(tag, lv, cancel):
    """The segment graph against the host loop over the kernels and the
    plain route, from ``lv``'s state: one segment of at most LOOP_LEVELS
    levels on each, timed (the graph's second launch, its capture done;
    the host loop over the levels the graph ran), their carries equal bit
    for bit and their levels run equal."""
    from jepsen_tpu_torch import interop
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.kernels import parity
    if cancel:
        G.cancel_lanes(lv.carry, [0])
    state = parity.copy_state(lv.carry, lv.scratch)
    graph_state = parity.copy_state(*state)

    def graph_segment():
        words, graph = G.run_segment(lv.cols, graph_state[0],
                                     graph_state[1], lv.shape, lv.nr,
                                     LOOP_LEVELS)
        assert graph is not None, tag
        return (G.end_segment(graph_state[0], lv.shape, words, graph)[0],
                words)

    graph_segment()
    load_state(graph_state, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run, graph_words = graph_segment()
    graph_s = time.perf_counter() - t0
    levels = run + run % 2
    host_state = parity.copy_state(*state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    G.run_segment_host(lv.cols, host_state[0], host_state[1], lv.shape,
                       lv.nr, levels)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    plain_state = parity.copy_state(*state)
    t0 = time.perf_counter()
    words, _ = G.run_segment(lv.cols, plain_state[0], plain_state[1],
                             lv.shape, lv.nr, LOOP_LEVELS, G.PLAIN)
    plain_s = time.perf_counter() - t0
    carries = [interop.batch_carry_to_numpy(c) for c, _ in (
        graph_state, host_state, plain_state)]
    # levels run, bound, go and the batch's ticket (back at 0): the pair's
    # end in the graph's last K4 against the plain route's K5
    assert graph_words.tolist() == words.tolist(), (
        tag, graph_words.tolist(), words.tolist())
    assert carries_equal(carries[0], carries[1]), (tag, "host loop")
    assert carries_equal(carries[0], carries[2]), (tag, "plain route")
    return {"B": lv.shape.B, "levels_run": run, "graph_s": graph_s,
            "host_s": host_s, "plain_s": plain_s,
            "per_level_ms_graph": graph_s / run * 1e3,
            "per_level_ms_host": host_s / levels * 1e3,
            "cancelled": bool(cancel)}


def segment_loop_phases(dev, seconds, recipes, head_p, head_kernel, r):
    """The segment loop at every state the kernels are held at (the
    ``recipes`` so far, then the gang's, each model's and the odd-pass
    state): K4 ending a level pair and K5 standing alone against their
    plain versions, and the graph loop against the host loop and the
    plain route (:func:`segment_loop`); then the headline checkpointed
    after its third segment and resumed, against its uninterrupted result
    ``r``. Returns the per-state loop lines and K5's numbers: the pair's
    end in K4, with K5 alone under ``host_loop``."""
    from jepsen_tpu_torch import resilience
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.kernels import parity
    with phase("segment loop", seconds):
        _, _, bucket, _, gang8 = serve_members()
        recipes = recipes + [("gang", [G._split_packed(
            m[1], bucket[1], bucket[2], m[2]) for m in gang8], GANG_RUNG,
            {}, GANG_WARM_LEVELS)]
        for tag in MODEL_HISTORIES:
            _, kernel, _, _, mcols, ladder = model_state(tag, dev)
            kw = {"model": kernel.name}
            recipes.append((f"model_{tag}", mcols, ladder[0], kw,
                            MODEL_WARM_LEVELS))
            if tag == "mutex":
                recipes.append(("odd", mcols, ladder[1], kw,
                                MODEL_WARM_LEVELS))
        loops, k5 = {}, {}
        for tag, cols_np, rung, kw, warm in recipes:
            marks = [time.perf_counter()]
            lv = parity.Level(cols_np, rung, dev, **kw)
            assert lv.advance(warm) > 0, tag
            marks.append(time.perf_counter())
            k5[tag] = check_pair_end(lv)
            marks.append(time.perf_counter())
            alone = k5[tag]["host_loop"] = check_seg_active(lv)
            marks.append(time.perf_counter())
            loops[tag] = segment_loop(tag, lv, tag in LOOP_CANCELLED)
            marks.append(time.perf_counter())
            loops[tag]["rung"] = list(rung)
            # where the state's seconds went: the warm levels, K4 ending a
            # pair, K5 alone, and the graph against host loop and plain
            loops[tag]["state_s"] = dict(zip(
                ("advance", "pair_end", "k5_alone", "loop"),
                (b - a for a, b in zip(marks, marks[1:]))))
            end = k5[tag]
            print(f"segment loop {tag}: {json.dumps(loops[tag])} "
                  f"dedup_truncate ending the pair ms={end['ms']:.4f} "
                  f"graph_ms={end['graph_ms']:.4f} (without the step "
                  f"{end['dedup_graph_ms']:.4f}) plain_ms="
                  f"{end['plain_ms']:.3f} bound_ms={end['bound_ms']:.6f} "
                  f"err={end['max_abs_err']}; seg_active alone (host "
                  f"loop) ms={alone['ms']:.4f} "
                  f"graph_ms={alone['graph_ms']:.4f} "
                  f"plain_ms={alone['plain_ms']:.3f} "
                  f"torch.any ms={alone['library_ms']:.4f} "
                  f"bound_ms={alone['bound_ms']:.7f}", flush=True)

    with phase("resume", seconds):
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "store", "smoke-resume", "headline.npz")
        os.makedirs(os.path.dirname(path), exist_ok=True)

        def third(cp):
            if cp.segment == 3:
                cp.save(path)

        rc = resilience.supervised_check_packed(head_p, head_kernel,
                                                device=dev,
                                                on_checkpoint=third)
        cp = resilience.Checkpoint.load(path)
        rr = resilience.supervised_check_packed(head_p, head_kernel,
                                                device=dev, resume=cp)
        fields = ("valid", "levels", "best-k", "rung", "segments")
        print(f"resume: checkpoint at segment {cp.segment} level "
              f"{cp.level}; resumed {[rr[f] for f in fields]}, "
              f"uninterrupted {[r[f] for f in fields]}")
        assert cp.segment == 3 and 0 < cp.level < r["levels"]
        assert [rr[f] for f in fields] == [rc[f] for f in fields] == [
            r[f] for f in fields]
    return loops, k5


def model_phases(dev, seconds, shapes):
    """The other model families: each kernel against its plain version at
    a live state of each model's full-size history (into ``shapes``),
    each history through ``linearizable`` cold and warm with a corrupted
    copy refuted, and the 1,000-op histories on the kernels and on their
    plain versions. Returns the per-model lines and the kernels' launch
    counts on the models path."""
    from jepsen_tpu_torch import models, resilience, testing
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.kernels import parity
    from jepsen_tpu_torch.kernels import search as K
    from jepsen_tpu_torch.ops.encode import pack_with_init

    # kernels at each model's live state
    model_runs = {}
    with phase("model kernels", seconds):
        for tag in MODEL_HISTORIES:
            model, kernel, h, packed, cols, ladder = model_state(tag, dev)
            lv = parity.Level(cols, ladder[0], dev, model=kernel.name)
            live = lv.advance(MODEL_WARM_LEVELS)
            assert live > 0, tag
            res = check_and_time(lv, parity)
            shapes[f"model_{tag}"] = res
            print_kernels(f"model {tag} ({kernel.name})", lv, live,
                          MODEL_WARM_LEVELS, res)
            model_runs[tag] = (model, kernel, h)
            if tag == "mutex":
                # an odd count of the sort's merge passes: the mutex
                # history on its second rung, (1024, 32, 64) at CR = 32,
                # has R = 5,120 rows, two tiles and one merge pass
                lv = parity.Level(cols, ladder[1], dev, model=kernel.name)
                live = lv.advance(MODEL_WARM_LEVELS)
                assert live > 0 and K.sort_passes(lv.shape) % 2 == 1
                res = check_and_time(lv, parity)
                shapes["odd"] = res
                print_kernels(f"odd merge passes ({kernel.name}, its "
                              f"second rung)", lv, live, MODEL_WARM_LEVELS,
                              res)

    # each model end to end
    model_lines = {}
    with phase("models", seconds):
        K.reset_launches()
        for tag, (model, kernel, h) in model_runs.items():
            mchecker = linearizable(model, device=dev)
            before = dict(K.launches)
            ends = K.segments["pair_ends"]
            t0 = time.perf_counter()
            rm = mchecker.check({}, h)
            cold_s = time.perf_counter() - t0
            run_launches = {k: K.launches[k] - before[k] for k in K.launches}
            ends = K.segments["pair_ends"] - ends
            gc.collect()   # else a collection lands in the timed check
            t0 = time.perf_counter()
            rm2 = mchecker.check({}, h)
            warm_m = time.perf_counter() - t0
            line = {"model": kernel.name, "ops": len(h) // 2,
                    "valid": rm["valid"], "levels": rm.get("levels"),
                    "rung": list(rm.get("rung") or ()),
                    "segments": rm.get("segments"), "cold_s": cold_s,
                    "warm_s": warm_m, "launches": run_launches,
                    "pair_ends": ends,
                    "fallback": rm.get("fallback-from")}
            assert rm["valid"] is True and rm["backend"] == "gpu", (tag, rm)
            assert "fallback-from" not in rm, tag
            assert (rm2["valid"], rm2["levels"]) == (True, rm["levels"]), tag
            if tag != "noop":   # the no-op model refutes nothing
                bad = testing.corrupt_model_history(h, kernel.name)
                t0 = time.perf_counter()
                if tag in MODEL_UNREFUTED:
                    pb = pack_with_init(bad, model)[0]
                    cap, win, exp = G._ladder_for(G._window_needed(pb),
                                                  dev)[0]
                    rb = resilience.supervised_check_packed(
                        pb, kernel, capacity=cap, window=win, expand=exp,
                        device=dev)
                else:
                    rb = mchecker.check({}, bad)
                line.update(
                    corrupt_valid=rb["valid"], corrupt_levels=rb["levels"],
                    corrupt_rung=list(rb["rung"]),
                    corrupt_prefix=rb.get("max-linearized-prefix"),
                    corrupt_error=rb.get("error"),
                    corrupt_s=time.perf_counter() - t0)
                assert rb["backend"] == "gpu", (tag, rb)
                assert "fallback-from" not in rb, tag
                if tag in MODEL_UNREFUTED:
                    assert rb["valid"] is not True, (tag, rb)
                else:
                    assert rb["valid"] is False, (tag, rb)
            model_lines[tag] = line
            print("model:", json.dumps(line), flush=True)
        model_launches = dict(K.launches)
        model_grid_launches = dict(K.grid_launches_total)
        model_segments = dict(K.segments)
        print(f"model launches: {model_launches} "
              f"cuda_launches={model_grid_launches} graphs={model_segments}")
        assert all(model_launches[k] > 0 for k in (
            "expand", "sort_rows", "group_scan", "dedup_truncate")), \
            model_launches
        # K5's step, in the pair's second K4; no K5 launch
        assert model_segments["pair_ends"] > 0, model_segments
        assert model_grid_launches["seg_active"] == 0, model_grid_launches

    with phase("models plain", seconds):
        # 1,000-op histories of each model, valid and corrupted, on the
        # kernels and on their plain versions (a search longer than
        # MODEL_PLAIN_LEVELS held for its first levels); a corrupted copy
        # on its first rung
        models_plain(dev, model_runs)
    return model_lines, model_launches, model_grid_launches, model_segments


def models_plain(dev, model_runs, n_ops=MODEL_PLAIN_OPS):
    """Each model's ``n_ops``-op history, valid and corrupted, through the
    supervised search on the kernels and on their plain versions: the
    results equal where the search takes at most MODEL_PLAIN_LEVELS
    levels, else its first levels held carry against carry. ``model_runs``
    maps a MODEL_HISTORIES tag to its (model, kernel, history)."""
    from jepsen_tpu_torch import resilience, testing
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.ops.encode import pack_with_init
    for tag, (cls, sim, kw) in MODEL_HISTORIES.items():
        model, kernel, _ = model_runs[tag]
        size = "n_adds" if "n_adds" in kw else "n_ops"
        h = getattr(testing, sim)(**{**kw, size: n_ops})
        cases = [("valid", h)]
        if tag != "noop":
            cases.append(("corrupt", testing.corrupt_model_history(
                h, kernel.name)))
        for label, hh in cases:
            pk = pack_with_init(hh, model)[0]
            pin = {}
            if label == "corrupt":
                pin = dict(zip(("capacity", "window", "expand"),
                               G._ladder_for(G._window_needed(pk),
                                             dev)[0]))
            fields = ("valid", "levels", "max-linearized-prefix", "rung",
                      "work")
            t0 = time.perf_counter()
            rr = resilience.supervised_check_packed(
                pk, kernel, device=dev, ops=G.KERNELS, **pin)
            a = {f: rr.get(f) for f in fields}
            kernels_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            if a["levels"] <= MODEL_PLAIN_LEVELS:
                rr = resilience.supervised_check_packed(
                    pk, kernel, device=dev, ops=G.PLAIN, **pin)
                b = {f: rr.get(f) for f in fields}
                assert a == b, (tag, label, a, b)
                held = "whole"
            else:
                # a longer search: its first levels on the first rung
                # it ran, carry against carry
                cols = G._split_packed(
                    pk, G._bucket(pk.n_required),
                    G._crash_width(pk.n - pk.n_required), kernel)
                hold_segments(f"model {tag} {label}", cols,
                              a["work"][0][0], dev,
                              MODEL_PLAIN_LEVELS // PLAIN_SEGMENT_LEVELS,
                              PLAIN_SEGMENT_LEVELS, model=kernel.name)
                held = f"first {MODEL_PLAIN_LEVELS} levels"
            print(f"model {tag} {label} {n_ops} ops: {a}, "
                  f"kernels {kernels_s:.3f} s, plain ({held}) "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
            if label == "valid":
                assert a["valid"] is True, (tag, a)
            elif tag in MODEL_UNREFUTED:
                assert a["valid"] is not True, (tag, a)
            else:
                assert a["valid"] is False, (tag, a)


def http_json(port, method, path, doc=None, token=None):
    """(status, body) of one request to the daemon on localhost, with a
    bearer ``token`` when given."""
    import urllib.error
    import urllib.request
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_phases(dev, seconds, shapes, head):
    """The serve daemon's path: the kernels at a gang's state (into
    ``shapes``), a gang against its members one by one, and the daemon
    answering POSTed requests. Returns the gang line, the serve line and
    the kernels' launch counts on the serve path."""
    import shutil
    import threading
    from jepsen_tpu_torch import journal, serve, testing
    from jepsen_tpu_torch.checker import check_safe
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.checker.engine import Engine
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.kernels import parity
    from jepsen_tpu_torch.kernels import search as K
    from jepsen_tpu_torch.models import CASRegister, Mutex
    from jepsen_tpu_torch.ops.encode import pack_with_init

    with phase("serve histories", seconds):
        regs, counts, main, extra, gang8 = serve_members()
        print(f"serve buckets: {counts}", flush=True)
        late, poison = extra[0], extra[1]
        kernel = regs[0][2]

        def sig(p):
            return (p.n, p.n_required, int(p.inv.sum()), int(p.v1.sum()))

        assert sum(sig(r[1]) == sig(poison[1]) for r in regs + extra) == 1
        bad_head = testing.corrupt_model_history(head, "cas-register")
        mutex_h = testing.simulate_mutex_history(
            **MODEL_HISTORIES["mutex"][2])

    with phase("gang kernels", seconds):
        cols = [G._split_packed(r[1], main[1], main[2], kernel)
                for r in gang8]
        lv = parity.Level(cols, GANG_RUNG, dev)
        live = lv.advance(GANG_WARM_LEVELS)
        assert live > 0
        shapes["gang"] = check_and_time(lv, parity)
        print_kernels("gang", lv, live, GANG_WARM_LEVELS, shapes["gang"])

    with phase("gang vs serial", seconds):
        pks = [r[1] for r in gang8]
        fields = VERDICT + ("rung", "work", "crash-width")
        gang = G.check_packed_gang_gpu(pks, kernel, device=dev)
        serial = [G.check_packed_gpu(p, kernel, device=dev) for p in pks]
        for g, s in zip(gang, serial):
            assert {k: g.get(k) for k in fields} == {
                k: s.get(k) for k in fields}, (g, s)
            assert g["valid"] is True, g
        times = {"gang": [], "serial": []}
        each = []
        for rep in range(GANG_REPS):
            for mode in (("gang", "serial") if rep % 2 == 0
                         else ("serial", "gang")):
                t0 = time.perf_counter()
                if mode == "gang":
                    G.check_packed_gang_gpu(pks, kernel, device=dev)
                else:
                    one = []
                    for p in pks:
                        t1 = time.perf_counter()
                        G.check_packed_gpu(p, kernel, device=dev)
                        one.append(time.perf_counter() - t1)
                    each.append(one)
                times[mode].append(time.perf_counter() - t0)
        gang_s = statistics.median(times["gang"])
        serial_s = statistics.median(times["serial"])
        deepest = max(range(GANG_SIZE), key=lambda i: gang[i]["levels"])
        gang_line = {
            "members": GANG_SIZE, "bucket": list(main),
            "rungs": [list(g["rung"]) for g in gang],
            "levels": [g["levels"] for g in gang],
            "gang_s": times["gang"], "serial_s": times["serial"],
            "gang_rps": GANG_SIZE / gang_s,
            "serial_rps": GANG_SIZE / serial_s,
            "speedup": serial_s / gang_s,
            "deepest_serial_s": statistics.median(
                one[deepest] for one in each),
            "serial_each_s": [statistics.median(one[i] for one in each)
                              for i in range(GANG_SIZE)]}
        print("gang vs serial:", json.dumps(gang_line), flush=True)

    with phase("serve", seconds):
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "store", "serve-smoke")
        shutil.rmtree(root, ignore_errors=True)
        # per tenant: its register requests first, then the other
        # buckets' (a gang takes members from the heads of the queues)
        mine = [[] for _ in range(SERVE_TENANTS)]
        for i, r in enumerate(regs):
            mine[i % SERVE_TENANTS].append(("reg", r[0], "cas-register",
                                            None))
        mine[0].insert(1, ("late", late[0], "cas-register",
                           SERVE_DEADLINE_S))
        mine[1].insert(1, ("poison", poison[0], "cas-register", None))
        mine[0].append(("mutex", mutex_h, "mutex", None))
        mine[1].append(("corrupt", bad_head, "cas-register", None))
        mine[2].append(("headline", head, "cas-register", None))

        def fault(pks):
            if any(sig(p) == sig(poison[1]) for p in pks):
                raise MemoryError("injected gang fault")

        cfg = serve.ServeConfig(root=root, batch_max=SERVE_BATCH_MAX,
                                batch_wait_ms=SERVE_WAIT_MS,
                                queue_max=64, tenant_max=16)
        K.reset_launches()
        daemon, server = serve.run_daemon(cfg, port=0)
        port = server.server_port
        posted = {}
        G._GANG_FAULT = fault
        try:
            def post(t):
                for tag, h, model, dl in mine[t]:
                    doc = {"tenant": f"tenant{t}", "model": model,
                           "history": [o.to_dict() for o in h]}
                    if dl is not None:
                        doc["deadline-s"] = dl
                    code, body = http_json(port, "POST", "/check", doc)
                    assert code == 202, (code, body)
                    posted[body["id"]] = (tag, h, model)

            t0 = time.perf_counter()
            threads = [threading.Thread(target=post, args=(t,))
                       for t in range(SERVE_TENANTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
                assert not th.is_alive()
            docs = {}
            while len(docs) < len(posted):
                for rid in posted:
                    if rid not in docs:
                        code, doc = http_json(port, "GET", f"/check/{rid}")
                        if doc["state"] == "done":
                            docs[rid] = (code, doc["result"])
                assert time.perf_counter() - t0 < 600, "serve timed out"
                time.sleep(0.05)
            wall = time.perf_counter() - t0
            serve_launches = dict(K.launches)
            serve_grid_launches = dict(K.grid_launches_total)
            serve_segments = dict(K.segments)
            code, health = http_json(port, "GET", "/healthz")
            assert code == 200
        finally:
            G._GANG_FAULT = None
            http_json(port, "POST", "/drain")
            server.shutdown()
            server.server_close()
            daemon.stop()
        stats = health["stats"]
        print(f"serve launches: {serve_launches} "
              f"cuda_launches={serve_grid_launches} graphs={serve_segments}")
        # the gangs' narrow rungs scan their group starts in K4, whose
        # second of a pair ends it with K5's step
        assert all(serve_launches[k] > 0 for k in (
            "expand", "sort_rows", "dedup_truncate")), serve_launches
        assert serve_segments["pair_ends"] > 0, serve_segments
        assert serve_grid_launches["seg_active"] == 0, serve_grid_launches
        records, _ = journal.read_json_records(
            os.path.join(root, serve.WAL_NAME))
        gangs = {}
        for rec in records:
            if rec.get("event") == "done":
                key = tuple(rec.get("gang") or (rec["id"],))
                gangs[key] = rec["seconds"]
        tags = {rid: posted[rid][0] for rid in posted}
        gang_list = [{"size": len(k), "seconds": v,
                      "members": sorted({tags[r] for r in k})}
                     for k, v in gangs.items()]
        for g in gang_list:
            print(f"serve gang: size={g['size']} seconds={g['seconds']:.4f}"
                  f" members={g['members']}", flush=True)

        # every verdict against the port's serial check of the history
        t1 = time.perf_counter()
        checked = 0
        for rid, (tag, h, model) in posted.items():
            code, res = docs[rid]
            gang = res["serve"].get("gang") or {}
            assert code == (500 if tag == "poison" else 200), (tag, code)
            if tag == "poison":
                assert gang["poison"] is True and gang["size"] > 1, res
                assert res["error-class"] == "oom", res
                continue
            assert gang.get("poison") is not True, (tag, res)
            if tag == "late":
                assert res["error"] == ":info/timeout", res
                assert res["serve"]["timed-out"] is True
                assert gang.get("size", 1) > 1, res
                mates = next(k for k in gangs if rid in k)
                assert all(docs[m][1]["valid"] in (True, False)
                           for m in mates if tags[m] not in (
                               "late", "poison")), "late's mates"
                continue
            want = check_safe(linearizable(
                Mutex() if model == "mutex" else CASRegister(),
                device=dev), {}, History.of(o.to_dict() for o in h))
            assert {k: res.get(k) for k in VERDICT} == {
                k: want.get(k) for k in VERDICT}, (tag, res, want)
            assert res["valid"] is (tag != "corrupt"), (tag, res)
            checked += 1
        assert stats["poisoned"] == 1 and stats["max-batch"] > 1, stats
        serve_line = {
            "requests": len(posted), "tenants": SERVE_TENANTS,
            "wall_s": wall, "requests_per_s": len(posted) / wall,
            "gangs": gang_list, "stats": stats,
            "checked_against_serial": checked,
            "serial_check_s": time.perf_counter() - t1,
            "warm_buckets": health["engine"]["warm-buckets"]}
        print("serve:", json.dumps(serve_line), flush=True)
    return (gang_line, serve_line, serve_launches, serve_grid_launches,
            serve_segments)


def stream_post(port, ops, order=None, close=True, tag=""):
    """Open a stream on the daemon at ``port`` and POST the chunks of
    ``ops`` in ``order`` (chunk indices, all of them in order when None;
    a repeat is a duplicate), with their CRCs; then, with ``close``, wait
    for the online check to catch up and seal the stream. Returns the
    stream id, its chunks, the intake seconds (the first POST to the last
    ack) and the close's ``time.perf_counter()``."""
    from jepsen_tpu_torch.stream import chunk_crc
    code, body = http_json(port, "POST", "/stream",
                           {"tenant": tag, "model": "cas-register"})
    assert code == 202, (code, body)
    sid = body["id"]
    chunks = [ops[i:i + STREAM_CHUNK]
              for i in range(0, len(ops), STREAM_CHUNK)]
    t0 = time.perf_counter()
    for i in range(len(chunks)) if order is None else order:
        code, body = http_json(port, "POST", f"/stream/{sid}/ops",
                               {"seq": i, "ops": chunks[i],
                                "crc": chunk_crc(chunks[i])})
        assert code == 202, (tag, i, code, body)
    intake = time.perf_counter() - t0
    if close:
        stream_idle(port, sid)
        code, body = http_json(port, "POST", f"/stream/{sid}/close",
                               {"chunks": len(chunks)})
        assert code == 200, (tag, code, body)
    return sid, chunks, intake


def stream_idle(port, sid, timeout=120.0, quiet=3):
    """Wait until the stream's checked prefix and level have not moved for
    ``quiet`` polls 50 ms apart (a live client's close comes long after
    its last op; this one's comes once the online check is idle)."""
    t0 = time.perf_counter()
    last, still = None, 0
    while time.perf_counter() - t0 < timeout:
        code, doc = http_json(port, "GET", f"/stream/{sid}")
        key = (doc["checked-events"], doc["checked-level"])
        if doc["state"] != "open":
            return doc
        still = still + 1 if key == last and key[1] > 0 else 0
        if still >= quiet:
            return doc
        last = key
        time.sleep(0.05)
    raise AssertionError(f"stream {sid} never went idle: {doc}")


def stream_wait(port, root, sid, timeout=300.0):
    """The stream's status once done, and the seconds from its seal to its
    verdict as the daemon journaled them."""
    from jepsen_tpu_torch import journal
    from jepsen_tpu_torch import stream as stream_ns
    t0 = time.perf_counter()
    while True:
        code, doc = http_json(port, "GET", f"/stream/{sid}")
        assert code == 200, (code, doc)
        if doc["state"] == "done" and doc.get("result"):
            break
        assert time.perf_counter() - t0 < timeout, doc
        time.sleep(0.01)
    records, _ = journal.read_json_records(os.path.join(
        root, "streams", sid, stream_ns.WAL_NAME))
    return doc, [r for r in records if r["event"] == "verdict"][-1][
        "seconds"]


def stream_lockstep(stream_ns):
    """The stream runner fed one chunk of the scripted sizes at a time,
    each once its search is idle, so that two runs take the same barriers
    whatever the threads' timing."""

    class Lockstep(stream_ns.StreamRunner):
        def __init__(self, *a, sizes=(), **kw):
            super().__init__(*a, **kw)
            self._sizes = list(sizes)

        def _poll(self):
            if self._work_pending():
                return [], False
            s = self.session
            with s.cond:
                if self._sizes:
                    k = self._sizes.pop(0)
                    new = list(s.ops[self._fed:self._fed + k])
                    self._fed += len(new)
                    return new, False
                new = list(s.ops[self._fed:])
                self._fed += len(new)
                return new, s.state != "open"

    return Lockstep


def stream_phases(dev, seconds, head, smi):
    """The streaming path: the daemon on port 0 on CUDA, histories POSTed
    to its /stream routes (see STREAM_FREE), each verdict against the
    offline check of the same history on the card; a daemon killed after a
    checkpoint and a new one resuming its stream; and a stream on the
    kernels against the same stream on their plain versions. Returns the
    stream line, the kernels' launch counts and CUDA launches on the
    stream path, and its segment counts."""
    import shutil
    from jepsen_tpu_torch import resilience, serve
    from jepsen_tpu_torch import stream as stream_ns
    from jepsen_tpu_torch import testing
    from jepsen_tpu_torch.checker import check_safe
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.kernels import search as K
    from jepsen_tpu_torch.models import CASRegister

    def bounded(res, want, tag):
        """The stream's verdict equals the offline check's; its levels are
        the offline search's plus at most one a barrier (a barrier where
        the search was done, followed by a forced op, costs a level in the
        reference's online check as here)."""
        for k in ("valid", "max-linearized-prefix", "final-states",
                  "frontier-op"):
            assert res.get(k) == want.get(k), (tag, k, res, want)
        extra = res["levels"] - want["levels"]
        assert 0 <= extra <= res["stream"]["barriers"], (tag, res, want)
        return extra

    with phase("stream", seconds):
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "store", "stream-smoke")
        shutil.rmtree(root, ignore_errors=True)
        free = testing.simulate_register_history(**STREAM_FREE)
        bad = testing.corrupt_model_history(head, "cas-register")
        hist = {"free": free, "head": head, "bad": bad}
        ops = {k: [o.to_dict() for o in h] for k, h in hist.items()}
        checker = linearizable(CASRegister(), device=dev)
        offline, offline_s = {}, {}
        for tag, h in hist.items():
            offline[tag] = check_safe(checker, {}, h)
            gc.collect()
            t0 = time.perf_counter()
            again = check_safe(checker, {}, h)
            offline_s[tag] = time.perf_counter() - t0
            assert again["levels"] == offline[tag]["levels"], tag
        assert offline["free"]["valid"] is True
        assert offline["head"]["valid"] is True
        assert offline["bad"]["valid"] is False
        first_info = next(i for i, o in enumerate(ops["head"])
                          if o["type"] == "info")

        K.reset_launches()
        cfg = serve.ServeConfig(root=root, device=(
            None if dev.type == "cuda" else "cpu"))
        daemon, server = serve.run_daemon(cfg, port=0)
        port = server.server_port
        lines, results, before = {}, {}, dict(K.launches)
        try:
            def account(tag, res, intake, close_s, n):
                st = res["stream"]
                now = dict(K.launches)
                lines[tag] = {
                    "ops": n, "valid": res["valid"],
                    "levels": res["levels"],
                    "offline_levels": offline[tag]["levels"],
                    "watermark": st["watermark"],
                    "barriers": st["barriers"], "rebases": st["rebases"],
                    "segments": st["segments"], "captures": st["captures"],
                    "close_level": st["close-level"],
                    "failed_fast": st["failed-fast"],
                    "close_to_verdict_s": close_s,
                    "offline_warm_s": offline_s[tag],
                    "intake_ops_per_s": n / intake,
                    "launches": {k: now[k] - before[k]
                                 for k in STREAM_KERNELS}}
                before.update(now)
                results[tag] = res
                print(f"stream {tag}: {json.dumps(lines[tag])}", flush=True)

            # the crash-free history: chunk 2 before chunk 1, then chunk 1
            # again
            n = -(-len(ops["free"]) // STREAM_CHUNK)
            order = [0, 2, 1, 1] + list(range(3, n))
            sid, chunks, intake = stream_post(port, ops["free"], order,
                                                 tag="free")
            doc, close_s = stream_wait(port, root, sid)
            res = doc["result"]
            assert res["stream"]["dup-chunks"] == 1
            assert res["stream"]["reordered"] == 1
            assert res["stream"]["watermark"] == len(ops["free"])
            # checked online: the close found a carry deep in the search
            assert res["stream"]["barriers"] >= 2, res["stream"]
            assert res["stream"]["close-level"] > 0, res["stream"]
            bounded(res, offline["free"], "free")
            account("free", res, intake, close_s, len(ops["free"]))

            # the headline: its first crash pins the watermark
            sid, chunks, intake = stream_post(port, ops["head"],
                                                 tag="head")
            doc, close_s = stream_wait(port, root, sid)
            res = doc["result"]
            assert res["stream"]["rebases"] == [], res["stream"]
            assert res["stream"]["close-level"] is not None
            assert res["crash-width"] > 0
            bounded(res, offline["head"], "head")
            account("head", res, intake, close_s, len(ops["head"]))
            lines["head"]["first_info_event"] = first_info

            # the corrupted headline: refuted before its last chunk is
            # sent, which then answers 409
            sid, chunks, _ = stream_post(port, ops["bad"], [],
                                            close=False, tag="bad")
            t0 = time.perf_counter()
            sent = 0
            for i in range(len(chunks) - 1):
                code, body = http_json(port, "POST", f"/stream/{sid}/ops",
                                       {"seq": i, "ops": chunks[i]})
                if code == 409 and body["error"] == "stream-failed":
                    break
                assert code == 202, (code, body)
                sent += 1
            intake = time.perf_counter() - t0
            doc, _ = stream_wait(port, root, sid)
            res = doc["result"]
            code, body = http_json(port, "POST", f"/stream/{sid}/ops",
                                   {"seq": len(chunks) - 1,
                                    "ops": chunks[-1]})
            assert code == 409 and body["error"] == "stream-failed", body
            assert res["valid"] is False and res["stream"]["failed-fast"]
            assert res["stream"]["watermark"] < len(ops["bad"])
            for k in ("max-linearized-prefix", "final-states",
                      "frontier-op"):
                assert res.get(k) == offline["bad"].get(k), (k, res)
            account("bad", res, intake, None,
                    sum(len(c) for c in chunks[:max(sent, 1)]))
            lines["bad"]["chunks_sent"] = sent

            # a kill after a checkpoint at level > 0, then a new daemon
            sid, chunks, intake = stream_post(
                port, ops["free"], range(STREAM_KILL_AFTER), close=False,
                tag="kill")
            cp_path = os.path.join(root, "streams", sid,
                                   stream_ns.CHECKPOINT_NAME)
            stream_idle(port, sid)
        finally:
            http_json(port, "POST", "/drain")
            server.shutdown()
            server.server_close()
            daemon.stop()
        # the kill: the daemon stopped its runner, leaving the WAL and the
        # last checkpoint
        cp = resilience.Checkpoint.load(cp_path)
        assert cp.level > 0 and cp.n_required > 0, cp.level
        daemon, server = serve.run_daemon(cfg, port=0)
        port = server.server_port
        try:
            assert daemon.replay_stats["streams-resumed"] == 1
            t0 = time.perf_counter()
            for i in range(STREAM_KILL_AFTER, len(chunks)):
                code, body = http_json(port, "POST", f"/stream/{sid}/ops",
                                       {"seq": i, "ops": chunks[i]})
                assert code == 202, (code, body)
            intake += time.perf_counter() - t0
            stream_idle(port, sid)
            code, body = http_json(port, "POST", f"/stream/{sid}/close",
                                   {"chunks": len(chunks)})
            assert code == 200, body
            doc, close_s = stream_wait(port, root, sid)
            res = doc["result"]
            assert res["stream"]["resume-level"] == cp.level > 0, res
            offline["kill"], offline_s["kill"] = (offline["free"],
                                                  offline_s["free"])
            bounded(res, offline["kill"], "kill")
            account("kill", res, intake, close_s, len(ops["free"]))
            lines["kill"]["resume_level"] = cp.level
            lines["kill"]["checkpoint_n_required"] = cp.n_required
            code, health = http_json(port, "GET", "/healthz")
            assert health["streams"]["sessions"] == health["streams"][
                "done"] == 4, health["streams"]
        finally:
            http_json(port, "POST", "/drain")
            server.shutdown()
            server.server_close()
            daemon.stop()
        launches = dict(K.launches)
        grid = dict(K.grid_launches_total)
        segs = dict(K.segments)
        assert all(launches[k] > 0 for k in (
            "expand", "sort_rows", "dedup_truncate")), launches
        assert segs["pair_ends"] > 0 and grid["seg_active"] == 0, segs
        print(f"stream launches: {launches} cuda_launches={grid} "
              f"graphs={segs}", flush=True)

    with phase("stream plain", seconds):
        # the same lock-step stream on the kernels and on their plain
        # versions, on the card: equal results
        small = ops["free"][:STREAM_PLAIN_OPS]
        sizes = [len(small[i:i + STREAM_PLAIN_CHUNK])
                 for i in range(0, len(small), STREAM_PLAIN_CHUNK)]
        plain = {}
        for name, step_ops in (("kernels", G.KERNELS), ("plain", G.PLAIN)):
            sess = stream_ns.StreamSession(name, "t", "cas-register",
                                           os.path.join(root, "lockstep"))
            sess.append(0, small)
            sess.close(1)
            runner = stream_lockstep(stream_ns)(
                sess, CASRegister(), device=dev, ops=step_ops, sizes=sizes)
            t0 = time.perf_counter()
            runner.start()
            runner.join(300)
            assert sess.state == "done", sess.status()
            sess.stop_wal()
            plain[name] = dict(sess.result, wall_s=time.perf_counter() - t0)
        fields = ("valid", "levels", "max-linearized-prefix",
                  "final-states", "rung", "segments")
        a = {k: plain["kernels"].get(k) for k in fields}
        b = {k: plain["plain"].get(k) for k in fields}
        assert a == b, (a, b)
        for k in ("watermark", "barriers", "rebases"):
            assert plain["kernels"]["stream"][k] == \
                plain["plain"]["stream"][k], k
        want = check_safe(linearizable(CASRegister(), device=dev), {},
                          History.of(small))
        extra = bounded(plain["kernels"], want, "lockstep")
        plain_line = {"ops": len(small), "chunk": STREAM_PLAIN_CHUNK,
                      "levels": a["levels"], "offline_levels":
                      want["levels"], "extra_levels": extra,
                      "barriers": plain["kernels"]["stream"]["barriers"],
                      "kernels_s": plain["kernels"]["wall_s"],
                      "plain_s": plain["plain"]["wall_s"]}
        print(f"stream plain: {json.dumps(plain_line)}", flush=True)
    line = {"streams": lines, "lockstep": plain_line, "nvidia_smi": smi,
            "chunk": STREAM_CHUNK}
    print("stream:", json.dumps(line), flush=True)
    return line, launches, grid, segs


def cpu_model() -> str:
    """The host CPU as /proc/cpuinfo's first processor names it (model
    name, vendor, family and model numbers; lscpu's model name where
    /proc/cpuinfo has none) and its count of logical CPUs."""
    info = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    name = info.get("model name")
    if name in (None, "", "unknown"):
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
            name = next((line.split(":", 1)[1].strip()
                         for line in out.splitlines()
                         if line.startswith("Model name")), name)
        except (OSError, subprocess.SubprocessError):
            pass
    ids = " ".join(f"{k}={info[k]}" for k in ("vendor_id", "cpu family",
                                              "model", "stepping")
                   if k in info)
    return f"{name or 'unknown'} ({ids}) x{os.cpu_count()}"


def host_engine_phases(dev, seconds, head, head_warm_s, etcd, invalid):
    """The host engines behind the facade on the card's host: the native
    engine built and answering the headline beside the device's warm
    seconds, the corrupted headline and the etcd batch on both, a race,
    the device's UNKNOWN routed to the native engine, and linear.svg.
    Returns the phase's JSON line."""
    import tempfile
    from jepsen_tpu_torch import independent, native, testing
    from jepsen_tpu_torch.checker import native as N
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.kernels import search as K
    from jepsen_tpu_torch.models import CASRegister, SetModel
    from jepsen_tpu_torch.ops.encode import pack_with_init
    from jepsen_tpu_torch.testing import (keyed_history,
                                          simulate_register_history)

    etcd_hs, etcd_out, etcd_wall, etcd_batches = etcd
    with phase("host engines", seconds):
        # the facades built above already loaded the engine: time a build
        # of the same source into a scratch directory
        assert N.available(), "the native engine did not build"
        build_dir = native.BUILD_DIR
        with tempfile.TemporaryDirectory() as d:
            native.BUILD_DIR = d
            try:
                t0 = time.perf_counter()
                assert native.build("wgl_engine") is not None
                build_s = time.perf_counter() - t0
            finally:
                native.BUILD_DIR = build_dir
        path = os.path.relpath(N.library_path())
        assert path.startswith("jepsen_tpu_torch" + os.sep), path
        host = linearizable(CASRegister(), backend="cpu")
        assert host.algorithm == "native", host.algorithm
        device = linearizable(CASRegister(), device=dev)

        def timed(fn, reps=1):
            times, out = [], None
            for _ in range(reps):
                t0 = time.perf_counter()
                out = fn()
                times.append(time.perf_counter() - t0)
            return out, statistics.median(times), times

        # the headline: the facade (packing included, as the device's
        # warm seconds include it) and the engine call alone
        r, native_s, native_times = timed(lambda: host.check({}, head),
                                          HOST_REPS)
        assert r["valid"] is True and r["engine"] == "native", r
        packed, kernel = pack_with_init(head, CASRegister())
        _, engine_s, _ = timed(lambda: N.check_packed_native(packed, kernel),
                               HOST_REPS)
        cpu = cpu_model()
        line = {"card": nvidia_smi(), "cpu": cpu, "build_s": build_s,
                "library": path,
                "headline": {"native_s": native_s,
                             "native_runs_s": native_times,
                             "native_engine_only_s": engine_s,
                             "device_warm_s": head_warm_s,
                             "device_over_native": head_warm_s / native_s,
                             "configs_explored": r["configs-explored"]}}
        print(f"host engines: headline native_s={native_s:.4f} (engine "
              f"alone {engine_s:.4f}) device_warm_s={head_warm_s:.4f} "
              f"device/native={head_warm_s / native_s:.2f} "
              f"card={line['card']!r} cpu={cpu!r}", flush=True)

        # the corrupted headline on both
        bad = testing.corrupt_model_history(head, "cas-register")
        rd, dev_s, _ = timed(lambda: device.check({}, bad), HOST_REPS)
        rn, nat_s, _ = timed(lambda: host.check({}, bad), HOST_REPS)
        assert rd["valid"] is rn["valid"] is False, (rd, rn)
        assert rd["max-linearized-prefix"] == rn["max-linearized-prefix"]
        line["corrupt_headline"] = {
            "device_s": dev_s, "native_s": nat_s,
            "max_linearized_prefix": rn["max-linearized-prefix"]}

        # the race on a 2,000-op history, against the device's verdict
        h2k = simulate_register_history(seed=SERVE_SEED, **SERVE)
        race = linearizable(CASRegister(), backend="cpu",
                            algorithm="competition")
        rc, race_s, _ = timed(lambda: race.check({}, h2k))
        assert rc["valid"] is device.check({}, h2k)["valid"] is True, rc
        line["competition"] = {"seconds": race_s,
                               "winner": rc["algorithm"]}

        # histories the device leaves UNKNOWN: its host fallback is the
        # native engine, after K1-K4 ran
        routed = {}
        for tag, h, model, want in (
                ("far-write", testing.far_write_history(130, 7),
                 CASRegister(), FAR_WRITE_REFERENCE[7]),
                ("far-write-bad", testing.far_write_history(130, 8),
                 CASRegister(), FAR_WRITE_REFERENCE[8]),
                ("set-lost-add", testing.simulate_set_history(**LOST_ADD),
                 SetModel(), LOST_ADD_REFERENCE)):
            K.reset_launches()
            ru, u_s, _ = timed(lambda: linearizable(
                model, device=dev).check({}, h))
            launched = dict(K.launches)
            assert all(launched[k] > 0 for k in (
                "expand", "sort_rows", "dedup_truncate")), (tag, launched)
            assert ru["fallback-from"] == "gpu", (tag, ru)
            assert ru["engine"] == "native", (tag, ru)
            assert {k: ru.get(k) for k in want} == want, (tag, ru, want)
            routed[tag] = {"seconds": u_s, "launches": launched,
                           "fallback_reason": ru["fallback-reason"],
                           "valid": ru["valid"]}
            print(f"host engines: {tag} valid={ru['valid']} "
                  f"reason={ru['fallback-reason']!r} launches={launched} "
                  f"({u_s:.2f} s)", flush=True)
        line["device_unknown"] = routed

        # the etcd-shaped batch, key by key against the device's run: the
        # engine over the split keys, and the keyed checker on both routes
        # over the [k v] history, warm
        rk, keyed_s, _ = timed(lambda: N.check_keyed_native(
            etcd_hs, CASRegister()), HOST_REPS)
        verdicts = {k: r["valid"] for k, r in etcd_out["results"].items()}
        assert rk["valid"] is etcd_out["valid"] is False
        assert {k: r["valid"] for k, r in rk["results"].items()} == verdicts
        kh = keyed_history(etcd_hs)
        by = {}
        for tag, chk in (("device", device), ("native", host)):
            out, by[tag], _ = timed(lambda: independent.checker(chk).check(
                {}, kh), HOST_REPS)
            assert {k: r["valid"] for k, r in out["results"].items()} == \
                verdicts, tag
        assert all(r["engine"] == "native" for r in out["results"].values())
        line["etcd"] = {"native_engine_s": keyed_s,
                        "native_keyed_checker_s": by["native"],
                        "device_keyed_checker_s": by["device"],
                        "device_first_run_wall_s": etcd_wall,
                        "device_first_run_batch_s": sum(
                            b["seconds"] for b in etcd_batches)}
        print(f"host engines: etcd native_keyed_s={by['native']:.4f} "
              f"device_keyed_s={by['device']:.4f} (engine over the split "
              f"keys {keyed_s:.4f})", flush=True)

        # an invalid history with a store-dir: linear.svg, on both routes
        with tempfile.TemporaryDirectory() as d:
            for tag, chk in (("device", device), ("native", host)):
                store = os.path.join(d, tag)
                ri = chk.check({"store-dir": store}, invalid)
                assert ri["valid"] is False, (tag, ri)
                assert ri["counterexample"] == "linear.svg", (tag, ri)
                assert os.path.getsize(os.path.join(store,
                                                    "linear.svg")) > 0
                assert ri["final-path"] and ri["configs"], (tag, ri)
        print("host engines:", json.dumps(line), flush=True)
    return line


def plan_phase(dev, seconds, head_p, head_kernel, r, states):
    """The plan gate on the card: the headline's ``plan`` entry, each
    state's footprint against what a fresh engine allocates, a pool seeded
    under a pinned byte budget, and an explicit rung rejected before any
    allocation. ``states`` maps a tag to the LevelShape of a state the
    kernels ran at. Returns the phase's JSON entry."""
    from jepsen_tpu_torch.analysis.plan_lint import PlanRejectedError
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.checker import plan
    from jepsen_tpu_torch.checker.engine import Engine, default_engine
    from jepsen_tpu_torch.kernels import search as K
    line = {}
    with phase("plan", seconds):
        total = torch.cuda.mem_get_info(dev)[1]
        entry = r["plan"]
        print(f"plan: headline {json.dumps(entry)} card_bytes={total}")
        assert entry["selected"] == "segment 128/32/8 @8192+16", entry
        assert entry["bytes-limit"] == total and not entry["rejected"], entry
        line["headline"] = entry

        # each footprint against a fresh engine's allocation
        line["footprints"] = {}
        for tag, shape in states.items():
            cand = plan.Candidate("batch" if shape.B > 1 else "segment",
                                  shape.C, shape.W, shape.E, shape.n,
                                  shape.CR, keys=shape.B,
                                  tiebreak=shape.tiebreak)
            fp = plan.footprint(cand)
            cols = {c: np.zeros((shape.B, shape.n + 1 if c == "sm" else
                                 shape.n if c in K.COLS[:8] else shape.CR),
                                np.int32) for c in K.COLS}
            cols["nr"] = np.zeros(shape.B, np.int32)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            a0 = torch.cuda.memory_allocated(dev)
            q0 = torch.cuda.memory_stats(dev).get(
                "requested_bytes.all.current")
            eng = Engine()
            eng.state(shape, dev)
            eng.batch_cols(cols, dev, copy=False)
            grown = torch.cuda.memory_allocated(dev) - a0
            q1 = torch.cuda.memory_stats(dev).get(
                "requested_bytes.all.current")
            requested = None if q0 is None else q1 - q0
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            line["footprints"][tag] = {
                "label": cand.label(), "footprint": fp,
                "memory_allocated_growth": grown,
                "requested_bytes_growth": requested}
            print(f"plan: {tag} {cand.label()} footprint={fp} "
                  f"memory_allocated_growth={grown} "
                  f"requested_bytes_growth={requested}")
            assert grown == fp["allocated-bytes"], (tag, grown, fp)
            assert requested in (None, fp["total-bytes"]), (tag, requested)

        # the gate's host cost a check (the supervisor's own call)
        wneed = G._window_needed(head_p)
        ladder = G._ladder_for(wneed, dev)
        t0 = time.perf_counter()
        for _ in range(PLAN_GATE_REPS):
            plan.gate_ladder(plan.PlanDims.from_packed(head_p, wneed),
                             head_kernel, ladder, kind="segment",
                             explicit=False, derate=True, device=dev)
        line["gate_us"] = (time.perf_counter() - t0) / PLAN_GATE_REPS * 1e6
        print(f"plan: gate_us={line['gate_us']:.1f} (PlanDims and "
              f"gate_ladder over {len(ladder)} rungs, mean of "
              f"{PLAN_GATE_REPS})")

        # a byte budget between the first rung's footprint and its half's
        # seeds the pool at the half
        n, cr = states["headline"].n, states["headline"].CR

        def fp_at(cap, exp):
            return plan.footprint(plan.Candidate("segment", cap, 32, exp, n,
                                                 cr))["total-bytes"]

        limit = (fp_at(128, 8) + fp_at(64, 4)) // 2
        os.environ["JTPU_PLAN_BYTES_LIMIT"] = str(limit)
        try:
            seeded = G.check_packed_gpu(head_p, head_kernel, device=dev)
        finally:
            del os.environ["JTPU_PLAN_BYTES_LIMIT"]
        explicit = G.check_packed_gpu(head_p, head_kernel, capacity=64,
                                      expand=4, device=dev)
        seeds = [a["outcome"] for a in seeded["attempts"]
                 if a.get("event") == "plan"]
        line["seeded"] = {"limit": limit, "seeds": seeds,
                          "valid": seeded["valid"],
                          "levels": seeded["levels"],
                          "rung": seeded["rung"],
                          "explicit_valid": explicit["valid"],
                          "explicit_levels": explicit["levels"]}
        print(f"plan: seeded {json.dumps(line['seeded'], default=str)}")
        assert seeds and seeds[0] == "plan-seeded-pool-64", seeds
        assert (seeded["valid"], seeded["levels"]) == (
            explicit["valid"], explicit["levels"])

        # an explicit rung that cannot fit: rejected before any allocation
        eng = default_engine()
        buckets = len(eng._states)
        torch.cuda.synchronize()
        a0 = torch.cuda.memory_allocated(dev)
        cap, win, exp = PLAN_OOM_RUNG
        os.environ["JTPU_PLAN_BYTES_LIMIT"] = str(PLAN_OOM_LIMIT)
        try:
            G.check_packed_gpu(head_p, head_kernel, capacity=cap,
                               window=win, expand=exp, device=dev)
            raise AssertionError("the oversized rung was not rejected")
        except PlanRejectedError as e:
            rejected = str(e)
        finally:
            del os.environ["JTPU_PLAN_BYTES_LIMIT"]
        print(f"plan: {rejected}")
        assert "PLAN-OOM" in rejected
        assert len(eng._states) == buckets
        assert torch.cuda.memory_allocated(dev) == a0
        line["rejected"] = rejected
    return line


#: warm headlines a mode, in turns: tracing on, off, and JTPU_PROF=1
TELEMETRY_TURNS = 5
#: the headline's K1, K2 and K4, as the profile names their kernels
PROFILE_KERNELS = ("expand_kernel", "sort_tile_kernel", "dedup_block_kernel")
#: a graph launch of this many levels at the headline state, timed with
#: CUDA events against the profile's attributed kernel time
TELEMETRY_LEVELS = 512


def telemetry_phase(dev, seconds, checker, head, r, head_cols, dwide):
    """The device path's telemetry: the headline traced and untraced (the
    same verdict and levels), the search counters against the result,
    the ``cost`` entry against the model the kernel bounds read, K4
    without its stats buffer against its plain version bit for bit (and
    the stats-off segment graph against the stats-on one) at the
    headline and dwide states, a ``JTPU_PROF=1`` capture whose kernels
    sit under ``checker.segment`` spans (or a counted, sticky refusal),
    the daemon's ``/metrics`` families, the CUDA-init probe, and the warm
    headline's medians with tracing on, off and profiled, in turns."""
    import shutil
    import tempfile
    import urllib.request
    from jepsen_tpu_torch import accel, interop, obs, serve
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.kernels import cost as kcost
    from jepsen_tpu_torch.kernels import parity
    from jepsen_tpu_torch.kernels import search as K
    from jepsen_tpu_torch.obs import metrics as obs_metrics
    from jepsen_tpu_torch.obs import profiler
    line = {}
    with phase("telemetry", seconds):
        # -- traced against untraced -------------------------------------
        lv0 = G._LEVELS_TOTAL.value()
        sg0 = G._SEGMENTS_TOTAL.value()
        on = checker.check({}, head)
        assert G._LEVELS_TOTAL.value() - lv0 == on["levels"]
        assert G._SEGMENTS_TOTAL.value() - sg0 == on["segments"]
        os.environ["JTPU_TRACE"] = "0"
        try:
            off = checker.check({}, head)
        finally:
            os.environ.pop("JTPU_TRACE")
        assert (off["valid"], off["levels"]) == (on["valid"], on["levels"])
        assert "searchstats" not in off and "cost" not in off
        assert on["searchstats"]["levels"] == on["levels"]
        print(f"telemetry: traced valid={on['valid']} levels={on['levels']}"
              f" segments={on['segments']} device-s={on['device-s']} "
              f"segment-levels={on['segment-levels']} frontier-hwm="
              f"{on['frontier-hwm']} transfer-bytes={on['transfer-bytes']}"
              f"; untraced levels={off['levels']}", flush=True)
        # -- the cost entry is the model the kernel bounds read ----------
        rung = tuple(on["rung"])
        shape = K.LevelShape(C=rung[0], W=rung[1],
                             E=min(rung[2] or rung[0], rung[0]),
                             n=head_cols["f"].shape[0],
                             CR=head_cols["cf"].shape[0])
        assert on["cost"] == [kcost.cost_entry("segment", rung, shape,
                                               on["levels"])], on["cost"]
        stages = kcost.level_cost(shape)
        lv = parity.Level(head_cols, HEADLINE_RUNG, dev)
        lv.advance(HEADLINE_WARM_LEVELS)
        bounds = {}
        add_bounds_out = {n: {} for n in ("expand", "sort_rows",
                                          "dedup_truncate")}
        add_bounds(add_bounds_out, lv)
        assert add_bounds_out["sort_rows"]["bytes"] == stages["sort"][0]
        assert add_bounds_out["sort_rows"]["ops"] == stages["sort"][1]
        assert add_bounds_out["expand"]["ops"] == stages["expand"][1]
        assert add_bounds_out["dedup_truncate"]["ops"] == (
            stages["dedup"][1] + stages["group_starts"][1])
        for n, b in add_bounds_out.items():
            bounds[n] = {k: b[k] for k in ("bytes", "ops", "bound_ms")}
        print(f"telemetry: cost={on['cost'][0]} bounds={bounds}",
              flush=True)
        line["cost"] = on["cost"][0]
        # -- K4 with stats off, bit for bit ------------------------------
        k4 = {}
        for tag, level in (("headline", lv), ("dwide", dwide)):
            off_lv = level.without_stats()
            errs = {name: err for name, _, _, _, err in off_lv.walk()}
            pair_err, _ = off_lv.pair_end(SEG_CASES)
            assert all(e == 0 for e in errs.values()), (tag, errs)
            assert pair_err == 0, (tag, pair_err)
            # a segment graph over the stats-off buffers against the
            # stats-on one from the same state
            ends = []
            for lvl in (level, off_lv):
                c, sc = parity.copy_state(lvl.carry, lvl.scratch)
                words, graph = G.run_segment(lvl.cols, c, sc, lvl.shape,
                                             lvl.nr, 64, G.KERNELS)
                G.end_segment(c, lvl.shape, words, graph)
                ends.append(interop.batch_carry_to_numpy(c)[:13])
            assert carries_equal(*ends), tag
            k4[tag] = {"max_abs_err": max(errs.values()),
                       "pair_end_err": pair_err, "graph": "equal"}
        print(f"telemetry: K4 stats off {k4}", flush=True)
        line["k4_stats_off"] = k4
        # -- a torch.profiler capture of the segment graphs --------------
        run_dir = tempfile.mkdtemp(prefix="jtpu-prof-")
        os.environ["JTPU_PROF"] = "1"
        try:
            obs.start_run(run_dir)
            pr = checker.check({}, head)
            obs.finish_run()
        finally:
            os.environ.pop("JTPU_PROF")
        assert (pr["valid"], pr["levels"]) == (on["valid"], on["levels"])
        refusal = profiler.failure()
        if refusal is not None:
            failed = obs_metrics.REGISTRY.counter(
                "jtpu_prof_captures_total").value(outcome="failed")
            assert failed >= 1
            assert not profiler.find_traces(profiler.profile_dir(run_dir))
            print(f"telemetry: the profiler REFUSED the capture "
                  f"(counted {failed:.0f}, sticky): {refusal}", flush=True)
            line["profile"] = {"refused": refusal}
        else:
            merged, mstats = profiler.merged_records(run_dir)
            segs = {x["sid"]: x for x in merged
                    if x["name"] == "checker.segment"}
            under = [x for x in merged if x.get("track") == "device"
                     and x.get("pid") in segs]
            names = {x["name"] for x in under}
            for k in PROFILE_KERNELS:
                assert any(k in nm for nm in names), (k, sorted(names))
            rows = profiler.segment_kernel_times(merged)
            # the graph's nodes (K1, K2, K4), apart from PyTorch's own
            # kernels and copies at each segment's end
            attributed, other = {}, {}
            for row in rows:
                into = attributed if row["graph"] else other
                into[row["name"]] = into.get(row["name"], 0.0) + row["ns"]
            how = sorted({row["attribution"] for row in rows
                          if row["graph"]})
            recorded = sum(row["records"] for row in rows if row["graph"])
            assert recorded > 0 or dev.type != "cuda", "no graph node"
            body = sorted({int(sp.get("body") or 0)
                           for sp in segs.values()})
            # CUDA events around one graph launch of TELEMETRY_LEVELS
            # levels at the headline state
            c, sc = parity.copy_state(lv.carry, lv.scratch)
            G.run_segment(lv.cols, c, sc, lv.shape, lv.nr, 64, G.KERNELS)
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            words, graph = G.run_segment(lv.cols, c, sc, lv.shape, lv.nr,
                                         TELEMETRY_LEVELS, G.KERNELS)
            e1.record()
            run = G.end_segment(c, lv.shape, words, graph)[0]
            event_ms_level = e0.elapsed_time(e1) / run
            attr_ms_level = sum(attributed.values()) / 1e6 / pr["levels"]
            seg_host_ms = sum(sp["dur"] for sp in segs.values()) / 1e6
            print(f"telemetry: profile files={mstats['profile-files']} "
                  f"device records={mstats['device']} under segments="
                  f"{len(under)} graph-node records={recorded} "
                  f"body={body} segments={len(segs)} "
                  f"levels={pr['levels']} attribution={how}", flush=True)
            for nm, ns in sorted(attributed.items(), key=lambda t: -t[1]):
                print(f"  attributed {ns / 1e6:10.3f} ms  {nm[:90]}")
            print(f"  outside the graph {sum(other.values()) / 1e6:.3f} ms "
                  f"in {len(other)} kernel names")
            print(f"telemetry: attributed kernel ms a level "
                  f"{attr_ms_level:.5f} against CUDA events "
                  f"{event_ms_level:.5f} (one {run}-level graph launch); "
                  f"segment spans {seg_host_ms:.3f} ms host", flush=True)
            line["profile"] = {
                "records": recorded, "under_segments": len(under),
                "body": body, "attribution": how,
                "attributed_ms_per_level": attr_ms_level,
                "event_ms_per_level": event_ms_level,
                "segment_host_ms": seg_host_ms,
                "kernels_ms": {nm: ns / 1e6
                               for nm, ns in attributed.items()},
                "outside_graph_ms": sum(other.values()) / 1e6}
        shutil.rmtree(run_dir, ignore_errors=True)
        # -- the daemon's /metrics ---------------------------------------
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "store", "telemetry-smoke")
        shutil.rmtree(root, ignore_errors=True)
        daemon, server = serve.run_daemon(serve.ServeConfig(
            root=root, device=None if dev.type == "cuda" else "cpu"),
            port=0)
        try:
            port = server.server_port
            code, body = http_json(port, "POST", "/check", {
                "tenant": "t", "model": "cas-register",
                "history": [o.to_dict() for o in head]})
            assert code == 202, body
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline:
                code, doc = http_json(port, "GET", f"/check/{body['id']}")
                if doc.get("state") == "done":
                    break
                time.sleep(0.1)
            assert doc["result"]["valid"] is True, doc
            phases = doc["result"]["serve"]["phases"]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=60) as resp:
                text = resp.read().decode()
            families = sorted({ln.split()[2] for ln in text.splitlines()
                               if ln.startswith("# TYPE ")})
            for prefix in ("jtpu_device_", "jtpu_search_", "jtpu_engine_"):
                assert any(f.startswith(prefix) for f in families), prefix
            print(f"telemetry: /metrics {len(families)} families, "
                  f"{len(text)} bytes; phases={phases}", flush=True)
            line["metrics_families"] = len(families)
        finally:
            server.shutdown()
            server.server_close()
            daemon.stop()
        # -- the CUDA-init probe -----------------------------------------
        t0 = time.perf_counter()
        probed = accel._spawn_probe(accel._probe_timeout())
        probe_s = time.perf_counter() - t0
        assert probed == "cuda" and accel.probe_default_backend() == "cuda"
        print(f"telemetry: CUDA-init probe child -> {probed} in "
              f"{probe_s:.2f} s", flush=True)
        line["probe_s"] = probe_s
        # -- the warm headline: tracing on, off, profiled, in turns ------
        times = {"on": [], "off": [], "prof": []}
        for _ in range(TELEMETRY_TURNS):
            for mode in times:
                env = {"off": {"JTPU_TRACE": "0"},
                       "prof": {"JTPU_PROF": "1"}}.get(mode, {})
                os.environ.update(env)
                run_dir = tempfile.mkdtemp(prefix="jtpu-turn-")
                try:
                    if mode == "prof":
                        obs.start_run(run_dir)
                    gc.collect()
                    t0 = time.perf_counter()
                    res = checker.check({}, head)
                    times[mode].append(time.perf_counter() - t0)
                    if mode == "prof":
                        obs.finish_run()
                finally:
                    for k in env:
                        os.environ.pop(k)
                    shutil.rmtree(run_dir, ignore_errors=True)
                assert res["levels"] == on["levels"], mode
        med = {m: statistics.median(v) for m, v in times.items()}
        print(f"telemetry: warm headline medians of {TELEMETRY_TURNS} in "
              f"turns: traced {med['on']:.4f} s, untraced "
              f"{med['off']:.4f} s, profiled {med['prof']:.4f} s; "
              f"all {json.dumps(times)}", flush=True)
        line["warm_s"] = med
        line["warm_s_all"] = times
    return line


#: the runner's atom test: the headline's width through ``core.run``
#: (10,000 ops of ``gen.cas_gen()`` at concurrency 5, about 20,000 events)
RUNNER_OPS = 10000
#: the atom run whose history is checked on the kernels and on the plain
#: route (``device="cpu"``), valid and with one read corrupted
RUNNER_PLAIN_OPS = 2000
#: the safe local-kv run: three kvnode daemons, hammer-time every 3 s
LOCALKV_RUN = {"time-limit": 6, "nemesis-period": 3}
#: the recover child's clients hang after this many invocations; it is
#: SIGKILLed there, mid-workload
RECOVER_HANG_AT = 4000
#: the child ``recover`` rebuilds: a 10,000-op atom run whose clients
#: stop mid-workload (argv: repo root, store root, hang point)
RECOVER_CHILD = """
import sys, threading, time
sys.path.insert(0, sys.argv[1])
from jepsen_tpu_torch import core, generator as gen
from jepsen_tpu_torch.checker import linearizable
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.testing import AtomClient, SharedRegister, atom_test

class HangingClient(AtomClient):
    count, lock = [0], threading.Lock()
    def open(self, test, node):
        return HangingClient(self.register)
    def invoke(self, test, op):
        with self.lock:
            self.count[0] += 1
            n = self.count[0]
        if n == int(sys.argv[3]):
            print("mid-workload", flush=True)
        if n >= int(sys.argv[3]):
            time.sleep(3600)
        return super().invoke(test, op)

reg = SharedRegister()
core.run(atom_test(reg, client=HangingClient(reg),
                   checker=linearizable(CASRegister()),
                   generator=gen.clients(gen.limit(10000, gen.cas_gen())),
                   **{"store-root": sys.argv[2]}))
"""


def run_split(test) -> dict:
    """A stored run's wall clock split into workload, store save and check
    seconds, read from its ``trace.jsonl`` spans."""
    from jepsen_tpu_torch import obs
    recs, _ = obs.read_trace(os.path.join(test["store-dir"], "trace.jsonl"))
    dur = {r["name"]: r["dur"] / 1e9 for r in recs}
    return {"wall_s": dur["core.run"], "workload_s": dur["core.run_case"],
            "save_s": dur["store.save"], "check_s": dur["checker.check"]}


def port_env() -> dict:
    """The environment of a ``python -m jepsen_tpu_torch`` process: the
    repository on its path and, once this process has run on the card,
    ``JEPSEN_ACCEL_OK``, which spares it the CUDA-init probe's child."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    if torch.cuda.is_initialized():
        env["JEPSEN_ACCEL_OK"] = "1"
    return env


def port_cmd(*args, timeout=600):
    """``python -m jepsen_tpu_torch ARGS`` from the repository root:
    (rc, stdout, stderr)."""
    return port_wait(port_start(*args), timeout)


def port_start(*args):
    """``python -m jepsen_tpu_torch ARGS`` started from the repository
    root, its output piped (:func:`port_wait` collects it)."""
    return subprocess.Popen([sys.executable, "-m", "jepsen_tpu_torch", *args],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            env=port_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def port_wait(proc, timeout=600):
    """(rc, stdout, stderr) of a :func:`port_start` process."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    return proc.returncode, out, err


def runner_phase(dev, seconds, smi):
    """The test runner on the card: the 10,000-op atom test through
    ``core.run``, first and second in this process, its stored artifacts,
    its verdict against the native engine's; a 2,000-op atom run checked
    on the kernels and on the plain route, as is a copy with one read
    corrupted, and the safe local-kv run's history on the plain route on
    the card; the safe local-kv suite under hammer-time and the unsafe one
    refuted; ``analyze`` of the atom run and of a corrupted copy; a
    10,000-op atom run SIGKILLed mid-workload and ``recover``ed. Every
    check on the card: ``backend`` gpu, no ``fallback-from``, no
    ``error``. Returns the phase's JSON entry, the launches, CUDA
    launches and segment counts of the in-process runs, and a copy of the
    local-kv run's store (for the ``cli`` phase, which removes it)."""
    import select
    import shutil
    import signal
    import tempfile
    from jepsen_tpu_torch import core, resilience, store
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.kernels import search as K
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops.encode import pack_with_init
    from jepsen_tpu_torch.suites.localkv import (localkv_test,
                                                 localkv_unsafe_test)
    from jepsen_tpu_torch.testing import atom_test, corrupt_one_read
    line = {"card": smi}
    root = tempfile.mkdtemp(prefix="jtpu-runner-")

    def on_card(res, tag):
        assert res.get("backend") == "gpu", (tag, res)
        assert "fallback-from" not in res and "error" not in res, (tag, res)

    def atom(n_ops, name):
        return core.run(atom_test(
            checker=linearizable(CASRegister(), device=dev),
            generator=gen.clients(gen.limit(n_ops, gen.cas_gen())),
            concurrency=5, name=name, **{"store-root": root}))

    def report(tag, test, res):
        split = run_split(test)
        entry = dict(split, ops=len(test["history"]), valid=res["valid"],
                     levels=res.get("levels"),
                     device_s=res.get("device-s"))
        print(f"runner: {tag}: {entry} [{smi}]", flush=True)
        line[tag] = entry
        return entry

    child = None
    try:
        with phase("runner", seconds):
            # the recover child's run goes on beside the others until it
            # hangs mid-workload (its own process: no launch is counted)
            rroot = os.path.join(root, "recover")
            repo = os.path.dirname(os.path.abspath(__file__))
            child = subprocess.Popen(
                [sys.executable, "-c", RECOVER_CHILD, repo, rroot,
                 str(RECOVER_HANG_AT)], stdout=subprocess.PIPE, text=True)
            K.reset_launches()
            # -- the atom test at the headline's width, first and second
            for tag in ("atom first", "atom second"):
                t = atom(RUNNER_OPS, "atom-cas")
                res = t["results"]
                assert res["valid"] is True, res
                on_card(res, tag)
                report(tag, t, res)
                d = t["store-dir"]
                for f in ("history.jsonl", "results.json", "run.state",
                          "history.wal", "trace.jsonl", "metrics.json",
                          "searchstats.json"):
                    assert os.path.exists(os.path.join(d, f)), (d, f)
                assert store.read_state(d)["state"] == "done"
                assert 2 * RUNNER_OPS - 10 <= len(t["history"]) \
                    <= 2 * RUNNER_OPS, len(t["history"])
            atom_dir, atom_h = d, t["history"]
            # -- 2,000 ops on the kernels ------------------------------
            t2 = atom(RUNNER_PLAIN_OPS, "atom-cas-2k")
            r2 = t2["results"]
            assert r2["valid"] is True, r2
            on_card(r2, "atom 2k")
            report("atom 2k", t2, r2)
            # -- local-kv: three kvnode daemons under hammer-time --------
            kv = core.run(localkv_test(dict(LOCALKV_RUN,
                                            **{"store-root": root})))
            lin = kv["results"]["linear"]
            assert kv["results"]["valid"] is True and lin["valid"] is True, \
                kv["results"]
            on_card(lin, "local-kv")
            report("local-kv", kv, lin)
            paused = [o for o in kv["history"] if o.process == "nemesis"
                      and "paused" in str(o.value)]
            assert paused, "hammer-time paused no node"
            pids = set()
            for node in kv["nodes"]:
                with open(os.path.join(kv["store-dir"], node,
                                       "kv.log")) as fh:
                    body = fh.read()
                got = {int(m) for m in re.findall(r"kvnode\[(\d+)\]", body)}
                assert got and "listening on" in body, (node, body[-300:])
                pids |= got
            assert len(pids) >= len(kv["nodes"]) and os.getpid() not in pids
            kv_store = tempfile.mkdtemp(prefix="jtpu-kv-store-")
            shutil.copytree(kv["store-dir"], kv_store, dirs_exist_ok=True)
            line["local-kv"]["pids"] = sorted(pids)
            line["local-kv"]["paused"] = len(paused)
            # -- local-kv-unsafe: a stale read refuted on the card ------
            un = core.run(localkv_unsafe_test({"store-root": root}))
            ulin = un["results"]["linear"]
            assert un["results"]["valid"] is False and ulin["valid"] is False
            on_card(ulin, "local-kv-unsafe")
            assert os.path.exists(os.path.join(un["store-dir"], "linear.svg"))
            report("local-kv-unsafe", un, ulin)
            launches = dict(K.launches)
            grid = dict(K.grid_launches_total)
            segs = dict(K.segments)
            assert all(launches[k] > 0 for k in (
                "expand", "sort_rows", "dedup_truncate")), launches
            assert segs["pair_ends"] > 0 and grid["seg_active"] == 0, segs
            print(f"runner launches: {launches} cuda_launches={grid} "
                  f"graphs={segs}", flush=True)
            # -- the native engine on the atom run's history -------------
            t0 = time.perf_counter()
            nat = linearizable(CASRegister(), backend="cpu").check(
                {}, atom_h)
            line["atom second"]["native_s"] = time.perf_counter() - t0
            assert nat["valid"] is True and nat.get("engine") == "native", \
                nat
            print(f"runner: native engine on the atom history: "
                  f"{line['atom second']['native_s']:.4f} s [{smi}]")
            # -- the kernels against the plain route on one history -----
            plain = linearizable(CASRegister(), device="cpu")
            kern = linearizable(CASRegister(), device=dev)
            h2 = t2["history"]
            for i in range(100):
                bad = corrupt_one_read(h2, random.Random(i))
                if any(a.value != b.value for a, b in zip(bad, h2)):
                    break
            for tag, h in (("valid", h2), ("corrupted", bad)):
                rk, rp = kern.check({}, h), plain.check({}, h)
                keys = ("valid", "levels", "best-k", "max-linearized-prefix")
                assert [rk.get(k) for k in keys] == [rp.get(k) for k in keys], \
                    (tag, rk, rp)
                print(f"runner: {tag}: kernels = plain route: "
                      f"{[rk.get(k) for k in keys]}", flush=True)
                line.setdefault("plain_route", {})[tag] = [
                    rk.get(k) for k in keys]
            assert line["plain_route"]["corrupted"][0] is False
            # the local-kv history (crashed ops, hundreds of levels) on the
            # plain route on the card: the CPU's ladder starts on another
            # rung, so the card's is held to the same one
            kvp, kvk = pack_with_init(kv["history"], CASRegister())
            rp = resilience.supervised_check_packed(kvp, kvk, device=dev,
                                                    ops=G.PLAIN)
            keys = ("valid", "levels", "best-k", "rung")
            assert [lin[k] for k in keys] == [rp[k] for k in keys], (lin, rp)
            line["plain_route"]["local-kv"] = [lin[k] for k in keys]
            print(f"runner: local-kv: kernels = plain route on the card: "
                  f"{line['plain_route']['local-kv']}", flush=True)
            # -- analyze of the run and of a corrupted copy, and recover
            # of the SIGKILLed run: three processes at once
            bad_dir = os.path.join(root, "corrupted-copy")
            shutil.copytree(atom_dir, bad_dir)
            for i in range(100):
                bad = corrupt_one_read(atom_h, random.Random(i))
                if any(a.value != b.value for a, b in zip(bad, atom_h)):
                    break
            store.write_history(bad_dir, bad)
            analyzing = [port_start("analyze", "--store", d)
                         for d in (atom_dir, bad_dir)]
            try:
                ready, _, _ = select.select([child.stdout], [], [], 300)
                assert ready and child.stdout.readline().strip() == \
                    "mid-workload", "the recover child never reached its " \
                    "hang point"
                time.sleep(0.5)
            finally:
                child.send_signal(signal.SIGKILL)
                child.wait(timeout=60)
            (dead,) = store.dead_runs(rroot)
            recovering = port_start("recover", "--store-root", rroot)
            rc, out, err = port_wait(analyzing[0])
            assert rc == 0, (rc, out[-2000:], err[-2000:])
            assert "# compile:" in out and "# search:" in out, out[:2000]
            line["analyze"] = [ln for ln in out.splitlines()
                               if ln.startswith("# ")]
            print("runner: analyze:\n  " + "\n  ".join(line["analyze"]))
            rc, out, err = port_wait(analyzing[1])
            assert rc == 1, (rc, out[-2000:], err[-2000:])
            rc, out, err = port_wait(recovering)
            assert rc == 0, (rc, out[-2000:], err[-2000:])
            st = store.read_state(dead)
            assert st["state"] == "done" and st["recovered"] is True, st
            rec = store.load(dead)
            on_card(rec["results"], "recover")
            assert rec["results"]["valid"] is True, rec["results"]
            dangling = st["recovery"]["reconciled"]
            assert 1 <= dangling <= 5, st
            assert sum(1 for o in rec["history"] if o.type == "info"
                       and "wal-recovery" in str(o.error)) == dangling
            line["recover"] = dict(st["recovery"],
                                   levels=rec["results"].get("levels"))
            print(f"runner: recover: {line['recover']}; "
                  + " ".join(ln for ln in out.splitlines()
                             if ln.startswith("# recovery")), flush=True)
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait(timeout=60)
        shutil.rmtree(root, ignore_errors=True)
    return line, launches, grid, segs, kv_store


#: the sqlite phase: the three suites of the real SQLite engine at their
#: own default sizes (register and bank 10 s at concurrency 5 under the
#: lock hammer every 3 s; the toctou schedule's four client ops)
SQLITE_SUITES = ("sqlite-register", "sqlite-register-toctou", "sqlite-bank")
#: the result fields the register histories' checks are held to
SQLITE_KEYS = ("valid", "levels", "best-k", "rung", "max-linearized-prefix")


def sqlite_phase(dev, seconds, smi):
    """The sqlite tier on the card: ``sqlite-register`` under the lock
    hammer, valid, its check on the kernels held against the plain route
    on the card and against the native engine on the same history;
    ``sqlite-register-toctou`` refuted on the kernels with ``linear.svg``,
    held to both likewise, and ``explain`` of its store (the report and
    ``python -m jepsen_tpu_torch explain``) naming the violating level;
    ``sqlite-bank`` valid. Every check on the card: ``backend`` gpu, no
    ``fallback-from``, no ``error``. Returns the phase's JSON entry and
    the launches, CUDA launches and segment counts of the three runs."""
    import io
    import shutil
    import tempfile
    from jepsen_tpu_torch import core, explain, resilience, suites
    from jepsen_tpu_torch.__main__ import main as port_main
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.kernels import search as K
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops.encode import pack_with_init
    line = {"card": smi}
    root = tempfile.mkdtemp(prefix="jtpu-sqlite-")
    ctors = suites.registry()
    runs = {}
    try:
        with phase("sqlite", seconds):
            K.reset_launches()
            for name in SQLITE_SUITES:
                before = dict(K.launches)
                t = core.run(ctors[name]({"store-root": root}))
                res = t["results"]
                entry = dict(run_split(t), valid=res["valid"],
                             ops=sum(1 for o in t["history"]
                                     if o.process != "nemesis"),
                             launches={k: K.launches[k] - before.get(k, 0)
                                       for k in K.launches})
                lin = res.get("linear")
                if lin is not None:
                    assert lin.get("backend") == "gpu", (name, lin)
                    assert "fallback-from" not in lin \
                        and "error" not in lin, (name, lin)
                    entry.update(levels=lin.get("levels"),
                                 rung=lin.get("rung"),
                                 device_s=lin.get("device-s"))
                runs[name] = t
                line[name] = entry
            launches = dict(K.launches)
            grid = dict(K.grid_launches_total)
            segs = dict(K.segments)
            # -- the verdicts ------------------------------------------
            reg, toc, bank = (runs[n] for n in SQLITE_SUITES)
            assert reg["results"]["valid"] is True, reg["results"]
            nem = [o for o in reg["history"] if o.process == "nemesis"]
            assert any("lock held" in str(o.value) for o in nem), nem
            busy = [o for o in reg["history"] if o.type == "fail"
                    and "locked" in str(o.error)]
            assert busy, "the lock hammer produced no busy failures"
            line["sqlite-register"]["busy_failures"] = len(busy)
            assert toc["results"]["valid"] is False, toc["results"]
            oks = [o for o in toc["history"] if o.is_ok and o.f == "cas"]
            assert len(oks) == 2, oks
            assert os.path.exists(os.path.join(toc["store-dir"],
                                               "linear.svg"))
            assert bank["results"]["valid"] is True, bank["results"]
            reads = [o for o in bank["history"]
                     if o.is_ok and o.f == "read"]
            assert reads and all(sum(o.value) == 50 for o in reads)
            line["sqlite-bank"]["reads"] = len(reads)
            assert all(launches[k] > 0 for k in (
                "expand", "sort_rows", "dedup_truncate")), launches
            assert segs["pair_ends"] > 0 and grid["seg_active"] == 0, segs
            # -- the kernels against the plain route on the card, and the
            # native engine, on each register history --------------------
            native = linearizable(CASRegister(), backend="cpu")
            for name in SQLITE_SUITES[:2]:
                t, lin = runs[name], runs[name]["results"]["linear"]
                packed, kernel = pack_with_init(t["history"], CASRegister())
                rp = resilience.supervised_check_packed(
                    packed, kernel, device=dev, ops=G.PLAIN)
                assert [lin.get(k) for k in SQLITE_KEYS] == \
                    [rp.get(k) for k in SQLITE_KEYS], (name, lin, rp)
                t0 = time.perf_counter()
                nat = native.check({}, t["history"])
                native_s = time.perf_counter() - t0
                assert nat["valid"] == lin["valid"], (name, nat, lin)
                assert nat.get("engine") == "native", nat
                if lin["valid"] is False:
                    assert nat.get("max-linearized-prefix") == \
                        lin["max-linearized-prefix"], (nat, lin)
                line[name].update(
                    plain_route=[rp.get(k) for k in SQLITE_KEYS],
                    native_s=native_s,
                    max_linearized_prefix=lin.get("max-linearized-prefix"))
            # -- explain the refutation --------------------------------
            rep = explain.explain_report(toc["store-dir"])
            cex = rep.get("counterexample") or {}
            assert rep["kind"] == "invalid" and isinstance(
                cex.get("violating-level"), int), rep
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = port_main(["explain", "--store", toc["store-dir"]])
            text = out.getvalue()
            assert rc == 1 and "non-linearizable at op" in text, (rc, text)
            line["explain"] = {
                "violating-level": cex["violating-level"],
                "n-required": cex.get("n-required"),
                "final-path": cex.get("final-path"),
                "lines": [ln for ln in text.splitlines()
                          if ln.startswith("# explain:")]}
            print("sqlite: explain:\n  " + "\n  ".join(
                line["explain"]["lines"]), flush=True)
        brief = {name: {k: line[name].get(k) for k in (
            "wall_s", "workload_s", "save_s", "check_s", "ops", "valid",
            "levels", "rung", "native_s")} for name in SQLITE_SUITES}
        print(f"sqlite: {json.dumps(brief)} launches={launches} "
              f"cuda_launches={grid} graphs={segs} [{smi}]", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return line, launches, grid, segs


#: the suites phase: the wire-protocol suites through the port's command
#: line against the in-process fakes of tools/torch_suite_fakes.py (one
#: subprocess a run; five listeners, one a member): etcd at its own
#: shapes (10 threads, 300 ops and a 1/30 s stagger a key) on 50 workers
#: for ETCD_SECONDS, valid; the same suite for STALE_SECONDS against the
#: fake's lagging replicas, refuted; and the hazelcast lock for
#: LOCK_SECONDS. Each database's lifecycle runs under the dummy control
#: plane, with the fakes' scripted replies
SUITES_RUN = {"members": 5, "concurrency": "10n", "etcd_seconds": 15,
              "stale_seconds": 6, "lock_seconds": 6}
#: the fields a key's verdict is held to across the run, the plain route
#: and analyze
SUITE_KEYS = ("valid", "levels")
#: the fields a refuted key's result is held to on the plain route
PREFIX_KEYS = ("max-linearized-prefix", "deepest-expanded", "final-states")


class SuiteFake:
    """One fake of ``tools/torch_suite_fakes.py`` in a subprocess: its
    node names; stopped (stdin closed, then killed if need be) on exit."""

    def __init__(self, *args):
        root = os.path.dirname(os.path.abspath(__file__))
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(root, "tools",
                                          "torch_suite_fakes.py"), *args],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.nodes = json.loads(self.proc.stdout.readline())["nodes"]
        self.stats = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            self.proc.stdin.close()
            line = self.proc.stdout.readline()
            self.stats = json.loads(line)["stats"] if line.strip() else None
            self.proc.wait(timeout=30)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()


def on_card(res, tag):
    """A check ran on the card: backend gpu, no host fallback, no
    error."""
    assert res.get("backend") == "gpu", (tag, res)
    assert "fallback-from" not in res and "error" not in res, (tag, res)


def stored(x):
    """``x`` as a stored result holds it (tuples become lists)."""
    return json.loads(json.dumps(x))


@contextlib.contextmanager
def keyed_batches():
    """The keyed batches the checks inside the block run, read back
    through a wrapper of ``check_keyed_gpu``."""
    from jepsen_tpu_torch.checker import gpu as G
    batches, orig = [], G.check_keyed_gpu

    def spy(*a, **kw):
        out = orig(*a, **kw)
        batches.extend(out["batches"])
        return out
    G.check_keyed_gpu = spy
    try:
        yield batches
    finally:
        G.check_keyed_gpu = orig


def keyed_entry(t, batches, keyed) -> dict:
    """A keyed run's line: its wall split, events, keys, verdict, events
    and levels a key, the batches' device seconds and the batches."""
    res = t["results"]["indep"]["results"]
    levels = [r.get("levels") for r in res.values()]
    return dict(run_split(t), events=len(t["history"]), keys=len(keyed),
                valid=t["results"]["valid"],
                events_per_key=[min(len(h) for h in keyed.values()),
                                max(len(h) for h in keyed.values())],
                levels_per_key=[min(levels), max(levels)],
                device_s=sum(b["seconds"] for b in batches),
                batches=[{"rung": list(b["rung"]), "keys": b["keys"],
                          "levels": b["levels"], "tiebreak": b["tiebreak"],
                          "crash_width": b["crash-width"]}
                         for b in batches])


def per_key_checks(dev, entry, tag, keyed, res, refuted):
    """The keyed check on the plain route on the card, and the native
    engine, on a run's subhistories, against the run's per-key verdicts
    (``res``); the refuted keys are ``refuted``. Their seconds go into
    ``entry``."""
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.models import CASRegister
    t0 = time.perf_counter()
    plain = G.check_keyed_gpu(keyed, CASRegister(), device=dev,
                              ops=G.PLAIN)["results"]
    plain_s = time.perf_counter() - t0
    native = linearizable(CASRegister(), backend="cpu")
    nat_s = {}
    for k, h in keyed.items():
        r = res[str(k)]
        on_card(r, f"{tag} key {k}")
        assert [plain[k].get(f) for f in SUITE_KEYS] == \
            [r.get(f) for f in SUITE_KEYS], (tag, k, plain[k], r)
        t1 = time.perf_counter()
        nat = native.check({}, h)
        nat_s[k] = time.perf_counter() - t1
        assert nat["valid"] == r["valid"] and \
            nat.get("engine") == "native", (tag, k, nat, r)
        if r["valid"] is False:
            # the device's prefix is its last living pool's deepest k, and
            # the all-time deepest (the native engine's) is
            # deepest-expanded where the two differ, as in the reference
            # (checker/tpu.py:1270-1295)
            deepest = r.get("deepest-expanded", r["max-linearized-prefix"])
            assert stored([plain[k].get(f) for f in PREFIX_KEYS]) == \
                stored([r.get(f) for f in PREFIX_KEYS]) and \
                nat.get("max-linearized-prefix") == deepest, \
                (tag, k, plain[k], nat, r)
    assert {k for k, r in res.items() if r["valid"] is False} == \
        {str(k) for k in refuted}
    entry.update(plain_route_s=plain_s, native_s=sum(nat_s.values()),
                 native_key_s=[min(nat_s.values()), max(nat_s.values())])


def analyze_keys(store_dir, res, on_cpu):
    """``analyze`` of a stored valid keyed run (in this process): exit 0
    and the run's per-key verdicts and levels. Its ``# `` lines."""
    import io
    from jepsen_tpu_torch.__main__ import main as port_main
    out = io.StringIO()
    argv = ["analyze", "--store", store_dir]
    with contextlib.redirect_stdout(out):
        rc = port_main(argv + (["--device", "cpu"] if on_cpu else []))
    text = out.getvalue()
    assert rc == 0, (rc, text[-2000:])
    again = json.loads(text[text.index("\n{") + 1:])
    for k, r in res.items():
        assert [again["results"][k].get(f) for f in SUITE_KEYS] == \
            [r.get(f) for f in SUITE_KEYS], (k, again["results"][k])
    return [ln for ln in text.splitlines() if ln.startswith("# ")]


def suites_phase(dev, seconds, smi, cfg=SUITES_RUN):
    """The wire-protocol suites on the card, each through ``python -m
    jepsen_tpu_torch run`` (its ``main``, in this process) against the
    fakes: the canonical etcd run valid, its keyed check on K1, K2 and K4
    and never K5 standing alone, every key's verdict and levels held
    against the keyed check on the plain route on the card, against the
    native engine on the same subhistories (timed) and against
    ``analyze`` of the stored run; the stale-read etcd run refuted, each
    failing key refuted by the plain route and the native engine at the
    same ``max-linearized-prefix``; the hazelcast lock valid, its
    ``Mutex`` check held to the plain route and the native engine. Every
    check on the card: ``backend`` gpu, no ``fallback-from``, no
    ``error``. Returns the phase's JSON entry and the launches, CUDA
    launches and segment counts of the three runs."""
    import shutil
    import tempfile
    from jepsen_tpu_torch import independent, resilience, store
    from jepsen_tpu_torch.__main__ import main as port_main
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.kernels import search as K
    from jepsen_tpu_torch.models import Mutex
    from jepsen_tpu_torch.ops.encode import pack_with_init
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import torch_suite_fakes as fakes
    line = {"card": smi}
    root = tempfile.mkdtemp(prefix="jtpu-suites-")
    on_cpu = dev.type == "cpu"

    counters = (K.launches, K.grid_launches_total, K.segments)
    #: the launches, CUDA launches and segment counts of the three runs
    totals = tuple(dict.fromkeys(c, 0) for c in counters)

    def run(suite, nodes, secs, *extra):
        """``run --suite`` in this process; (exit code, the stored run,
        the keyed batches its check ran, its kernel launches). Its
        counts are added to ``totals``."""
        responses = os.path.join(root, f"{suite}-responses.json")
        with open(responses, "w") as fh:
            json.dump(fakes.DUMMY_RESPONSES[suite], fh)
        argv = ["run", "--suite", suite, "--ssh-mode", "dummy",
                "--dummy-responses", responses, "--time-limit", str(secs),
                "--store-root", root, *extra]
        for n in nodes:
            argv += ["-n", n]
        if on_cpu:
            argv += ["--device", "cpu"]
        before = tuple(dict(c) for c in counters)
        with keyed_batches() as batches:
            rc = port_main(argv)
        for c, was, total in zip(counters, before, totals):
            for k in c:
                total[k] += c[k] - was[k]
        name = suite if suite != "hazelcast" else "hazelcast-lock"
        return (rc, store.load(os.path.join(root, name, "latest")), batches,
                {k: K.launches[k] - before[0][k] for k in K.launches})

    try:
        with phase("suites", seconds):
            K.reset_launches()
            # -- etcd at its canonical shapes: valid --------------------
            with SuiteFake("etcd", "--members", str(cfg["members"])) as f:
                rc, t, batches, etcd_launches = run(
                    "etcd", f.nodes, cfg["etcd_seconds"], "--concurrency",
                    cfg["concurrency"])
            assert rc == 0, rc
            res = t["results"]
            assert res["valid"] is True and res["indep"]["valid"] is True
            keyed = independent.subhistories(t["history"])
            entry = line["etcd"] = keyed_entry(t, batches, keyed)
            entry.update(fake=f.stats, launches=etcd_launches)
            assert set(res["indep"]["results"]) == {str(k) for k in keyed}
            assert batches and len(keyed) >= 2, (batches, len(keyed))
            print(f"suites: etcd: {json.dumps(entry)} [{smi}]", flush=True)
            if not on_cpu:
                # K2 under either tie-break: the keyed ladder's first
                # rungs sort with the hash key
                assert etcd_launches["expand"] > 0 and \
                    etcd_launches["dedup_truncate"] > 0 and \
                    etcd_launches["sort_rows"] + \
                    etcd_launches["sort_rows_hash"] > 0, etcd_launches
            per_key_checks(dev, entry, "etcd", keyed,
                           res["indep"]["results"], ())
            # -- analyze of the stored run: the same per-key verdicts ----
            entry["analyze"] = analyze_keys(t["store-dir"],
                                            res["indep"]["results"], on_cpu)
            # -- etcd against lagging replicas: refuted -----------------
            with SuiteFake("etcd", "--members", str(cfg["members"]),
                           "--stale-reads") as f:
                rc, st, sbatches, _ = run("etcd", f.nodes,
                                          cfg["stale_seconds"],
                                          "--concurrency",
                                          cfg["concurrency"])
            assert rc == 1, rc
            sres = st["results"]
            assert sres["valid"] is False and sres["indep"]["failures"], sres
            skeyed = independent.subhistories(st["history"])
            entry = line["etcd stale"] = keyed_entry(st, sbatches, skeyed)
            entry.update(fake=f.stats,
                         failures=sorted(sres["indep"]["failures"]))
            print(f"suites: etcd stale: {json.dumps(entry)} [{smi}]",
                  flush=True)
            per_key_checks(dev, entry, "etcd stale", skeyed,
                           sres["indep"]["results"],
                           sres["indep"]["failures"])
            # -- the hazelcast lock: a Mutex on the card -----------------
            with SuiteFake("hazelcast", "--members",
                           str(cfg["members"])) as f:
                rc, ht, _, lock_launches = run(
                    "hazelcast", f.nodes, cfg["lock_seconds"], "--workload",
                    "lock")
            assert rc == 0, rc
            lin = ht["results"]["workload"]
            assert ht["results"]["valid"] is True and lin["valid"] is True
            on_card(lin, "hazelcast lock")
            hist = ht["history"]
            packed, kernel = pack_with_init(hist, Mutex())
            assert kernel.name == "mutex", kernel.name
            rp = resilience.supervised_check_packed(packed, kernel,
                                                    device=dev, ops=G.PLAIN)
            keys = ("valid", "levels", "best-k", "rung")
            assert stored([lin.get(k) for k in keys]) == \
                stored([rp.get(k) for k in keys]), (lin, rp)
            t0 = time.perf_counter()
            nat = linearizable(Mutex(), backend="cpu").check({}, hist)
            native_s = time.perf_counter() - t0
            assert nat["valid"] is True and nat.get("engine") == "native"
            line["hazelcast lock"] = dict(
                run_split(ht), events=len(hist), valid=lin["valid"],
                levels=lin.get("levels"), rung=lin.get("rung"),
                device_s=lin.get("device-s"), native_s=native_s,
                plain_route=[rp.get(k) for k in keys],
                launches=lock_launches)
            print(f"suites: hazelcast lock: "
                  f"{json.dumps(line['hazelcast lock'])} [{smi}]",
                  flush=True)
            launches, grid, segs = totals
            if not on_cpu:
                assert all(lock_launches[k] > 0 for k in (
                    "expand", "sort_rows", "dedup_truncate")), lock_launches
                assert segs["pair_ends"] > 0 and \
                    grid["seg_active"] == 0, (segs, grid)
        print(f"suites: launches={launches} cuda_launches={grid} "
              f"graphs={segs} [{smi}]", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return line, launches, grid, segs


#: the cas-suites phase: the keyed CAS-register suites whose data plane is
#: a command on the nodes (cockroachdb's ``cockroach sql``, aerospike's
#: ``aql``, mongodb's ``mongosh``), each through ``core.run`` with its test
#: map from the registry and ``tools/torch_suite_fakes.py``'s ``CliFake``
#: sessions on five nodes under the dummy control plane. aerospike at its
#: canonical shapes (100 workers, 5 threads, 100 ops and a 1/10 s stagger
#: a key) for AEROSPIKE_SECONDS; cockroachdb's register under the
#: small-skews nemesis for COCKROACH_SECONDS; a seeded TIMEOUT_P of both
#: runs' writes and CAS's time out (half of them applied), so their
#: histories hold crashed ops; mongodb's document CAS for MONGO_SECONDS
#: twice against a primary whose secondaries apply its writes DELAY_S
#: late, with linearizable and with local reads
CAS_RUN = {"members": 5, "aerospike_workers": 100, "aerospike_seconds": 15,
           "cockroach_workers": 50, "cockroach_seconds": 20,
           "mongo_workers": 50, "mongo_seconds": 6, "timeout_p": 0.02,
           "seed": 16, "delay_s": 0.5, "cockroach_opts": {}}


def cas_suites_phase(dev, seconds, smi, cfg=CAS_RUN):
    """The keyed CAS-register suites of the command-line data planes on
    the card, each through ``core.run`` with the registry's test map and
    the fake's sessions: aerospike at 100 workers and cockroachdb's
    register under a clock-skew nemesis valid with crashed ops in their
    histories, mongodb with linearizable reads valid and with local reads
    from lagging secondaries refuted. Each keyed check on K1, K2 and K4
    (K3 where a key reaches a wide rung with crashed ops), every key held
    against the plain route on the card and the native engine (timed),
    and the valid runs' stores against ``analyze``; the skew nemesis's
    helper install and its bump and reset commands on the nodes it
    planned. Every check on the card: ``backend`` gpu, no
    ``fallback-from``, no ``error``. Returns the phase's JSON entry and
    the four runs' launches, CUDA launches and segment counts."""
    import shutil
    import tempfile
    from jepsen_tpu_torch import core, independent, store, suites
    from jepsen_tpu_torch.kernels import search as K
    from jepsen_tpu_torch.suites import cockroachdb
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import torch_suite_fakes as fakes
    line = {"card": smi}
    root = tempfile.mkdtemp(prefix="jtpu-cas-suites-")
    on_cpu = dev.type == "cpu"
    nodes = [f"n{i + 1}" for i in range(cfg["members"])]
    counters = (K.launches, K.grid_launches_total, K.segments)
    #: the launches, CUDA launches and segment counts of the four runs
    totals = tuple(dict.fromkeys(c, 0) for c in counters)

    def run(tag, suite, workers, secs, fake, **opts):
        """``suite``'s test map from the registry through ``core.run``
        on the fake's sessions; the stored run, its keyed subhistories,
        its line (the run's kernel launches in it) and the nodes' command
        logs."""
        test = suites.registry()[suite](dict(
            opts, nodes=nodes, concurrency=workers, **{
                "time-limit": secs, "store-root": root,
                "ssh": {"mode": "dummy"}},
            **({"device": "cpu"} if on_cpu else {})))
        sessions = test["_sessions"] = fake.sessions()
        before = tuple(dict(c) for c in counters)
        with keyed_batches() as batches:
            t = store.load(core.run(test)["store-dir"])
        for c, was, total in zip(counters, before, totals):
            for k in c:
                total[k] += c[k] - was[k]
        keyed = independent.subhistories(t["history"])
        entry = line[tag] = keyed_entry(t, batches, keyed)
        res = t["results"]["indep"]["results"]
        assert set(res) == {str(k) for k in keyed} and len(keyed) >= 2
        for k, r in res.items():
            on_card(r, f"{tag} key {k}")
        crashed = [o for o in t["history"]
                   if o.type == "info" and o.process != "nemesis"]
        launches = {k: K.launches[k] - before[0][k] for k in K.launches}
        entry.update(crashed=len(crashed), fake=dict(fake.stats),
                     crash_widths=sorted({b["crash-width"]
                                          for b in batches}),
                     launches=launches,
                     k3_launched=launches["group_scan"] > 0)
        if not on_cpu:
            assert launches["expand"] > 0 and \
                launches["dedup_truncate"] > 0 and \
                launches["sort_rows"] + launches["sort_rows_hash"] > 0, \
                (tag, launches)
        print(f"cas-suites: {tag}: {json.dumps(entry)} [{smi}]", flush=True)
        return t, keyed, entry, {n: s.log for n, s in sessions.items()}

    def crashing_fake(suite):
        return fakes.CliFake(nodes, fakes.DUMMY_RESPONSES[suite],
                             timeout_p=cfg["timeout_p"], seed=cfg["seed"])

    try:
        with phase("cas-suites", seconds):
            K.reset_launches()
            # -- aerospike at its canonical shapes, with crashed ops -----
            t, keyed, entry, _ = run(
                "aerospike", "aerospike", cfg["aerospike_workers"],
                cfg["aerospike_seconds"], crashing_fake("aerospike"))
            res = t["results"]["indep"]["results"]
            assert t["results"]["valid"] is True and entry["crashed"] > 0, \
                entry
            per_key_checks(dev, entry, "aerospike", keyed, res, ())
            entry["analyze"] = analyze_keys(t["store-dir"], res, on_cpu)
            # -- cockroachdb's register under small skews ----------------
            t, keyed, entry, logs = run(
                "cockroachdb", "cockroachdb", cfg["cockroach_workers"],
                cfg["cockroach_seconds"], crashing_fake("cockroachdb"),
                nemesis=cockroachdb.named_nemesis(["small-skews"], None),
                **cfg["cockroach_opts"])
            res = t["results"]["indep"]["results"]
            assert t["results"]["valid"] is True and entry["crashed"] > 0, \
                entry
            # the skew nemesis compiled its helper on every node, bumped
            # the clocks of the nodes each start planned, and reset them
            plans = [o.value for o in t["history"] if o.process == "nemesis"
                     and tuple(o.f) == ("small-skews", "start")
                     and isinstance(o.value, dict)]
            assert plans, [o for o in t["history"]
                           if o.process == "nemesis"]
            bumped = set()
            for node, cmds in logs.items():
                assert any("g++ -O2 -o bump-time" in c for c in cmds), node
                assert any("ntpdate -b" in c for c in cmds), node
                for plan in plans:
                    if node in plan:
                        assert any(f"/opt/jepsen/bump-time {plan[node]}" in c
                                   for c in cmds), (node, plan, cmds)
                        bumped.add(node)
                assert node in bumped or not any(
                    "/opt/jepsen/bump-time " in c for c in cmds), node
            entry["skews"] = plans
            per_key_checks(dev, entry, "cockroachdb", keyed, res, ())
            entry["analyze"] = analyze_keys(t["store-dir"], res, on_cpu)
            # -- mongodb against lagging secondaries ---------------------
            for concern, valid in (("linearizable", True), ("local", False)):
                fake = fakes.CliFake(nodes, fakes.DUMMY_RESPONSES["mongodb"],
                                     stale_reads=True,
                                     delay_s=cfg["delay_s"])
                tag = f"mongodb {concern}"
                t, keyed, entry, _ = run(
                    tag, "mongodb", cfg["mongo_workers"],
                    cfg["mongo_seconds"], fake,
                    **{"read-concern": concern})
                ind = t["results"]["indep"]
                assert t["results"]["valid"] is valid, (tag, ind["failures"])
                assert bool(ind["failures"]) is not valid, ind["failures"]
                entry["failures"] = sorted(ind["failures"])
                per_key_checks(dev, entry, tag, keyed, ind["results"],
                               ind["failures"])
            launches, grid, segs = totals
            if not on_cpu:
                assert segs["pair_ends"] > 0 and \
                    grid["seg_active"] == 0, (segs, grid)
        print(f"cas-suites: launches={launches} cuda_launches={grid} "
              f"graphs={segs} [{smi}]", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return line, launches, grid, segs


#: the small-suites phase: the registers of ``suites/small.py``, each
#: through ``core.run`` with its test map from the registry on five nodes
#: under the dummy control plane. logcabin at its own shapes (5 workers, a
#: 1/10 s stagger, the partition cycle) for LOGCABIN_SECONDS, not 60,
#: against ``CliFake``'s logcabin CLI with a seeded TIMEOUT_P of its
#: writes and CAS's timing out (half of them applied): a crashed op stays
#: open to the end of the one history, so it holds 33-128 of them, a
#: crashed mask of two to four words; ravendb for RAVEN_SECONDS against
#: ``RavenFake``'s five listeners with a seeded ERROR_P of PUTs answered
#: 503 (half applied); rethinkdb for RETHINK_SECONDS twice against a
#: primary (n1) whose replicas apply its writes DELAY_S late, with
#: majority reads and with outdated reads on the client's own node; and
#: mongodb-rocks' keyed document CAS for ROCKS_SECONDS. The plain route
#: re-checks a whole history of at most PLAIN_LEVELS levels of search,
#: else the deciding rung's first PLAIN_SEGMENTS segments, lane by lane.
SMALL_RUN = {"members": 5, "workers": 5, "logcabin_seconds": 20,
             "timeout_p": 0.06, "seed": 17, "raven_seconds": 10,
             "error_p": 0.06, "rethink_seconds": 10, "delay_s": 0.5,
             "rocks_workers": 50, "rocks_seconds": 5, "plain_levels": 1024,
             "plain_segments": 1, "min_crash_width": 64}


def analyze_single(store_dir, res, on_cpu):
    """``analyze`` of a stored single-register run (in this process): the
    run's verdict and levels. Its ``# `` lines."""
    import io
    from jepsen_tpu_torch.__main__ import main as port_main
    out = io.StringIO()
    argv = ["analyze", "--store", store_dir]
    with contextlib.redirect_stdout(out):
        rc = port_main(argv + (["--device", "cpu"] if on_cpu else []))
    text = out.getvalue()
    again = json.loads(text[text.index("\n{") + 1:])
    assert rc == (0 if res["valid"] is True else 1), (rc, text[-2000:])
    assert [again.get(f) for f in SUITE_KEYS] == \
        [res.get(f) for f in SUITE_KEYS], again
    return [ln for ln in text.splitlines() if ln.startswith("# ")]


def single_checks(dev, entry, tag, hist, res, cfg):
    """A single register history's check on the card held against the
    plain route on the card (the whole search when it ran at most
    ``plain_levels`` levels, else the deciding rung's first segments, lane
    by lane) and against the native engine (timed); a refuted history at
    the same ``max-linearized-prefix``. Their seconds go into ``entry``."""
    from jepsen_tpu_torch import resilience
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops.encode import pack_with_init
    on_card(res, tag)
    packed, kernel = pack_with_init(hist, CASRegister())
    searched = sum(w[-1] for w in res["work"])
    t0 = time.perf_counter()
    if searched <= cfg["plain_levels"]:
        rp = resilience.supervised_check_packed(packed, kernel, device=dev,
                                                ops=G.PLAIN)
        keys = SUITE_KEYS + ("rung", "crash-width")
        assert stored([rp.get(k) for k in keys]) == \
            stored([res.get(k) for k in keys]), (tag, rp, res)
        if res["valid"] is False:
            assert stored([rp.get(f) for f in PREFIX_KEYS]) == \
                stored([res.get(f) for f in PREFIX_KEYS]), (tag, rp, res)
        entry["plain_route"] = "whole search"
    else:
        cols = G._split_packed(packed, G._bucket(packed.n_required),
                               res["crash-width"], kernel)
        level = hold_segments(f"{tag} plain", cols, tuple(res["rung"]), dev,
                              cfg["plain_segments"], PLAIN_SEGMENT_LEVELS)
        entry["plain_route"] = (f"first {cfg['plain_segments']} segment(s) "
                                f"of rung {list(res['rung'])}, level "
                                f"{level}, carries equal")
    entry["plain_route_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat = linearizable(CASRegister(), backend="cpu").check({}, hist)
    entry["native_s"] = time.perf_counter() - t0
    assert nat["valid"] == res["valid"] and nat.get("engine") == "native", \
        (tag, nat, res)
    if res["valid"] is False:
        deepest = res.get("deepest-expanded", res["max-linearized-prefix"])
        assert nat.get("max-linearized-prefix") == deepest, (tag, nat, res)


def small_suites_phase(dev, seconds, smi, cfg=SMALL_RUN):
    """The registers of ``suites/small.py`` on the card, each through
    ``core.run`` with the registry's test map: logcabin valid with 33-128
    crashed ops in its one history, checked at crash width 64 or 128 (the
    rung trail printed), held to the plain route and native, and
    ``analyze`` of its store agreeing; ravendb with 503s valid; rethinkdb
    with majority reads valid, the reconfigure nemesis's commands on the
    nodes it chose, and with outdated reads refuted by the device, the
    plain route and native at one prefix; mongodb-rocks' keyed document
    CAS valid with the rocksdb engine configured on every node. Every
    check on the card: ``backend`` gpu, no ``fallback-from``, no
    ``error``. Returns the phase's JSON entry and the five runs'
    launches, CUDA launches and segment counts."""
    import shutil
    import tempfile
    from jepsen_tpu_torch import core, independent, store, suites
    from jepsen_tpu_torch.kernels import search as K
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import torch_suite_fakes as fakes
    line = {"card": smi}
    root = tempfile.mkdtemp(prefix="jtpu-small-suites-")
    on_cpu = dev.type == "cpu"
    nodes = [f"n{i + 1}" for i in range(cfg["members"])]
    counters = (K.launches, K.grid_launches_total, K.segments)
    #: the launches, CUDA launches and segment counts of the five runs
    totals = tuple(dict.fromkeys(c, 0) for c in counters)

    def run(tag, suite, secs, nodes, fake=None, responses=None, **opts):
        """``suite``'s test map from the registry through ``core.run``,
        on the fake's sessions if any; the stored run, its line (the
        run's kernel launches in it) and the nodes' command logs."""
        test = suites.registry()[suite](dict(
            opts, nodes=nodes, concurrency=opts.pop(
                "concurrency", cfg["workers"]), **{
                "time-limit": secs, "store-root": root,
                "ssh": {"mode": "dummy", "dummy-responses": {
                    k: tuple(v) if isinstance(v, list) else v
                    for k, v in (responses or {}).items()}}},
            **({"device": "cpu"} if on_cpu else {})))
        sessions = test["_sessions"] = fake.sessions() if fake else {}
        before = tuple(dict(c) for c in counters)
        with keyed_batches() as batches:
            t = store.load(core.run(test)["store-dir"])
        for c, was, total in zip(counters, before, totals):
            for k in c:
                total[k] += c[k] - was[k]
        crashed = [o for o in t["history"]
                   if o.type == "info" and o.process != "nemesis"]
        launches = {k: K.launches[k] - before[0][k] for k in K.launches}
        entry = line[tag] = dict(run_split(t), events=len(t["history"]),
                                 valid=t["results"]["valid"],
                                 crashed=len(crashed), launches=launches,
                                 k3_launched=launches["group_scan"] > 0)
        if fake is not None:
            entry["fake"] = dict(fake.stats)
        return t, entry, batches, {n: s.log for n, s in sessions.items()}

    def single(tag, t, entry):
        """The single history's check result, in the run's line."""
        res = t["results"]["linear"]
        entry.update(levels=res.get("levels"), rung=res.get("rung"),
                     crash_width=res.get("crash-width"),
                     segments=res.get("segments"),
                     device_s=res.get("device-s"),
                     trail=[[list(a["rung"]), a["event"], a["levels"]]
                            for a in res.get("attempts", ())],
                     work=res.get("work"))
        single_checks(dev, entry, tag, t["history"], res, cfg)
        if not on_cpu:
            launches = entry["launches"]
            assert launches["expand"] > 0 and \
                launches["dedup_truncate"] > 0 and \
                launches["sort_rows"] + launches["sort_rows_hash"] > 0, \
                (tag, launches)
        print(f"small-suites: {tag}: {json.dumps(entry, default=str)} "
              f"[{smi}]", flush=True)
        return res

    try:
        with phase("small-suites", seconds):
            K.reset_launches()
            # -- logcabin: one register, crashed ops to the end ----------
            fake = fakes.CliFake(nodes, fakes.DUMMY_RESPONSES["logcabin"],
                                 timeout_p=cfg["timeout_p"],
                                 seed=cfg["seed"])
            print(f"small-suites: logcabin: timeout share "
                  f"{cfg['timeout_p']} of writes and CAS's, half applied",
                  flush=True)
            t, entry, _, _ = run("logcabin", "logcabin",
                                 cfg["logcabin_seconds"], nodes, fake)
            res = single("logcabin", t, entry)
            assert res["valid"] is True, res
            assert 33 <= entry["crashed"] <= 128 or on_cpu, entry["crashed"]
            assert res["crash-width"] >= cfg["min_crash_width"], res
            entry["analyze"] = analyze_single(t["store-dir"], res, on_cpu)
            # -- ravendb: a read/write register over HTTP, 503s ----------
            raven = fakes.RavenFake(cfg["members"], cfg["error_p"],
                                    cfg["seed"])
            try:
                t, entry, _, _ = run(
                    "ravendb", "ravendb", cfg["raven_seconds"],
                    raven.start(),
                    responses=fakes.DUMMY_RESPONSES["ravendb"])
            finally:
                raven.stop()
            entry["fake"] = dict(raven.stats)
            res = single("ravendb", t, entry)
            assert res["valid"] is True, res
            # -- rethinkdb against a lagging replica ---------------------
            for mode, valid in (("majority", True), ("outdated", False)):
                tag = f"rethinkdb {mode}"
                fake = fakes.CliFake(nodes,
                                     fakes.DUMMY_RESPONSES["rethinkdb"],
                                     stale_reads=True,
                                     delay_s=cfg["delay_s"])
                t, entry, _, logs = run(
                    tag, "rethinkdb", cfg["rethink_seconds"], nodes, fake,
                    **{"write-acks": "majority", "read-mode": mode})
                res = single(tag, t, entry)
                assert res["valid"] is valid, (tag, res)
                assert fake.write_acks == "majority", fake.write_acks
                # each reconfiguration ran on the node it chose, as many
                # as the nemesis completed
                recon = [(n, c) for n, cmds in logs.items() for c in cmds
                         if "rethinkdb admin" in c]
                done = [o for o in t["history"] if o.process == "nemesis"
                        and o.type == "info" and isinstance(o.value, dict)]
                assert recon and len(recon) == len(done), (recon, done)
                assert all(f"--join {n}:29015 reconfigure jepsen.cas" in c
                           for n, c in recon), recon
                entry["reconfigurations"] = len(recon)
            # -- mongodb-rocks: the document CAS on RocksDB --------------
            fake = fakes.CliFake(nodes,
                                 fakes.DUMMY_RESPONSES["mongodb-rocks"])
            t, entry, batches, logs = run(
                "mongodb-rocks", "mongodb-rocks", cfg["rocks_seconds"],
                nodes, fake, concurrency=cfg["rocks_workers"])
            ind = t["results"]["indep"]
            assert t["results"]["valid"] is True, ind["failures"]
            keyed = independent.subhistories(t["history"])
            entry.update(keyed_entry(t, batches, keyed))
            per_key_checks(dev, entry, "mongodb-rocks", keyed,
                           ind["results"], ())
            for node, cmds in logs.items():
                assert any("engine: rocksdb" in c and "/etc/mongod.conf"
                           in c for c in cmds), node
            print(f"small-suites: mongodb-rocks: {json.dumps(entry)} "
                  f"[{smi}]", flush=True)
            launches, grid, segs = totals
            if not on_cpu:
                assert segs["pair_ends"] > 0 and \
                    grid["seg_active"] == 0, (segs, grid)
        print(f"small-suites: launches={launches} cuda_launches={grid} "
              f"graphs={segs} [{smi}]", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return line, launches, grid, segs


#: the cli phase: the daemon's gang bound, its leader's wait (ms) and its
#: bearer token; the watched local-kv run's time limit (s)
CLI_BATCH_MAX, CLI_WAIT_MS, CLI_TOKEN = 4, 50, "smoke-token"
CLI_RUN_S = 2
#: the kernels a profiled search's ``trace summary`` must name: K1, K2 and
#: K4 (its block-per-key kernel on the narrow rungs, the multi-block one
#: on the wide)
CLI_PROFILE_KERNELS = {"K1": ("expand_kernel",), "K2": ("sort_tile_kernel",),
                       "K4": ("dedup_block_kernel", "dedup_kernel")}


def port_popen(out_dir, tag, *args):
    """``python -m jepsen_tpu_torch ARGS`` started from the repository
    root (:func:`port_env`), its stdout and stderr into
    ``out_dir/TAG.out`` and ``.err``: (process, stdout path, stderr
    path)."""
    outp = os.path.join(out_dir, f"{tag}.out")
    errp = os.path.join(out_dir, f"{tag}.err")
    with open(outp, "w") as o, open(errp, "w") as e:
        proc = subprocess.Popen(
            [sys.executable, "-m", "jepsen_tpu_torch", *args],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=port_env(),
            stdout=o, stderr=e)
    return proc, outp, errp


def read_text(path) -> str:
    with open(path) as fh:
        return fh.read()


def result_json(out: str) -> dict:
    """The result a command prints last (after its ``#`` lines)."""
    return json.loads(out[out.index("\n{") + 1:])


def daemon_launches(port) -> dict:
    """The daemon process's kernel launches, from its ``/metrics``."""
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as resp:
        text = resp.read().decode()
    out = {}
    for m in re.finditer(r'^jtpu_kernel_launches_total\{kernel="(\w+)"\}'
                         r' ([0-9.e+]+)$', text, re.M):
        out[m.group(1)] = int(float(m.group(2)))
    return out


def cli_phase(dev, seconds, smi, kv_store):
    """The command line on the card, each step a ``python -m
    jepsen_tpu_torch`` process: the daemon under ``serve --batch-max 4
    --batch-wait-ms 50 --auth-token T --serve-backend gpu`` answering 8
    same-bucket register histories in gangs of at most 4, each verdict
    and ``levels`` equal to a lone ``check_history_gpu`` here, a POST
    without the token refused with 401; a local-kv run on the card under
    ``run --watch --profile`` exiting with its own code while ``watch``
    follows its store, and ``watch --once`` on it; ``stream --store`` of
    the local-kv run in ``kv_store`` (the runner phase's) through the
    daemon, with the verdict of ``analyze --profile`` of it; ``trace
    summary``, ``request``, ``find --min-device-s 0`` and ``export
    --format chrome`` over the daemon's directory, ``trace summary
    --format json`` of the analyze's profiled search naming K1, K2 and
    K4, and the watched run's own profile naming them (read here, with
    ``obs.profiler.read_profile``). Processes that need not wait
    for each other run at once. Returns the phase's JSON entry, the
    daemon's kernel launches (its ``/metrics``), its pair ends, and a
    copy of the watched run's directory with the lone checks' results
    (``{"run", "lone"}``, for :func:`daemon_telemetry_phase`)."""
    import shutil
    import signal
    import tempfile
    import threading
    from jepsen_tpu_torch import journal, serve, store
    from jepsen_tpu_torch.checker.gpu import check_history_gpu
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.obs import profiler
    line = {"card": smi}
    # on the CPU (a dry run of the phase) each process checks there too
    on = ("cuda",) if dev.type == "cuda" else ("cpu",)
    root = tempfile.mkdtemp(prefix="jtpu-cli-")
    serve_dir = os.path.join(root, "serve")
    store_root = os.path.join(root, "store")
    procs = []

    def start(tag, *args):
        p = port_popen(root, tag, *args)
        procs.append(p[0])
        return p

    try:
        with phase("cli", seconds):
            t0 = time.perf_counter()
            daemon, d_out, d_err = start(
                "serve", "serve", "--check-daemon", "--host", "127.0.0.1",
                "--port", "0", "--serve-dir", serve_dir, "--batch-max",
                str(CLI_BATCH_MAX), "--batch-wait-ms", str(CLI_WAIT_MS),
                "--auth-token", CLI_TOKEN, "--serve-backend", "gpu",
                "--device", *on)
            run, r_out, r_err = start(
                "run", "run", "--suite", "local-kv", "--device", *on,
                "--watch", "--profile", "--time-limit", str(CLI_RUN_S),
                "--store-root", store_root)
            # ``watch`` follows the run's store from as soon as it exists,
            # while the run is in flight, until its run.state is terminal
            kv_root = os.path.join(store_root, "local-kv")
            follower = {}

            def follow():
                while not (os.path.isdir(kv_root) and [
                        d for d in os.listdir(kv_root) if d != "latest"]):
                    if run.poll() is not None:
                        return
                    time.sleep(0.05)
                follower["dir"] = os.path.join(kv_root, next(
                    d for d in os.listdir(kv_root) if d != "latest"))
                follower["in_flight"] = run.poll() is None
                follower["proc"] = start("watch", "watch", "--store",
                                         follower["dir"], "--interval",
                                         "0.2")
                # watch --once as soon as the search publishes its status
                progress = os.path.join(follower["dir"], "progress.json")
                while not os.path.exists(progress) and run.poll() is None:
                    time.sleep(0.05)
                follower["once_in_flight"] = run.poll() is None
                follower["once"] = start("watch-once", "watch", "--once",
                                         "--store", follower["dir"])

            follow_thread = threading.Thread(target=follow)
            follow_thread.start()
            started = {"analyze": start("analyze", "analyze", "--store",
                                        kv_store, "--profile", "--device",
                                        *on)}
            # meanwhile here: the gang's histories and lone checks
            _, _, _, _, gang8 = serve_members()
            lone = [check_history_gpu(m[0], CASRegister(), device=dev)
                    for m in gang8]
            marks = {"lone": time.perf_counter() - t0}
            while "Listening on" not in read_text(d_out):
                assert daemon.poll() is None, read_text(d_err)[-3000:]
                assert time.perf_counter() - t0 < 300, "no daemon"
                time.sleep(0.1)
            port = int(re.search(r"http://127\.0\.0\.1:(\d+)/",
                                 read_text(d_out)).group(1))
            marks["daemon"] = time.perf_counter() - t0
            docs = [{"tenant": f"tenant{i % 2}", "model": "cas-register",
                     "history": [o.to_dict() for o in m[0]]}
                    for i, m in enumerate(gang8)]
            code, _ = http_json(port, "POST", "/check", docs[0])
            assert code == 401, code
            ids = [None] * len(docs)

            def post(i):
                code, body = http_json(port, "POST", "/check", docs[i],
                                       token=CLI_TOKEN)
                assert code == 202, (code, body)
                ids[i] = body["id"]

            threads = [threading.Thread(target=post, args=(i,))
                       for i in range(len(docs))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            assert all(ids), ids
            results = {}
            while len(results) < len(ids):
                for rid in ids:
                    if rid not in results:
                        code, doc = http_json(port, "GET", f"/check/{rid}")
                        if doc.get("state") == "done":
                            results[rid] = doc["result"]
                assert time.perf_counter() - t0 < 600, "gangs timed out"
                time.sleep(0.05)
            marks["gangs"] = time.perf_counter() - t0
            # the daemon's directory through trace, and the atom run
            # through the daemon's stream routes
            for tag, argv in (
                    ("summary", ("trace", "summary", "--store", serve_dir)),
                    ("request", ("trace", "request", ids[0], "--store",
                                 serve_dir)),
                    ("find", ("trace", "find", "--min-device-s", "0",
                              "--format", "json", "--store", serve_dir)),
                    ("export", ("trace", "export", "--format", "chrome",
                                "--store", serve_dir)),
                    ("stream", ("stream", "--url",
                                f"http://127.0.0.1:{port}", "--store",
                                kv_store, "--auth-token", CLI_TOKEN,
                                "--chunk", "500", "--poll", "0.1"))):
                started[tag] = start(f"{tag}", *argv)
            proc, _, errp = started["analyze"]
            assert proc.wait(timeout=600) == 0, read_text(errp)[-3000:]
            started["profiled"] = start(
                "trace-profiled", "trace", "summary", "--format", "json",
                "--top", "100", "--store", kv_store)
            # the watched run, the watch that followed it, watch --once,
            # and the kernels of the run's own profile
            run_rc = run.wait(timeout=600)
            marks["run"] = time.perf_counter() - t0
            follow_thread.join(timeout=120)
            assert "proc" in follower, read_text(r_err)[-3000:]
            run_dir, in_flight = follower["dir"], follower["in_flight"]
            follow, f_out, f_err = follower["proc"]
            started["once"] = follower["once"]
            outs = {}
            for tag, (proc, outp, errp) in started.items():
                assert proc.wait(timeout=600) == 0, (tag, read_text(errp))
                outs[tag] = read_text(outp)
            assert follow.wait(timeout=120) == 0, read_text(f_err)[-2000:]
            marks["commands"] = time.perf_counter() - t0
            launches = daemon_launches(port)
            code, health = http_json(port, "GET", "/healthz")
            records, _ = journal.read_json_records(
                os.path.join(serve_dir, serve.WAL_NAME))
            gangs = [r["ids"] for r in records if r.get("event") == "gang"]
            assert http_json(port, "POST", "/drain",
                             token=CLI_TOKEN)[0] == 200
            assert daemon.wait(timeout=120) == 0, read_text(d_err)[-3000:]
            marks["drained"] = time.perf_counter() - t0
        # -- what they said ------------------------------------------------
        for rid, want in zip(ids, lone):
            got = results[rid]
            assert (got["valid"], got["levels"]) == (
                want["valid"], want["levels"]), (rid, got, want)
            assert got["valid"] is True and got["backend"] == "gpu"
        assert in_flight, "the run ended before watch started"
        ticker = [ln for ln in read_text(r_err).splitlines()
                  if ln.startswith("# watch:")]
        run_res = store.load(run_dir)["results"]
        assert run_rc == (0 if run_res["valid"] is True else 1), \
            (run_rc, run_res["valid"])
        assert run_res["linear"]["backend"] == "gpu"
        assert ticker and "level" in ticker[-1], read_text(r_err)[-2000:]
        followed = read_text(f_out).splitlines()
        assert any(ln.startswith("# watch: level") for ln in followed), \
            followed
        once = outs["once"]
        assert once.startswith("# watch: level"), once
        stream_res = result_json(outs["stream"])
        analyze_res = result_json(outs["analyze"])
        assert stream_res["valid"] is analyze_res["valid"] is True
        sizes = sorted(len(g) for g in gangs)
        assert sizes and max(sizes) <= CLI_BATCH_MAX < 8, sizes
        assert health["stats"]["max-batch"] <= CLI_BATCH_MAX, health
        assert outs["summary"].startswith("# trace: integrity:")
        waterfall = outs["request"].splitlines()
        assert ids[0] in waterfall[0] and len(waterfall) > 2, waterfall
        found = {r["id"]: r for r in json.loads(outs["find"])["requests"]}
        assert set(ids) <= set(found), (ids, sorted(found))
        assert all(found[rid]["device-s"] > 0 for rid in ids), found
        chrome = json.loads(outs["export"])
        assert chrome["traceEvents"], "empty export"
        kernels = json.loads(outs["profiled"])["kernels"]
        named = {k: sum(r["self-ns"] for r in kernels
                        if any(n in r["name"] for n in names))
                 for k, names in CLI_PROFILE_KERNELS.items()}
        # the watched run's own capture: its check is the process's first
        # CUDA work, and its profile has the kernels all the same
        run_records, _ = profiler.read_profile(run_dir)
        run_named = {k: sum(r["dur"] for r in run_records
                            if any(n in r["name"] for n in names))
                     for k, names in CLI_PROFILE_KERNELS.items()}
        # the plain versions launch no kernel: a dry run on the CPU has
        # neither kernels in its profiles nor launches in its counts
        for got in (named, run_named):
            assert all(ns > 0 for ns in got.values()) \
                or dev.type != "cuda", (got, kernels[:20],
                                        sorted({r["name"] for r in
                                                run_records})[:40])
        assert all(launches.get(k, 0) > 0 for k in (
            "expand", "sort_rows", "dedup_truncate", "pair_end")) \
            or dev.type != "cuda", launches
        line.update({
            "gang_sizes": sizes, "verdicts_equal_lone": len(ids),
            "levels": [r["levels"] for r in lone],
            "unauthorized": 401, "run_rc": run_rc,
            "run_levels": run_res["linear"].get("levels"),
            "watch_in_flight": in_flight, "watch_followed": followed[-3:],
            "watch_once": once.strip(),
            "watch_once_in_flight": follower["once_in_flight"],
            "run_watch_ticker": ticker[-1],
            "stream": {"valid": stream_res["valid"],
                       "levels": stream_res.get("levels")},
            "analyze": {"valid": analyze_res["valid"],
                        "levels": analyze_res.get("levels")},
            "trace_find_device_s": {rid: found[rid]["device-s"]
                                    for rid in ids},
            "trace_request_records": len(waterfall) - 1,
            "chrome_events": len(chrome["traceEvents"]),
            "profiled_kernel_ns": named,
            "run_profiled_kernel_ns": run_named,
            "daemon_launches": launches, "seconds_at": marks})
        print("cli:", json.dumps(line), flush=True)
        # the watched, profiled run outlives the phase's directory: the
        # daemon telemetry phase serves it
        kept = tempfile.mkdtemp(prefix="jtpu-run-")
        shutil.copytree(run_dir, os.path.join(kept,
                                              os.path.basename(run_dir)))
    finally:
        # an interrupt lets a run tear its nodes down; then a kill
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        shutil.rmtree(root, ignore_errors=True)
    return line, {k: launches.get(k, 0) for k in KERNELS}, launches.get(
        "pair_end", 0), {"run": os.path.join(
            kept, os.path.basename(run_dir)), "lone": lone}


#: the daemon telemetry phase: its daemon's time-series cadence (s), and
#: the name the runner phase's local-kv store takes in the browser's store
TEL_CADENCE_S = 0.5
TEL_KV_TS = "20260101T000000.000"
TEL_TRACEPARENT = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"


def http_get(port, path):
    """(status, body bytes) of a GET on localhost; an error status is an
    answer too."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=300) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def wait_listening(proc, outp, errp, t0, limit=300):
    """The port a ``serve`` process printed it listens on."""
    while "Listening on" not in read_text(outp):
        assert proc.poll() is None, read_text(errp)[-3000:]
        assert time.perf_counter() - t0 < limit, "no daemon"
        time.sleep(0.05)
    return int(re.search(r"http://127\.0\.0\.1:(\d+)/",
                         read_text(outp)).group(1))


def daemon_telemetry_phase(dev, seconds, smi, kv_store, cli_kept):
    """The daemon's telemetry plane and the results browser on the card:
    ``serve --check-daemon --batch-max 4`` as a process, with
    ``JTPU_TSDB_CADENCE=0.5`` and ``JTPU_SERVE_BATCH_VERIFY=1``, over a
    store holding the runner phase's local-kv run (``kv_store``) and the
    cli phase's watched, profiled run (``cli_kept["run"]``). The cli
    phase's 8 same-bucket 2,000-op histories from three tenants: each
    verdict and ``levels`` that of the lone check (``cli_kept["lone"]``),
    each gang re-run serially (context-free ``checker.segment`` spans in
    the daemon's trace, no ``batch-mismatch``); ``GET /usage`` against
    ``usage --json`` on the WAL; ``/slo``'s default objectives; the
    burn-rate gauge and K1, K2 and K4's launches in ``/metrics``;
    ``metrics.tsdb`` with two ticks or more; a stream opened with a
    ``traceparent`` (its trace id on ``GET /stream/<id>``, the stream keys
    in ``progress.json`` while it is open); a gang member's ``GET
    /trace/request/<id>`` with the gang's join event; ``top --once`` and
    ``watch --store --once`` on the serve directory; the browser's home,
    ``/live``, ``/trace`` (the profiled run's kernels as its device lane),
    ``/explain``, a file and its zip; ``../`` refused. ``POST /drain``
    (the process exits 0), a second incarnation on the same directory
    replaying the meter to the same ``/usage``, SIGTERM (exit 0), and
    ``flightrec`` listing the drain and sigterm dumps, the drain dump's
    ``--json`` holding spans and the time-series annex. Removes
    ``kv_store`` and the cli phase's copy. Returns the phase's JSON
    entry, the first daemon's kernel launches (its ``/metrics``) and its
    pair ends."""
    import shutil
    import signal
    import tempfile
    import threading
    from jepsen_tpu_torch import journal, serve
    from jepsen_tpu_torch.obs import flightrec as obs_flightrec
    line = {"card": smi}
    on = ("cuda",) if dev.type == "cuda" else ("cpu",)
    root = tempfile.mkdtemp(prefix="jtpu-tel-")
    store_root = os.path.join(root, "store")
    serve_dir = os.path.join(store_root, "serve")
    run_ts = os.path.basename(cli_kept["run"])
    procs = []
    env = dict(port_env(), JTPU_TSDB_CADENCE=str(TEL_CADENCE_S),
               JTPU_SERVE_BATCH_VERIFY="1")

    def start(tag, *args):
        outp = os.path.join(root, f"{tag}.out")
        errp = os.path.join(root, f"{tag}.err")
        with open(outp, "w") as o, open(errp, "w") as e:
            proc = subprocess.Popen(
                [sys.executable, "-m", "jepsen_tpu_torch", *args],
                cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                stdout=o, stderr=e)
        procs.append(proc)
        return proc, outp, errp

    daemon_args = ("serve", "--check-daemon", "--host", "127.0.0.1",
                   "--port", "0", "--store-root", store_root,
                   "--batch-max", str(CLI_BATCH_MAX), "--batch-wait-ms",
                   str(CLI_WAIT_MS), "--serve-backend", "gpu", "--device",
                   *on)
    try:
        with phase("daemon telemetry", seconds):
            t0 = time.perf_counter()
            daemon, d_out, d_err = start("serve", *daemon_args)
            shutil.copytree(kv_store, os.path.join(store_root, "local-kv",
                                                   TEL_KV_TS))
            shutil.copytree(cli_kept["run"], os.path.join(
                store_root, "local-kv", run_ts))
            _, _, _, _, gang8 = serve_members()
            docs = [{"tenant": f"tenant{i % 3}", "model": "cas-register",
                     "history": [o.to_dict() for o in m[0]]}
                    for i, m in enumerate(gang8)]
            port = wait_listening(daemon, d_out, d_err, t0)
            marks = {"daemon": time.perf_counter() - t0}
            ids = [None] * len(docs)

            def post(i):
                code, body = http_json(port, "POST", "/check", docs[i])
                assert code == 202, (code, body)
                ids[i] = body["id"]

            threads = [threading.Thread(target=post, args=(i,))
                       for i in range(len(docs))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            assert all(ids), ids
            # top and watch read the live daemon's heartbeat while the
            # gangs run (a process takes its seconds to start)
            cmds = {tag: start(tag, *argv) for tag, argv in (
                ("top", ("top", "--once", "--store", serve_dir)),
                ("watch", ("watch", "--once", "--store", serve_dir)))}
            # a traced stream, opened while the gangs run
            import urllib.request
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/stream", method="POST",
                data=json.dumps({"tenant": "streamer",
                                 "model": "cas-register"}).encode(),
                headers={"traceparent": TEL_TRACEPARENT})
            with urllib.request.urlopen(req, timeout=300) as resp:
                opened = json.loads(resp.read())
                stream_tp = resp.headers.get("traceparent")
            sid = opened["id"]
            sops = docs[0]["history"]
            half = len(sops) // 2
            code, _ = http_json(port, "POST", f"/stream/{sid}/ops",
                                {"seq": 0, "ops": sops[:half]})
            assert code == 202, code
            progress_path = os.path.join(serve_dir, "progress.json")
            while True:
                with open(progress_path) as f:
                    beat = json.load(f)
                if "streams" in beat["serve"]:
                    break
                assert time.perf_counter() - t0 < 300, beat
                time.sleep(0.05)
            code, _ = http_json(port, "POST", f"/stream/{sid}/ops",
                                {"seq": 1, "ops": sops[half:]})
            assert code == 202, code
            assert http_json(port, "POST", f"/stream/{sid}/close",
                             {"chunks": 2})[0] == 200
            results = {}
            while len(results) < len(ids):
                for rid in ids:
                    if rid not in results:
                        code, doc = http_json(port, "GET", f"/check/{rid}")
                        if doc.get("state") == "done":
                            results[rid] = doc["result"]
                assert time.perf_counter() - t0 < 600, "gangs timed out"
                time.sleep(0.05)
            marks["gangs"] = time.perf_counter() - t0
            while True:
                code, sdoc = http_json(port, "GET", f"/stream/{sid}")
                if sdoc["state"] == "done":
                    break
                assert time.perf_counter() - t0 < 600, sdoc
                time.sleep(0.05)
            # usage over the WAL, which the drain leaves as it is
            cmds["usage"] = start("usage", "usage", "--json", "--serve-dir",
                                  serve_dir)
            usage = http_json(port, "GET", "/usage")[1]
            slo = http_json(port, "GET", "/slo")[1]
            code, metrics_text = http_get(port, "/metrics")
            metrics_text = metrics_text.decode()
            launches = daemon_launches(port)
            records, _ = journal.read_json_records(
                os.path.join(serve_dir, serve.WAL_NAME))
            gangs = [r["ids"] for r in records if r.get("event") == "gang"]
            # a member that joined a leader's gang: its trace has the join
            member = next(g[1] for g in gangs if len(g) > 1)
            pages = {}
            for tag, path in (
                    ("home", "/"),
                    ("live", f"/live/local-kv/{run_ts}"),
                    ("trace", f"/trace/local-kv/{run_ts}"),
                    ("explain", f"/explain/local-kv/{TEL_KV_TS}"),
                    ("file", f"/files/local-kv/{TEL_KV_TS}/results.json"),
                    ("zip", f"/files/local-kv/{run_ts}?zip"),
                    ("request", f"/trace/request/{member}"),
                    ("files-up", "/files/../../etc/passwd"),
                    ("flightrec-up", "/flightrec/..%2Fserve.wal")):
                pages[tag] = http_get(port, path)
            outs = {}
            for tag in ("top", "watch"):
                proc, outp, errp = cmds[tag]
                assert proc.wait(timeout=300) == 0, (tag, read_text(errp))
                outs[tag] = read_text(outp)
            marks["commands"] = time.perf_counter() - t0
            assert http_json(port, "POST", "/drain")[0] == 200
            assert daemon.wait(timeout=120) == 0, read_text(d_err)[-3000:]
            marks["drained"] = time.perf_counter() - t0
            # the drain's dump through flightrec, while a second
            # incarnation replays the meter and is SIGTERMed
            drain_dump = next(
                d["name"] for d in obs_flightrec.list_dumps(serve_dir)
                if d["reason"] == "drain")
            one = start("flightrec-one", "flightrec", drain_dump, "--json",
                        "--serve-dir", serve_dir)
            again, a_out, a_err = start("serve-again", *daemon_args)
            port2 = wait_listening(again, a_out, a_err, t0)
            usage2 = http_json(port2, "GET", "/usage")[1]
            again.send_signal(signal.SIGTERM)
            assert again.wait(timeout=120) == 0, read_text(a_err)[-3000:]
            marks["sigterm"] = time.perf_counter() - t0
            proc, outp, errp = start("flightrec", "flightrec", "--json",
                                     "--serve-dir", serve_dir)
            assert proc.wait(timeout=300) == 0, read_text(errp)
            dumps = json.loads(read_text(outp))["dumps"]
            proc, outp, errp = one
            assert proc.wait(timeout=300) == 0, read_text(errp)
            dump = json.loads(read_text(outp))
            proc, outp, errp = cmds["usage"]
            assert proc.wait(timeout=300) == 0, read_text(errp)
            outs["usage"] = read_text(outp)
            marks["flightrec"] = time.perf_counter() - t0
        # -- what they said ------------------------------------------------
        lone = cli_kept["lone"]
        for rid, want in zip(ids, lone):
            got = results[rid]
            assert (got["valid"], got["levels"]) == (
                want["valid"], want["levels"]), (rid, got, want)
            assert got["valid"] is True and "batch-mismatch" not in got
        sizes = sorted({r["serve"].get("gang", {}).get("size", 1)
                        for r in results.values()})
        assert max(sizes) <= CLI_BATCH_MAX, sizes
        ganged = sum(len(g) for g in gangs)
        # the serial re-runs of batch verify run outside any request's
        # trace: their segments are the daemon's only trace-less ones
        with open(os.path.join(serve_dir, "trace.jsonl")) as f:
            text = f.read()
        verify_segments = sum(
            1 for ln in text.splitlines()
            if '"name":"checker.segment"' in ln.replace(" ", "")
            and '"trace"' not in ln)
        assert gangs and verify_segments >= ganged, (gangs,
                                                     verify_segments)
        wal_usage = json.loads(outs["usage"])
        for t, u in wal_usage["tenants"].items():
            live = usage["tenants"][t]
            assert (u["requests"], u["ops"]) == (live["requests"],
                                                 live["ops"]), (t, u, live)
            assert u["device-s"] > 0, (t, u)
        assert sorted(wal_usage["tenants"]) == [
            "tenant0", "tenant1", "tenant2"], wal_usage
        assert usage2 == usage, (usage2, usage)
        assert set(slo["objectives"]) == {
            "verdict-latency-p99", "queue-wait-p95", "availability"}, slo
        assert "jtpu_slo_burn_rate{" in metrics_text
        assert all(launches.get(k, 0) > 0 for k in (
            "expand", "sort_rows", "dedup_truncate")) \
            or dev.type != "cuda", launches
        tsdb_records, _ = journal.read_json_records(
            os.path.join(serve_dir, "metrics.tsdb"))
        ticks = sum(r.get("k") == "tick" for r in tsdb_records)
        assert ticks >= 2, ticks
        trace_id = TEL_TRACEPARENT.split("-")[1]
        assert opened["trace"] == trace_id and trace_id in stream_tp
        assert sdoc["trace"] == trace_id and sdoc["result"]["valid"] is True
        assert {"streams", "stream-ops", "stream-checked",
                "stream-lag"} <= set(beat["serve"]), beat
        assert outs["top"].splitlines()[1].startswith(
            "# top: state serving | queue "), outs["top"]
        assert outs["watch"].strip(), outs["watch"]
        for tag in ("home", "live", "trace", "explain", "file", "zip",
                    "request"):
            assert pages[tag][0] == 200, (tag, pages[tag][1][:500])
        assert pages["files-up"][0] in (403, 404), pages["files-up"]
        assert pages["flightrec-up"][0] == 404, pages["flightrec-up"]
        assert b"serve.gang.join" in pages["request"][1]
        assert pages["zip"][1][:2] == b"PK"
        trace_page = pages["trace"][1].decode()
        assert "device lane" in trace_page
        device_kernels = {k: sum(trace_page.count(n) for n in names)
                          for k, names in CLI_PROFILE_KERNELS.items()}
        assert all(device_kernels.values()) or dev.type != "cuda", \
            device_kernels
        assert {d["reason"] for d in dumps} == {"drain", "sigterm"}, dumps
        assert dump["reason"] == "drain" and dump["spans"] \
            and dump["tsdb"]["series"], sorted(dump)
        line.update({
            "gang_sizes": sizes, "gangs": len(gangs),
            "verdicts_equal_lone": len(ids),
            "verify_segments": verify_segments,
            "usage": {t: {k: u[k] for k in ("requests", "ops", "device-s")}
                      for t, u in usage["tenants"].items()},
            "usage_equal_wal": True, "usage_replayed_equal": True,
            "slo_objectives": sorted(slo["objectives"]),
            "tsdb_ticks": ticks, "stream_trace": sdoc["trace"],
            "stream_keys": {k: beat["serve"][k] for k in (
                "streams", "stream-ops", "stream-checked", "stream-lag")},
            "top": outs["top"].splitlines()[1:],
            "watch": outs["watch"].strip(),
            "pages": {t: p[0] for t, p in pages.items()},
            "trace_device_kernels": device_kernels,
            "dumps": sorted(d["reason"] for d in dumps),
            "dump_spans": len(dump["spans"]),
            "daemon_launches": launches, "seconds_at": marks})
        print("daemon telemetry:", json.dumps(line), flush=True)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(kv_store, ignore_errors=True)
        shutil.rmtree(os.path.dirname(cli_kept["run"]), ignore_errors=True)
    return line, {k: launches.get(k, 0) for k in KERNELS}, launches.get(
        "pair_end", 0)


#: the fleet phase: (a) wide_history(**WIDE) searched pool-sharded over a
#: FLEET_SHARDS-shard mesh of the card at FLEET_RUNG (window: the
#: history's bucket) against the unsharded search, and its first
#: FLEET_LEVEL_REPS levels timed both ways; (b) the
#: headline through the elastic fleet on two worker processes, one
#: SIGKILLed after round FLEET_KILL_ROUND, against the same fleet of
#: in-process hosts; (c) the 8 gang histories sent to ``serve --fleet 2``
#: with worker host-1 slowed FLEET_SLOW_S before each segment and killed
#: in its first; (d) the keyed staggered headline by
#: check_keyed_distributed over two gloo ranks on the card, then on the
#: same two ranks (a)'s search over a global mesh of 2 entries a rank in
#: segments of FLEET_DCN_SEGMENT_ITERS levels, held against the unsharded
#: search at the same segments at every segment end, its first levels
#: timed (FLEET_DCN_TIMING), and the reference dryrun's two legs
FLEET_SHARDS = 4
FLEET_RUNG = (4096, None, 512)
FLEET_LEVEL_REPS = 8
FLEET_KILL_ROUND = 1
FLEET_SLOW_S = 2.0
FLEET_RANK_CHILD = """
import json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, os.path.join(sys.argv[1], "tools"))
from jepsen_tpu_torch import interop, parallel
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.ops.encode import pack_with_init
from jepsen_tpu_torch.testing import simulate_register_history, wide_history
import torch_dryrun_dcn as dcn
keys, ops, kw, out, device, wide, rung, seg, reps = json.loads(sys.argv[2])
keyed = {k: simulate_register_history(ops, n_procs=5, n_vals=8,
                                      seed=7000 + k, **kw)
         for k in range(keys)}
res = parallel.check_keyed_distributed(keyed, CASRegister(), device=device)
rank = int(os.environ["JTPU_PROCESS_ID"])
if rank == 0:
    with open(out, "w") as fh:
        json.dump({"valid": repr(res["valid"]), "ranks": res.get("ranks"),
                   "results": {str(k): [repr(r["valid"]), r.get("levels"),
                                        r.get("rung"), r.get("crash-width"),
                                        r.get("tiebreak")]
                               for k, r in res["results"].items()}}, fh)
# one pool-sharded search over the global mesh: 2 entries a rank
dev = torch.device(device or "cuda")
cuda = dev.type == "cuda"
pmesh = parallel.make_mesh(axis="pool", devices=[dev] * 2)
p, kernel = pack_with_init(wide_history(**wide), CASRegister())
cap, _, exp = rung
win = G._window_bucket(G._window_needed(p))
ends = []
K.reset_launches()
t0 = time.perf_counter()
sharded = G.check_packed_sharded(
    p, kernel, pmesh, capacity=cap, window=win, expand=exp,
    segment_iters=seg, on_checkpoint=lambda cp: ends.append(cp.carry))
search_s = time.perf_counter() - t0
launches = {k: K.launches[k] for k in ("expand", "sort_rows", "merge_runs",
                                       "dedup_truncate", "seg_active")}
doc = {"rank": rank, "search_s": search_s, "launches": launches,
       "verdict": [repr(sharded["valid"]), sharded["levels"],
                   sharded.get("max-linearized-prefix")],
       "ranks": sharded.get("ranks"), "mesh": pmesh.size,
       "pool_sharding": sharded["pool-sharding"], "ends": len(ends)}
if rank == 0:
    np.savez(out + ".ends.npz", **{f"e{i}_{j}": x for i, c in enumerate(ends)
                                   for j, x in enumerate(c)})
else:
    doc["crcs"] = [G._carry_crc(c) for c in ends]
# the first levels of the search timed on every rank (each level is one
# exchange, so every rank runs them); CUDA events on the card
cols_np = G._prep_single(p, kernel)[0]
shape = K.LevelShape(C=cap, W=win, E=exp, n=cols_np["f"].shape[0],
                     CR=cols_np["cf"].shape[0], model=kernel.name)
host = G._carry0_host(cap, win, shape.CR, cols_np["ini"], int(cols_np["nr"]),
                      stats_rows=shape.lmax + 1)
st = G.ShardedState(pmesh.devices, cols_np, shape, True, pmesh.ranks,
                    pmesh.rank)
level_ms, exchange_ms, gather_ms = [], [], []
for rep in range(reps[0] + 1):
    interop.carry_from_numpy(host, st.lead, out=st.carry)
    st.acc.zero_()
    st.exchange_log = []
    if cuda:
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
    else:
        t0 = time.perf_counter()
    for _ in range(reps[1]):
        st.level()
    if cuda:
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b)
        ex = sum(e0.elapsed_time(e1) for e0, e1, _ in st.exchange_log)
    else:
        ms = (time.perf_counter() - t0) * 1e3
        ex = sum(t1 - t0 for t0, t1, _ in st.exchange_log) * 1e3
    if rep:
        level_ms.append(ms / reps[1])
        exchange_ms.append(ex / reps[1])
        gather_ms.append(sum(g for *_, g in st.exchange_log) * 1e3
                         / reps[1])
# the collective alone, both ranks entering it together: gloo's floor for
# a level's bytes on this host
block = st.hsend if st.staged else st.xsend
recv = st.hrecv if st.staged else st.xrecv
alone = []
for _ in range(reps[0] * reps[1]):
    dist.barrier()
    t0 = time.perf_counter()
    parallel.all_gather_tensor(recv, block)
    alone.append((time.perf_counter() - t0) * 1e3)
mid = lambda xs: sorted(xs)[len(xs) // 2]
doc.update(level_ms=mid(level_ms), exchange_ms=mid(exchange_ms),
           gather_ms=mid(gather_ms), gather_alone_ms=mid(alone),
           exchange_bytes=st.exchange_bytes, reps=reps)
del st
# the reference dryrun's two legs on the global mesh
lines = []
legs = dcn.dcn_legs([dev] * 2, out=lines.append)
doc["dcn_lines"] = lines
keyed_res = legs["keyed"]["results"]
doc["dcn"] = {"keyed_valid": repr(legs["keyed"]["valid"]),
              "invalid_key": repr(keyed_res["invalid"]["valid"]),
              "valid": repr(legs["valid"]["valid"]),
              "refuted": repr(legs["refuted"]["valid"])}
with open(out + f".rank{rank}.json", "w") as fh:
    json.dump(doc, fh)
"""

#: the fleet phase's (d): the levels of the cross-rank search timed
#: (repetitions, levels), as (a) times its first FLEET_LEVEL_REPS levels
FLEET_DCN_TIMING = (5, FLEET_LEVEL_REPS)
#: the cross-rank search's segment length: several segment ends (and the
#: ranks' lock-step check at each) over the wide history's levels
FLEET_DCN_SEGMENT_ITERS = 8


def keyed_fields(res) -> dict:
    """A keyed result's per-key verdict fields, as the rank child writes
    them."""
    return {str(k): [repr(r["valid"]), r.get("levels"),
                     list(r["rung"]) if r.get("rung") else r.get("rung"),
                     r.get("crash-width"), r.get("tiebreak")]
            for k, r in res["results"].items()}


def fleet_phase(dev, seconds, smi):
    """B8 and the fleet on the card: (a) the pool-sharded search over a
    mesh of FLEET_SHARDS logical shards of the card, each segment end's
    carry held bit for bit against the unsharded search's, its K2 merge
    (``merge_runs``) held against its plain version and timed, the
    search's first levels timed sharded and unsharded; (b) the elastic fleet on two worker processes sharing
    the card, one SIGKILLed mid-rung; (c) ``serve --fleet 2``'s gangs
    with a worker killed mid-gang; (d) the keyed headline over two gloo
    ranks, then (a)'s search with its pool sharded across the two ranks
    (2 shards each, the runs exchanged every level), each segment end
    held bit for bit against (a)'s unsharded search's, the level and its
    exchange timed, and ``tools/torch_dryrun_dcn.py``'s two legs.
    Returns (line, the sharded search's launches and CUDA launches and
    pair ends, the merge kernel's JSON entry)."""
    import shutil
    import signal
    import tempfile
    import threading
    from jepsen_tpu_torch import fleet, interop, parallel, resilience
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.checker.gpu import check_keyed_gpu
    from jepsen_tpu_torch.kernels import cost as kcost
    from jepsen_tpu_torch.kernels import search as K
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops.encode import pack_with_init
    from jepsen_tpu_torch.testing import (simulate_register_history,
                                          wide_history)
    line = {"card": smi}
    root = tempfile.mkdtemp(prefix="jtpu-fleet-")
    procs = []
    try:
        with phase("fleet", seconds):
            t0 = time.perf_counter()
            # (a) the pool-sharded search against the unsharded one
            p, kernel = pack_with_init(wide_history(**WIDE), CASRegister())
            cap, _, exp = FLEET_RUNG
            win = G._window_bucket(G._window_needed(p))
            mesh = parallel.make_mesh(axis="pool",
                                      devices=[dev] * FLEET_SHARDS)
            ends_u, ends_s = [], []
            unsharded = resilience.supervised_check_packed(
                p, kernel, capacity=cap, window=win, expand=exp,
                device=dev, on_checkpoint=ends_u.append)
            K.reset_launches()
            sharded = G.check_packed_sharded(
                p, kernel, mesh, capacity=cap, window=win, expand=exp,
                on_checkpoint=ends_s.append)
            launches = dict(K.launches)
            grid = dict(K.grid_launches_total)
            segs = {"pair_ends": K.segments["pair_ends"]}
            for f in ("valid", "levels", "max-linearized-prefix"):
                assert sharded.get(f) == unsharded.get(f), \
                    (f, sharded.get(f), unsharded.get(f))
            assert len(ends_s) == len(ends_u) >= 1
            for a, b in zip(ends_u, ends_s):
                assert all(np.array_equal(np.asarray(x), np.asarray(y))
                           for x, y in zip(a.carry, b.carry)), \
                    "a segment end's carry differs"
            for name in ("expand", "sort_rows", "merge_runs",
                         "dedup_truncate", "seg_active"):
                # (the plain versions of a CPU dry run count nothing)
                assert launches[name] > 0 or dev.type != "cuda", \
                    (name, launches)
            line["sharded"] = {
                "rung": [cap, win, exp], "shards": FLEET_SHARDS,
                "valid": sharded["valid"], "levels": sharded["levels"],
                "segment_ends_equal": len(ends_s),
                "shard_balance": sharded["shard-balance"],
                "pool_sharding": sharded["pool-sharding"],
                "launches": {k: v for k, v in launches.items() if v},
                "cuda_launches": {k: v for k, v in grid.items() if v}}
            print(f"fleet sharded: {sharded['pool-sharding']} "
                  f"{sharded['levels']} levels, balance "
                  f"{sharded['shard-balance']}", flush=True)
            # the first levels timed both ways, and the merge
            cols_np = G._prep_single(p, kernel)[0]
            shape = K.LevelShape(C=cap, W=win, E=exp,
                                 n=cols_np["f"].shape[0],
                                 CR=cols_np["cf"].shape[0],
                                 model=kernel.name)
            host = G._carry0_host(cap, win, shape.CR, cols_np["ini"],
                                  int(cols_np["nr"]),
                                  stats_rows=shape.lmax + 1)
            st = G.ShardedState([dev] * FLEET_SHARDS, cols_np, shape, True)
            from jepsen_tpu_torch.checker.engine import Engine
            eng = Engine()
            carry, scratch = eng.state(shape, dev, True)
            cols = eng.cols(cols_np, dev)

            def reload():
                interop.carry_from_numpy(host, dev, out=st.carry)
                interop.carry_from_numpy(host, dev, out=carry)
                st.acc.zero_()
                scratch.acc.zero_()
                return ()

            def sharded_levels():
                for _ in range(FLEET_LEVEL_REPS):
                    st.level()

            def unsharded_levels():
                for _ in range(FLEET_LEVEL_REPS):
                    G.search_level(cols, carry, scratch, shape, cols["nr"])
            line["level_ms"] = {
                "sharded": device_ms(sharded_levels, reload)
                / FLEET_LEVEL_REPS,
                "unsharded": device_ms(unsharded_levels, reload)
                / FLEET_LEVEL_REPS,
                "bound_ms": kcost.per_level(shape)["bytes-accessed"]
                / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
                "from_level": int(host[8]), "levels": FLEET_LEVEL_REPS}
            reload()
            st.expand_shards()
            RM = st.rows.shape[1]
            runs, alt = st.rows.clone(), st.rows_alt.clone()
            outs = {}
            for tag, fn in (("kernel", K.merge_runs),
                            ("plain", K.merge_runs_plain)):
                a, b = runs.clone(), alt.clone()
                outs[tag] = fn(a, b, st.carry.scal, shape, RM,
                               st.run)[:, :shape.R].clone()
            err = int((outs["kernel"].long()
                       - outs["plain"].long()).abs().max())
            assert err == 0, err

            def prep_merge():
                return runs.clone(), alt.clone()
            key = (runs[0, :, 0].long() << 32) | (
                runs[0, :, 1].long() & 0xFFFFFFFF)
            nbytes = 2 * 4 * shape.R * shape.NK
            merge = {
                "name": "merge_runs", "route": "cuda", "source": SOURCE,
                "replaces": "jepsen_tpu/checker/tpu.py:244",
                "launches": launches["merge_runs"], "path": "fleet",
                "state": "fleet sharded",
                "max_abs_err": err,
                "ms": device_ms(lambda a, b: K.merge_runs(
                    a, b, st.carry.scal, shape, RM, st.run), prep_merge),
                "plain_ms": host_ms(lambda a, b: K.merge_runs_plain(
                    a, b, st.carry.scal, shape, RM, st.run), prep_merge),
                "bound_ms": nbytes / PEAK_BYTES_S * 1e3,
                "bound_by": "bytes",
                "library_ms": device_ms(
                    lambda k: torch.sort(k), lambda: (key.clone(),)),
                "rows": RM, "run": st.run,
                "cuda_launches_per_call": K.merge_passes(RM, st.run)}
            del st, eng, carry, scratch, cols
            line["a_s"] = time.perf_counter() - t0
            # (b) the elastic fleet: two worker processes, one killed
            head_p, head_k = pack_with_init(
                simulate_register_history(**HEADLINE), CASRegister())
            single = G.check_packed_gpu(head_p, head_k, device=dev)
            hosts = [fleet.ProcHost(f"host-{i}",
                                    os.path.join(root, f"fleet-host-{i}"),
                                    device=str(dev)) for i in range(2)]
            killed = {}

            def kill(round_idx, fl):
                if round_idx == FLEET_KILL_ROUND and not killed:
                    killed["pid"] = fl.hosts[1].pid
                    os.kill(fl.hosts[1].pid, signal.SIGKILL)
                    fl.hosts[1].proc.wait(timeout=30)
            procs.extend(hosts)
            tb = time.perf_counter()
            res = fleet.check_packed_fleet(head_p, head_k, hosts=hosts,
                                           on_round=kill, device=dev)
            outcomes = [a.get("outcome") for a in res["attempts"]]
            assert killed and "remesh-to-1-hosts" in outcomes, outcomes
            assert res["valid"] == single["valid"], (res["valid"],
                                                     single["valid"])

            def kill_local(round_idx, fl):
                if round_idx == FLEET_KILL_ROUND:
                    fl.hosts[1].kill()
            K.reset_launches()
            local = fleet.check_packed_fleet(
                head_p, head_k, hosts=[fleet.LocalHost(f"host-{i}",
                                                       device=dev)
                                       for i in range(2)],
                on_round=kill_local, device=dev)
            fleet_launches = dict(K.launches)
            assert local["levels"] == res["levels"], (local["levels"],
                                                      res["levels"])
            assert local["valid"] == res["valid"]
            line["elastic"] = {
                "valid": res["valid"], "levels": res["levels"],
                "single_levels": single["levels"],
                "in_process_levels": local["levels"],
                "rounds": res["fleet"]["rounds"], "rung": res["rung"],
                "trail": [o for o in outcomes if o],
                "seconds": time.perf_counter() - tb,
                "in_process_launches": {k: v for k, v in
                                        fleet_launches.items() if v}}
            print(f"fleet elastic: {res['valid']} {res['levels']} levels "
                  f"(single {single['levels']}), trail "
                  f"{line['elastic']['trail']}", flush=True)
            # (c) serve --fleet 2, a worker killed mid-gang
            tc = time.perf_counter()
            serve_dir = os.path.join(root, "serve")
            env_slow = dict(port_env(), JTPU_CHAOS_SLOW_HOST=(
                f"fleet-host-1:{FLEET_SLOW_S}"))
            outp = os.path.join(root, "serve.out")
            errp = os.path.join(root, "serve.err")
            with open(outp, "w") as o, open(errp, "w") as e:
                daemon = subprocess.Popen(
                    [sys.executable, "-m", "jepsen_tpu_torch", "serve",
                     "--check-daemon", "--host", "127.0.0.1", "--port", "0",
                     "--serve-dir", serve_dir, "--fleet", "2",
                     "--batch-max", "8", "--batch-wait-ms", "3000",
                     "--device", "cuda" if dev.type == "cuda" else "cpu"],
                    cwd=os.path.dirname(os.path.abspath(__file__)),
                    env=env_slow, stdout=o, stderr=e)
            procs.append(daemon)
            _, _, _, _, gang8 = serve_members()
            lone = [G.check_history_gpu(m[0], CASRegister(), device=dev)
                    for m in gang8]
            port = wait_listening(daemon, outp, errp, tc)
            ids = [None] * len(gang8)

            def post(i):
                code, body = http_json(port, "POST", "/check", {
                    "tenant": f"tenant{i % 2}", "model": "cas-register",
                    "history": [o.to_dict() for o in gang8[i][0]]})
                assert code == 202, (code, body)
                ids[i] = body["id"]
            threads = [threading.Thread(target=post, args=(i,))
                       for i in range(len(gang8))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            assert all(ids), ids
            # the slowed host sleeps in its first segment: kill it there
            hb_dir = os.path.join(serve_dir, "fleet-host-1")
            victim = None
            while victim is None:
                hb = fleet.read_heartbeat(hb_dir) or {}
                if hb.get("state") == "segment":
                    victim = int(hb["pid"])
                assert time.perf_counter() - tc < 300, "no segment"
                time.sleep(0.02)
            os.kill(victim, signal.SIGKILL)
            results = {}
            while len(results) < len(ids):
                for rid in ids:
                    if rid not in results:
                        code, doc = http_json(port, "GET", f"/check/{rid}")
                        if doc.get("state") == "done":
                            results[rid] = doc["result"]
                assert time.perf_counter() - tc < 600, "gangs timed out"
                time.sleep(0.05)
            for rid, want in zip(ids, lone):
                got = results[rid]
                assert (got["valid"], got.get("levels")) == (
                    want["valid"], want.get("levels")), (got, want)
            _, health = http_json(port, "GET", "/healthz")
            fl = health["fleet"]
            assert fl["hosts"] == 2 and fl["live"] == 1, fl
            assert fl["host-losses"] >= 1 and fl["gangs"] >= 1, fl
            code, _ = http_json(port, "POST", "/drain", {})
            assert code == 200, code
            daemon.wait(timeout=120)
            line["serve_fleet"] = {
                "verdicts_equal_lone": len(ids), "healthz_fleet": fl,
                "gang_sizes": sorted({r["serve"]["gang"]["size"]
                                      for r in results.values()
                                      if r.get("serve", {}).get("gang")}),
                "seconds": time.perf_counter() - tc}
            print(f"fleet serve: {len(ids)} verdicts = lone, healthz "
                  f"{fl}", flush=True)
            # (d) the keyed headline over two gloo ranks on the card
            td = time.perf_counter()
            kw = KEYED["staggered"]
            out = os.path.join(root, "keyed.json")
            init = "file://" + os.path.join(root, "gloo-init")
            ranks = []
            for r in range(2):
                env = dict(port_env(), JTPU_COORDINATOR_ADDRESS=init,
                           JTPU_NUM_PROCESSES="2", JTPU_PROCESS_ID=str(r))
                rp = subprocess.Popen(
                    [sys.executable, "-c", FLEET_RANK_CHILD,
                     os.path.dirname(os.path.abspath(__file__)),
                     json.dumps([KEYS, KEY_OPS, kw, out,
                                 None if dev.type == "cuda" else "cpu",
                                 WIDE, FLEET_RUNG, FLEET_DCN_SEGMENT_ITERS,
                                 FLEET_DCN_TIMING])],
                    env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
                procs.append(rp)
                ranks.append(rp)
            keyed = {k: simulate_register_history(
                KEY_OPS, n_procs=5, n_vals=8, seed=7000 + k, **kw)
                for k in range(KEYS)}
            want = check_keyed_gpu(keyed, CASRegister(), device=dev)
            # the unsharded search in the ranks' segments
            ends_d = []
            unsharded_d = resilience.supervised_check_packed(
                p, kernel, capacity=cap, window=win, expand=exp,
                segment_iters=FLEET_DCN_SEGMENT_ITERS, device=dev,
                on_checkpoint=ends_d.append)
            assert [repr(unsharded_d.get(f)) for f in
                    ("valid", "levels", "max-linearized-prefix")] == \
                [repr(unsharded.get(f)) for f in
                 ("valid", "levels", "max-linearized-prefix")]
            assert all(np.array_equal(np.asarray(x), np.asarray(y))
                       for x, y in zip(ends_d[-1].carry, ends_u[-1].carry)), \
                "the last segment end differs from (a)'s"
            texts = []
            for rp in ranks:
                text, _ = rp.communicate(timeout=600)
                texts.append(text)
                assert rp.returncode == 0, text[-3000:]
            with open(out) as fh:
                got = json.load(fh)
            assert got["ranks"] == 2, got["ranks"]
            assert got["results"] == keyed_fields(want), "keyed differs"
            line["keyed_distributed"] = {
                "keys": len(got["results"]), "ranks": 2,
                "valid": got["valid"], "equal": True,
                "seconds": time.perf_counter() - td}
            print(f"fleet keyed: 2 ranks, {len(got['results'])} keys = "
                  f"check_keyed_gpu", flush=True)
            # the pool-sharded search across the two ranks against the
            # unsharded one in the same segments, every end bit for bit
            docs = []
            for r in range(2):
                with open(out + f".rank{r}.json") as fh:
                    docs.append(json.load(fh))
            ends_r0 = np.load(out + ".ends.npz")
            n_lanes = len(ends_d[0].carry)
            want_v = [repr(unsharded["valid"]), unsharded["levels"],
                      unsharded.get("max-linearized-prefix")]
            for doc in docs:
                assert doc["ends"] == len(ends_d) > 1, \
                    (doc["ends"], len(ends_d))
                assert doc["verdict"] == want_v, (doc["verdict"], want_v)
                assert doc["ranks"] == 2 and doc["mesh"] == 4, doc
                for name, n in doc["launches"].items():
                    assert n > 0 or dev.type != "cuda", (doc["rank"], name)
                for ln in doc["dcn_lines"]:
                    print(ln, flush=True)
                assert doc["dcn"] == {
                    "keyed_valid": "False", "invalid_key": "False",
                    "valid": "True", "refuted": "False"}, doc["dcn"]
            for i, cp in enumerate(ends_d):
                assert all(np.array_equal(ends_r0[f"e{i}_{j}"],
                                          np.asarray(cp.carry[j]))
                           for j in range(n_lanes)), \
                    f"rank 0's segment end {i} differs"
            assert docs[1]["crcs"] == [G._carry_crc(cp.carry)
                                       for cp in ends_d], \
                "rank 1's segment ends differ"
            d0 = docs[0]
            line["dcn"] = {
                "ranks": 2, "entries_per_rank": 2, "rung": [cap, win, exp],
                "segment_iters": FLEET_DCN_SEGMENT_ITERS,
                "segment_ends_equal": len(ends_d),
                "valid": docs[0]["verdict"][0],
                "levels": docs[0]["verdict"][1],
                "search_s": [doc["search_s"] for doc in docs],
                "launches": [doc["launches"] for doc in docs],
                "level_ms": d0["level_ms"],
                "exchange_ms": d0["exchange_ms"],
                "exchange_share": d0["exchange_ms"] / d0["level_ms"],
                "gather_ms": d0["gather_ms"],
                "gather_alone_ms": d0["gather_alone_ms"],
                "exchange_bytes_per_level": d0["exchange_bytes"],
                "timing": {"reps": d0["reps"][0], "levels": d0["reps"][1],
                           "from_level": 0, "clock": "CUDA events"
                           if dev.type == "cuda" else "host"},
                "dcn_legs": docs[0]["dcn"],
                "seconds": time.perf_counter() - td}
            print(f"fleet dcn: 2 ranks x 2 shards, {len(ends_d)} segment "
                  f"ends = unsharded, level {d0['level_ms']:.4f} ms, "
                  f"exchange {d0['exchange_ms']:.4f} ms "
                  f"({line['dcn']['exchange_share']:.3f} of it; the "
                  f"collective {d0['gather_ms']:.4f} ms, alone "
                  f"{d0['gather_alone_ms']:.4f}), "
                  f"{d0['exchange_bytes']} bytes a level", flush=True)
    finally:
        for pr in procs:
            if isinstance(pr, fleet.ProcHost):
                pr.stop()
            elif pr.poll() is None:
                pr.kill()
                pr.wait(timeout=30)
        shutil.rmtree(root, ignore_errors=True)
    return line, launches, grid, segs, merge


#: the ci tools phase: the port's CI tools, each its own process on the
#: card. The soak runs CI_SOAK_S seconds from a fixed seed (a soak by hand
#: takes the clock's); the chaos matrix runs the scenarios that touch the
#: device
CI_SOAK_S = 45
CI_SOAK_SEED = 21
CI_CHAOS = ("oom", "wedge", "kill-mid-segment", "transient", "plan-rejects",
            "serve-batch-poison", "fleet-host-kill")
CI_TIMEOUT_S = 600


def tool_popen(out_dir, tag, script, *args):
    """``python tools/SCRIPT ARGS`` started from the repository root
    (:func:`port_env`), its stdout and stderr into ``out_dir/TAG.out``
    and ``.err``: (process, stdout path, stderr path)."""
    root = os.path.dirname(os.path.abspath(__file__))
    outp = os.path.join(out_dir, f"{tag}.out")
    errp = os.path.join(out_dir, f"{tag}.err")
    with open(outp, "w") as o, open(errp, "w") as e:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(root, "tools", script), *args],
            cwd=root, env=port_env(), stdout=o, stderr=e)
    return proc, outp, errp


def ci_tools_phase(dev, seconds, smi):
    """The port's CI tools on the card, each a process: the differential
    soak for CI_SOAK_S seconds (rc 0, no mismatch, at least one device
    round and one keyed round; its kernel launches are the ``ci-tools``
    path's) and the chaos matrix's CI_CHAOS scenarios at once, then the
    profiling gate (K1, K2 and K4 named under host spans) and the serve
    gate one after the other, as each holds a wall-clock budget. Returns
    (line, the soak's launches, CUDA launches and segment counts)."""
    import shutil
    import tempfile
    line = {"card": smi}
    out_dir = tempfile.mkdtemp(prefix="jtpu-ci-tools-")
    dev_args = ("--device", dev.type)
    tools = {"soak": ("torch_soak_differential.py", str(CI_SOAK_S),
                      "--seed", str(CI_SOAK_SEED), *dev_args),
             "chaos": ("torch_chaos_matrix.py", "--only", *CI_CHAOS,
                       *dev_args),
             "prof gate": ("torch_prof_gate.py", *dev_args),
             "serve gate": ("torch_serve_gate.py", *dev_args)}
    procs, outs, rcs, secs = {}, {}, {}, {}

    def start(tag):
        t0 = time.perf_counter()
        procs[tag] = (tool_popen(out_dir, tag.replace(" ", "-"),
                                 *tools[tag]), t0)

    def wait(*tags):
        """Wait for the tools ``tags``, each timed to its own exit."""
        left = list(tags)
        deadline = time.perf_counter() + CI_TIMEOUT_S
        while left:
            assert time.perf_counter() < deadline, ("ci tools hung", left)
            for tag in list(left):
                (proc, outp, errp), t0 = procs[tag]
                if proc.poll() is None:
                    continue
                left.remove(tag)
                rcs[tag], secs[tag] = proc.returncode, \
                    time.perf_counter() - t0
                outs[tag] = read_text(outp)
                print(f"ci tools: {tag}: rc {rcs[tag]}, {secs[tag]:.2f} s "
                      f"[{smi}]", flush=True)
                assert rcs[tag] == 0, (tag, rcs[tag], outs[tag][-3000:],
                                       read_text(errp)[-3000:])
            time.sleep(0.05)

    try:
        with phase("ci tools", seconds):
            start("soak")
            start("chaos")
            wait("soak", "chaos")
            for tag in ("prof gate", "serve gate"):
                start(tag)
                wait(tag)
            # the soak: no mismatch, device and keyed rounds answered
            soak = json.loads(next(
                ln for ln in outs["soak"].splitlines()
                if ln.startswith("# soak: "))[len("# soak: "):])
            assert soak["mismatches"] == 0 and soak["keyed"] >= 1 and \
                soak["answered"]["device"] >= 1 and \
                soak["answered"]["keyed-keys"] >= 1, soak
            print(f"ci tools: soak: {outs['soak'].strip().splitlines()[-2]}"
                  f" [{smi}]", flush=True)
            # the chaos matrix: every selected scenario passed
            table = outs["chaos"].strip().splitlines()
            print("\n".join(f"ci tools: chaos: {ln}" for ln in table),
                  flush=True)
            assert table[-1] == (f"{len(CI_CHAOS)}/{len(CI_CHAOS)} "
                                 f"scenarios passed"), table[-1]
            # the profiling gate: K1, K2 and K4 under host spans
            gate = next(ln for ln in outs["prof gate"].splitlines()
                        if ln.startswith("# prof-gate: ") and "kernels" in ln)
            kernels = json.loads(re.search(r"kernels (\{[^}]*\})",
                                           gate).group(1))
            assert all(kernels.values()) or dev.type != "cuda", gate
            serve = [ln for ln in outs["serve gate"].splitlines()
                     if ln.startswith("# serve-gate: ")]
            print("\n".join(f"ci tools: {ln}" for ln in [gate] + serve),
                  flush=True)
            launches = soak.get("launches", {})
            grid = soak.get("grid_launches", {})
            segs = soak.get("segments", {"pair_ends": 0})
            if dev.type == "cuda":
                assert all(launches[k] > 0 for k in (
                    "expand", "sort_rows", "dedup_truncate")) and \
                    segs["pair_ends"] > 0, (launches, segs)
            line.update({
                "seconds": secs, "soak": soak, "chaos": table,
                "prof_gate": gate, "prof_gate_kernels": kernels,
                "serve_gate": serve})
    finally:
        for (proc, _, _), _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        shutil.rmtree(out_dir, ignore_errors=True)
    return line, launches, grid, segs


def watchdog_phase(dev, seconds, checker, head, head_p, head_kernel, r):
    """The segment watchdog on the card: an injected wedge that ends
    UNKNOWN with its last segment end, which the caller resumes on the
    CPU; a real device stall that the watchdog ends with a wedge, a second
    check answered at once while the card still spins, the headline again
    once the record is cleared, and the warm headline with a deadline
    beside it without one. Returns the phase's JSON entry."""
    import warnings
    from jepsen_tpu_torch import accel, resilience
    from jepsen_tpu_torch.checker import UNKNOWN
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops.encode import pack_with_init
    from jepsen_tpu_torch.testing import simulate_register_history
    line = {}
    with phase("watchdog", seconds):
        # (a) an injected wedge under a watchdog: UNKNOWN with the last
        # segment end as its checkpoint; CUDA then refuses checks, and the
        # caller resumes the checkpoint on the CPU
        wp, wk = pack_with_init(simulate_register_history(**WEDGE_HISTORY),
                                CASRegister())
        base = G.check_packed_gpu(wp, wk, device=dev)
        wedged = []

        def wedge(ctx):
            if ctx["segment"] == WEDGE_SEGMENT and not wedged:
                wedged.append(ctx["level"])
                raise resilience.WedgeError("injected wedged execution")

        resilience._inject_fault = wedge
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                cut = G.check_packed_gpu(wp, wk, device=dev,
                                         deadline_s=WATCH_DEADLINE_S)
        finally:
            resilience._inject_fault = None
        refused = G.check_packed_gpu(wp, wk, device=dev)
        cp = cut.get("checkpoint")
        resumed = (resilience.supervised_check_packed(
            wp, wk, device="cpu", resume=cp) if cp is not None else {})
        accel._reset_for_tests()
        line["resume"] = {
            "wedged": cut["valid"] is UNKNOWN, "error": cut.get("error"),
            "checkpoint": (None if cp is None
                           else {"segment": cp.segment, "level": cp.level}),
            "cuda_refused": refused["valid"] is UNKNOWN,
            "valid": resumed.get("valid"), "levels": resumed.get("levels"),
            "base_levels": base["levels"], "wedged_at_level": wedged,
            "attempts": cut["attempts"]}
        print(f"watchdog: wedge at level {wedged} -> "
              f"{cut['valid']} checkpoint={line['resume']['checkpoint']}; "
              f"CUDA refused={line['resume']['cuda_refused']}; resumed on "
              f"the CPU valid={resumed.get('valid')} "
              f"levels={resumed.get('levels')} (unwedged {base['levels']})")
        assert wedged and cut["valid"] is UNKNOWN and cp is not None
        assert (cp.segment, cp.level) == (WEDGE_SEGMENT, wedged[0])
        assert refused["valid"] is UNKNOWN and "backend-fallback" not in cut
        assert (resumed["valid"], resumed["levels"]) == (base["valid"],
                                                         base["levels"])

        # (b) a real stall: a GPU-side spin ahead of the first segment
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        e1.record()
        e1.synchronize()
        cycles = int(SLEEP_CYCLES * STALL_S * 1e3 / e0.elapsed_time(e1))
        stream = torch.cuda.current_stream(dev)
        stalled = []

        def stall(ctx):
            if ctx["segment"] == 0 and not stalled:
                stalled.append(1)
                torch.cuda._sleep(cycles)

        os.environ["JTPU_SEGMENT_DEADLINE_S"] = str(STALL_DEADLINE_S)
        resilience._inject_fault = stall
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                t0 = time.perf_counter()
                stuck = G.check_packed_gpu(head_p, head_kernel, device=dev)
                fire_s = time.perf_counter() - t0
            resilience._inject_fault = None
            t0 = time.perf_counter()
            again = G.check_packed_gpu(head_p, head_kernel, device=dev)
            again_s = time.perf_counter() - t0
            spinning = not stream.query()
        finally:
            resilience._inject_fault = None
            del os.environ["JTPU_SEGMENT_DEADLINE_S"]
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        spin_left_s = time.perf_counter() - t0
        workers = accel.abandoned_workers()
        for w in workers:
            w.join(30)
        ended = not any(w.is_alive() for w in workers)
        line["stall"] = {"spin_s": STALL_S, "deadline_s": STALL_DEADLINE_S,
                         "fire_s": fire_s, "error": stuck.get("error"),
                         "second_check_s": again_s,
                         "card_still_spinning": spinning,
                         "spin_left_s": spin_left_s,
                         "workers": len(workers), "workers_ended": ended}
        print(f"watchdog: stall fire_s={fire_s:.3f} "
              f"error={stuck.get('error')!r} second_check_s={again_s:.4f} "
              f"card_still_spinning={spinning} "
              f"spin_left_s={spin_left_s:.2f} workers={len(workers)} "
              f"ended={ended}")
        assert stalled and stuck["valid"] is UNKNOWN
        assert "deadline" in stuck["error"], stuck
        assert fire_s < STALL_DEADLINE_S + 1.0, fire_s
        assert again["valid"] is UNKNOWN and again_s < 1.0, again
        assert spinning and workers and ended
        accel._reset_for_tests()
        after = checker.check({}, head)
        assert after["valid"] is True and after["levels"] == r["levels"]

        # (c) the watchdog's cost on the warm headline
        times = {"unset": [], "deadline": []}
        for turn in range(WATCH_REPS):
            for tag in (("unset", "deadline") if turn % 2 == 0
                        else ("deadline", "unset")):
                if tag == "deadline":
                    os.environ["JTPU_SEGMENT_DEADLINE_S"] = str(
                        WATCH_DEADLINE_S)
                try:
                    gc.collect()
                    t0 = time.perf_counter()
                    rr = checker.check({}, head)
                    times[tag].append(time.perf_counter() - t0)
                finally:
                    os.environ.pop("JTPU_SEGMENT_DEADLINE_S", None)
                assert rr["valid"] is True and rr["levels"] == r["levels"]
        line["warm_headline_s"] = {
            tag: {"median": statistics.median(v), "runs": v}
            for tag, v in times.items()}
        print(f"watchdog: warm headline median_s unset="
              f"{statistics.median(times['unset']):.4f} deadline="
              f"{statistics.median(times['deadline']):.4f} "
              f"(runs {json.dumps(times)})")
        assert not accel.runtime_wedged()
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    smoke(torch.device("cuda"))
    return 0


def smoke(dev: torch.device) -> None:
    """Every phase on ``dev``; any failure raises."""
    from jepsen_tpu_torch import independent, interop, resilience
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.kernels import build, parity
    from jepsen_tpu_torch.kernels import search as K
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops.encode import pack_with_init
    from jepsen_tpu_torch.testing import (corrupt_one_read, crash_writes,
                                          keyed_history,
                                          simulate_register_history,
                                          wide_history)

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {kind} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    print(smi)
    seconds = {}

    # -- build --------------------------------------------------------------
    with phase("build", seconds):
        build.load()
    print(f"build: {os.path.relpath(build.library_path())}")
    with open(build.library_path()[:-3] + ".log") as fh:
        for line in fh:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    def packed_cols(history, breq=None, cr=None):
        packed, kernel = pack_with_init(history, CASRegister())
        if cr is None:
            cr = G._crash_width(packed.n - packed.n_required)
        return packed, kernel, G._split_packed(
            packed, breq or G._bucket(packed.n_required), cr, kernel)

    # -- single-history kernels against their plain versions, timed --------
    with phase("single kernels", seconds):
        head = simulate_register_history(**HEADLINE)
        head_p, head_kernel, head_cols = packed_cols(head)
        wide = crash_writes(wide_history(**WIDE), WIDE_CRASHED_WRITES)
        _, _, wide_cols = packed_cols(wide)
        shapes, level_shapes = {}, {}
        for tag, cols_np, rung, warm in (
                ("headline", head_cols, HEADLINE_RUNG, HEADLINE_WARM_LEVELS),
                ("wide", wide_cols, WIDE_RUNG, WIDE_WARM_LEVELS)):
            lv = parity.Level(cols_np, rung, dev)
            live = lv.advance(warm)
            assert live > 0 and lv.shape.CR > 0, tag
            res = check_and_time(lv, parity)
            shapes[tag], level_shapes[tag] = res, lv.shape
            print_kernels(tag, lv, live, warm, res)
        # the wide shape crosses the sort's tiles (an odd count of merge
        # passes, 5) and the scan's blocks
        assert level_shapes["wide"].RP > 1024
        assert K.sort_passes(level_shapes["wide"]) % 2 == 1
        # a one-client history's first level: K1's one forced run walks
        # to its last op, and the search ends there
        _, _, seq_cols = packed_cols(simulate_register_history(
            **SEQUENTIAL))
        lv = parity.Level(seq_cols, HEADLINE_RUNG, dev)
        res = check_and_time(lv, parity)
        shapes["sequential"] = res
        print_kernels("sequential", lv, 1, 0, res)
        assert lv.advance(1) == 0 and int(lv.carry.scal[0, K.DONE]) == 1

    # -- (a) batched kernels at the keyed first rungs, both tie-breaks ------
    with phase("keyed histories", seconds):
        keyed = {label: {k: simulate_register_history(
            KEY_OPS, n_procs=5, n_vals=8, seed=7000 + k, **kw)
            for k in range(KEYS)} for label, kw in KEYED.items()}
        keyed_h = {label: keyed_history(hs) for label, hs in keyed.items()}
    #: (state, columns, rung, Level keywords, warm levels) of every state
    #: the kernels are held at, for the segment loop phase
    loop_recipes = [("headline", head_cols, HEADLINE_RUNG, {},
                     HEADLINE_WARM_LEVELS),
                    ("wide", wide_cols, WIDE_RUNG, {}, WIDE_WARM_LEVELS),
                    ("sequential", seq_cols, HEADLINE_RUNG, {}, 0)]
    with phase("keyed kernels", seconds):
        for name, label, rung, cr, warm, tbs, wide in KEYED_COHORTS:
            cohort = cohort_cols(keyed[label].values(), cr, wide)
            assert len(cohort) >= (2 if wide else 16), (name, len(cohort))
            for tb in tbs:
                loop_recipes.append((f"keyed {name} {tb}", cohort, rung,
                                     {"tiebreak": tb}, warm))
                lv = parity.Level(cohort, rung, dev, tiebreak=tb)
                live = lv.advance(warm)
                assert live > 0, (name, tb)
                res = check_and_time(lv, parity)
                shapes[f"keyed {name} {tb}"] = res
                print_kernels(f"keyed {name}", lv, live, warm, res)
        # the deferred keys' rung crosses the sort's tiles and the scan's
        # blocks, so the sort's merge passes run there
        assert lv.shape.RP > 1024 and lv.shape.B >= 2
        dwide_shape = lv.shape

    # -- the single-history path end to end ---------------------------------
    checker = linearizable(CASRegister(), device=dev)
    with phase("headline", seconds):
        K.reset_launches()
        t0 = time.perf_counter()
        r = checker.check({}, head)
        cold_headline = time.perf_counter() - t0
        launches = dict(K.launches)
        grid_launches = dict(K.grid_launches_total)
        path_segments = {"headline": dict(K.segments)}
        print(f"headline: valid={r['valid']} levels={r['levels']} "
              f"rung={r['rung']} segments={r['segments']} "
              f"cold_s={cold_headline:.3f} launches={launches} "
              f"cuda_launches={grid_launches} "
              f"python_calls={K.host_calls} graphs={K.segments}")
        assert r["valid"] is True and r["backend"] == "gpu"
        assert "fallback-from" not in r
        assert all(launches[k] > 0 for k in ("expand", "sort_rows",
                                             "dedup_truncate")), launches
        # the headline's rung scans its group starts in K4 and ends each
        # level pair in the pair's second K4: no K3 or K5 launch
        assert K.segments["pair_ends"] > 0, K.segments
        assert launches["group_scan"] == launches["seg_active"] == 0, \
            launches
        assert grid_launches["group_scan"] == grid_launches[
            "seg_active"] == 0, grid_launches
        # no Python per level: one capture from Python, one graph launch
        # a segment, the levels counted on the device
        assert K.segments["launches"] == r["segments"], K.segments
        assert K.segments["levels"] == r["levels"], K.segments
        assert all(K.host_calls[k] == K.segments["captures"] for k in (
            "expand", "sort_rows", "dedup_truncate"))
        gc.collect()   # a collection over two million live ops takes ~1 s
        t0 = time.perf_counter()
        r2 = checker.check({}, head)
        warm_s = time.perf_counter() - t0
        assert r2["valid"] is True and r2["levels"] == r["levels"]
        print(f"headline: warm_s={warm_s:.3f} "
              f"per_level_ms={warm_s / r['levels'] * 1e3:.4f} "
              f"searchstats={r['searchstats']}")

    with phase("headline plain", seconds):
        # the first HEADLINE_PLAIN_SEGMENTS segments of the headline's
        # search, kernels against plain versions, every lane of the carry
        # after each (the whole run on the plain route took 64.6 s and is
        # cut to this depth, to keep the smoke inside half its limit)
        lvs = {name: parity.Level(head_cols, r["rung"], dev)
               for name in ("kernels", "plain")}
        for i in range(HEADLINE_PLAIN_SEGMENTS):
            seg = {}
            for name, ops in (("kernels", G.KERNELS), ("plain", G.PLAIN)):
                lv = lvs[name]
                t0 = time.perf_counter()
                G.run_segment(lv.cols, lv.carry, lv.scratch, lv.shape,
                              lv.nr, G.DEFAULT_SEGMENT_ITERS, ops)
                seg[name] = interop.carry_to_numpy(lv.carry)
                print(f"segment {i + 1} ({name}): "
                      f"{time.perf_counter() - t0:.3f} s, "
                      f"level={int(seg[name][8])}")
            assert carries_equal(seg["kernels"], seg["plain"]), \
                f"segment {i + 1}"
        assert int(seg["plain"][8]) == min(
            r["levels"], HEADLINE_PLAIN_SEGMENTS * G.DEFAULT_SEGMENT_ITERS)

    # -- the plan gate ------------------------------------------------------
    plan_line = plan_phase(dev, seconds, head_p, head_kernel, r, {
        "headline": K.LevelShape(C=128, W=32, E=8, n=head_cols["f"].shape[0],
                                 CR=head_cols["cf"].shape[0]),
        "wide": level_shapes["wide"], "dwide": dwide_shape})

    # -- the segment loop: graph, host loop and plain route at each state -
    loops, k5 = segment_loop_phases(dev, seconds, loop_recipes, head_p,
                                    head_kernel, r)

    with phase("invalid", seconds):
        cfg = dict(INVALID)
        seed = cfg.pop("seed")
        bad = corrupt_one_read(simulate_register_history(seed=seed, **cfg),
                               random.Random(seed))
        invalid_h = bad
        t0 = time.perf_counter()
        ri = checker.check({}, bad)
        ti = time.perf_counter() - t0
        print(f"invalid: valid={ri['valid']} levels={ri['levels']} "
              f"rung={ri['rung']} prefix={ri.get('max-linearized-prefix')} "
              f"work={ri['work']} ({ti:.2f} s)")
        assert ri["valid"] is False and ri["backend"] == "gpu"
        # its search's first segments on the plain versions, carry against
        # carry (the whole plain run is cut to this depth)
        _, _, bad_cols = packed_cols(bad)
        level = hold_segments("invalid", bad_cols, ri["work"][0][0], dev,
                              INVALID_PLAIN_SEGMENTS, PLAIN_SEGMENT_LEVELS)
        assert level == INVALID_PLAIN_SEGMENTS * PLAIN_SEGMENT_LEVELS, level
        # the refutation's prefix on both routes, on a history small enough
        # for the plain route's whole search
        cfg = dict(INVALID_SMALL)
        seed = cfg.pop("seed")
        small = corrupt_one_read(simulate_register_history(seed=seed, **cfg),
                                 random.Random(seed))
        small_p, small_kernel, _ = packed_cols(small)
        rs = {name: resilience.supervised_check_packed(
            small_p, small_kernel, device=dev, ops=ops)
            for name, ops in (("kernels", G.KERNELS), ("plain", G.PLAIN))}
        print(f"invalid {cfg['n_ops']} ops: " + ", ".join(
            f"{name} valid={x['valid']} levels={x['levels']} "
            f"prefix={x.get('max-linearized-prefix')} rung={x['rung']}"
            for name, x in rs.items()), flush=True)
        assert rs["kernels"]["valid"] is False
        assert [rs["kernels"].get(f) for f in (
            "valid", "levels", "max-linearized-prefix", "work")] == \
            [rs["plain"].get(f) for f in (
                "valid", "levels", "max-linearized-prefix", "work")], rs

    with phase("wide", seconds):
        wh = wide_history(**WIDE)
        t0 = time.perf_counter()
        rw = checker.check({}, wh)
        tw = time.perf_counter() - t0
        wp, wk, _ = packed_cols(wh)
        rwp = resilience.supervised_check_packed(wp, wk, device=dev,
                                                 ops=G.PLAIN)
        print(f"wide: valid={rw['valid']} levels={rw['levels']} "
              f"rung={rw['rung']} ({tw:.2f} s); plain "
              f"levels={rwp['levels']}")
        assert rw["valid"] is True and rw["rung"][1] == WIDE_WINDOW
        assert (rwp["valid"], rwp["levels"]) == (rw["valid"], rw["levels"])

    # -- (b) the keyed headline: the keyed path end to end ------------------
    indep = independent.checker(linearizable(CASRegister(), device=dev))

    def keyed_run(h):
        """One independent check of a [k v] history; its results, wall
        seconds, and its device batches (from the check_keyed_gpu call
        inside, read back through a wrapper)."""
        calls = []
        orig = G.check_keyed_gpu

        def spy(*a, **kw):
            out = orig(*a, **kw)
            calls.append(out)
            return out
        G.check_keyed_gpu = spy
        try:
            t0 = time.perf_counter()
            out = indep.check({}, h)
            wall = time.perf_counter() - t0
        finally:
            G.check_keyed_gpu = orig
        assert len(calls) == 1
        return out, wall, calls[0]["batches"]

    def describe(label, out, wall, batches, temp):
        res = out["results"]
        per_rung = {}
        for v in res.values():
            rung = tuple(v["rung"]) if "rung" in v else None
            per_rung[str(rung)] = per_rung.get(str(rung), 0) + 1
        # keys the batch left unknown are checked again one by one (a
        # result with segments), and on the host if still unknown
        rechecked = sum(1 for v in res.values() if "segments" in v)
        fallbacks = sum(1 for v in res.values() if "fallback-from" in v)
        launched = sum(b["levels-launched"] for b in batches)
        dev_s = sum(b["seconds"] for b in batches)
        line = {"label": label, "run": temp, "seconds": wall,
                "keys": len(res), "valid": out["valid"],
                "keys_true": sum(1 for v in res.values()
                                 if v["valid"] is True),
                "rechecked": rechecked, "fallbacks": fallbacks,
                "decided_per_rung": per_rung,
                "max_levels": max(b["levels"] for b in batches),
                "levels_launched": launched, "batch_seconds": dev_s,
                "per_level_ms": dev_s / launched * 1e3,
                "batches": [{k: (list(v) if isinstance(v, tuple) else v)
                             for k, v in b.items()} for b in batches]}
        print("keyed:", json.dumps(line), flush=True)
        return line

    keyed_lines = []
    with phase("keyed headline", seconds):
        K.reset_launches()
        cold = {label: keyed_run(keyed_h[label]) for label in KEYED}
        keyed_launches = dict(K.launches)
        keyed_grid_launches = dict(K.grid_launches_total)
        path_segments["keyed"] = dict(K.segments)
        print(f"keyed launches: {keyed_launches} "
              f"cuda_launches={keyed_grid_launches}")
        for label in KEYED:
            keyed_lines.append(describe(label, *cold[label], "cold"))
            warm = keyed_run(keyed_h[label])
            keyed_lines.append(describe(label, *warm, "warm"))
            for out in (cold[label][0], warm[0]):
                assert out["valid"] is True, label
                assert all(v["valid"] is True
                           for v in out["results"].values()), label
                assert len(out["results"]) == KEYS
            assert ({k: v.get("levels") for k, v in warm[0]["results"]
                     .items()} == {k: v.get("levels") for k, v in
                                   cold[label][0]["results"].items()})
        assert all(keyed_launches[k] > 0 for k in KERNELS
                   if k != "seg_active"), keyed_launches
        assert path_segments["keyed"]["pair_ends"] > 0, path_segments
        assert keyed_grid_launches["seg_active"] == 0, keyed_grid_launches

    # -- (c) an etcd-shaped batch with one corrupted key --------------------
    with phase("etcd batch", seconds):
        cfg = dict(ETCD)
        n_keys = cfg.pop("keys")
        hs = {k: simulate_register_history(seed=9000 + k, **cfg)
              for k in range(n_keys)}
        seed = 0
        while True:
            bad = corrupt_one_read(hs[0], random.Random(seed))
            if [o.value for o in bad] != [o.value for o in hs[0]]:
                break
            seed += 1
        hs[0] = bad
        out, wall, batches = keyed_run(keyed_history(hs))
        etcd = (hs, out, wall, batches)
        keyed_lines.append(describe("etcd", out, wall, batches, "cold"))
        assert out["valid"] is False and out["failures"] == [0], \
            out["failures"]
        assert out["results"][0]["backend"] == "gpu"
        assert all(out["results"][k]["valid"] is True
                   for k in range(1, n_keys))

    # -- (d) a mixed sub-batch, kernels against plain versions --------------
    with phase("keyed plain", seconds):
        mixed = {}
        for k in range(MIXED_KEYS):
            kw = dict(KEYED["staggered" if k % 2 else "dense"])
            if k == MIXED_KEYS - 1:
                kw["crash_p"] = 0.05
            mixed[k] = simulate_register_history(MIXED_OPS, n_procs=5,
                                                 n_vals=8, seed=7000 + k,
                                                 **kw)
        for seed in MIXED_WIDE_SEEDS:
            mixed[f"wide{seed}"] = crash_writes(wide_history(40, 2,
                                                             seed=seed), 2)
        runs = {}
        for name, ops in (("kernels", G.KERNELS), ("plain", G.PLAIN)):
            t0 = time.perf_counter()
            runs[name] = G.check_keyed_gpu(mixed, CASRegister(), device=dev,
                                           ops=ops)
            batches = [(b["rung"], b["crash-width"], b["tiebreak"],
                        b["keys"], b["levels"])
                       for b in runs[name]["batches"]]
            print(f"mixed sub-batch ({name}): "
                  f"{time.perf_counter() - t0:.2f} s, valid="
                  f"{runs[name]['valid']}, batches={batches}")
        fields = ("valid", "levels", "max-linearized-prefix", "rung",
                  "tiebreak", "work", "crash-width")
        for k in mixed:
            a = {f: runs["kernels"]["results"][k].get(f) for f in fields}
            b = {f: runs["plain"]["results"][k].get(f) for f in fields}
            assert a == b, (k, a, b)
        assert {r["crash-width"] for r in runs["kernels"]["results"]
                .values()} != {0}
        # the window-deferred keys met on the wide rung, in one batch
        assert any(b["rung"] == WIDE_RUNG_KEYED and b["keys"] >= 2
                   for b in runs["kernels"]["batches"])

    # -- the other model families ------------------------------------------
    model_lines, model_launches, model_grid_launches, path_segments[
        "models"] = model_phases(dev, seconds, shapes)

    # -- the serve daemon's gangs ------------------------------------------
    (gang_line, serve_line, serve_launches, serve_grid_launches,
     path_segments["serve"]) = serve_phases(dev, seconds, shapes, head)

    # -- the host engines behind the facade --------------------------------
    host_line = host_engine_phases(dev, seconds, head, warm_s, etcd,
                                   invalid_h)

    # -- streaming: the online check over a growing stable prefix ---------
    (stream_line, stream_launches, stream_grid_launches,
     path_segments["stream"]) = stream_phases(dev, seconds, head, smi)

    # -- the device path's telemetry ----------------------------------------
    dwide_lv = next(parity.Level(cols_np, rung, dev, **kw)
                    for tag, cols_np, rung, kw, warm in loop_recipes
                    if tag == "keyed dense wide lex")
    dwide_lv.advance(next(warm for tag, _, _, _, warm in loop_recipes
                          if tag == "keyed dense wide lex"))
    telemetry_line = telemetry_phase(dev, seconds, checker, head, r,
                                     head_cols, dwide_lv)

    # -- the test runner: core.run, the suites, analyze and recover -------
    (runner_line, run_launches, run_grid_launches,
     path_segments["run"], kv_store) = runner_phase(dev, seconds, smi)

    # -- the sqlite tier: a real engine's histories, and explain ----------
    (sqlite_line, sqlite_launches, sqlite_grid_launches,
     path_segments["sqlite"]) = sqlite_phase(dev, seconds, smi)

    # -- the wire-protocol suites against their fakes ----------------------
    (suites_line, suites_launches, suites_grid_launches,
     path_segments["suites"]) = suites_phase(dev, seconds, smi)

    # -- the keyed CAS-register suites of the command-line data planes -----
    (cas_line, cas_launches, cas_grid_launches,
     path_segments["cas-suites"]) = cas_suites_phase(dev, seconds, smi)

    # -- the single registers of the small suites, with crashed ops -------
    (small_line, small_launches, small_grid_launches,
     path_segments["small-suites"]) = small_suites_phase(dev, seconds, smi)

    # -- the command line, each step its own process ----------------------
    cli_line, cli_launches, cli_pair_ends, cli_kept = cli_phase(
        dev, seconds, smi, kv_store)
    path_segments["cli"] = {"pair_ends": cli_pair_ends}

    # -- the daemon's telemetry plane and the results browser -------------
    tel_line, tel_launches, tel_pair_ends = daemon_telemetry_phase(
        dev, seconds, smi, kv_store, cli_kept)
    path_segments["daemon-telemetry"] = {"pair_ends": tel_pair_ends}

    # -- B8 and the fleet: the pool-sharded search, the elastic fleet,
    # fleet-backed serving, the keyed check over two ranks
    fleet_line, fleet_launches, fleet_grid, path_segments["fleet"], \
        merge_entry = fleet_phase(dev, seconds, smi)

    # -- the CI tools: the soak, the chaos matrix, the two gates ---------
    ci_line, ci_launches, ci_grid, path_segments["ci-tools"] = \
        ci_tools_phase(dev, seconds, smi)

    # -- the watchdog (last: it wedges the card on purpose) ----------------
    watch_line = watchdog_phase(dev, seconds, checker, head, head_p,
                                head_kernel, r)

    # -- summary ------------------------------------------------------------
    for tag, res in k5.items():
        shapes[tag]["seg_active"] = res
    kernels = []
    keep = ("ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "cuda_launches_per_call")
    path_launches = {"headline": launches, "keyed": keyed_launches,
                     "models": model_launches, "serve": serve_launches,
                     "stream": stream_launches, "run": run_launches,
                     "sqlite": sqlite_launches, "suites": suites_launches,
                     "cas-suites": cas_launches,
                     "small-suites": small_launches, "cli": cli_launches,
                     "daemon-telemetry": tel_launches,
                     "fleet": fleet_launches, "ci-tools": ci_launches}
    path_grid = {"headline": grid_launches, "keyed": keyed_grid_launches,
                 "models": model_grid_launches, "serve": serve_grid_launches,
                 "stream": stream_grid_launches, "run": run_grid_launches,
                 "sqlite": sqlite_grid_launches,
                 "suites": suites_grid_launches,
                 "cas-suites": cas_grid_launches,
                 "small-suites": small_grid_launches, "fleet": fleet_grid,
                 "ci-tools": ci_grid}
    # K5's step runs in the pair's second K4 on every path: its entry
    # counts those K4 launches (the pair ends) and is timed and bounded as
    # that K4; seg_active_kernel standing alone is the host loop's, under
    # "host_loop", and launches nowhere on these paths
    pair_ends = {p: path_segments[p]["pair_ends"] for p in path_launches}
    for name in KERNELS:
        single = name != "sort_rows_hash"
        tb = "lex" if name == "sort_rows" else "hash"
        state, path = MAIN_STATE.get(name, ("headline", "headline"))
        top = shapes[state][name]
        fused = name == "seg_active"
        counted = (pair_ends if fused else
                   {p: path_launches[p][name] for p in path_launches})
        extra = ("dedup_graph_ms", "host_loop") if fused else ()

        def at(tag):
            """The kernel's numbers at state ``tag``; None where a level
            there does not launch it."""
            res = shapes[tag].get(name)
            return None if res is None else {k: res[k]
                                             for k in keep + extra}
        errs = [r[name]["max_abs_err"] for r in shapes.values() if name in r]
        if fused:
            errs += [r[name]["host_loop"]["max_abs_err"]
                     for r in shapes.values() if name in r]
        entry = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": counted[path], "path": path,
            "state": state,
            "max_abs_err": max(errs),
            "ms": top["ms"], "graph_ms": top["graph_ms"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "launches_by_path": counted,
            "cuda_launches_by_path": {p: path_grid[p][name]
                                      for p in path_grid},
        }
        if fused:
            entry["launched_as"] = ("the tail of the pair's second "
                                    "dedup_truncate (ms, graph_ms, bound: "
                                    "that launch; dedup_graph_ms: it "
                                    "without the step)")
            entry["dedup_graph_ms"] = top["dedup_graph_ms"]
            entry["host_loop"] = dict(top["host_loop"], launches_by_path={
                p: path_launches[p][name] for p in path_launches})
        if single:
            entry["headline"] = at("headline")
            entry["wide"] = at("wide")
            entry["gang"] = at("gang")
            entry["odd"] = at("odd")
            entry["sequential"] = at("sequential")
        entry["keyed_staggered"] = at("keyed staggered " + tb)
        entry["keyed_dense"] = at("keyed dense " + tb)
        if single:
            entry["keyed_dense_wide"] = at("keyed dense wide lex")
            for tag in MODEL_HISTORIES:
                entry[f"model_{tag}"] = at(f"model_{tag}")
        if single:
            entry["launches_by_model"] = {
                line["model"]: (line["pair_ends"] if fused
                                else line["launches"][name])
                for line in model_lines.values()}
        kernels.append(entry)
    # B8's cross-shard merge, on the pool-sharded search's path only
    merge_entry["launches_by_path"] = {p: path_launches[p].get(
        "merge_runs", 0) for p in path_launches}
    merge_entry["cuda_launches_by_path"] = {p: path_grid[p].get(
        "merge_runs", 0) for p in path_grid}
    # the search across two ranks (fleet (d)): rank 0's launches
    merge_entry["launches_by_path"]["fleet-ranks"] = \
        fleet_line["dcn"]["launches"][0]["merge_runs"]
    kernels.append(merge_entry)
    loop_summary = {
        "states": loops,
        "paths": {path: dict(path_segments[path],
                             per_level_ms_graph=loops[tag][
                                 "per_level_ms_graph"],
                             per_level_ms_host=loops[tag][
                                 "per_level_ms_host"], state=tag)
                  for path, tag in LOOP_PATHS.items()}}
    print(json.dumps({"kernels": kernels, "segment_loop": loop_summary,
                      "headline": {
        "cold_s": cold_headline, "warm_s": warm_s, "levels": r["levels"],
        "invalid_s": ti, "wide_s": tw}, "keyed": keyed_lines,
        "models": model_lines, "gang_vs_serial": gang_line,
        "serve": serve_line, "host_engines": host_line,
        "stream": stream_line, "plan": plan_line, "watchdog": watch_line,
        "telemetry": telemetry_line, "runner": runner_line,
        "sqlite": sqlite_line, "suites": suites_line,
        "cas_suites": cas_line, "small_suites": small_line,
        "cli": cli_line, "daemon_telemetry": tel_line, "fleet": fleet_line,
        "ci_tools": ci_line, "phase_seconds": seconds, "nvidia_smi": smi},
        default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
