"""Command line of the port.

``python -m jepsen_tpu_torch serve`` serves the results browser
(:mod:`jepsen_tpu_torch.web`) over ``--store-root``; with
``--check-daemon`` (or JTPU_SERVE=1) the check daemon
(:mod:`jepsen_tpu_torch.serve`) is mounted on it, its directory
``--serve-dir`` (default ``<store-root>/serve``). The daemon's flags are
the reference's (``jtpu serve``): ``--host``, ``--port``, ``--serve-dir``,
``--workers``, ``--queue-max``, ``--tenant-max``, ``--deadline-s``,
``--batch-max`` and ``--batch-wait-ms`` (the gangs), ``--auth-token``,
``--engine-max-buckets``, ``--rate-limit`` and ``--serve-backend
gpu|cpu``; each flag given wins over its ``JTPU_SERVE_*`` variable.
``--compile-cache DIR`` is the kernel library's build directory, so that
a restarted daemon loads the library built there. ``--device cpu`` runs
the searches on the CPU (the kernels' plain versions) instead of CUDA.
``--fleet N`` places the gangs on N fleet hosts (worker processes under
``<serve-dir>/fleet-host-N``, on the daemon's device). The
daemon serves until ``POST /drain`` or SIGTERM (after a flight-recorder
dump) and then exits 0; the browser alone until an interrupt.

``usage`` (per-tenant totals from a serve directory's WAL, the daemon's
``GET /usage``), ``flightrec [DUMP]`` (the flight-recorder dumps) and
``top`` (a serve directory's heartbeat on one screen; a run directory's
is ``watch``'s line) read a daemon's artifacts, live or not, as the
reference's commands of those names do.

``python -m jepsen_tpu_torch stream [--store DIR | --history FILE]`` is
the client of a daemon's stream routes (the reference's ``jtpu stream``):
it opens a stream, POSTs the ops of a stored run's ``history.jsonl`` (the
latest under ``./store`` by default) or of a history file (a JSON array
or JSON lines of op maps) as sequenced, CRC'd chunks, waiting out 429s
and resending from the daemon's ``need`` on a 409 gap, seals it and
polls for the verdict, which it prints. Exit 0 when valid, 1 when not (or unknown), 254 for bad
arguments or an empty history, 255 when the daemon fails a call.

``python -m jepsen_tpu_torch plan --dims N[,CRASHED[,WINDOW[,EVENTS]]]``
(or ``--dims @file.json``, or ``--history FILE``) verifies a search plan
before any device time (the reference's ``jtpu plan``): every candidate
rung with its footprint in the port's own buffers, the ``PLAN-*`` rules
and the shape check (:mod:`jepsen_tpu_torch.checker.plan`). It plans for
CUDA unless ``--device cpu``. Exit 0 when no error-severity finding, 1
when one, 254 for bad arguments. ``--format text|json|sarif``; ``--mesh
N`` verifies the pool-sharded plan over N shards too.

``python -m jepsen_tpu_torch run --suite local-kv`` runs a test (the
reference's ``jtpu run``): ``core.run`` boots the suite's system, drives
its clients under the generator with the nemesis, tees every op into the
WAL, saves the store under ``--store-root`` and then checks the history,
on the card unless ``--device cpu`` (the kernels' plain versions) or
``--backend cpu`` (the host search). ``--node``, ``--concurrency`` and
``--time-limit`` default to the suite's own settings; ``--workload``
selects a workload of the hazelcast, aerospike, mongodb, cockroachdb and
tidb suites, ``--nemesis`` and ``--nemesis2`` (repeatable) name the
cockroachdb or tidb nemeses to compose (a tidb row runs the first point
of the reference ``tidb_main``'s matrix; without them it keeps its own
partition cycle), and ``--write-concern`` and
``--read-concern`` set the mongodb client's concerns, as the reference's
``main`` of each of those suites takes them; each exits 254 for a suite
that does not take it. With ``--ssh-mode dummy`` the control plane records
each node's commands and runs none; ``--dummy-responses FILE`` scripts
its replies (a JSON object: command substring -> stdout, or ``[exit,
stdout, stderr]``), as the reference's tests put ``dummy-responses`` in
the test map, so that a database's install can be recorded through to
its start. ``--watch`` prints the search's live status line to stderr
while the check runs; ``--fleet N`` runs each single-history search
under the elastic fleet over N logical hosts (``JTPU_FLEET=N``).
Chronos's check runs on the host, so ``run --suite chronos``
does not probe the card.

``python -m jepsen_tpu_torch analyze --store DIR`` re-checks a stored run
(by either package) and prints, before the result, its lint summary, its
``# plan:`` line, the ``# contention:`` forecast, the ``# compile:`` split
of the check's wall clock and the ``# search:`` analytics.
``python -m jepsen_tpu_torch recover`` finds the runs under
``--store-root`` whose process died mid-flight, rebuilds each history
from its WAL (dangling invokes become ``info``), re-checks it and marks
the run done. All three take ``--backend`` and ``--device``; ``analyze``
and ``recover`` also ``--model`` and ``--algorithm``. ``run --suite``
offers the local-kv suites, the sqlite ones (``sqlite-register``,
``sqlite-bank``, ``sqlite-register-toctou``: the real SQLite engine) and
the wire-protocol ones (``etcd``, ``zookeeper``, ``consul``, ``disque``,
``raftis``, ``rabbitmq``, ``rabbitmq-mutex``, ``hazelcast``) and those
whose data plane is a command on the nodes (the eight ``cockroachdb``
rows, ``aerospike``, ``aerospike-counter``, ``mongodb``,
``mongodb-transfer``), and the rest: ``logcabin``, ``robustirc``,
``rethinkdb``, ``rethinkdb-aggressive``, ``ravendb``, ``mongodb-rocks``,
the three ``galera`` rows, the three ``tidb`` rows, the three ``percona``
rows, ``mysql-cluster``, ``postgres-rds``, the three ``crate`` rows, the
seven ``elasticsearch`` rows and ``chronos``: all 53 rows of the
reference's ``SUITES``. A stored run whose ops carry ``[k v]`` values
(etcd's, the keyed registers') is re-checked key by key, as the run
checked it (``independent.checker``).

``python -m jepsen_tpu_torch explain [--store DIR]`` says why a stored
run (by either package; the latest under ``--store-root`` by default) got
its verdict (:mod:`jepsen_tpu_torch.explain`): the search's shape for a
valid run, the violating level, blocking ops and witness region for an
invalid one, the cause chain for an unknown one, as ``# explain:`` lines
or, with ``--format json``, the report. It reads the artifacts only: no
check runs.

``python -m jepsen_tpu_torch watch [--store DIR] [--once]`` follows
another process's run from its ``progress.json`` (the search's level,
frontier, rate and ETA) until its ``run.state`` is terminal; ``--fleet
DIR...`` renders several hosts' directories side by side.
``python -m jepsen_tpu_torch trace export|summary|request|find`` reads a
run's or a serve directory's ``trace.jsonl``: a Chrome/Perfetto or jsonl
export and a per-span rollup (each with the kernels of a ``--profile``d
run's ``profile/`` merged in as a device lane), one request's stitched
waterfall (by serve request id or trace id), and a search of the serve
directory's requests by tenant, device seconds, error class and host.
``python -m jepsen_tpu_torch lint`` runs the static analyzer's passes
(:mod:`jepsen_tpu_torch.analysis`) over the port, or over the paths and
``--history`` files given, against its baseline
(``jepsen_tpu_torch/analysis/lint.baseline``): text, ``json`` or
``sarif``, ``--write-baseline``, ``--prune-stale`` and ``--strict`` as in
the reference. These print what the reference's commands print on the
same inputs.

Exit codes, as the reference's command line has them: 0 valid, 1 not
valid (or unknown), 254 bad arguments or a missing store, 255 an internal
error, a CUDA device that does not initialise among them: with the card's
backend, nothing carries on on the CPU.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import logging
import os
import sys
import time
from typing import Optional

#: exit codes, as the reference's command line has them
OK, TEST_FAILED, INVALID_ARGS, CRASHED = 0, 1, 254, 255


class _ArgError(Exception):
    pass


class _Parser(argparse.ArgumentParser):
    """Raises instead of exiting, so :func:`main` answers bad arguments
    with 254."""

    def error(self, message):
        raise _ArgError(message)


def _parser() -> argparse.ArgumentParser:
    from jepsen_tpu_torch.serve import models
    from jepsen_tpu_torch.suites import SUITES
    from jepsen_tpu_torch.suites.cockroachdb import NEMESES
    from jepsen_tpu_torch.suites.mongodb import READ_CONCERNS, WRITE_CONCERNS
    p = _Parser(prog="python -m jepsen_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="serve the results browser (and, "
                                     "opted in, the check daemon)")
    s.add_argument("--check-daemon", action="store_true",
                   help="mount the multi-tenant check daemon: POST /check, "
                        "GET /check/<id>, /healthz, /drain, the /stream "
                        "routes and the telemetry (JTPU_SERVE=1 does the "
                        "same)")
    s.add_argument("-b", "--host", default="0.0.0.0")
    s.add_argument("-p", "--port", type=int, default=8080,
                   help="port to listen on (0: any free port)")
    s.add_argument("--store-root", default="store",
                   help="the store the results browser serves")
    s.add_argument("--serve-dir", default=None, metavar="DIR",
                   help="daemon directory: request journal, results, "
                        "heartbeat, time series (default: "
                        "<store-root>/serve)")
    s.add_argument("--workers", type=int, default=None,
                   help="check worker threads (JTPU_SERVE_WORKERS)")
    s.add_argument("--queue-max", type=int, default=None,
                   help="queue depth past which POST /check answers 429 "
                        "(JTPU_SERVE_QUEUE)")
    s.add_argument("--tenant-max", type=int, default=None,
                   help="queued requests a tenant may have "
                        "(JTPU_SERVE_TENANT_MAX)")
    s.add_argument("--deadline-s", type=float, default=None,
                   help="default per-request deadline; past it a request "
                        "answers :info/timeout (JTPU_SERVE_DEADLINE_S)")
    s.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the searches run (default: cuda)")
    s.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="the kernel library's build directory, so that a "
                        "restarted daemon loads the library built there "
                        "instead of running nvcc again")
    s.add_argument("--serve-backend", default=None, choices=["gpu", "cpu"],
                   help="checker backend for daemon requests (default: gpu, "
                        "the device search; JTPU_SERVE_BACKEND)")
    s.add_argument("--batch-max", type=int, default=None,
                   help="most same-bucket requests coalesced into one gang; "
                        "0 or 1 turns gangs off (JTPU_SERVE_BATCH_MAX)")
    s.add_argument("--batch-wait-ms", type=float, default=None,
                   help="how long a gang's leader waits for members of its "
                        "bucket (JTPU_SERVE_BATCH_WAIT_MS)")
    s.add_argument("--auth-token", default=None, metavar="TOKEN",
                   help="require 'Authorization: Bearer TOKEN' on POST "
                        "/check, /stream and /drain (JTPU_SERVE_TOKEN)")
    s.add_argument("--engine-max-buckets", type=int, default=None,
                   help="evict the least recently used warm buckets past "
                        "this count; 0: no bound (JTPU_ENGINE_MAX_BUCKETS)")
    s.add_argument("--fleet", type=int, default=None, metavar="N",
                   help="place the gangs on N fleet worker hosts "
                        "(JTPU_SERVE_FLEET)")
    s.add_argument("--rate-limit", type=float, default=None, metavar="R",
                   help="per-tenant POST /check token bucket: R requests/s, "
                        "429 with Retry-After past it; 0: off "
                        "(JTPU_SERVE_RATE)")
    t = sub.add_parser("stream", help="stream a history into a check "
                                      "daemon's /stream routes and await "
                                      "the verdict")
    t.add_argument("--url", default="http://127.0.0.1:8080",
                   help="daemon base URL")
    t.add_argument("--store", default=None,
                   help="store directory whose history.jsonl to stream "
                        "(default: the latest under ./store)")
    t.add_argument("--history", default=None, metavar="FILE",
                   help="history file (a JSON array or JSON lines of op "
                        "maps) instead of --store")
    t.add_argument("--model", default="cas-register", choices=list(models()))
    t.add_argument("--tenant", default="default")
    t.add_argument("--chunk", type=int, default=1000, help="ops per chunk")
    t.add_argument("--auth-token", default=None, metavar="TOKEN",
                   help="Authorization: Bearer TOKEN")
    t.add_argument("--poll", type=float, default=0.5,
                   help="verdict poll interval (seconds)")
    t.add_argument("--timeout", type=float, default=600.0,
                   help="the client's whole budget (seconds)")
    q = sub.add_parser("plan", help="verify a search plan ahead of any "
                                    "device time: encoding, memory and "
                                    "kernel shape")
    q.add_argument("--history", default=None, metavar="FILE",
                   help="derive the dims from a history file (a JSON array "
                        "or JSON lines of op maps)")
    q.add_argument("--dims", default=None, metavar="SPEC",
                   help="dims without a history: 'N_REQUIRED[,N_CRASHED"
                        "[,WINDOW_NEEDED[,N_EVENTS]]]' or @file.json (keys: "
                        "n_required, n_crashed, window_needed, n_events, "
                        "keys, capacity, window, expand, bytes_limit)")
    q.add_argument("--model", default="cas-register", choices=list(models()))
    q.add_argument("--keys", type=int, default=1,
                   help="verify the keyed-batch plan for this many keys")
    q.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="also verify the pool-sharded plan over a mesh "
                        "axis of N shards")
    q.add_argument("--capacity", type=int, default=None,
                   help="pin the rung instead of the ladder")
    q.add_argument("--window", type=int, default=None)
    q.add_argument("--expand", type=int, default=None)
    q.add_argument("--bytes-limit", type=int, default=None,
                   help="byte budget (default: JTPU_PLAN_BYTES_LIMIT, else "
                        "the card's memory, else unchecked)")
    q.add_argument("--no-trace", action="store_true",
                   help="skip the shape check (arithmetic only)")
    q.add_argument("--format", default="text",
                   choices=["text", "json", "sarif"])
    q.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the device whose ladder and memory to plan for")
    r = sub.add_parser("run", help="run a registered suite: workload, "
                                   "store, then the check")
    r.add_argument("--suite", required=True, choices=sorted(SUITES))
    r.add_argument("-n", "--node", action="append", metavar="HOSTNAME",
                   help="node to run the test on; repeatable (default: "
                        "the suite's nodes)")
    r.add_argument("--nodes-file", metavar="FILENAME",
                   help="file of node hostnames, one per line")
    r.add_argument("--username", default="root", help="ssh username")
    r.add_argument("--password", default="root", help="sudo password")
    r.add_argument("--strict-host-key-checking", action="store_true",
                   help="check ssh host keys")
    r.add_argument("--ssh-private-key", metavar="FILE",
                   help="ssh identity file")
    r.add_argument("--ssh-mode", default=None,
                   choices=[None, "ssh", "dummy", "local"],
                   help="control-plane transport (dummy = record only)")
    r.add_argument("--dummy-responses", default=None, metavar="FILE",
                   help="with --ssh-mode dummy: a JSON object mapping a "
                        "command substring to its reply (stdout, or "
                        "[exit, stdout, stderr])")
    r.add_argument("--workload", default=None,
                   choices=sorted({w for m in _WORKLOAD_MODULES
                                   for w in _workloads(m)}),
                   help="the workload of a hazelcast, aerospike, mongodb, "
                        "cockroachdb or tidb suite (default: the row's "
                        "own)")
    r.add_argument("--nemesis", action="append", default=None,
                   choices=sorted(NEMESES),
                   help="a cockroachdb or tidb nemesis (a tidb row takes "
                        "none, parts, majring, startstop, startstop2, "
                        "startkill and startkill2); repeatable")
    r.add_argument("--nemesis2", action="append", default=None,
                   choices=sorted(NEMESES),
                   help="a second cockroachdb or tidb nemesis to compose "
                        "with --nemesis; repeatable")
    r.add_argument("--write-concern", default=None, choices=WRITE_CONCERNS,
                   help="the mongodb client's write concern (default: "
                        "majority)")
    r.add_argument("--read-concern", default=None, choices=READ_CONCERNS,
                   help="the mongodb client's read concern (default: "
                        "linearizable)")
    r.add_argument("--concurrency", default=None,
                   help="worker count; an integer, optionally followed by "
                        "n to multiply by the node count (e.g. 3n; "
                        "default: the suite's)")
    r.add_argument("--test-count", type=int, default=1,
                   help="how many times to repeat the test")
    r.add_argument("--time-limit", type=int, default=None,
                   help="test phase duration in seconds (default: the "
                        "suite's)")
    r.add_argument("--op-timeout", type=float, default=None,
                   metavar="SECONDS",
                   help="bound each client op: a hung invoke becomes an "
                        ":info op and the process reincarnates")
    r.add_argument("--store-root", default="store", metavar="DIR",
                   help="where runs are stored")
    _add_device_opts(r)
    r.add_argument("--watch", action="store_true",
                   help="print a live search-progress status line "
                        "(level/frontier/ETA) to stderr while the checker "
                        "runs; `watch` follows another process's run")
    r.add_argument("--fleet", type=int, default=None, metavar="N",
                   help="run single-history searches under the elastic "
                        "fleet over N logical hosts (JTPU_FLEET=N)")
    a = sub.add_parser("analyze", help="re-check a stored run offline")
    a.add_argument("--store", default=None,
                   help="store directory (default: the latest under "
                        "./store)")
    _add_check_opts(a)
    v = sub.add_parser("recover", help="recover runs that died mid-flight "
                                       "from their WALs and re-check them")
    v.add_argument("--store", default=None,
                   help="a specific run directory (default: scan "
                        "--store-root for dead runs)")
    v.add_argument("--store-root", default="store",
                   help="store root to scan for dead runs")
    v.add_argument("--no-analyze", action="store_true",
                   help="reconstruct histories only; skip the checker")
    v.add_argument("--force", action="store_true",
                   help="recover --store even if its run.state says done "
                        "or its pid looks alive")
    _add_check_opts(v)
    e = sub.add_parser("explain", help="explain a stored run's verdict "
                                       "from its artifacts (results, "
                                       "searchstats, attempts trail)")
    e.add_argument("--store", default=None,
                   help="run directory (default: the latest under "
                        "--store-root)")
    e.add_argument("--store-root", default="store")
    e.add_argument("--model", default="cas-register", choices=list(models()),
                   help="the model the counterexample is packed with "
                        "(invalid verdicts only)")
    e.add_argument("--format", default="text", choices=["text", "json"])
    _add_watch_parser(sub)
    _add_trace_parser(sub)
    _add_lint_parser(sub)
    _add_daemon_readers(sub)
    return p


def _add_daemon_readers(sub) -> None:
    """``usage``, ``flightrec`` and ``top``: readers of a serve
    directory's artifacts, live or not."""
    u = sub.add_parser("usage", help="per-tenant usage totals from a serve "
                                     "daemon's request journal")
    u.add_argument("--serve-dir", default=None, metavar="DIR",
                   help="daemon directory (default: <store-root>/serve)")
    u.add_argument("--store-root", default="store")
    u.add_argument("--tenant", default=None,
                   help="one tenant only (default: all)")
    u.add_argument("--json", action="store_true",
                   help="raw JSON instead of the table")
    f = sub.add_parser("flightrec", help="list or show a serve daemon's "
                                         "flight-recorder dumps")
    f.add_argument("dump", nargs="?", default=None,
                   help="dump file name (default: list them)")
    f.add_argument("--serve-dir", default=None, metavar="DIR",
                   help="daemon directory (default: <store-root>/serve)")
    f.add_argument("--store-root", default="store")
    f.add_argument("--json", action="store_true",
                   help="raw JSON instead of the summary")
    t = sub.add_parser("top", help="one-screen live status of a serve "
                                   "directory from its published artifacts")
    t.add_argument("--store", default=None,
                   help="serve (or run) directory (default: latest under "
                        "--store-root)")
    t.add_argument("--store-root", default="store")
    t.add_argument("--interval", type=float, default=2.0,
                   help="seconds between refreshes")
    t.add_argument("--once", action="store_true",
                   help="print one screen and exit")


def _add_watch_parser(sub) -> None:
    w = sub.add_parser("watch", help="live status line of an in-flight "
                                     "run's device search")
    w.add_argument("--store", default=None,
                   help="run directory (default: the latest under "
                        "--store-root)")
    w.add_argument("--store-root", default="store")
    w.add_argument("--interval", type=float, default=1.0,
                   help="seconds between refreshes")
    w.add_argument("--once", action="store_true",
                   help="print one status line and exit")
    w.add_argument("--fleet", nargs="+", default=None, metavar="HOST_DIR",
                   help="fleet mode: merge N hosts' run directories "
                        "(trace, metrics, progress) and render each host's "
                        "level, imbalance and headroom side by side")


def _add_trace_parser(sub) -> None:
    t = sub.add_parser("trace", help="export, summarize, stitch or search a "
                                     "run's span trace (trace.jsonl)")
    t.add_argument("action", choices=["export", "summary", "request",
                                      "find"],
                   help="export: Chrome/Perfetto (or raw jsonl) trace; "
                        "summary: per-span rollup; request: one request's "
                        "stitched waterfall; find: search a serve "
                        "directory's requests")
    t.add_argument("rid", nargs="?", default=None, metavar="ID",
                   help="with `request`: the serve request id (or 32-hex "
                        "trace id) to stitch")
    t.add_argument("--store", default=None,
                   help="store directory (default: the latest under "
                        "./store)")
    t.add_argument("--format", default=None,
                   choices=["chrome", "jsonl", "json", "text"],
                   help="output format (default: chrome for export, text "
                        "for request)")
    t.add_argument("-o", "--output", default=None, metavar="FILE",
                   help="write the export here (default: stdout)")
    t.add_argument("--top", type=int, default=None, metavar="N",
                   help="with `summary`: also the N slowest span names by "
                        "self time")
    t.add_argument("--host-dir", action="append", default=None,
                   metavar="DIR",
                   help="with `request`: more host directories whose "
                        "trace.jsonl joins the stitch (repeatable)")
    t.add_argument("--tenant", default=None,
                   help="with `find`: only this tenant's requests")
    t.add_argument("--min-device-s", type=float, default=None, metavar="S",
                   help="with `find`: only requests that took at least S "
                        "device seconds")
    t.add_argument("--error-class", default=None, metavar="CLASS",
                   help="with `find`: only requests whose result carries "
                        "this error class")
    t.add_argument("--host", default=None,
                   help="with `find`: only requests with spans on this host")
    t.add_argument("--limit", type=int, default=50, metavar="N",
                   help="with `find`: the newest N matches (default 50)")


def _add_lint_parser(sub) -> None:
    from jepsen_tpu_torch import analysis
    q = sub.add_parser("lint", help="static analysis: broken suites, "
                                    "malformed histories, races, lock "
                                    "order, crash consistency, widths")
    q.add_argument("paths", nargs="*", metavar="PATH",
                   help="files to lint (.py through the code passes, "
                        ".jsonl/.wal through the history pass); default: "
                        "the port at its standard scopes")
    q.add_argument("--history", action="append", default=[],
                   metavar="FILE",
                   help="also lint a saved history artifact (repeatable)")
    q.add_argument("--pass", dest="passes", action="append",
                   choices=list(analysis.PASSES), metavar="PASS",
                   help=f"run only these passes (repeatable; choices: "
                        f"{', '.join(analysis.PASSES)})")
    q.add_argument("--baseline", default=None, metavar="FILE",
                   help="baseline file (default: "
                        "jepsen_tpu_torch/analysis/lint.baseline)")
    q.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline: report everything")
    q.add_argument("--write-baseline", action="store_true",
                   help="accept the current findings into the baseline "
                        "file (existing justifications are kept; new "
                        "entries get a TODO stub)")
    q.add_argument("--prune-stale", action="store_true",
                   help="rewrite the baseline without the entries that no "
                        "longer match any finding")
    q.add_argument("--strict", action="store_true",
                   help="exit nonzero on new warnings too, not just errors")
    q.add_argument("--format", default="text",
                   choices=["text", "json", "sarif"],
                   help="sarif: SARIF 2.1.0 of the new findings")
    q.add_argument("--root", default=None,
                   help="repo root override (fixtures, tests)")


def _add_check_opts(p: argparse.ArgumentParser) -> None:
    """The checker options of analyze and recover."""
    from jepsen_tpu_torch.serve import models
    p.add_argument("--model", default="cas-register", choices=list(models()),
                   help="the model to check against")
    p.add_argument("--algorithm", default="auto",
                   choices=["auto", "wgl", "linear", "native",
                            "competition"],
                   help="the host search")
    _add_device_opts(p)


def _add_device_opts(p: argparse.ArgumentParser) -> None:
    """Where the check runs: the options of run, analyze and recover."""
    p.add_argument("--backend", default="gpu", choices=["gpu", "cpu"],
                   help="gpu: the device search (default); cpu: the host "
                        "search")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the device search runs (default: cuda; cpu "
                        "runs the kernels' plain versions)")
    p.add_argument("--segment-iters", type=int, default=None, metavar="N",
                   help="device-search levels per checkpointed segment "
                        "(JTPU_SEGMENT_ITERS)")
    p.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler trace of the check into "
                        "<run>/profile/ (JTPU_PROF=1)")


def serve_config(opts: argparse.Namespace):
    """The daemon's ``ServeConfig`` from ``serve``'s flags: each flag given
    wins over its ``JTPU_SERVE_*`` variable, which only sets the default.
    ``--compile-cache`` points the kernel build directory at its
    argument."""
    from jepsen_tpu_torch import serve as serve_ns
    cfg = serve_ns.ServeConfig(
        root=opts.serve_dir or os.path.join(opts.store_root, "serve"),
        device="cpu" if opts.device == "cpu" else None)
    for name in ("workers", "queue_max", "tenant_max", "batch_wait_ms",
                 "engine_max_buckets", "rate_limit"):
        if getattr(opts, name) is not None:
            setattr(cfg, name, getattr(opts, name))
    if opts.deadline_s is not None:
        cfg.deadline_s = opts.deadline_s or None
    if opts.serve_backend is not None:
        cfg.backend = opts.serve_backend
    if opts.batch_max is not None:
        cfg.batch_max = opts.batch_max
        cfg.batch_enabled = opts.batch_max > 1
    if opts.auth_token is not None:
        cfg.auth_token = opts.auth_token or None
    if opts.fleet is not None:
        cfg.fleet_hosts = opts.fleet
    if opts.compile_cache is not None:
        from jepsen_tpu_torch.kernels import build
        build.BUILD_DIR = os.path.abspath(opts.compile_cache)
    return cfg


def serve(opts: argparse.Namespace) -> int:
    """The results browser over ``--store-root``; with ``--check-daemon``
    (or JTPU_SERVE=1) the check daemon mounted on it, until ``POST
    /drain`` or SIGTERM (which first dumps the flight recorder)."""
    from jepsen_tpu_torch import serve as serve_ns
    from jepsen_tpu_torch import web
    if not (opts.check_daemon or serve_ns.serve_enabled()):
        server = web.serve(host=opts.host, port=opts.port,
                           root=opts.store_root)
        print(f"Listening on http://{opts.host}:{server.server_port}/",
              flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        server.server_close()
        return OK
    cfg = serve_config(opts)
    daemon, server = serve_ns.run_daemon(cfg, host=opts.host,
                                         port=opts.port,
                                         store_root=opts.store_root)
    if daemon.flightrec is not None:
        import signal

        def on_sigterm(_sig, _frame):
            # the recorder's last window, then the wait below ends
            daemon.flightrec.dump("sigterm")
            daemon.drained.set()

        try:
            signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:
            pass    # not the main thread: no handler
    print(f"Listening on http://{opts.host}:{server.server_port}/ (check "
          f"daemon: POST /check, GET /check/<id>, /healthz, /drain"
          f"{', /stream' if daemon._streams is not None else ''})",
          flush=True)
    try:
        daemon.drained.wait()
    except KeyboardInterrupt:
        daemon.drain(timeout_s=30.0)
    server.shutdown()
    server.server_close()
    daemon.stop()
    return 0


def _load_ops(path: str) -> list:
    """A history file's op maps: a JSON array, or one per line."""
    with open(path) as f:
        text = f.read().strip()
    if text.startswith("["):
        return json.loads(text)
    return [json.loads(ln) for ln in text.splitlines() if ln.strip()]


def stream(opts: argparse.Namespace) -> int:
    import urllib.error
    import urllib.request

    from jepsen_tpu_torch.stream import chunk_crc
    base = opts.url.rstrip("/")

    def call(method, path, doc=None):
        req = urllib.request.Request(
            base + path, method=method,
            data=None if doc is None else json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"})
        if opts.auth_token:
            req.add_header("Authorization", f"Bearer {opts.auth_token}")
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read() or b"{}")
            except ValueError:
                body = {}
            return e.code, body

    if opts.history:
        try:
            ops = _load_ops(opts.history)
        except (OSError, ValueError) as e:
            print(f"cannot read {opts.history}: {e}", file=sys.stderr)
            return INVALID_ARGS
    else:
        from jepsen_tpu_torch import repl, store
        if opts.store and not os.path.isdir(opts.store):
            print(f"no such store directory: {opts.store}", file=sys.stderr)
            return INVALID_ARGS
        test = store.load(opts.store) if opts.store else repl.last_test()
        if test is None:
            print("no stored test found", file=sys.stderr)
            return INVALID_ARGS
        ops = [op.to_dict() if hasattr(op, "to_dict") else dict(op)
               for op in (test.get("history") or [])]
    if not ops:
        print("history is empty; nothing to stream", file=sys.stderr)
        return INVALID_ARGS
    deadline = time.monotonic() + opts.timeout

    def budget() -> float:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError("stream client budget exhausted")
        return left

    opening = {"tenant": opts.tenant, "model": opts.model}
    code, body = call("POST", "/stream", opening)
    while code == 429:
        time.sleep(min(float(body.get("retry-after-s") or 1.0), budget()))
        code, body = call("POST", "/stream", opening)
    if code != 202:
        print(f"open failed: HTTP {code} {body}", file=sys.stderr)
        return CRASHED
    sid = body["id"]
    n_chunk = max(1, opts.chunk)
    chunks = [ops[i:i + n_chunk] for i in range(0, len(ops), n_chunk)]
    print(f"# stream: {sid} -> {base} ({len(ops)} ops in {len(chunks)} "
          f"chunk(s) of <= {n_chunk})", flush=True)
    seq = 0
    while seq < len(chunks):
        code, body = call("POST", f"/stream/{sid}/ops",
                          {"seq": seq, "ops": chunks[seq],
                           "crc": chunk_crc(chunks[seq])})
        if code == 202:
            seq += 1
        elif code == 429:
            time.sleep(min(float(body.get("retry-after-s") or 1.0),
                           budget()))
        elif code == 409 and body.get("error") == "gap":
            # chunks are idempotent: resend from the daemon's cursor
            seq = int(body["need"])
        elif code == 409 and body.get("error") == "stream-failed":
            # the online check refuted a stable prefix: the verdict is in
            print(f"# stream: {sid} failed fast at chunk {seq}; awaiting "
                  f"the verdict", flush=True)
            break
        else:
            print(f"chunk {seq} failed: HTTP {code} {body}", file=sys.stderr)
            return CRASHED
        budget()
    code, body = call("POST", f"/stream/{sid}/close",
                      {"chunks": len(chunks)})
    if code not in (200, 202) and body.get("error") != "stream-failed":
        print(f"close failed: HTTP {code} {body}", file=sys.stderr)
        return CRASHED
    while True:
        code, body = call("GET", f"/stream/{sid}")
        if code == 200 and body.get("state") == "done" \
                and body.get("result") is not None:
            break
        time.sleep(min(opts.poll, budget()))
    result = body["result"]
    print(json.dumps(result, indent=2, default=repr))
    return OK if result.get("valid") is True else TEST_FAILED


def _plan_dims(opts: argparse.Namespace, model):
    """The dims ``plan`` verifies, or an error message. Shape knobs a
    ``@file.json`` pins fill the flags not given."""
    from jepsen_tpu_torch.checker import plan
    from jepsen_tpu_torch.history import History
    if opts.history:
        try:
            h = History.of(_load_ops(opts.history))
        except (OSError, ValueError) as e:
            return f"cannot read {opts.history}: {e}"
        dims = plan.PlanDims.from_history(h, model)
        if dims is None:
            return f"model {opts.model} has no integer kernel; nothing to plan"
        return dims
    if not opts.dims:
        return "pass --history FILE or --dims SPEC"
    spec = opts.dims
    if spec.startswith("@"):
        try:
            with open(spec[1:], encoding="utf-8") as f:
                d = json.load(f)
        except (OSError, ValueError) as e:
            return f"--dims {spec!r}: {e}"
        for knob in ("capacity", "window", "expand", "mesh", "bytes_limit"):
            if getattr(opts, knob) is None and d.get(knob) is not None:
                setattr(opts, knob, int(d[knob]))
        return plan.PlanDims(
            n_required=int(d["n_required"]),
            n_crashed=int(d.get("n_crashed", 0)),
            window_needed=int(d.get("window_needed", 1)),
            n_events=(int(d["n_events"]) if d.get("n_events") is not None
                      else None),
            keys=int(d.get("keys", opts.keys or 1)))
    try:
        parts = [int(x) for x in spec.split(",")]
    except ValueError:
        return (f"--dims {spec!r}: expected comma-separated integers or "
                f"@file.json")
    if not parts or len(parts) > 4:
        return f"--dims {spec!r}: 1-4 integers"
    return plan.PlanDims(*parts, keys=opts.keys or 1)


def plan_cmd(opts: argparse.Namespace) -> int:
    from jepsen_tpu_torch.checker import plan
    from jepsen_tpu_torch.models.core import kernel_spec_for
    from jepsen_tpu_torch.serve import models
    model = models()[opts.model]()
    dims = _plan_dims(opts, model)
    if isinstance(dims, str):
        print(dims, file=sys.stderr)
        return INVALID_ARGS
    if (opts.keys or 1) > 1 and dims.keys == 1:
        dims = plan.PlanDims(dims.n_required, dims.n_crashed,
                             dims.window_needed, dims.n_events,
                             keys=opts.keys)
    report = plan.analyze(dims, kernel=kernel_spec_for(model),
                          capacity=opts.capacity, window=opts.window,
                          expand=opts.expand, bytes_limit=opts.bytes_limit,
                          trace=not opts.no_trace, device=opts.device,
                          mesh_axis=opts.mesh)
    errors = [i for i in report["issues"] if i["severity"] == "error"]
    if opts.format == "json":
        print(json.dumps(report, indent=2))
        return TEST_FAILED if errors else OK
    if opts.format == "sarif":
        from jepsen_tpu_torch.analysis import plan_lint, sarif
        print(sarif.render(plan_lint.findings_from_report(report)), end="")
        return TEST_FAILED if errors else OK
    d, lim = report["dims"], report["bytes-limit"]
    print(f"# plan: dims n={d['n-required']}+{d['n-crashed']} "
          f"window<={d['window-needed']} keys={d['keys']}, limit "
          f"{'unchecked' if lim is None else f'{lim} B'}")
    for i in report["issues"]:
        if not i.get("label"):   # dims-level, not per-candidate
            print(f"# plan: {i['severity'].upper()} [{i['rule']}] "
                  f"{i['message']}")
    for c in report["candidates"]:
        mark = "ok " if c["status"] == "ok" else "REJ"
        line = (f"# plan: {mark} {c['label']:<36} "
                f"{c['footprint']['total-bytes'] / 1e6:9.3f} MB")
        if c.get("cost"):
            # integer operations and bytes of one level (kernels/cost.py)
            line += (f" {c['cost']['flops'] / 1e6:10.2f} MOP/level "
                     f"{c['cost']['bytes-accessed'] / 1e6:9.3f} MB/level")
        rules = sorted({i["rule"] for i in c["issues"]})
        if rules:
            line += "  " + " ".join(rules)
        print(line)
    print(f"# plan: selected {report['selected'] or 'NONE'}; "
          f"{len(errors)} error finding(s)")
    return TEST_FAILED if errors else OK


def _apply_check_env(opts: argparse.Namespace) -> None:
    """--segment-iters and --profile reach the device search through the
    environment it reads, for every check this process runs."""
    if opts.segment_iters is not None:
        os.environ["JTPU_SEGMENT_ITERS"] = str(opts.segment_iters)
    if opts.profile:
        os.environ["JTPU_PROF"] = "1"


def _device(opts: argparse.Namespace):
    """The device argument of the checkers: None (CUDA) or "cpu"."""
    return "cpu" if opts.device == "cpu" else None


def _card_refused(opts: argparse.Namespace, cmd: str) -> bool:
    """True, with the reason on stderr, when the check is to run on the
    card and CUDA does not initialise: the command then stops before any
    work, and does not carry on on the CPU."""
    if opts.backend != "gpu" or opts.device == "cpu":
        return False
    from jepsen_tpu_torch import accel
    try:
        accel.ensure_usable(cmd)
    except accel.AcceleratorUnavailable as e:
        print(f"{cmd}: {e}", file=sys.stderr)
        return True
    return False


#: the suite modules whose rows take ``--workload`` (of sql_family, the
#: tidb rows only: ``_takes_workload``)
_WORKLOAD_MODULES = ("hazelcast", "aerospike", "mongodb", "cockroachdb",
                     "sql_family")


#: the suites whose checks run on the host only: ``run`` does not probe
#: the card for them
_HOST_CHECKED = ("chronos",)


def _workloads(module: str):
    """The workload names of a suite module in _WORKLOAD_MODULES (a
    mapping keyed by them)."""
    m = importlib.import_module(f"jepsen_tpu_torch.suites.{module}")
    return m.workloads() if module == "hazelcast" else m.WORKLOADS


def _suite_module(suite: str) -> str:
    from jepsen_tpu_torch.suites import SUITES
    return SUITES[suite][0]


def _is_tidb(suite: str) -> bool:
    """A tidb row: the rows the reference's ``tidb_main`` runs."""
    from jepsen_tpu_torch.suites.sql_family import TIDB_WORKLOADS
    return suite in TIDB_WORKLOADS


def _takes_workload(suite: str) -> bool:
    module = _suite_module(suite)
    return module in _WORKLOAD_MODULES and (module != "sql_family"
                                            or _is_tidb(suite))


def _parse_concurrency(c: str, n_nodes: int) -> int:
    """'3n' -> 3 * nodes; a plain integer otherwise."""
    import re
    m = re.fullmatch(r"(\d+)(n?)", str(c))
    if not m:
        raise _ArgError(f"--concurrency {c} should be an integer "
                        f"optionally followed by n")
    return int(m.group(1)) * (n_nodes if m.group(2) == "n" else 1)


def _test_opts(opts: argparse.Namespace) -> dict:
    """The option map a suite constructor takes (the reference's
    ``test_opt_fn``); options left at None are the suite's own."""
    nodes = list(opts.node or [])
    if opts.nodes_file:
        with open(opts.nodes_file) as f:
            nodes += [ln.strip() for ln in f if ln.strip()]
    out = {"ssh": {"username": opts.username, "password": opts.password,
                   "strict-host-key-checking":
                       opts.strict_host_key_checking,
                   "private-key-path": opts.ssh_private_key,
                   "mode": opts.ssh_mode},
           "test-count": opts.test_count, "op-timeout": opts.op_timeout,
           "store-root": opts.store_root, "backend": opts.backend,
           "device": _device(opts), "segment-iters": opts.segment_iters,
           "profile": opts.profile}
    if nodes:
        out["nodes"] = nodes
    if opts.concurrency is not None:
        if str(opts.concurrency).endswith("n") and not nodes:
            raise _ArgError("--concurrency Nn needs --node or --nodes-file")
        out["concurrency"] = _parse_concurrency(opts.concurrency, len(nodes))
    if opts.time_limit is not None:
        out["time-limit"] = opts.time_limit
    module = _suite_module(opts.suite)
    if opts.workload is not None:
        if not _takes_workload(opts.suite):
            raise _ArgError("--workload selects a workload of a hazelcast, "
                            "aerospike, mongodb, cockroachdb or tidb suite "
                            "only")
        choices = _workloads(module)
        if opts.workload not in choices:
            raise _ArgError(f"--workload {opts.workload} is not a workload "
                            f"of --suite {opts.suite} (choose from "
                            f"{', '.join(sorted(choices))})")
        out["workload"] = opts.workload
    if module == "cockroachdb":
        # composed as the reference's cockroachdb main composes them
        from jepsen_tpu_torch.suites import cockroachdb
        out["nemesis"] = cockroachdb.named_nemesis(opts.nemesis,
                                                   opts.nemesis2)
    elif _is_tidb(opts.suite):
        # composed in run_cmd, as the reference's tidb_main composes them
        from jepsen_tpu_torch.suites.sql_family import TIDB_NEMESES
        for flag, names in (("nemesis", opts.nemesis),
                            ("nemesis2", opts.nemesis2)):
            for name in names or ():
                if name not in TIDB_NEMESES:
                    raise _ArgError(
                        f"--{flag} {name} is not a nemesis of --suite "
                        f"{opts.suite} (choose from "
                        f"{', '.join(sorted(TIDB_NEMESES))})")
    elif opts.nemesis or opts.nemesis2:
        raise _ArgError("--nemesis and --nemesis2 name the nemeses of a "
                        "cockroachdb or tidb suite only")
    for flag in ("write_concern", "read_concern"):
        value = getattr(opts, flag)
        if value is None:
            continue
        if module != "mongodb":
            raise _ArgError(f"--{flag.replace('_', '-')} sets the client "
                            f"of a mongodb suite only")
        out[flag.replace("_", "-")] = value
    if opts.dummy_responses is not None:
        if opts.ssh_mode != "dummy":
            raise _ArgError("--dummy-responses needs --ssh-mode dummy")
        out["ssh"]["dummy-responses"] = _dummy_responses(
            opts.dummy_responses)
    return out


def _dummy_responses(path: str) -> dict:
    """The dummy control plane's scripted replies from a JSON file: a
    command substring -> its stdout, or ``[exit, stdout, stderr]``."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise _ArgError(f"--dummy-responses {path}: {e}")
    if not isinstance(doc, dict):
        raise _ArgError(f"--dummy-responses {path}: expected a JSON object")
    out = {}
    for pat, resp in doc.items():
        if isinstance(resp, list):
            if len(resp) != 3:
                raise _ArgError(f"--dummy-responses {path}: {pat!r} needs "
                                f"[exit, stdout, stderr]")
            resp = (int(resp[0]), str(resp[1]), str(resp[2]))
        elif not isinstance(resp, str):
            raise _ArgError(f"--dummy-responses {path}: {pat!r}: expected "
                            f"a string or a list")
        out[str(pat)] = resp
    return out


def run_cmd(opts: argparse.Namespace) -> int:
    if opts.fleet is None:
        return _run(opts)
    # the device search reads the fleet opt-in from the environment, for
    # this run only
    prev = os.environ.get("JTPU_FLEET")
    os.environ["JTPU_FLEET"] = str(opts.fleet)
    try:
        return _run(opts)
    finally:
        if prev is None:
            os.environ.pop("JTPU_FLEET", None)
        else:
            os.environ["JTPU_FLEET"] = prev


def _run(opts: argparse.Namespace) -> int:
    from jepsen_tpu_torch import core, suites
    from jepsen_tpu_torch.obs import observatory
    test_opts = _test_opts(opts)
    _apply_check_env(opts)
    if opts.suite not in _HOST_CHECKED and _card_refused(opts, "run"):
        return CRASHED
    ctor = suites.registry()[opts.suite]
    module = _suite_module(opts.suite)
    if opts.workload is not None and module != "hazelcast":
        # the workload picks the module's constructor, as its reference
        # main does; hazelcast's reads the option itself
        ctor = _workloads(module)[opts.workload]
    if _is_tidb(opts.suite) and (opts.nemesis or opts.nemesis2):
        # the first point of the tidb matrix (the reference's tidb_main);
        # without a nemesis the row keeps its own partition cycle
        from jepsen_tpu_torch.suites.sql_family import named_test
        ctor = functools.partial(named_test, opts.workload or opts.suite,
                                 opts.nemesis, opts.nemesis2)
    stop = observatory.live_status_printer() if opts.watch else None
    try:
        for _ in range(opts.test_count):
            test = core.run(ctor(dict(test_opts)))
            if test["results"].get("valid") is not True:
                return TEST_FAILED
        return OK
    finally:
        if stop is not None:
            stop()


def _search_line(out) -> Optional[str]:
    """The ``# search:`` analytics line from the result's searchstats
    roll-up; None when the check ran without the stats lane."""
    ss = (out or {}).get("searchstats")
    if not isinstance(ss, dict):
        return None
    return ("# search: dup-rate {dr:.0%}, prune-efficiency {pe:.0%}, "
            "frontier area {fa} (peak {fp}), truncation-losses {tr} "
            "over {lv} level(s)").format(
                dr=ss.get("dup-rate", 0.0),
                pe=ss.get("prune-efficiency", 0.0),
                fa=ss.get("frontier-area", 0),
                fp=ss.get("frontier-peak", 0),
                tr=ss.get("trunc-losses", 0),
                lv=ss.get("levels", 0))


def _forecast(history, model, opts: argparse.Namespace) -> None:
    """The ``# plan:`` line and the ``# contention:`` lines; a history of
    ``[k v]`` values is forecast as its keys' batch."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.analysis import contention
    from jepsen_tpu_torch.checker import plan
    if independent.history_keys(history):
        history = independent.subhistories(history)
    print(plan.summary_line(history, model, device=opts.device))
    for ln in contention.forecast_lines(contention.profile(history)):
        print(ln)


def _recheck(test: dict, model, opts: argparse.Namespace) -> dict:
    """Re-check a stored run's history (key by key when its ops carry
    ``[k v]`` values); prints the ``# compile:`` and ``# search:`` lines.
    Live progress (and a --profile capture) go to the run's directory."""
    from jepsen_tpu_torch import independent, repl
    from jepsen_tpu_torch.checker import gpu
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.obs import observatory, profiler
    checker = linearizable(model, backend=opts.backend, device=_device(opts),
                           algorithm=opts.algorithm)
    if independent.history_keys(test.get("history") or []):
        # [k v] values: checked key by key, as the run checked them
        checker = independent.checker(checker)
    observatory.attach(test.get("store-dir"))
    profiler.attach(test.get("store-dir"))
    comp0 = gpu.compile_snapshot()
    t0 = time.perf_counter()
    try:
        out = repl.recheck(test, checker)
    finally:
        wall = time.perf_counter() - t0
        observatory.detach()
        profiler.detach()
    print(gpu.compile_line(gpu.compile_delta(comp0), wall))
    sline = _search_line(out)
    if sline:
        print(sline)
    return out


def analyze_cmd(opts: argparse.Namespace) -> int:
    from jepsen_tpu_torch import analysis, core, repl, store
    from jepsen_tpu_torch.analysis.history_lint import lint_history
    from jepsen_tpu_torch.serve import models
    if opts.store and not os.path.isdir(opts.store):
        # a missing directory is a typo, not an empty run
        print(f"no such store directory: {opts.store}", file=sys.stderr)
        return INVALID_ARGS
    test = store.load(opts.store) if opts.store else repl.last_test()
    if test is None:
        print("no stored test found", file=sys.stderr)
        return INVALID_ARGS
    _apply_check_env(opts)
    if _card_refused(opts, "analyze"):
        return CRASHED
    history = test.get("history") or []
    model = models()[opts.model]()
    print(analysis.summary_line(lint_history(history)))
    _forecast(history, model, opts)
    out = _recheck(test, model, opts)
    leaked = core.abandoned_threads()
    if leaked:
        print(f"# leaked-threads: {leaked} hung client-op thread(s) "
              f"abandoned by op-timeout and still resident")
    print(json.dumps(out, indent=2, default=repr))
    return OK if out.get("valid") is True else TEST_FAILED


def recover_cmd(opts: argparse.Namespace) -> int:
    from jepsen_tpu_torch import analysis, store
    from jepsen_tpu_torch.analysis import history_lint as hl
    from jepsen_tpu_torch.obs import trace as trace_ns
    from jepsen_tpu_torch.serve import models
    if opts.store:
        d = opts.store
        if not os.path.isdir(d):
            print(f"no such store directory: {d}", file=sys.stderr)
            return INVALID_ARGS
        status = store.run_status(d)
        if status != "dead" and not opts.force:
            print(f"# recovery: {d}: status={status or 'no run.state'}; "
                  f"nothing to recover (--force overrides)")
            return OK if status in ("done", "recovered") else INVALID_ARGS
        targets = [d]
    else:
        targets = store.dead_runs(opts.store_root or "store")
        if not targets:
            print("# recovery: no dead runs found")
            return OK
    _apply_check_env(opts)
    if not opts.no_analyze and _card_refused(opts, "recover"):
        return CRASHED
    worst = OK
    for d in targets:
        try:
            rec = store.recover_run(d)
        except (OSError, ValueError) as e:
            print(f"# recovery: {d}: FAILED: {e}", file=sys.stderr)
            worst = TEST_FAILED
            continue
        s = rec["stats"]
        print(f"# recovery: {d}: {s['ops']} ops recovered "
              f"({s['records']} WAL records, {s['torn']} torn, "
              f"{s['corrupt']} corrupt, {s['reconciled']} dangling "
              f"invoke(s) -> info)")
        tpath = os.path.join(d, trace_ns.TRACE_NAME)
        if os.path.exists(tpath):
            try:
                _, tstats = trace_ns.read_trace(tpath)
                print(f"# trace: {tstats['spans']} span(s) recovered from "
                      f"trace.jsonl ({tstats['torn']} torn, "
                      f"{tstats['corrupt']} corrupt)")
            except OSError as e:
                print(f"# trace: unreadable trace.jsonl: {e}",
                      file=sys.stderr)
        # the structure the reconciler could not repair fails the
        # recovery; decode damage was counted above
        findings = hl.lint_history(rec["history"], decode_errors=0)
        print(analysis.summary_line(findings))
        model = models()[opts.model]()
        _forecast(rec["history"], model, opts)
        errs = hl.errors(findings)
        if errs:
            for f in errs[:10]:
                print(f"# lint: {d}: {f.format()}", file=sys.stderr)
            print(f"# recovery: {d}: FAILED: recovered history is "
                  f"malformed ({len(errs)} error finding(s); see above)",
                  file=sys.stderr)
            worst = TEST_FAILED
            continue
        if opts.no_analyze:
            continue
        out = _recheck(store.load(d), model, opts)
        store.write_results(d, out)
        store.write_state(d, "done", recovered=True, recovery=s)
        print(f"# recovery: {d}: verdict valid={out.get('valid')}")
        if out.get("valid") is not True:
            worst = TEST_FAILED
    return worst


def explain_cmd(opts: argparse.Namespace) -> int:
    from jepsen_tpu_torch import explain, store
    from jepsen_tpu_torch.serve import models
    d = opts.store
    if d is None:
        t = store.latest(opts.store_root or "store")
        d = t.get("store-dir") if t else None
    if not d or not os.path.isdir(d):
        print(f"no such store directory: {d}", file=sys.stderr)
        return INVALID_ARGS
    report = explain.explain_report(d, model=models()[opts.model]())
    if opts.format == "json":
        print(json.dumps(report, indent=2, default=repr))
    else:
        print(explain.render_text(report))
    return OK if report.get("valid") is True else TEST_FAILED


def _watch_fleet(opts: argparse.Namespace) -> int:
    from jepsen_tpu_torch.obs import fleet
    dirs = list(opts.fleet)
    # all directories missing is a typo; some missing (or vanishing
    # mid-poll) is a dead host, rendered as host=dead
    if not any(os.path.isdir(d) for d in dirs):
        print(f"no such host directory: {dirs[0]}", file=sys.stderr)
        return INVALID_ARGS
    while True:
        merged = fleet.merge(dirs)
        for line in fleet.format_fleet(merged):
            print(line, flush=True)
        states = [(p or {}).get("state")
                  for p in merged["progress"].values()]
        if opts.once or all(s in (None, "done") for s in states):
            return OK
        time.sleep(max(opts.interval or 1.0, 0.05))


def watch_cmd(opts: argparse.Namespace) -> int:
    """Follow another process's run from its ``progress.json`` until its
    ``run.state`` is terminal; ``--once`` prints one line."""
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.obs import observatory
    if opts.fleet:
        return _watch_fleet(opts)
    d = opts.store
    if d is None:
        t = store.latest(opts.store_root or "store")
        d = t.get("store-dir") if t else None
    if not d or not os.path.isdir(d):
        print(f"no such store directory: {d}", file=sys.stderr)
        return INVALID_ARGS
    tty = sys.stdout.isatty()
    while True:
        p = observatory.read_progress(d)
        state = store.run_status(d)
        if p is None:
            line = (f"# watch: no search progress published yet "
                    f"(state={state or 'unknown'})")
        else:
            line = observatory.format_status(p)
            if state and state != "running":
                line += f" [{state}]"
        print(line, end="\r" if tty else "\n", flush=True)
        done = (p or {}).get("state") == "done"
        if opts.once or done or state in ("done", "dead", "recovered"):
            if tty:
                print()
            return OK
        time.sleep(max(opts.interval or 1.0, 0.05))


def trace_cmd(opts: argparse.Namespace) -> int:
    """``trace export|summary|request|find`` over a run's or a serve
    directory's ``trace.jsonl`` (torn-tail tolerant), with the device lane
    of a ``--profile``d run merged into ``export`` and ``summary``."""
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.obs import profiler
    from jepsen_tpu_torch.obs import trace as trace_ns
    d = opts.store
    if d is None:
        t = store.latest()
        d = t.get("store-dir") if t else None
    if not d or not os.path.isdir(d):
        print(f"no such store directory: {d}", file=sys.stderr)
        return INVALID_ARGS
    fmt = opts.format or "chrome"
    if opts.action == "request":
        return _trace_request(opts, d)
    if opts.action == "find":
        return _trace_find(opts, d)
    path = os.path.join(d, trace_ns.TRACE_NAME)
    if not os.path.exists(path):
        print(f"no {trace_ns.TRACE_NAME} in {d} (run predates tracing, or "
              f"JTPU_TRACE=0)", file=sys.stderr)
        return INVALID_ARGS
    records, stats = trace_ns.read_trace(path)
    print(f"# trace: {stats['spans']} span(s) in {path} ({stats['torn']} "
          f"torn, {stats['corrupt']} corrupt)", file=sys.stderr)
    # a --profile run's kernels, merged under their host spans as a device
    # lane; a run without (or with a torn) capture stays host-only
    device = []
    if os.path.isdir(profiler.profile_dir(d)):
        raw_dev, pstats = profiler.read_profile(d)
        device = profiler.merge_into_host(records, raw_dev)
        print(f"# trace: {len(device)} device span(s) merged from profile/ "
              f"({pstats['files']} file(s), {pstats['errors']} unreadable)",
              file=sys.stderr)
    if opts.action == "summary":
        rollup = trace_ns.summarize(records)
        kern = profiler.top_kernels(device, k=opts.top or 10)
        if fmt == "json":
            print(json.dumps({
                "stats": stats, "summary": rollup,
                "self-time": trace_ns.self_time_rollup(records),
                "kernels": kern}, indent=2, default=repr))
            return OK
        print(f"# trace: integrity: {stats['torn']} torn, "
              f"{stats['corrupt']} corrupt line(s); {stats['traces']} "
              f"request trace id(s)")
        width = max((len(n) for n in rollup), default=4)
        print(f"# trace: {'name':<{width}}  count  total      max")
        for name, st in sorted(rollup.items(),
                               key=lambda kv: -kv[1]["total-ns"]):
            print(f"# trace: {name:<{width}}  {st['count']:>5}  "
                  f"{st['total-ns'] / 1e9:>8.3f}s "
                  f"{st['max-ns'] / 1e9:>8.3f}s")
        if opts.top:
            top = trace_ns.self_time_rollup(records)
            rows = sorted(top.items(),
                          key=lambda kv: -kv[1]["self-ns"])[:opts.top]
            print(f"# trace: top {len(rows)} by self-time")
            print(f"# trace: {'name':<{width}}  count  self       p95")
            for name, st in rows:
                print(f"# trace: {name:<{width}}  {st['count']:>5}  "
                      f"{st['self-ns'] / 1e9:>8.3f}s "
                      f"{st['p95-ns'] / 1e9:>8.3f}s")
        if kern:
            print(f"# trace: device kernels, top {len(kern)} by self-time "
                  f"(per rung)")
            for row in kern:
                rung = row.get("rung")
                print(f"# trace:   {row['name'][:60]:<60} "
                      f"{row['count']:>5}  "
                      f"{row['self-ns'] / 1e9:>8.3f}s  "
                      f"rung={rung if rung else '?'}")
        return OK
    if fmt == "chrome":
        text = json.dumps(trace_ns.to_chrome(
            records + device, process_name=os.path.basename(d) or "jtpu"))
    else:
        text = "\n".join(json.dumps(r, default=repr)
                         for r in records + device) + "\n"
    _emit(opts, text, f"# trace: wrote {fmt} export to {opts.output}")
    return OK


def _emit(opts: argparse.Namespace, text: str, note: str) -> None:
    """An export to ``--output`` (with ``note`` on stderr), else stdout."""
    if opts.output:
        with open(opts.output, "w") as f:
            f.write(text)
        print(note, file=sys.stderr)
    else:
        print(text)


def _resolve_trace_id(store_dir: str, token: str) -> Optional[str]:
    """A serve request id (through the daemon's accepted records in
    serve.wal) or a literal 32-hex trace id -> the trace id, else None."""
    from jepsen_tpu_torch import journal as journal_ns
    from jepsen_tpu_torch.serve import WAL_NAME
    t = (token or "").strip()
    low = t.lower()
    if len(low) == 32 and all(c in "0123456789abcdef" for c in low):
        return low
    wal = os.path.join(store_dir, WAL_NAME)
    if not os.path.exists(wal):
        return None
    try:
        records, _ = journal_ns.read_json_records(wal)
    except (OSError, ValueError):
        return None
    for r in records:
        if r.get("event") == "accepted" and r.get("id") == t:
            return r.get("trace")
    return None


def _trace_request(opts: argparse.Namespace, d: str) -> int:
    """One request's trace, stitched across the serve daemon's
    trace.jsonl and any host directories, as a waterfall (or chrome, json,
    jsonl)."""
    from jepsen_tpu_torch.obs import fleet as obs_fleet
    rid = opts.rid
    if not rid:
        print("trace request needs a request id (or a 32-hex trace id): "
              "jtpu trace request <id> --store <serve-dir>",
              file=sys.stderr)
        return INVALID_ARGS
    tid = _resolve_trace_id(d, rid)
    if not tid:
        print(f"couldn't resolve {rid!r} to a trace id: no matching "
              f"accepted record in {d}/serve.wal and it is not a 32-hex "
              f"trace id (JTPU_TRACE=0 at admission?)", file=sys.stderr)
        return INVALID_ARGS
    stitched = obs_fleet.stitch_request(d, tid, extra_dirs=opts.host_dir)
    recs = stitched["records"]
    fmt = opts.format or "text"
    text = None
    if fmt == "json":
        text = json.dumps(stitched, indent=2, default=repr)
    elif fmt == "chrome":
        text = json.dumps(obs_fleet.to_chrome(
            {"hosts": stitched["hosts"], "trace": recs}))
    elif fmt == "jsonl":
        text = "\n".join(json.dumps(r, default=repr) for r in recs) + "\n"
    if text is not None:
        _emit(opts, text, f"# trace: wrote {fmt} request export to "
                          f"{opts.output}")
        return OK
    hosts = stitched.get("hosts") or []
    method = stitched.get("method")
    print(f"# trace: request {rid}: trace {tid}: {len(recs)} record(s) "
          f"across {max(len(hosts), 1)} process(es)"
          + (f", clocks aligned via {method}" if method else ""))
    if not recs:
        print("# trace: no spans for this trace id (JTPU_TRACE=0, or the "
              "request has not run yet)")
        return OK
    t0 = min(int(r.get("ts", 0)) for r in recs)
    t1 = max(int(r.get("ts", 0)) + int(r.get("dur", 0) or 0) for r in recs)
    total = max(t1 - t0, 1)
    cols = 40
    namew = max(len(str(r.get("name", "?"))) for r in recs)
    hostw = max((len(str(r.get("host", ""))) for r in recs), default=0)
    for r in recs:
        ts = int(r.get("ts", 0))
        dur = int(r.get("dur", 0) or 0)
        a = (cols * (ts - t0)) // total
        b = max(a + 1, (cols * (ts - t0 + dur) + total - 1) // total)
        bar = " " * a + ("#" * (b - a) if dur else "|") \
            + " " * max(0, cols - b)
        dur_bit = f"{dur / 1e9:>9.4f}s" if dur else "   instant"
        print(f"# trace: [{bar[:cols]}] {(ts - t0) / 1e9:>9.4f}s "
              f"{dur_bit}  {str(r.get('host', '')):<{hostw}} "
              f"{str(r.get('name', '?')):<{namew}}")
    return OK


def _trace_find(opts: argparse.Namespace, d: str) -> int:
    """A serve directory's completed requests filtered by tenant, device
    seconds, error class and host, one line each, newest first."""
    from jepsen_tpu_torch.obs import federation
    rows = federation.trace_find(
        d, tenant=opts.tenant, min_device_s=opts.min_device_s,
        error_class=opts.error_class, host=opts.host,
        limit=opts.limit or 50)
    if (opts.format or "text") == "json":
        print(json.dumps({"requests": rows}, indent=2, default=repr))
        return OK
    print(f"# trace: find: {len(rows)} matching request(s) in {d}")
    if not rows:
        return OK
    idw = max(len(str(r.get("id", ""))) for r in rows)
    tw = max((len(str(r.get("tenant", ""))) for r in rows), default=6)
    for r in rows:
        dev = r.get("device-s")
        secs = r.get("seconds")
        print(f"# trace: {str(r.get('id', '')):<{idw}} "
              f"{str(r.get('tenant', '')):<{tw}} "
              f"valid={r.get('valid')} "
              f"secs={secs if secs is not None else '-'} "
              f"device-s={dev if dev is not None else '-'} "
              f"err={r.get('error-class') or '-'} "
              f"hosts={' '.join(r.get('hosts') or []) or '-'}")
    print("# trace: drill in: jtpu trace request <id> --store " + d)
    return OK


def lint_cmd(opts: argparse.Namespace) -> int:
    """The static analyzer's passes, gated against the port's baseline:
    exit 1 on a new error (with ``--strict``, a new warning or a baseline
    entry whose justification is still the stub)."""
    from jepsen_tpu_torch import analysis
    from jepsen_tpu_torch.analysis import baseline as bl
    root = opts.root or analysis.repo_root()
    passes = tuple(opts.passes or analysis.PASSES)
    if opts.paths:
        findings = analysis.lint_files(list(opts.paths) + list(opts.history),
                                       passes=passes, root=root)
    else:
        findings = analysis.lint_repo(root=root, passes=passes,
                                      histories=opts.history)
    bpath = opts.baseline or bl.default_path(root)
    if opts.write_baseline:
        bl.write(bpath, findings)
        print(f"# lint: baseline written to {bpath} ({len(findings)} "
              f"finding(s))")
        return OK
    if opts.prune_stale:
        pruned = bl.prune(bpath, (f.key() for f in findings))
        for key in pruned:
            print(f"# lint: pruned stale baseline entry: {key}")
        print(f"# lint: {len(pruned)} stale baseline entr"
              f"{'y' if len(pruned) == 1 else 'ies'} pruned from {bpath}")
        return OK
    accepted_keys = {} if opts.no_baseline else bl.load(bpath)
    new, accepted = bl.split(findings, accepted_keys)
    if opts.format == "json":
        print(json.dumps({"findings": [vars(f) for f in new],
                          "accepted": [vars(f) for f in accepted],
                          "counts": analysis.summarize(new)}, indent=2))
    elif opts.format == "sarif":
        from jepsen_tpu_torch.analysis import sarif
        print(sarif.render(new), end="")
    else:
        for f in sorted(new, key=lambda x: (x.path, x.line)):
            print(f.format())
        print(analysis.summary_line(new))
        if accepted:
            print(f"# lint: {len(accepted)} finding(s) accepted by {bpath}")
    gate = [f for f in new if f.severity == "error"
            or (opts.strict and f.severity == "warning")]
    if opts.strict and accepted:
        # an acceptance still carrying the --write-baseline stub was never
        # reviewed: strict mode does not let it suppress a finding
        stub_keys = set(bl.stubbed(accepted_keys))
        unjustified = sorted({f.key() for f in accepted} & stub_keys)
        for key in unjustified:
            print(f"# lint: --strict: baseline entry {key!r} still carries "
                  f"the stub justification ({bl.STUB!r}); replace it with "
                  f"a real reason in {bpath}", file=sys.stderr)
        gate = gate or unjustified
    return TEST_FAILED if gate else OK


def _serve_dir(opts: argparse.Namespace) -> str:
    return opts.serve_dir or os.path.join(opts.store_root or "store",
                                          "serve")


def usage_cmd(opts: argparse.Namespace) -> int:
    """Per-tenant usage totals recomputed from a serve directory's WAL
    ``done`` records (:func:`jepsen_tpu_torch.obs.usage.from_wal`): what
    a live daemon's ``GET /usage`` answers, offline too."""
    from jepsen_tpu_torch import serve as serve_ns
    from jepsen_tpu_torch.obs import usage as obs_usage
    wal = os.path.join(_serve_dir(opts), serve_ns.WAL_NAME)
    if not os.path.exists(wal):
        print(f"no request journal at {wal}", file=sys.stderr)
        return INVALID_ARGS
    doc = obs_usage.from_wal(wal)
    if opts.tenant is not None:
        doc["tenants"] = {t: u for t, u in doc["tenants"].items()
                          if t == opts.tenant}
    if opts.json:
        print(json.dumps(doc, indent=2))
        return OK
    for t in sorted(doc["tenants"]):
        u = doc["tenants"][t]
        print(f"# usage: {t}: {u['requests']} request(s), "
              f"{u['ops']:g} op(s), {u['device-s']:g} device-s, "
              f"{u['bytes']:g} byte(s), lane-share "
              f"{u['lane-share']:g}, {u['seconds']:g}s wall")
    tot = doc["total"]
    print(f"# usage: total: {tot['requests']} request(s), "
          f"{tot['ops']:g} op(s), {tot['device-s']:g} device-s, "
          f"{tot['bytes']:g} byte(s), {tot['seconds']:g}s wall")
    return OK


def flightrec_cmd(opts: argparse.Namespace) -> int:
    """A serve directory's flight-recorder dumps: the list, newest first,
    or one dump's summary (``--json``: the dump itself)."""
    from jepsen_tpu_torch.obs import flightrec as obs_flightrec
    d = _serve_dir(opts)

    def when(ts) -> str:
        return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts or 0))

    if opts.dump:
        doc = obs_flightrec.load_dump(d, opts.dump)
        if doc is None:
            print(f"no such dump: {opts.dump}", file=sys.stderr)
            return INVALID_ARGS
        if opts.json:
            print(json.dumps(doc, indent=2))
            return OK
        print(f"# flightrec: {opts.dump}: reason={doc.get('reason')} at "
              f"{when(doc.get('wall-ts'))}, window "
              f"{doc.get('window-s'):g}s")
        print(f"# flightrec: {len(doc.get('spans') or [])} span(s), "
              f"{len(doc.get('trace-ids') or [])} trace id(s), "
              f"{len(doc.get('metrics') or {})} metric(s)")
        if doc.get("extra"):
            print(f"# flightrec: extra: "
                  f"{json.dumps(doc['extra'], default=repr)}")
        for tid in doc.get("trace-ids") or []:
            print(f"# flightrec: trace {tid}")
        return OK
    dumps = obs_flightrec.list_dumps(d)
    if opts.json:
        print(json.dumps({"dumps": dumps}, indent=2))
        return OK
    if not dumps:
        print(f"# flightrec: no dumps under "
              f"{os.path.join(d, obs_flightrec.DIR_NAME)}")
        return OK
    for rec in dumps:
        print(f"# flightrec: {rec['name']}: reason={rec.get('reason')} at "
              f"{when(rec.get('wall-ts'))}, {rec.get('spans', 0)} span(s), "
              f"{rec.get('trace-ids', 0)} trace(s), "
              f"{rec.get('bytes', 0)} byte(s)")
    return OK


def _top_screen(d: str) -> list:
    """One ``top`` screen of directory ``d``: the daemon's heartbeat, its
    SLO burn and top tenant, and each fleet host's frame age; a run
    directory's heartbeat gives ``watch``'s line."""
    from jepsen_tpu_torch.obs import federation, observatory
    p = observatory.read_progress(d)
    lines = [f"# top: {d} at {time.strftime('%H:%M:%S')}"]
    if p is None:
        lines.append("# top: no progress.json yet (daemon not started, or "
                     "JTPU_TRACE=0)")
        return lines
    s = p.get("serve")
    if s is None:
        lines.append(observatory.format_status(p))
        return lines
    lines.append(f"# top: state {p.get('state') or 'serving'} | queue "
                 f"{s.get('queue-depth', 0)} | inflight "
                 f"{s.get('inflight', 0)} | done {s.get('completed', 0)} | "
                 f"rejected {s.get('rejected', 0)}")
    bits = []
    slo = s.get("slo")
    if slo is not None:
        n, burn = slo.get("breached", 0), slo.get("max-burn", 0)
        bits.append(f"slo BURN x{n} ({burn:g})" if n
                    else f"slo OK ({burn:g})")
    if s.get("usage-top"):
        bits.append(f"top tenant {s['usage-top'][0]}: "
                    f"{s['usage-top'][1]:g} device-s")
    if s.get("breakers-open"):
        bits.append(f"breakers-open {s['breakers-open']}")
    if bits:
        lines.append("# top: " + " | ".join(bits))
    if s.get("fleet-hosts") is not None:
        fbit = f"fleet {s.get('fleet-live', 0)}/{s['fleet-hosts']} host(s)"
        if s.get("remeshes"):
            fbit += f" | remesh {s['remeshes']}"
        lines.append("# top: " + fbit)
    stragglers = set(s.get("straggler-hosts") or [])
    ages = federation.fleet_ages(d)
    for host in sorted(set(ages) | stragglers):
        age = ages.get(host)
        abit = f"age {age:g}s" if age is not None else "age ?"
        sbit = "  STRAGGLER" if host in stragglers else ""
        lines.append(f"# top:   {host:<16} {abit}{sbit}")
    return lines


def top_cmd(opts: argparse.Namespace) -> int:
    """``top``: :func:`_top_screen` each ``--interval`` (``--once``: one
    screen)."""
    from jepsen_tpu_torch import store
    d = opts.store
    if d is None:
        t = store.latest(opts.store_root or "store")
        d = t.get("store-dir") if t else None
    if not d or not os.path.isdir(d):
        print(f"no such store directory: {d}", file=sys.stderr)
        return INVALID_ARGS
    while True:
        for line in _top_screen(d):
            print(line, flush=True)
        if opts.once:
            return OK
        time.sleep(max(opts.interval or 2.0, 0.05))


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    try:
        opts = _parser().parse_args(argv)
    except _ArgError as e:
        print(f"python -m jepsen_tpu_torch: {e}", file=sys.stderr)
        return INVALID_ARGS
    run = {"stream": stream, "serve": serve, "plan": plan_cmd}.get(opts.cmd)
    if run is not None:
        return run(opts)
    run = {"run": run_cmd, "analyze": analyze_cmd,
           "recover": recover_cmd, "explain": explain_cmd,
           "watch": watch_cmd, "trace": trace_cmd,
           "lint": lint_cmd, "usage": usage_cmd,
           "flightrec": flightrec_cmd, "top": top_cmd}[opts.cmd]
    try:
        return run(opts)
    except _ArgError as e:
        print(f"python -m jepsen_tpu_torch: {e}", file=sys.stderr)
        return INVALID_ARGS
    except Exception:  # noqa: BLE001 -- the exit-code contract's 255
        import traceback
        traceback.print_exc()
        return CRASHED


if __name__ == "__main__":
    sys.exit(main())
