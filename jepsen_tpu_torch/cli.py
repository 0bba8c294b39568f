"""Command-line library of the port: commands as maps, and their dispatch.

The counterpart of ``jepsen_tpu.cli``, under its names and with its exit
codes::

    0    all tests passed (valid)
    1    some test failed (not valid, or unknown)
    254  invalid arguments, an unknown command, a missing store
    255  an internal error; a CUDA device that does not initialise among
         them: with the card's backend, nothing carries on on the CPU

A command is ``{"name": {"parser": builder, "opt_fn": fn, "run": fn}}``:
:func:`run` builds the chosen command's parser only, parses the rest of
the arguments into a dict, passes it through ``opt_fn`` (if any) and
hands the result to ``run``, whose return value is the exit code. A user
turns the test map of their own database into a command line with::

    from jepsen_tpu_torch import cli

    def my_test(opts): return {...test map...}

    if __name__ == "__main__":
        cli.main(cli.merge_commands(
            cli.single_test_cmd(my_test), cli.serve_cmd()))

which gives ``test`` (the standard test options of :func:`add_test_opts`,
plus ``opt_spec``'s) and ``serve``. Each suite module's ``main`` is that.
``python -m jepsen_tpu_torch`` dispatches :func:`default_commands`:

``run --suite NAME`` runs a registered suite (the reference's ``jtpu
run``): ``core.run`` boots the suite's system, drives its clients under
the generator with the nemesis, tees every op into the WAL, saves the
store under ``--store-root`` and then checks the history, on the card
unless ``--device cpu`` (the kernels' plain versions) or ``--backend
cpu`` (the host search). ``--node``, ``--concurrency`` and
``--time-limit`` default to the suite's own settings; ``--workload``
selects a workload of the hazelcast, aerospike, mongodb, cockroachdb and
tidb suites, ``--nemesis`` and ``--nemesis2`` (repeatable) name the
cockroachdb or tidb nemeses to compose (a tidb row runs the first point
of the reference ``tidb_main``'s matrix; without them it keeps its own
partition cycle), and ``--write-concern`` and ``--read-concern`` set the
mongodb client's concerns, as the reference's ``main`` of each of those
suites takes them; each exits 254 for a suite that does not take it.
With ``--ssh-mode dummy`` the control plane records each node's commands
and runs none; ``--dummy-responses FILE`` scripts its replies (a JSON
object: command substring -> stdout, or ``[exit, stdout, stderr]``). All
53 rows of the reference's ``SUITES`` are there. Chronos's check runs on
the host, so ``run --suite chronos`` does not probe the card.

``test`` and ``run`` take ``--watch`` (the search's live status line on
stderr while the check runs), ``--fleet N`` (each single-history search
under the elastic fleet over N logical hosts), ``--segment-iters N`` and
``--profile`` (a ``torch.profiler`` capture of the check into
``<run>/profile/``); these three reach the device search through
``JTPU_FLEET``, ``JTPU_SEGMENT_ITERS`` and ``JTPU_PROF`` for the command
only, where the reference's set them for the rest of the process.

``analyze --store DIR`` re-checks a stored run (by either package) and
prints, before the result, its lint summary, its ``# plan:`` line, the
``# contention:`` forecast, the ``# compile:`` split of the check's wall
clock and the ``# search:`` analytics. ``recover`` finds the runs under
``--store-root`` whose process died mid-flight, rebuilds each history
from its WAL (dangling invokes become ``info``), re-checks it and marks
the run done. Both take ``--backend``, ``--device``, ``--model`` and
``--algorithm``; a stored run whose ops carry ``[k v]`` values is
re-checked key by key. ``explain [--store DIR]`` says why a stored run
got its verdict, from its artifacts only. ``watch [--store DIR]
[--once]`` follows another process's run from its ``progress.json``
until its ``run.state`` is terminal; ``--fleet DIR...`` renders several
hosts' directories side by side. ``trace export|summary|request|find``
reads a run's or a serve directory's ``trace.jsonl``. ``lint`` runs the
static analyzer's passes over the port, or the paths and ``--history``
files given, against its baseline. ``plan --dims N[,CRASHED[,WINDOW[,
EVENTS]]]`` (or ``--dims @file.json``, or ``--history FILE``) verifies a
search plan before any device time, for CUDA unless ``--device cpu``.

``serve`` serves the results browser over ``--store-root``; with
``--check-daemon`` (or JTPU_SERVE=1) the check daemon is mounted on it,
its directory ``--serve-dir`` (default ``<store-root>/serve``), with the
reference's flags, each of which wins over its ``JTPU_SERVE_*``
variable; ``--compile-cache DIR`` is the kernel library's build
directory, ``--device cpu`` runs the searches on the CPU, ``--fleet N``
places the gangs on N fleet hosts. The daemon serves until ``POST
/drain`` or SIGTERM (after a flight-recorder dump) and then exits 0.
``stream [--store DIR | --history FILE]`` is the client of a daemon's
stream routes: it POSTs the ops as sequenced, CRC'd chunks, waits out
429s, resends from the daemon's ``need`` on a 409 gap, seals the stream
and prints the verdict. ``usage``, ``flightrec [DUMP]`` and ``top`` read
a daemon's artifacts, live or not.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib
import json
import os
import re
import sys
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

DEFAULT_NODES = ["n1", "n2", "n3", "n4", "n5"]

OK = 0
TEST_FAILED = 1
INVALID_ARGS = 254
CRASHED = 255


class _ArgError(Exception):
    pass


class Parser(argparse.ArgumentParser):
    """An argparse parser that raises instead of exiting, so that
    :func:`run` owns the exit-code contract."""

    def error(self, message):
        raise _ArgError(message)


# ---------------------------------------------------------------------------
# the standard test options
# ---------------------------------------------------------------------------

def add_test_opts(p: argparse.ArgumentParser,
                  suite_defaults: bool = False) -> None:
    """The standard test options: the reference's, with ``--backend
    gpu|cpu``, ``--device cuda|cpu`` and ``--store-root``. With
    ``suite_defaults`` ``--node``, ``--concurrency`` and ``--time-limit``
    default to None: the suite's own settings."""
    own = "the suite's" if suite_defaults else None
    p.add_argument("-n", "--node", action="append", metavar="HOSTNAME",
                   help="node to run the test on; repeatable (default: "
                        f"{own or ' '.join(DEFAULT_NODES)})")
    p.add_argument("--nodes-file", metavar="FILENAME",
                   help="file of node hostnames, one per line")
    p.add_argument("--username", default="root", help="ssh username")
    p.add_argument("--password", default="root", help="sudo password")
    p.add_argument("--strict-host-key-checking", action="store_true",
                   help="check ssh host keys")
    p.add_argument("--ssh-private-key", metavar="FILE",
                   help="ssh identity file")
    p.add_argument("--ssh-mode", default=None,
                   choices=[None, "ssh", "dummy", "local"],
                   help="control-plane transport (dummy = record only)")
    p.add_argument("--concurrency", default=None if own else "1n",
                   help="worker count; an integer, optionally followed by "
                        "n to multiply by the node count (e.g. 3n; "
                        f"default: {own or '1n'})")
    p.add_argument("--test-count", type=int, default=1,
                   help="how many times to repeat the test")
    p.add_argument("--time-limit", type=int, default=None if own else 60,
                   help="test phase duration in seconds (default: "
                        f"{own or 60})")
    p.add_argument("--op-timeout", type=float, default=None,
                   metavar="SECONDS",
                   help="bound each client op: a hung invoke becomes an "
                        ":info op and the process reincarnates")
    p.add_argument("--store-root", default="store", metavar="DIR",
                   help="where runs are stored")
    _add_device_opts(p)
    p.add_argument("--watch", action="store_true",
                   help="print a live search-progress status line "
                        "(level/frontier/ETA) to stderr while the checker "
                        "runs; `watch` follows another process's run")
    p.add_argument("--fleet", type=int, default=None, metavar="N",
                   help="run single-history searches under the elastic "
                        "fleet over N logical hosts (JTPU_FLEET=N, for "
                        "this command)")


def _add_device_opts(p: argparse.ArgumentParser) -> None:
    """Where the check runs: the options of test, run, analyze and
    recover."""
    p.add_argument("--backend", default="gpu", choices=["gpu", "cpu"],
                   help="gpu: the device search (default); cpu: the host "
                        "search")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the device search runs (default: cuda; cpu "
                        "runs the kernels' plain versions)")
    p.add_argument("--segment-iters", type=int, default=None, metavar="N",
                   help="device-search levels per checkpointed segment "
                        "(JTPU_SEGMENT_ITERS, for this command)")
    p.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler trace of the check into "
                        "<run>/profile/ (JTPU_PROF=1, for this command)")


def parse_concurrency(c: str, n_nodes: int) -> int:
    """'3n' -> 3 * nodes; a plain integer otherwise."""
    m = re.fullmatch(r"(\d+)(n?)", str(c))
    if not m:
        raise _ArgError(f"--concurrency {c} should be an integer "
                        f"optionally followed by n")
    return int(m.group(1)) * (n_nodes if m.group(2) == "n" else 1)


def read_nodes_file(path: str) -> List[str]:
    """Node hostnames, one per line."""
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def _ssh(opts: Dict[str, Any]) -> dict:
    """The ssh map, its options popped from ``opts``."""
    return {"username": opts.pop("username", "root"),
            "password": opts.pop("password", "root"),
            "strict-host-key-checking": opts.pop("strict_host_key_checking",
                                                 False),
            "private-key-path": opts.pop("ssh_private_key", None),
            "mode": opts.pop("ssh_mode", None)}


def _device(opts: Dict[str, Any]) -> Optional[str]:
    """The device argument of the checkers: None (CUDA) or "cpu"."""
    return "cpu" if opts.get("device") == "cpu" else None


def test_opt_fn(opts: Dict[str, Any]) -> Dict[str, Any]:
    """The standard option post-processing: ``--node``/``--nodes-file``
    -> ``nodes`` (default :data:`DEFAULT_NODES`), the ssh options -> an
    ``ssh`` map, the concurrency parsed, the other options under the test
    map's hyphenated names, ``device`` None (CUDA) or "cpu"."""
    nodes = list(opts.pop("node", None) or [])
    nodes_file = opts.pop("nodes_file", None)
    if nodes_file:
        nodes.extend(read_nodes_file(nodes_file))
    if not nodes:
        nodes = list(DEFAULT_NODES)
    opts["nodes"] = nodes
    opts["ssh"] = _ssh(opts)
    opts["concurrency"] = parse_concurrency(opts.get("concurrency", "1n"),
                                            len(nodes))
    opts["time-limit"] = opts.pop("time_limit", 60)
    opts["test-count"] = opts.pop("test_count", 1)
    opts["op-timeout"] = opts.pop("op_timeout", None)
    opts["segment-iters"] = opts.pop("segment_iters", None)
    opts["profile"] = bool(opts.pop("profile", False))
    opts["fleet"] = opts.pop("fleet", None)
    opts["store-root"] = opts.pop("store_root", "store")
    opts["device"] = _device(opts)
    return opts


@contextlib.contextmanager
def _check_env(segment_iters=None, profile=False, fleet=None):
    """``--segment-iters``, ``--profile`` and ``--fleet`` reach the device
    search through the environment it reads: set for the command, then
    put back as they were."""
    new = {}
    if segment_iters is not None:
        new["JTPU_SEGMENT_ITERS"] = str(segment_iters)
    if profile:
        new["JTPU_PROF"] = "1"
    if fleet is not None:
        new["JTPU_FLEET"] = str(fleet)
    old = {k: os.environ.get(k) for k in new}
    os.environ.update(new)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _card_refused(opts: Dict[str, Any], cmd: str) -> bool:
    """True, with the reason on stderr, when the check is to run on the
    card and CUDA does not initialise: the command then stops before any
    work, and does not carry on on the CPU."""
    if opts.get("backend", "gpu") != "gpu" or opts.get("device") == "cpu":
        return False
    from jepsen_tpu_torch import accel
    try:
        accel.ensure_usable(cmd)
    except accel.AcceleratorUnavailable as e:
        print(f"{cmd}: {e}", file=sys.stderr)
        return True
    return False


def _run_tests(build: Callable[[dict], dict], opts: Dict[str, Any],
               watch: bool = False, fleet: Optional[int] = None) -> int:
    """``core.run`` of the test ``build(dict(opts))`` makes, ``test-count``
    times: 1 at the first run that is not valid, else 0. ``watch``
    mirrors the search's live status to stderr meanwhile."""
    from jepsen_tpu_torch import core
    from jepsen_tpu_torch.obs import observatory
    with _check_env(opts.get("segment-iters"), opts.get("profile"), fleet):
        stop = observatory.live_status_printer() if watch else None
        try:
            for _ in range(opts.get("test-count", 1)):
                test = core.run(build(dict(opts)))
                if test["results"].get("valid") is not True:
                    return TEST_FAILED
            return OK
        finally:
            if stop is not None:
                stop()


def single_test_cmd(test_fn: Callable[[dict], dict],
                    opt_spec: Optional[Callable] = None,
                    opt_fn: Optional[Callable] = None,
                    usage: Optional[str] = None) -> dict:
    """The ``test`` command: builds a test from the parsed options with
    ``test_fn(dict(opts))``, runs it ``--test-count`` times and exits 1
    at the first run that is not valid. ``opt_spec(parser)`` adds
    options; ``opt_fn`` post-processes the options after
    :func:`test_opt_fn`. On the card it probes CUDA before any work and
    exits 255 when the card cannot be used."""

    def build_parser():
        p = Parser(prog="test", description=usage or "Run a test.")
        add_test_opts(p)
        if opt_spec:
            opt_spec(p)
        return p

    def run_(opts) -> int:
        if _card_refused(opts, "test"):
            return CRASHED
        return _run_tests(test_fn, opts, watch=opts.get("watch"),
                          fleet=opts.get("fleet"))

    return {"test": {"parser": build_parser,
                     "opt_fn": (lambda o: opt_fn(test_opt_fn(o)))
                     if opt_fn else test_opt_fn,
                     "run": run_}}


# ---------------------------------------------------------------------------
# run --suite NAME
# ---------------------------------------------------------------------------

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


def _suite_opts(opts: Dict[str, Any]) -> Dict[str, Any]:
    """``run``'s option post-processing: the option map a suite
    constructor takes (options left at None are the suite's own), with
    the parsed flags under ``flags`` for the command itself."""
    flags = dict(opts)
    nodes = list(opts["node"] or [])
    if opts["nodes_file"]:
        nodes += read_nodes_file(opts["nodes_file"])
    out = {"ssh": _ssh(dict(opts)), "test-count": opts["test_count"],
           "op-timeout": opts["op_timeout"],
           "store-root": opts["store_root"], "backend": opts["backend"],
           "device": _device(opts), "segment-iters": opts["segment_iters"],
           "profile": opts["profile"], "flags": flags}
    if nodes:
        out["nodes"] = nodes
    if opts["concurrency"] is not None:
        if str(opts["concurrency"]).endswith("n") and not nodes:
            raise _ArgError("--concurrency Nn needs --node or --nodes-file")
        out["concurrency"] = parse_concurrency(opts["concurrency"],
                                               len(nodes))
    if opts["time_limit"] is not None:
        out["time-limit"] = opts["time_limit"]
    suite = opts["suite"]
    module = _suite_module(suite)
    if opts["workload"] is not None:
        if not _takes_workload(suite):
            raise _ArgError("--workload selects a workload of a hazelcast, "
                            "aerospike, mongodb, cockroachdb or tidb suite "
                            "only")
        choices = _workloads(module)
        if opts["workload"] not in choices:
            raise _ArgError(f"--workload {opts['workload']} is not a "
                            f"workload of --suite {suite} (choose from "
                            f"{', '.join(sorted(choices))})")
        out["workload"] = opts["workload"]
    if module == "cockroachdb":
        # composed as the reference's cockroachdb main composes them
        from jepsen_tpu_torch.suites import cockroachdb
        out["nemesis"] = cockroachdb.named_nemesis(opts["nemesis"],
                                                   opts["nemesis2"])
    elif _is_tidb(suite):
        # composed by the run, as the reference's tidb_main composes them
        from jepsen_tpu_torch.suites.sql_family import TIDB_NEMESES
        for flag in ("nemesis", "nemesis2"):
            for name in opts[flag] or ():
                if name not in TIDB_NEMESES:
                    raise _ArgError(
                        f"--{flag} {name} is not a nemesis of --suite "
                        f"{suite} (choose from "
                        f"{', '.join(sorted(TIDB_NEMESES))})")
    elif opts["nemesis"] or opts["nemesis2"]:
        raise _ArgError("--nemesis and --nemesis2 name the nemeses of a "
                        "cockroachdb or tidb suite only")
    for flag in ("write_concern", "read_concern"):
        if opts[flag] is None:
            continue
        if module != "mongodb":
            raise _ArgError(f"--{flag.replace('_', '-')} sets the client "
                            f"of a mongodb suite only")
        out[flag.replace("_", "-")] = opts[flag]
    if opts["dummy_responses"] is not None:
        if opts["ssh_mode"] != "dummy":
            raise _ArgError("--dummy-responses needs --ssh-mode dummy")
        out["ssh"]["dummy-responses"] = _dummy_responses(
            opts["dummy_responses"])
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


def suite_run_cmd() -> dict:
    """The ``run`` command: run a registered suite by name, with the
    suite options of each suite module's reference ``main``."""

    def build_parser():
        from jepsen_tpu_torch.suites import SUITES
        from jepsen_tpu_torch.suites.cockroachdb import NEMESES
        from jepsen_tpu_torch.suites.mongodb import (READ_CONCERNS,
                                                     WRITE_CONCERNS)
        p = Parser(prog="run", description="Run a registered suite: "
                                           "workload, store, then the check.")
        p.add_argument("--suite", required=True, choices=sorted(SUITES))
        add_test_opts(p, suite_defaults=True)
        p.add_argument("--dummy-responses", default=None, metavar="FILE",
                       help="with --ssh-mode dummy: a JSON object mapping a "
                            "command substring to its reply (stdout, or "
                            "[exit, stdout, stderr])")
        p.add_argument("--workload", default=None,
                       choices=sorted({w for m in _WORKLOAD_MODULES
                                       for w in _workloads(m)}),
                       help="the workload of a hazelcast, aerospike, "
                            "mongodb, cockroachdb or tidb suite (default: "
                            "the row's own)")
        p.add_argument("--nemesis", action="append", default=None,
                       choices=sorted(NEMESES),
                       help="a cockroachdb or tidb nemesis (a tidb row "
                            "takes none, parts, majring, startstop, "
                            "startstop2, startkill and startkill2); "
                            "repeatable")
        p.add_argument("--nemesis2", action="append", default=None,
                       choices=sorted(NEMESES),
                       help="a second cockroachdb or tidb nemesis to "
                            "compose with --nemesis; repeatable")
        p.add_argument("--write-concern", default=None,
                       choices=WRITE_CONCERNS,
                       help="the mongodb client's write concern (default: "
                            "majority)")
        p.add_argument("--read-concern", default=None, choices=READ_CONCERNS,
                       help="the mongodb client's read concern (default: "
                            "linearizable)")
        return p

    def run_(opts) -> int:
        from jepsen_tpu_torch import suites
        flags = opts.pop("flags")
        suite = flags["suite"]
        if suite not in _HOST_CHECKED and _card_refused(flags, "run"):
            return CRASHED
        ctor = suites.registry()[suite]
        module = _suite_module(suite)
        if flags["workload"] is not None and module != "hazelcast":
            # the workload picks the module's constructor, as its
            # reference main does; hazelcast's reads the option itself
            ctor = _workloads(module)[flags["workload"]]
        if _is_tidb(suite) and (flags["nemesis"] or flags["nemesis2"]):
            # the first point of the tidb matrix (the reference's
            # tidb_main); without a nemesis the row keeps its own cycle
            from jepsen_tpu_torch.suites.sql_family import named_test
            ctor = functools.partial(named_test, flags["workload"] or suite,
                                     flags["nemesis"], flags["nemesis2"])
        return _run_tests(ctor, opts, watch=flags["watch"],
                          fleet=flags["fleet"])

    return {"run": {"parser": build_parser, "opt_fn": _suite_opts,
                    "run": run_}}


# ---------------------------------------------------------------------------
# serve and stream
# ---------------------------------------------------------------------------

def serve_config(opts: Dict[str, Any]):
    """The daemon's ``ServeConfig`` from ``serve``'s options: each flag
    given wins over its ``JTPU_SERVE_*`` variable, which only sets the
    default. ``--compile-cache`` points the kernel build directory at its
    argument."""
    from jepsen_tpu_torch import serve as serve_ns
    cfg = serve_ns.ServeConfig(
        root=opts["serve_dir"] or os.path.join(opts["store_root"], "serve"),
        device=_device(opts))
    for name in ("workers", "queue_max", "tenant_max", "batch_wait_ms",
                 "engine_max_buckets", "rate_limit"):
        if opts[name] is not None:
            setattr(cfg, name, opts[name])
    if opts["deadline_s"] is not None:
        cfg.deadline_s = opts["deadline_s"] or None
    if opts["serve_backend"] is not None:
        cfg.backend = opts["serve_backend"]
    if opts["batch_max"] is not None:
        cfg.batch_max = opts["batch_max"]
        cfg.batch_enabled = opts["batch_max"] > 1
    if opts["auth_token"] is not None:
        cfg.auth_token = opts["auth_token"] or None
    if opts["fleet"] is not None:
        cfg.fleet_hosts = opts["fleet"]
    if opts["compile_cache"] is not None:
        from jepsen_tpu_torch.kernels import build
        build.BUILD_DIR = os.path.abspath(opts["compile_cache"])
    return cfg


def serve_cmd() -> dict:
    """The ``serve`` command: the results browser over ``--store-root``;
    with ``--check-daemon`` (or JTPU_SERVE=1) the check daemon mounted on
    it, until ``POST /drain`` or SIGTERM (which first dumps the flight
    recorder)."""

    def build_parser():
        p = Parser(prog="serve", description="Serve the results browser "
                                             "(and, opted in, the check "
                                             "daemon).")
        p.add_argument("--check-daemon", action="store_true",
                       help="mount the multi-tenant check daemon: POST "
                            "/check, GET /check/<id>, /healthz, /drain, the "
                            "/stream routes and the telemetry (JTPU_SERVE=1 "
                            "does the same)")
        p.add_argument("-b", "--host", default="0.0.0.0")
        p.add_argument("-p", "--port", type=int, default=8080,
                       help="port to listen on (0: any free port)")
        p.add_argument("--store-root", default="store",
                       help="the store the results browser serves")
        p.add_argument("--serve-dir", default=None, metavar="DIR",
                       help="daemon directory: request journal, results, "
                            "heartbeat, time series (default: "
                            "<store-root>/serve)")
        p.add_argument("--workers", type=int, default=None,
                       help="check worker threads (JTPU_SERVE_WORKERS)")
        p.add_argument("--queue-max", type=int, default=None,
                       help="queue depth past which POST /check answers 429 "
                            "(JTPU_SERVE_QUEUE)")
        p.add_argument("--tenant-max", type=int, default=None,
                       help="queued requests a tenant may have "
                            "(JTPU_SERVE_TENANT_MAX)")
        p.add_argument("--deadline-s", type=float, default=None,
                       help="default per-request deadline; past it a "
                            "request answers :info/timeout "
                            "(JTPU_SERVE_DEADLINE_S)")
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="where the searches run (default: cuda)")
        p.add_argument("--compile-cache", default=None, metavar="DIR",
                       help="the kernel library's build directory, so that "
                            "a restarted daemon loads the library built "
                            "there instead of running nvcc again")
        p.add_argument("--serve-backend", default=None,
                       choices=["gpu", "cpu"],
                       help="checker backend for daemon requests (default: "
                            "gpu, the device search; JTPU_SERVE_BACKEND)")
        p.add_argument("--batch-max", type=int, default=None,
                       help="most same-bucket requests coalesced into one "
                            "gang; 0 or 1 turns gangs off "
                            "(JTPU_SERVE_BATCH_MAX)")
        p.add_argument("--batch-wait-ms", type=float, default=None,
                       help="how long a gang's leader waits for members of "
                            "its bucket (JTPU_SERVE_BATCH_WAIT_MS)")
        p.add_argument("--auth-token", default=None, metavar="TOKEN",
                       help="require 'Authorization: Bearer TOKEN' on POST "
                            "/check, /stream and /drain (JTPU_SERVE_TOKEN)")
        p.add_argument("--engine-max-buckets", type=int, default=None,
                       help="evict the least recently used warm buckets "
                            "past this count; 0: no bound "
                            "(JTPU_ENGINE_MAX_BUCKETS)")
        p.add_argument("--fleet", type=int, default=None, metavar="N",
                       help="place the gangs on N fleet worker hosts "
                            "(JTPU_SERVE_FLEET)")
        p.add_argument("--rate-limit", type=float, default=None,
                       metavar="R",
                       help="per-tenant POST /check token bucket: R "
                            "requests/s, 429 with Retry-After past it; 0: "
                            "off (JTPU_SERVE_RATE)")
        return p

    def run_(opts) -> int:
        from jepsen_tpu_torch import serve as serve_ns
        from jepsen_tpu_torch import web
        host, port = opts["host"], opts["port"]
        if not (opts["check_daemon"] or serve_ns.serve_enabled()):
            server = web.serve(host=host, port=port,
                               root=opts["store_root"])
            print(f"Listening on http://{host}:{server.server_port}/",
                  flush=True)
            try:
                server.serve_forever()
            except KeyboardInterrupt:
                pass
            server.server_close()
            return OK
        cfg = serve_config(opts)
        daemon, server = serve_ns.run_daemon(cfg, host=host, port=port,
                                             store_root=opts["store_root"])
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
        print(f"Listening on http://{host}:{server.server_port}/ (check "
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
        return OK

    return {"serve": {"parser": build_parser, "run": run_}}


def _load_ops(path: str) -> list:
    """A history file's op maps: a JSON array, or one per line."""
    with open(path) as f:
        text = f.read().strip()
    if text.startswith("["):
        return json.loads(text)
    return [json.loads(ln) for ln in text.splitlines() if ln.strip()]


def stream_cmd() -> dict:
    """The ``stream`` command: the client of a daemon's stream routes.
    Exit 0 when valid, 1 when not (or unknown), 254 for bad arguments or
    an empty history, 255 when the daemon fails a call."""

    def build_parser():
        from jepsen_tpu_torch.serve import models
        p = Parser(prog="stream",
                   description="Stream a history into a check daemon's "
                               "/stream routes and await the verdict.")
        p.add_argument("--url", default="http://127.0.0.1:8080",
                       help="daemon base URL")
        p.add_argument("--store", default=None,
                       help="store directory whose history.jsonl to stream "
                            "(default: the latest under ./store)")
        p.add_argument("--history", default=None, metavar="FILE",
                       help="history file (a JSON array or JSON lines of op "
                            "maps) instead of --store")
        p.add_argument("--model", default="cas-register",
                       choices=list(models()))
        p.add_argument("--tenant", default="default")
        p.add_argument("--chunk", type=int, default=1000,
                       help="ops per chunk")
        p.add_argument("--auth-token", default=None, metavar="TOKEN",
                       help="Authorization: Bearer TOKEN")
        p.add_argument("--poll", type=float, default=0.5,
                       help="verdict poll interval (seconds)")
        p.add_argument("--timeout", type=float, default=600.0,
                       help="the client's whole budget (seconds)")
        return p

    def run_(opts) -> int:
        import urllib.error
        import urllib.request

        from jepsen_tpu_torch.stream import chunk_crc
        base = opts["url"].rstrip("/")

        def call(method, path, doc=None):
            req = urllib.request.Request(
                base + path, method=method,
                data=None if doc is None else json.dumps(doc).encode(),
                headers={"Content-Type": "application/json"})
            if opts["auth_token"]:
                req.add_header("Authorization",
                               f"Bearer {opts['auth_token']}")
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    return r.status, json.loads(r.read() or b"{}")
            except urllib.error.HTTPError as e:
                try:
                    body = json.loads(e.read() or b"{}")
                except ValueError:
                    body = {}
                return e.code, body

        if opts["history"]:
            try:
                ops = _load_ops(opts["history"])
            except (OSError, ValueError) as e:
                print(f"cannot read {opts['history']}: {e}", file=sys.stderr)
                return INVALID_ARGS
        else:
            from jepsen_tpu_torch import repl, store
            d = opts["store"]
            if d and not os.path.isdir(d):
                print(f"no such store directory: {d}", file=sys.stderr)
                return INVALID_ARGS
            test = store.load(d) if d else repl.last_test()
            if test is None:
                print("no stored test found", file=sys.stderr)
                return INVALID_ARGS
            ops = [op.to_dict() if hasattr(op, "to_dict") else dict(op)
                   for op in (test.get("history") or [])]
        if not ops:
            print("history is empty; nothing to stream", file=sys.stderr)
            return INVALID_ARGS
        deadline = time.monotonic() + opts["timeout"]

        def budget() -> float:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError("stream client budget exhausted")
            return left

        opening = {"tenant": opts["tenant"], "model": opts["model"]}
        code, body = call("POST", "/stream", opening)
        while code == 429:
            time.sleep(min(float(body.get("retry-after-s") or 1.0),
                           budget()))
            code, body = call("POST", "/stream", opening)
        if code != 202:
            print(f"open failed: HTTP {code} {body}", file=sys.stderr)
            return CRASHED
        sid = body["id"]
        n_chunk = max(1, opts["chunk"])
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
                print(f"chunk {seq} failed: HTTP {code} {body}",
                      file=sys.stderr)
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
            time.sleep(min(opts["poll"], budget()))
        result = body["result"]
        print(json.dumps(result, indent=2, default=repr))
        return OK if result.get("valid") is True else TEST_FAILED

    return {"stream": {"parser": build_parser, "run": run_}}


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

def _plan_dims(opts: Dict[str, Any], model):
    """The dims ``plan`` verifies, or an error message. Shape knobs a
    ``@file.json`` pins fill the flags not given."""
    from jepsen_tpu_torch.checker import plan
    from jepsen_tpu_torch.history import History
    if opts["history"]:
        try:
            h = History.of(_load_ops(opts["history"]))
        except (OSError, ValueError) as e:
            return f"cannot read {opts['history']}: {e}"
        dims = plan.PlanDims.from_history(h, model)
        if dims is None:
            return (f"model {opts['model']} has no integer kernel; nothing "
                    f"to plan")
        return dims
    if not opts["dims"]:
        return "pass --history FILE or --dims SPEC"
    spec = opts["dims"]
    if spec.startswith("@"):
        try:
            with open(spec[1:], encoding="utf-8") as f:
                d = json.load(f)
        except (OSError, ValueError) as e:
            return f"--dims {spec!r}: {e}"
        for knob in ("capacity", "window", "expand", "mesh", "bytes_limit"):
            if opts[knob] is None and d.get(knob) is not None:
                opts[knob] = int(d[knob])
        return plan.PlanDims(
            n_required=int(d["n_required"]),
            n_crashed=int(d.get("n_crashed", 0)),
            window_needed=int(d.get("window_needed", 1)),
            n_events=(int(d["n_events"]) if d.get("n_events") is not None
                      else None),
            keys=int(d.get("keys", opts["keys"] or 1)))
    try:
        parts = [int(x) for x in spec.split(",")]
    except ValueError:
        return (f"--dims {spec!r}: expected comma-separated integers or "
                f"@file.json")
    if not parts or len(parts) > 4:
        return f"--dims {spec!r}: 1-4 integers"
    return plan.PlanDims(*parts, keys=opts["keys"] or 1)


def plan_cmd() -> dict:
    """The ``plan`` command: verify a search plan ahead of any device
    time. Exit 0 when no error-severity finding, 1 when one, 254 for bad
    arguments."""

    def build_parser():
        from jepsen_tpu_torch.serve import models
        p = Parser(prog="plan",
                   description="Verify a search plan ahead of any device "
                               "time: encoding, memory and kernel shape.")
        p.add_argument("--history", default=None, metavar="FILE",
                       help="derive the dims from a history file (a JSON "
                            "array or JSON lines of op maps)")
        p.add_argument("--dims", default=None, metavar="SPEC",
                       help="dims without a history: 'N_REQUIRED[,N_CRASHED"
                            "[,WINDOW_NEEDED[,N_EVENTS]]]' or @file.json "
                            "(keys: n_required, n_crashed, window_needed, "
                            "n_events, keys, capacity, window, expand, "
                            "bytes_limit)")
        p.add_argument("--model", default="cas-register",
                       choices=list(models()))
        p.add_argument("--keys", type=int, default=1,
                       help="verify the keyed-batch plan for this many keys")
        p.add_argument("--mesh", type=int, default=None, metavar="N",
                       help="also verify the pool-sharded plan over a mesh "
                            "axis of N shards")
        p.add_argument("--capacity", type=int, default=None,
                       help="pin the rung instead of the ladder")
        p.add_argument("--window", type=int, default=None)
        p.add_argument("--expand", type=int, default=None)
        p.add_argument("--bytes-limit", type=int, default=None,
                       help="byte budget (default: JTPU_PLAN_BYTES_LIMIT, "
                            "else the card's memory, else unchecked)")
        p.add_argument("--no-trace", action="store_true",
                       help="skip the shape check (arithmetic only)")
        p.add_argument("--format", default="text",
                       choices=["text", "json", "sarif"])
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="the device whose ladder and memory to plan for")
        return p

    def run_(opts) -> int:
        from jepsen_tpu_torch.checker import plan
        from jepsen_tpu_torch.models.core import kernel_spec_for
        from jepsen_tpu_torch.serve import models
        model = models()[opts["model"]]()
        dims = _plan_dims(opts, model)
        if isinstance(dims, str):
            print(dims, file=sys.stderr)
            return INVALID_ARGS
        if (opts["keys"] or 1) > 1 and dims.keys == 1:
            dims = plan.PlanDims(dims.n_required, dims.n_crashed,
                                 dims.window_needed, dims.n_events,
                                 keys=opts["keys"])
        report = plan.analyze(dims, kernel=kernel_spec_for(model),
                              capacity=opts["capacity"],
                              window=opts["window"], expand=opts["expand"],
                              bytes_limit=opts["bytes_limit"],
                              trace=not opts["no_trace"],
                              device=opts["device"], mesh_axis=opts["mesh"])
        errors = [i for i in report["issues"] if i["severity"] == "error"]
        if opts["format"] == "json":
            print(json.dumps(report, indent=2))
            return TEST_FAILED if errors else OK
        if opts["format"] == "sarif":
            from jepsen_tpu_torch.analysis import plan_lint, sarif
            print(sarif.render(plan_lint.findings_from_report(report)),
                  end="")
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

    return {"plan": {"parser": build_parser, "run": run_}}


# ---------------------------------------------------------------------------
# analyze, recover, explain
# ---------------------------------------------------------------------------

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


def _forecast(history, model, opts: Dict[str, Any]) -> None:
    """The ``# plan:`` line and the ``# contention:`` lines; a history of
    ``[k v]`` values is forecast as its keys' batch."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.analysis import contention
    from jepsen_tpu_torch.checker import plan
    if independent.history_keys(history):
        history = independent.subhistories(history)
    print(plan.summary_line(history, model, device=opts["device"]))
    for ln in contention.forecast_lines(contention.profile(history)):
        print(ln)


def _recheck(test: dict, model, opts: Dict[str, Any]) -> dict:
    """Re-check a stored run's history (key by key when its ops carry
    ``[k v]`` values); prints the ``# compile:`` and ``# search:`` lines.
    Live progress (and a --profile capture) go to the run's directory."""
    from jepsen_tpu_torch import independent, repl
    from jepsen_tpu_torch.checker import gpu
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.obs import observatory, profiler
    checker = linearizable(model, backend=opts["backend"],
                           device=_device(opts),
                           algorithm=opts["algorithm"])
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


def analyze_cmd() -> dict:
    """The ``analyze`` command: re-check a stored run offline."""

    def build_parser():
        p = Parser(prog="analyze", description="Re-check a stored run "
                                               "offline.")
        p.add_argument("--store", default=None,
                       help="store directory (default: the latest under "
                            "./store)")
        _add_check_opts(p)
        return p

    def run_(opts) -> int:
        from jepsen_tpu_torch import analysis, core, repl, store
        from jepsen_tpu_torch.analysis.history_lint import lint_history
        from jepsen_tpu_torch.serve import models
        d = opts["store"]
        if d and not os.path.isdir(d):
            # a missing directory is a typo, not an empty run
            print(f"no such store directory: {d}", file=sys.stderr)
            return INVALID_ARGS
        test = store.load(d) if d else repl.last_test()
        if test is None:
            print("no stored test found", file=sys.stderr)
            return INVALID_ARGS
        if _card_refused(opts, "analyze"):
            return CRASHED
        history = test.get("history") or []
        model = models()[opts["model"]]()
        print(analysis.summary_line(lint_history(history)))
        with _check_env(opts["segment_iters"], opts["profile"]):
            _forecast(history, model, opts)
            out = _recheck(test, model, opts)
        leaked = core.abandoned_threads()
        if leaked:
            print(f"# leaked-threads: {leaked} hung client-op thread(s) "
                  f"abandoned by op-timeout and still resident")
        print(json.dumps(out, indent=2, default=repr))
        return OK if out.get("valid") is True else TEST_FAILED

    return {"analyze": {"parser": build_parser, "run": run_}}


def recover_cmd() -> dict:
    """The ``recover`` command: rebuild the runs that died mid-flight
    from their WALs and re-check them. 0 when every recovered run checks
    valid, 1 when a verdict is not valid or a recovery fails."""

    def build_parser():
        p = Parser(prog="recover",
                   description="Recover runs that died mid-flight from "
                               "their WALs and re-check them.")
        p.add_argument("--store", default=None,
                       help="a specific run directory (default: scan "
                            "--store-root for dead runs)")
        p.add_argument("--store-root", default="store",
                       help="store root to scan for dead runs")
        p.add_argument("--no-analyze", action="store_true",
                       help="reconstruct histories only; skip the checker")
        p.add_argument("--force", action="store_true",
                       help="recover --store even if its run.state says "
                            "done or its pid looks alive")
        _add_check_opts(p)
        return p

    def run_(opts) -> int:
        from jepsen_tpu_torch import store
        if opts["store"]:
            d = opts["store"]
            if not os.path.isdir(d):
                print(f"no such store directory: {d}", file=sys.stderr)
                return INVALID_ARGS
            status = store.run_status(d)
            if status != "dead" and not opts["force"]:
                print(f"# recovery: {d}: status={status or 'no run.state'}; "
                      f"nothing to recover (--force overrides)")
                return OK if status in ("done", "recovered") \
                    else INVALID_ARGS
            targets = [d]
        else:
            targets = store.dead_runs(opts["store_root"] or "store")
            if not targets:
                print("# recovery: no dead runs found")
                return OK
        if not opts["no_analyze"] and _card_refused(opts, "recover"):
            return CRASHED
        with _check_env(opts["segment_iters"], opts["profile"]):
            return _recover(targets, opts)

    return {"recover": {"parser": build_parser, "run": run_}}


def _recover(targets: List[str], opts: Dict[str, Any]) -> int:
    """Each dead run of ``targets`` rebuilt from its WAL, linted and (but
    for ``--no-analyze``) re-checked and marked done."""
    from jepsen_tpu_torch import analysis, store
    from jepsen_tpu_torch.analysis import history_lint as hl
    from jepsen_tpu_torch.obs import trace as trace_ns
    from jepsen_tpu_torch.serve import models
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
        model = models()[opts["model"]]()
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
        if opts["no_analyze"]:
            continue
        out = _recheck(store.load(d), model, opts)
        store.write_results(d, out)
        store.write_state(d, "done", recovered=True, recovery=s)
        print(f"# recovery: {d}: verdict valid={out.get('valid')}")
        if out.get("valid") is not True:
            worst = TEST_FAILED
    return worst


def _run_dir(opts: Dict[str, Any], root: Optional[str] = None
             ) -> Optional[str]:
    """``--store``, else the latest run under ``root`` (default: the
    store's own default); None when there is none."""
    from jepsen_tpu_torch import store
    d = opts["store"]
    if d is None:
        t = store.latest(root) if root else store.latest()
        d = t.get("store-dir") if t else None
    return d if d and os.path.isdir(d) else None


def explain_cmd() -> dict:
    """The ``explain`` command: why a stored run got its verdict, from
    its artifacts only (no check runs)."""

    def build_parser():
        from jepsen_tpu_torch.serve import models
        p = Parser(prog="explain",
                   description="Explain a stored run's verdict from its "
                               "artifacts (results, searchstats, attempts "
                               "trail).")
        p.add_argument("--store", default=None,
                       help="run directory (default: the latest under "
                            "--store-root)")
        p.add_argument("--store-root", default="store")
        p.add_argument("--model", default="cas-register",
                       choices=list(models()),
                       help="the model the counterexample is packed with "
                            "(invalid verdicts only)")
        p.add_argument("--format", default="text", choices=["text", "json"])
        return p

    def run_(opts) -> int:
        from jepsen_tpu_torch import explain
        from jepsen_tpu_torch.serve import models
        d = _run_dir(opts, opts["store_root"] or "store")
        if d is None:
            print(f"no such store directory: {opts['store']}",
                  file=sys.stderr)
            return INVALID_ARGS
        report = explain.explain_report(d, model=models()[opts["model"]]())
        if opts["format"] == "json":
            print(json.dumps(report, indent=2, default=repr))
        else:
            print(explain.render_text(report))
        return OK if report.get("valid") is True else TEST_FAILED

    return {"explain": {"parser": build_parser, "run": run_}}


# ---------------------------------------------------------------------------
# watch, top
# ---------------------------------------------------------------------------

def _watch_fleet(opts: Dict[str, Any]) -> int:
    from jepsen_tpu_torch.obs import fleet
    dirs = list(opts["fleet"])
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
        if opts["once"] or all(s in (None, "done") for s in states):
            return OK
        time.sleep(max(opts["interval"] or 1.0, 0.05))


def watch_cmd() -> dict:
    """The ``watch`` command: follow another process's run from its
    ``progress.json`` until its ``run.state`` is terminal; ``--once``
    prints one line."""

    def build_parser():
        p = Parser(prog="watch", description="Live status line of an "
                                             "in-flight run's device "
                                             "search.")
        p.add_argument("--store", default=None,
                       help="run directory (default: the latest under "
                            "--store-root)")
        p.add_argument("--store-root", default="store")
        p.add_argument("--interval", type=float, default=1.0,
                       help="seconds between refreshes")
        p.add_argument("--once", action="store_true",
                       help="print one status line and exit")
        p.add_argument("--fleet", nargs="+", default=None,
                       metavar="HOST_DIR",
                       help="fleet mode: merge N hosts' run directories "
                            "(trace, metrics, progress) and render each "
                            "host's level, imbalance and headroom side by "
                            "side")
        return p

    def run_(opts) -> int:
        from jepsen_tpu_torch import store
        from jepsen_tpu_torch.obs import observatory
        if opts["fleet"]:
            return _watch_fleet(opts)
        d = _run_dir(opts, opts["store_root"] or "store")
        if d is None:
            print(f"no such store directory: {opts['store']}",
                  file=sys.stderr)
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
            if opts["once"] or done or state in ("done", "dead",
                                                 "recovered"):
                if tty:
                    print()
                return OK
            time.sleep(max(opts["interval"] or 1.0, 0.05))

    return {"watch": {"parser": build_parser, "run": run_}}


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


def top_cmd() -> dict:
    """The ``top`` command: :func:`_top_screen` each ``--interval``
    (``--once``: one screen)."""

    def build_parser():
        p = Parser(prog="top", description="One-screen live status of a "
                                           "serve directory from its "
                                           "published artifacts.")
        p.add_argument("--store", default=None,
                       help="serve (or run) directory (default: latest "
                            "under --store-root)")
        p.add_argument("--store-root", default="store")
        p.add_argument("--interval", type=float, default=2.0,
                       help="seconds between refreshes")
        p.add_argument("--once", action="store_true",
                       help="print one screen and exit")
        return p

    def run_(opts) -> int:
        d = _run_dir(opts, opts["store_root"] or "store")
        if d is None:
            print(f"no such store directory: {opts['store']}",
                  file=sys.stderr)
            return INVALID_ARGS
        while True:
            for line in _top_screen(d):
                print(line, flush=True)
            if opts["once"]:
                return OK
            time.sleep(max(opts["interval"] or 2.0, 0.05))

    return {"top": {"parser": build_parser, "run": run_}}


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

def trace_cmd() -> dict:
    """The ``trace`` command: ``export|summary|request|find`` over a
    run's or a serve directory's ``trace.jsonl`` (torn-tail tolerant),
    with the device lane of a ``--profile``d run merged into ``export``
    and ``summary``."""

    def build_parser():
        p = Parser(prog="trace",
                   description="Export, summarize, stitch or search a "
                               "run's span trace (trace.jsonl).")
        p.add_argument("action", choices=["export", "summary", "request",
                                          "find"],
                       help="export: Chrome/Perfetto (or raw jsonl) trace; "
                            "summary: per-span rollup; request: one "
                            "request's stitched waterfall; find: search a "
                            "serve directory's requests")
        p.add_argument("rid", nargs="?", default=None, metavar="ID",
                       help="with `request`: the serve request id (or "
                            "32-hex trace id) to stitch")
        p.add_argument("--store", default=None,
                       help="store directory (default: the latest under "
                            "./store)")
        p.add_argument("--format", default=None,
                       choices=["chrome", "jsonl", "json", "text"],
                       help="output format (default: chrome for export, "
                            "text for request)")
        p.add_argument("-o", "--output", default=None, metavar="FILE",
                       help="write the export here (default: stdout)")
        p.add_argument("--top", type=int, default=None, metavar="N",
                       help="with `summary`: also the N slowest span names "
                            "by self time")
        p.add_argument("--host-dir", action="append", default=None,
                       metavar="DIR",
                       help="with `request`: more host directories whose "
                            "trace.jsonl joins the stitch (repeatable)")
        p.add_argument("--tenant", default=None,
                       help="with `find`: only this tenant's requests")
        p.add_argument("--min-device-s", type=float, default=None,
                       metavar="S",
                       help="with `find`: only requests that took at least "
                            "S device seconds")
        p.add_argument("--error-class", default=None, metavar="CLASS",
                       help="with `find`: only requests whose result "
                            "carries this error class")
        p.add_argument("--host", default=None,
                       help="with `find`: only requests with spans on this "
                            "host")
        p.add_argument("--limit", type=int, default=50, metavar="N",
                       help="with `find`: the newest N matches (default 50)")
        return p

    return {"trace": {"parser": build_parser, "run": _trace}}


def _trace(opts: Dict[str, Any]) -> int:
    from jepsen_tpu_torch.obs import profiler
    from jepsen_tpu_torch.obs import trace as trace_ns
    d = _run_dir(opts)
    if d is None:
        print(f"no such store directory: {opts['store']}", file=sys.stderr)
        return INVALID_ARGS
    fmt = opts["format"] or "chrome"
    if opts["action"] == "request":
        return _trace_request(opts, d)
    if opts["action"] == "find":
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
    if opts["action"] == "summary":
        return _trace_summary(opts, records, stats, device, fmt)
    if fmt == "chrome":
        text = json.dumps(trace_ns.to_chrome(
            records + device, process_name=os.path.basename(d) or "jtpu"))
    else:
        text = "\n".join(json.dumps(r, default=repr)
                         for r in records + device) + "\n"
    _emit(opts, text, f"# trace: wrote {fmt} export to {opts['output']}")
    return OK


def _trace_summary(opts: Dict[str, Any], records, stats, device,
                   fmt: str) -> int:
    from jepsen_tpu_torch.obs import profiler
    from jepsen_tpu_torch.obs import trace as trace_ns
    rollup = trace_ns.summarize(records)
    kern = profiler.top_kernels(device, k=opts["top"] or 10)
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
    if opts["top"]:
        top = trace_ns.self_time_rollup(records)
        rows = sorted(top.items(),
                      key=lambda kv: -kv[1]["self-ns"])[:opts["top"]]
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


def _emit(opts: Dict[str, Any], text: str, note: str) -> None:
    """An export to ``--output`` (with ``note`` on stderr), else stdout."""
    if opts["output"]:
        with open(opts["output"], "w") as f:
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


def _trace_request(opts: Dict[str, Any], d: str) -> int:
    """One request's trace, stitched across the serve daemon's
    trace.jsonl and any host directories, as a waterfall (or chrome, json,
    jsonl)."""
    from jepsen_tpu_torch.obs import fleet as obs_fleet
    rid = opts["rid"]
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
    stitched = obs_fleet.stitch_request(d, tid, extra_dirs=opts["host_dir"])
    recs = stitched["records"]
    fmt = opts["format"] or "text"
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
                          f"{opts['output']}")
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


def _trace_find(opts: Dict[str, Any], d: str) -> int:
    """A serve directory's completed requests filtered by tenant, device
    seconds, error class and host, one line each, newest first."""
    from jepsen_tpu_torch.obs import federation
    rows = federation.trace_find(
        d, tenant=opts["tenant"], min_device_s=opts["min_device_s"],
        error_class=opts["error_class"], host=opts["host"],
        limit=opts["limit"] or 50)
    if (opts["format"] or "text") == "json":
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


# ---------------------------------------------------------------------------
# lint
# ---------------------------------------------------------------------------

def lint_cmd() -> dict:
    """The ``lint`` command: the static analyzer's passes, gated against
    the port's baseline: exit 1 on a new error (with ``--strict``, a new
    warning or a baseline entry whose justification is still the
    stub)."""

    def build_parser():
        from jepsen_tpu_torch import analysis
        p = Parser(prog="lint",
                   description="Static analysis: broken suites, malformed "
                               "histories, races, lock order, crash "
                               "consistency, widths.")
        p.add_argument("paths", nargs="*", metavar="PATH",
                       help="files to lint (.py through the code passes, "
                            ".jsonl/.wal through the history pass); "
                            "default: the port at its standard scopes")
        p.add_argument("--history", action="append", default=[],
                       metavar="FILE",
                       help="also lint a saved history artifact "
                            "(repeatable)")
        p.add_argument("--pass", dest="passes", action="append",
                       choices=list(analysis.PASSES), metavar="PASS",
                       help=f"run only these passes (repeatable; choices: "
                            f"{', '.join(analysis.PASSES)})")
        p.add_argument("--baseline", default=None, metavar="FILE",
                       help="baseline file (default: "
                            "jepsen_tpu_torch/analysis/lint.baseline)")
        p.add_argument("--no-baseline", action="store_true",
                       help="ignore the baseline: report everything")
        p.add_argument("--write-baseline", action="store_true",
                       help="accept the current findings into the baseline "
                            "file (existing justifications are kept; new "
                            "entries get a TODO stub)")
        p.add_argument("--prune-stale", action="store_true",
                       help="rewrite the baseline without the entries that "
                            "no longer match any finding")
        p.add_argument("--strict", action="store_true",
                       help="exit nonzero on new warnings too, not just "
                            "errors")
        p.add_argument("--format", default="text",
                       choices=["text", "json", "sarif"],
                       help="sarif: SARIF 2.1.0 of the new findings")
        p.add_argument("--root", default=None,
                       help="repo root override (fixtures, tests)")
        return p

    def run_(opts) -> int:
        from jepsen_tpu_torch import analysis
        from jepsen_tpu_torch.analysis import baseline as bl
        root = opts["root"] or analysis.repo_root()
        passes = tuple(opts["passes"] or analysis.PASSES)
        if opts["paths"]:
            findings = analysis.lint_files(
                list(opts["paths"]) + list(opts["history"]), passes=passes,
                root=root)
        else:
            findings = analysis.lint_repo(root=root, passes=passes,
                                          histories=opts["history"])
        bpath = opts["baseline"] or bl.default_path(root)
        if opts["write_baseline"]:
            bl.write(bpath, findings)
            print(f"# lint: baseline written to {bpath} ({len(findings)} "
                  f"finding(s))")
            return OK
        if opts["prune_stale"]:
            pruned = bl.prune(bpath, (f.key() for f in findings))
            for key in pruned:
                print(f"# lint: pruned stale baseline entry: {key}")
            print(f"# lint: {len(pruned)} stale baseline entr"
                  f"{'y' if len(pruned) == 1 else 'ies'} pruned from "
                  f"{bpath}")
            return OK
        accepted_keys = {} if opts["no_baseline"] else bl.load(bpath)
        new, accepted = bl.split(findings, accepted_keys)
        if opts["format"] == "json":
            print(json.dumps({"findings": [vars(f) for f in new],
                              "accepted": [vars(f) for f in accepted],
                              "counts": analysis.summarize(new)}, indent=2))
        elif opts["format"] == "sarif":
            from jepsen_tpu_torch.analysis import sarif
            print(sarif.render(new), end="")
        else:
            for f in sorted(new, key=lambda x: (x.path, x.line)):
                print(f.format())
            print(analysis.summary_line(new))
            if accepted:
                print(f"# lint: {len(accepted)} finding(s) accepted by "
                      f"{bpath}")
        gate = [f for f in new if f.severity == "error"
                or (opts["strict"] and f.severity == "warning")]
        if opts["strict"] and accepted:
            # an acceptance still carrying the --write-baseline stub was
            # never reviewed: strict mode does not let it suppress a finding
            stub_keys = set(bl.stubbed(accepted_keys))
            unjustified = sorted({f.key() for f in accepted} & stub_keys)
            for key in unjustified:
                print(f"# lint: --strict: baseline entry {key!r} still "
                      f"carries the stub justification ({bl.STUB!r}); "
                      f"replace it with a real reason in {bpath}",
                      file=sys.stderr)
            gate = gate or unjustified
        return TEST_FAILED if gate else OK

    return {"lint": {"parser": build_parser, "run": run_}}


# ---------------------------------------------------------------------------
# usage, flightrec
# ---------------------------------------------------------------------------

def _serve_dir(opts: Dict[str, Any]) -> str:
    return opts["serve_dir"] or os.path.join(opts["store_root"] or "store",
                                             "serve")


def _add_serve_dir_opts(p: argparse.ArgumentParser) -> None:
    p.add_argument("--serve-dir", default=None, metavar="DIR",
                   help="daemon directory (default: <store-root>/serve)")
    p.add_argument("--store-root", default="store")


def usage_cmd() -> dict:
    """The ``usage`` command: per-tenant usage totals recomputed from a
    serve directory's WAL ``done`` records
    (:func:`jepsen_tpu_torch.obs.usage.from_wal`): what a live daemon's
    ``GET /usage`` answers, offline too."""

    def build_parser():
        p = Parser(prog="usage", description="Per-tenant usage totals from "
                                             "a serve daemon's request "
                                             "journal.")
        _add_serve_dir_opts(p)
        p.add_argument("--tenant", default=None,
                       help="one tenant only (default: all)")
        p.add_argument("--json", action="store_true",
                       help="raw JSON instead of the table")
        return p

    def run_(opts) -> int:
        from jepsen_tpu_torch import serve as serve_ns
        from jepsen_tpu_torch.obs import usage as obs_usage
        wal = os.path.join(_serve_dir(opts), serve_ns.WAL_NAME)
        if not os.path.exists(wal):
            print(f"no request journal at {wal}", file=sys.stderr)
            return INVALID_ARGS
        doc = obs_usage.from_wal(wal)
        if opts["tenant"] is not None:
            doc["tenants"] = {t: u for t, u in doc["tenants"].items()
                              if t == opts["tenant"]}
        if opts["json"]:
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

    return {"usage": {"parser": build_parser, "run": run_}}


def flightrec_cmd() -> dict:
    """The ``flightrec`` command: a serve directory's flight-recorder
    dumps, the list newest first, or one dump's summary (``--json``: the
    dump itself)."""

    def build_parser():
        p = Parser(prog="flightrec", description="List or show a serve "
                                                 "daemon's flight-recorder "
                                                 "dumps.")
        p.add_argument("dump", nargs="?", default=None,
                       help="dump file name (default: list them)")
        _add_serve_dir_opts(p)
        p.add_argument("--json", action="store_true",
                       help="raw JSON instead of the summary")
        return p

    def run_(opts) -> int:
        from jepsen_tpu_torch.obs import flightrec as obs_flightrec
        d = _serve_dir(opts)

        def when(ts) -> str:
            return time.strftime("%Y-%m-%d %H:%M:%S",
                                 time.localtime(ts or 0))

        if opts["dump"]:
            doc = obs_flightrec.load_dump(d, opts["dump"])
            if doc is None:
                print(f"no such dump: {opts['dump']}", file=sys.stderr)
                return INVALID_ARGS
            if opts["json"]:
                print(json.dumps(doc, indent=2))
                return OK
            print(f"# flightrec: {opts['dump']}: reason={doc.get('reason')} "
                  f"at {when(doc.get('wall-ts'))}, window "
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
        if opts["json"]:
            print(json.dumps({"dumps": dumps}, indent=2))
            return OK
        if not dumps:
            print(f"# flightrec: no dumps under "
                  f"{os.path.join(d, obs_flightrec.DIR_NAME)}")
            return OK
        for rec in dumps:
            print(f"# flightrec: {rec['name']}: reason={rec.get('reason')} "
                  f"at {when(rec.get('wall-ts'))}, {rec.get('spans', 0)} "
                  f"span(s), {rec.get('trace-ids', 0)} trace(s), "
                  f"{rec.get('bytes', 0)} byte(s)")
        return OK

    return {"flightrec": {"parser": build_parser, "run": run_}}


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def merge_commands(*cmds: dict) -> dict:
    """One command map of several; a later command of a name wins."""
    out: Dict[str, dict] = {}
    for c in cmds:
        out.update(c)
    return out


def run(subcommands: Dict[str, dict], argv: Sequence[str]) -> int:
    """Dispatch ``argv[0]`` among ``subcommands``; returns the exit code.
    No command, or an unknown one: the usage and the command list, 254. A
    parse error, or an argument error from ``opt_fn`` or the command:
    254. ``--help``: its exit code. Any other exception: a traceback and
    255."""
    argv = list(argv)
    command = argv[0] if argv else None
    if command not in subcommands:
        print("Usage: COMMAND [OPTIONS ...]")
        print("Commands:", ", ".join(sorted(subcommands)))
        return INVALID_ARGS
    spec = subcommands[command]
    try:
        opts = vars(spec["parser"]().parse_args(argv[1:]))
        opt_fn = spec.get("opt_fn")
        if opt_fn:
            opts = opt_fn(opts)
        return spec["run"](opts)
    except _ArgError as e:
        print(f"{command}: {e}", file=sys.stderr)
        return INVALID_ARGS
    except SystemExit as e:  # --help exits 0
        return int(e.code or 0)
    except Exception:  # noqa: BLE001 -- the exit-code contract's 255
        print(f"{command}: internal error:", file=sys.stderr)
        traceback.print_exc()
        return CRASHED


def main(subcommands: Dict[str, dict],
         argv: Optional[Sequence[str]] = None) -> None:
    """Exit the process with :func:`run`'s code (``argv`` default: the
    process's arguments)."""
    sys.exit(run(subcommands, sys.argv[1:] if argv is None else argv))


def default_commands() -> dict:
    """The 13 commands ``python -m jepsen_tpu_torch`` dispatches."""
    return merge_commands(suite_run_cmd(), analyze_cmd(), recover_cmd(),
                          lint_cmd(), plan_cmd(), trace_cmd(), watch_cmd(),
                          top_cmd(), serve_cmd(), stream_cmd(),
                          explain_cmd(), usage_cmd(), flightrec_cmd())
