"""Chronos suite — job-scheduler correctness via constraint solving.

Rebuild of chronos/src/jepsen/chronos/: jobs are registered with a start
time, interval, count, epsilon (allowed lateness) and duration; the
checker (chronos/checker.clj:20-210) computes, for each job, the target
intervals that MUST have started by the final read, and asks whether the
observed runs can satisfy every target with a *distinct* run whose start
falls inside the target window.

The reference solves this with the loco CSP solver ($distinct indices +
interval membership). That constraint system is a *convex bipartite
matching* — each target's feasible runs form a contiguous window of the
time-sorted run list — for which the greedy algorithm (process targets by
deadline, take the earliest unused feasible run) yields a maximum
matching, so the greedy answer here is exactly the CSP's satisfiability
answer, without a solver dependency.

The port's copy of ``jepsen_tpu.suites.chronos``. Its check runs on the
host, as in the reference: nothing of it reaches the card. Job starts
and the final read take the time from :data:`clock`, and the job
stagger and the nemesis cycle's sleeps are module constants, so that a
short run against a fake scheduler can run faster than the wall clock."""

from __future__ import annotations

import json
import time
import urllib.request
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from jepsen_tpu_torch import client as client_ns
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.checker import Checker
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.testing import noop_test

#: Seconds of deadline slack (checker.clj epsilon-forgiveness).
EPSILON_FORGIVENESS = 5

#: The clock (POSIX seconds) that job starts and the final read are taken
#: from: the wall clock.
clock = time.time

#: Seconds between job registrations (the stagger and the delay of
#: chronos.clj's generator), and each sleep of the nemesis cycle.
JOB_STAGGER_S = 30
NEMESIS_SLEEP_S = 200


@dataclass(frozen=True)
class Job:
    """A scheduled job (chronos.clj jobs are maps with these keys)."""

    name: int
    start: float        # POSIX seconds
    interval: float     # seconds between target begins
    count: int          # how many runs we asked for
    epsilon: float      # how late a run may begin
    duration: float     # how long a run takes


def job_targets(read_time: float, job: Job) -> List[Tuple[float, float]]:
    """[(start, deadline)] for targets that must have *begun* by the read
    (checker.clj:30-47): a run may start up to epsilon late and needs
    duration to finish, so targets newer than read - epsilon - duration
    are unconstrained."""
    finish = read_time - job.epsilon - job.duration
    out = []
    t = job.start
    for _ in range(job.count):
        if t >= finish:
            break
        out.append((t, t + job.epsilon + EPSILON_FORGIVENESS))
        t += job.interval
    return out


def split_runs(runs: Sequence[dict]) -> Tuple[List[dict], List[dict]]:
    """(complete, incomplete) runs, each sorted by start
    (checker.clj:59-76)."""
    complete = sorted((r for r in runs if r.get("end") is not None),
                      key=lambda r: r["start"])
    incomplete = sorted((r for r in runs if r.get("end") is None),
                        key=lambda r: r["start"])
    return complete, incomplete


def match_targets(targets: Sequence[Tuple[float, float]],
                  runs: Sequence[dict]) -> Optional[Dict[int, dict]]:
    """Maximum matching of targets to distinct runs with
    start <= run.start <= deadline, or None if some target is
    unsatisfiable. Greedy by deadline over time-sorted runs — exact for
    this convex structure (see module docstring)."""
    order = sorted(range(len(targets)), key=lambda i: targets[i][1])
    runs = sorted(runs, key=lambda r: r["start"])
    used = [False] * len(runs)
    out: Dict[int, dict] = {}
    for i in order:
        lo, hi = targets[i]
        chosen = None
        for j, r in enumerate(runs):
            if used[j] or r["start"] < lo:
                continue
            if r["start"] > hi:
                break
            chosen = j
            break
        if chosen is None:
            return None
        used[chosen] = True
        out[i] = runs[chosen]
    return out


def job_solution(read_time: float, job: Job,
                 runs: Sequence[dict]) -> Dict[str, Any]:
    """Solve one job (checker.clj:122-188)."""
    targets = job_targets(read_time, job)
    complete, incomplete = split_runs(runs or [])
    matching = match_targets(targets, complete)
    if matching is None:
        return {"valid": False, "job": job, "solution": None,
                "extra": None, "complete": complete,
                "incomplete": incomplete}
    matched_ids = {id(r) for r in matching.values()}
    extra = [r for r in complete if id(r) not in matched_ids]
    return {"valid": True, "job": job,
            "solution": {targets[i]: r for i, r in sorted(matching.items())},
            "extra": extra, "complete": complete,
            "incomplete": incomplete}


def solution(read_time: float, jobs: Sequence[Job],
             runs: Sequence[dict]) -> Dict[str, Any]:
    """All jobs (checker.clj:190-210): runs grouped by job name."""
    by_name: Dict[Any, List[dict]] = {}
    for r in runs:
        by_name.setdefault(r["name"], []).append(r)
    solns = {job.name: job_solution(read_time, job,
                                    by_name.get(job.name, []))
             for job in jobs}
    return {
        "valid": all(s["valid"] for s in solns.values()),
        "jobs": solns,
        "extra": [r for s in solns.values() for r in (s["extra"] or [])],
        "incomplete": [r for s in solns.values() for r in s["incomplete"]],
        "read-time": read_time,
    }


class ChronosChecker(Checker):
    """History checker: 'add-job' ok ops carry Job values; the final ok
    'read' carries {'time': read_time, 'runs': [{'name','start','end'}]}
    (chronos/checker.clj:212+)."""

    def check(self, test, history, opts=None):
        jobs = [op.value for op in history
                if op.f == "add-job" and op.is_ok]
        final = None
        for op in history:
            if op.f == "read" and op.is_ok and op.value is not None:
                final = op.value
        if final is None:
            return {"valid": "unknown", "error": "runs were never read"}
        out = solution(final["time"], jobs, final["runs"])
        out["valid"] = bool(out["valid"])
        return out


def chronos_checker() -> ChronosChecker:
    return ChronosChecker()


class ChronosClient(client_ns.Client):
    """Job registration over the chronos HTTP API
    (chronos.clj add-job! posts ISO8601 schedules)."""

    def __init__(self, node=None, port: int = 4400, timeout: float = 10.0):
        self.node = node
        self.port = port
        self.timeout = timeout

    def open(self, test, node):
        return ChronosClient(node, self.port, self.timeout)

    def _url(self, path):
        node = str(self.node)
        authority = node if ":" in node else f"{node}:{self.port}"
        return f"http://{authority}{path}"

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "add-job":
                j: Job = op.value
                body = json.dumps({
                    "name": str(j.name),
                    "schedule": f"R{j.count}/"
                                f"{_iso(j.start)}/PT{int(j.interval)}S",
                    "epsilon": f"PT{int(j.epsilon)}S",
                    "command": f"sleep {int(j.duration)}",
                }).encode()
                req = urllib.request.Request(
                    self._url("/scheduler/iso8601"), data=body,
                    method="POST",
                    headers={"Content-Type": "application/json"})
                urllib.request.urlopen(req, timeout=self.timeout)
                return op.replace(type="ok")
            if op.f == "read":
                with urllib.request.urlopen(
                        self._url("/scheduler/jobs"),
                        timeout=self.timeout) as resp:
                    json.loads(resp.read().decode())
                # run logs come from the run-capture files on nodes; the
                # in-memory fake (tests) returns them directly
                return op.replace(type="ok",
                                  value={"time": clock(), "runs": []})
            raise ValueError(f"unknown op {op.f!r}")
        except (OSError, TimeoutError) as e:
            crash = "fail" if op.f == "read" else "info"
            return op.replace(type=crash, error=type(e).__name__)


def _iso(posix: float) -> str:
    import datetime
    return (datetime.datetime.fromtimestamp(posix, datetime.timezone.utc)
            .strftime("%Y-%m-%dT%H:%M:%SZ"))


# ---------------------------------------------------------------------------
# Cluster DB, run capture, nemesis, test builder (chronos.clj)
# ---------------------------------------------------------------------------

#: docs say 8080 but the package binds to 4400 by default (chronos.clj:25)
PORT = 4400
JOB_DIR = "/tmp/chronos-test/"


def run_command(job: Job) -> str:
    """The shell command a run executes: log job name + start, sleep for
    the duration, log the end (chronos.clj command, :112-119). The run
    logfiles under JOB_DIR are what read_runs harvests."""
    return (f"MEW=$(mktemp -p {JOB_DIR}); "
            f"echo \"{job.name}\" >> $MEW; "
            f"date -u -Ins >> $MEW; "
            f"sleep {int(job.duration)}; "
            f"date -u -Ins >> $MEW;")


def parse_file_time(t):
    """ISO8601 with comma fractional seconds -> POSIX seconds
    (chronos.clj parse-file-time: date emits commas in some locales)."""
    if not t:
        return None
    import datetime
    t = t.strip().replace(",", ".")
    # `date -u -Ins` appends +00:00; fromisoformat handles it. Python
    # < 3.11 only accepts exactly 3 or 6 fractional digits, so normalize
    # the fraction to microseconds: trim nanosecond tails AND right-pad
    # short fractions like ".5" (comma-locale dates) to six digits.
    import re as _re
    t = _re.sub(r"\.(\d+)",
                lambda m: "." + m.group(1)[:6].ljust(6, "0"), t, count=1)
    return datetime.datetime.fromisoformat(t).timestamp()


def parse_file(node, file_str: str) -> dict:
    """One run logfile: name, start, end lines (chronos.clj parse-file)."""
    parts = (file_str.split("\n") + [None, None, None])[:3]
    name, start, end = parts
    return {"node": node, "name": int(name),
            "start": parse_file_time(start),
            "end": parse_file_time(end)}


def read_runs(test: dict) -> List[dict]:
    """All runs from all nodes: cat every JOB_DIR logfile over the
    control plane (chronos.clj read-runs, c/on-many + cu/ls-full)."""
    from jepsen_tpu_torch.control import on_nodes
    from jepsen_tpu_torch.control import util as cu

    def per_node(t, node):
        try:
            files = cu.ls_full(t, node, JOB_DIR)
        except Exception:  # noqa: BLE001 — node may be down/partitioned
            return []
        out = []
        for path in files:
            try:
                from jepsen_tpu_torch import control
                out.append(parse_file(node,
                                      control.exec(t, node, "cat", path)))
            except Exception:  # noqa: BLE001
                continue
        return out
    by_node = on_nodes(test, per_node)
    return [r for runs in by_node.values() for r in runs]


class ChronosDB:
    """Chronos over the mesos cluster (chronos.clj db, :57-83): mesos+ZK
    substrate, chronos package, lowered scheduler horizon, service
    start/stop, log capture."""

    def __init__(self, mesos_version: str = "0.23.0-1.0.debian81",
                 chronos_version: str = "2.3.4-1.0.81.debian77"):
        from jepsen_tpu_torch.suites.mesosphere import MesosDB
        self.mesos = MesosDB(mesos_version)
        self.chronos_version = chronos_version

    def setup(self, test, node):
        from jepsen_tpu_torch import control
        from jepsen_tpu_torch.os import debian
        self.mesos.setup(test, node)
        debian.install(test, node, {"chronos": self.chronos_version})
        with control.sudo():
            # lower the scheduler horizon, else chronos forgets frequent
            # tasks (chronos.clj configure, :41-46)
            control.execute(
                test, node,
                "echo 1 > /etc/chronos/conf/schedule_horizon")
            control.exec(test, node, "mkdir", "-p", JOB_DIR)
        start_chronos(test, node)

    def teardown(self, test, node):
        from jepsen_tpu_torch import control
        from jepsen_tpu_torch.control import util as cu
        with control.sudo():
            try:
                control.exec(test, node, "service", "chronos", "stop")
            except control.RemoteError:
                pass
            try:
                cu.grepkill(test, node, "/usr/bin/chronos")
            except control.RemoteError:
                pass
        self.mesos.teardown(test, node)
        with control.sudo():
            control.execute(test, node, f"rm -rf {JOB_DIR}")
            control.execute(test, node,
                            "truncate --size 0 /var/log/messages || true")

    def log_files(self, test, node):
        return self.mesos.log_files(test, node) + ["/var/log/messages"]


def start_chronos(test, node) -> None:
    """Start chronos if not already running (chronos.clj start!, :48-55)."""
    from jepsen_tpu_torch import control
    with control.sudo():
        try:
            control.exec(test, node, "service", "chronos", "status")
        except control.RemoteError:
            control.exec(test, node, "service", "chronos", "start")


class ResurrectionHub:
    """Nemesis wrapper: mesos and chronos crash all the time; an
    f='resurrect' op restarts mesos master+slave and chronos on every
    node, any other op is delegated to the wrapped nemesis
    (chronos.clj resurrection-hub, :220-238)."""

    def __init__(self, nemesis):
        self.nemesis = nemesis

    def setup(self, test):
        self.nemesis = self.nemesis.setup(test)
        return self

    def invoke(self, test, op):
        if op.f != "resurrect":
            return self.nemesis.invoke(test, op)
        from jepsen_tpu_torch.control import on_nodes
        from jepsen_tpu_torch.suites import mesosphere

        def revive(t, node):
            mesosphere.start_master(t, node)
            mesosphere.start_slave(t, node)
            start_chronos(t, node)
        on_nodes(test, revive)
        return op.replace(value="resurrection-complete")

    def teardown(self, test):
        self.nemesis.teardown(test)


def add_job_gen(seed: Optional[int] = None):
    """Generator of add-job invocations (chronos.clj add-job, :194-218):
    runs never overlap because the interval exceeds
    duration + epsilon + forgiveness."""
    import random

    rng = random.Random(seed)
    counter = {"id": 0}

    def op_fn(test=None, process=None):
        head_start = 10  # schedule a bit in the future
        duration = rng.randrange(10)
        epsilon = 10 + rng.randrange(20)
        interval = (1 + duration + epsilon + EPSILON_FORGIVENESS
                    + rng.randrange(30))
        counter["id"] += 1
        return Op(type="invoke", f="add-job",
                  value=Job(name=counter["id"],
                            start=clock() + head_start,
                            interval=interval,
                            count=1 + rng.randrange(99),
                            epsilon=epsilon,
                            duration=duration))
    return gen.gen(op_fn)


class ChronosRunsClient(ChronosClient):
    """ChronosClient whose final read harvests the run logfiles from the
    nodes over the control plane (chronos.clj Client :read ->
    read-runs)."""

    def open(self, test, node):
        return ChronosRunsClient(node, self.port, self.timeout)

    def invoke(self, test, op: Op) -> Op:
        if op.f == "read":
            try:
                runs = read_runs(test)
            except Exception as e:  # noqa: BLE001
                return op.replace(type="fail", error=repr(e)[:100])
            return op.replace(type="ok",
                              value={"time": clock(), "runs": runs})
        return super().invoke(test, op)


def _nemesis_cycle():
    """Partition, heal, then restart mesos and chronos everywhere, every
    2 x NEMESIS_SLEEP_S seconds (chronos.clj:252-258)."""
    while True:
        yield gen.sleep(NEMESIS_SLEEP_S)
        yield gen.once({"type": "info", "f": "start"})
        yield gen.sleep(NEMESIS_SLEEP_S)
        yield gen.once({"type": "info", "f": "stop"})
        yield gen.once({"type": "info", "f": "resurrect"})


def chronos_test(opts: dict) -> dict:
    """simple-test (chronos.clj:240-270): create jobs on a stagger, let
    them run under a start/stop/resurrect nemesis cycle, then a final
    read of which runs happened, checked by the CSP-equivalent matcher."""
    from jepsen_tpu_torch import nemesis as nem
    from jepsen_tpu_torch.os import debian

    test = noop_test()
    time_limit = opts.get("time-limit", 450)

    test.update({
        "name": "chronos",
        "os": debian.os(),
        "db": ChronosDB(opts.get("mesos-version", "0.23.0-1.0.debian81"),
                        opts.get("chronos-version",
                                 "2.3.4-1.0.81.debian77")),
        "client": ChronosRunsClient(),
        "nemesis": ResurrectionHub(nem.partition_random_halves()),
        "checker": chronos_checker(),
        "generator": gen.phases(
            gen.time_limit(
                time_limit,
                gen.clients(
                    gen.stagger(JOB_STAGGER_S,
                                gen.delay(JOB_STAGGER_S, add_job_gen())),
                    gen.seq(_nemesis_cycle()))),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.nemesis(gen.once({"type": "info", "f": "resurrect"})),
            gen.clients(gen.once({"type": "invoke", "f": "read"}))),
    })
    test.update({k: v for k, v in opts.items()
                 if k in ("nodes", "concurrency", "ssh", "time-limit",
                          "store-dir", "store-root", "net")})
    return test


def main(argv=None):
    """The reference's command line: ``test`` runs :func:`chronos_test`,
    ``serve`` the results browser (``python -m
    jepsen_tpu_torch.suites.chronos test|serve ...``)."""
    from jepsen_tpu_torch import cli
    cli.main(cli.merge_commands(cli.single_test_cmd(chronos_test),
                                cli.serve_cmd()), argv)


if __name__ == "__main__":
    main()
