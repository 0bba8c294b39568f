"""The chronos suite of the port, held against the reference on the CPU.

The schedule checker of both packages gives the same verdict, per-job
solutions, extra and incomplete runs on histories made from seeded numpy
(runs on time, late within the forgiveness, too late, missing, doubled,
still going; a read that never succeeded). The small functions, the
command logs of the mesos and chronos lifecycle and of the resurrection
nemesis under the dummy control plane are the reference's. Last, whole
runs through ``python -m jepsen_tpu_torch run --suite chronos --ssh-mode
dummy`` against ``tools/torch_suite_fakes.py``'s chronos fake, its clock
ten times the wall clock's pace: valid, and invalid on the job whose due
run the fake drops or delays.
"""

import io
import json
import os
import sys
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from jepsen_tpu.history import Op as JOp
from jepsen_tpu.suites import chronos as j_chronos

from jepsen_tpu_torch import control, suites
from jepsen_tpu_torch.__main__ import main
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.suites import chronos

from test_torch_suite_substrate import both_logs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import torch_suite_fakes as fakes  # noqa: E402

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

NODES = ["n1", "n2", "n3", "n4", "n5"]


# ---------------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------------

#: what happens to a target's run in a generated history
KINDS = ("on-time", "late", "too-late", "missing", "doubled", "going")


def make_case(seed):
    """Jobs, runs and a read time from seeded numpy: each target of each
    job gets one of KINDS, and a few runs of no target are thrown in."""
    rng = np.random.default_rng(seed)
    read = 10_000.0
    jobs, runs = [], []
    for name in range(1, int(rng.integers(1, 5)) + 1):
        duration = int(rng.integers(0, 10))
        epsilon = 10 + int(rng.integers(0, 20))
        interval = (1 + duration + epsilon + chronos.EPSILON_FORGIVENESS
                    + int(rng.integers(0, 30)))
        count = int(rng.integers(1, 12))
        start = read - float(rng.uniform(20, 400))
        job = dict(name=name, start=start, interval=interval, count=count,
                   epsilon=epsilon, duration=duration)
        jobs.append(job)
        for k in range(count):
            t = start + k * interval
            kind = KINDS[int(rng.integers(0, len(KINDS)))]
            if kind == "missing" or t > read:
                continue
            late = {"on-time": float(rng.uniform(0, epsilon)),
                    "late": epsilon + float(rng.uniform(
                        0, chronos.EPSILON_FORGIVENESS)),
                    "too-late": epsilon + chronos.EPSILON_FORGIVENESS
                    + float(rng.uniform(1, 10))}.get(kind, 0.5)
            begin = t + late
            end = None if kind == "going" else begin + duration
            runs.append({"node": f"n{1 + k % 5}", "name": name,
                         "start": begin, "end": end})
            if kind == "doubled":
                runs.append({"node": "n5", "name": name,
                             "start": begin + 0.25, "end": end})
        for _ in range(int(rng.integers(0, 3))):
            begin = start + float(rng.uniform(0, count * interval))
            runs.append({"node": "n2", "name": name, "start": begin,
                         "end": begin + duration})
    order = rng.permutation(len(runs))
    return jobs, [runs[i] for i in order], read


def history(mod, op_cls, jobs, runs, read, read_ok=True):
    h = []
    for j in jobs:
        job = mod.Job(**j)
        h.append(op_cls(type="invoke", f="add-job", value=job, process=0))
        h.append(op_cls(type="ok", f="add-job", value=job, process=0))
    h.append(op_cls(type="invoke", f="read", value=None, process=1))
    if read_ok:
        h.append(op_cls(type="ok", f="read", process=1, value={
            "time": read, "runs": [dict(r) for r in runs]}))
    else:
        h.append(op_cls(type="fail", f="read", process=1, value=None,
                        error="ConnectionRefusedError"))
    return h


def _run(r):
    return None if r is None else (r["name"], r["start"], r["end"],
                                   r["node"])


def normalized(out):
    """A checker result with Jobs as field dicts, runs as tuples and each
    solution as a sorted list of (target, run)."""
    if "jobs" not in out:
        return out
    jobs = {}
    for name, s in out["jobs"].items():
        jobs[name] = {
            "valid": s["valid"], "job": vars(s["job"]),
            "solution": (None if s["solution"] is None else sorted(
                (t, _run(r)) for t, r in s["solution"].items())),
            "extra": (None if s["extra"] is None
                      else [_run(r) for r in s["extra"]]),
            "complete": [_run(r) for r in s["complete"]],
            "incomplete": [_run(r) for r in s["incomplete"]]}
    return {"valid": out["valid"], "jobs": jobs,
            "extra": [_run(r) for r in out["extra"]],
            "incomplete": [_run(r) for r in out["incomplete"]],
            "read-time": out["read-time"]}


@pytest.mark.parametrize("seed", range(40))
def test_the_checker_is_the_references(seed):
    jobs, runs, read = make_case(seed)
    ref = j_chronos.ChronosChecker().check(
        {}, history(j_chronos, JOp, jobs, runs, read))
    got = chronos.ChronosChecker().check(
        {}, history(chronos, Op, jobs, runs, read))
    assert normalized(got) == normalized(ref)


def test_the_cases_cover_both_verdicts_and_every_kind_of_run():
    outs = [chronos.ChronosChecker().check(
        {}, history(chronos, Op, *make_case(seed))) for seed in range(40)]
    assert {o["valid"] for o in outs} == {True, False}
    assert any(o["incomplete"] for o in outs)
    assert any(o["extra"] for o in outs)
    assert any(s["solution"] for o in outs for s in o["jobs"].values())


def test_a_read_that_never_succeeded_is_unknown_as_in_the_reference():
    jobs, runs, read = make_case(3)
    ref = j_chronos.ChronosChecker().check(
        {}, history(j_chronos, JOp, jobs, runs, read, read_ok=False))
    got = chronos.ChronosChecker().check(
        {}, history(chronos, Op, jobs, runs, read, read_ok=False))
    assert got == ref == {"valid": "unknown",
                          "error": "runs were never read"}


# ---------------------------------------------------------------------------
# the small functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_job_targets_are_the_references(seed):
    jobs, _, read = make_case(seed)
    for j in jobs:
        for t in (read, read - 30, j["start"], j["start"] - 1):
            assert chronos.job_targets(t, chronos.Job(**j)) == \
                j_chronos.job_targets(t, j_chronos.Job(**j))


@pytest.mark.parametrize("text", [
    "2026-10-18T13:33:46,123456789+00:00",
    "2026-10-18T13:33:46,5+00:00",
    "2026-10-18T13:33:46.25+00:00",
    "2026-10-18T13:33:46+00:00",
    "  2026-10-18T13:33:46,000001234+00:00\n", "", None])
def test_parse_file_time_is_the_references(text):
    assert chronos.parse_file_time(text) == j_chronos.parse_file_time(text)


@pytest.mark.parametrize("body", [
    "7\n2026-10-18T13:33:46,5+00:00\n2026-10-18T13:33:49,500000000+00:00",
    "12\n2026-10-18T13:33:46,123456789+00:00",
    "3"])
def test_parse_file_is_the_references(body):
    assert chronos.parse_file("n2", body) == j_chronos.parse_file("n2", body)


def test_run_command_is_the_references():
    for j in (dict(name=1, start=0.0, interval=60, count=3, epsilon=15,
                   duration=4), dict(name=42, start=5.5, interval=30,
                                     count=1, epsilon=10, duration=0)):
        assert chronos.run_command(chronos.Job(**j)) == \
            j_chronos.run_command(j_chronos.Job(**j))


@pytest.mark.parametrize("seed", [0, 1, 99])
def test_add_job_gen_is_the_references(seed, monkeypatch):
    now = 1_700_000_000.5
    monkeypatch.setattr(time, "time", lambda: now)
    monkeypatch.setattr(chronos, "clock", lambda: now)
    ref, got = j_chronos.add_job_gen(seed), chronos.add_job_gen(seed)
    for _ in range(20):
        a, b = ref.op({}, 0), got.op({}, 0)
        assert (b.type, b.f, vars(b.value)) == (a.type, a.f, vars(a.value))


def test_the_test_map_is_the_references():
    opts = {"nodes": NODES, "time-limit": 30, "concurrency": 5}
    ref, got = j_chronos.chronos_test(opts), chronos.chronos_test(opts)
    assert sorted(got) == sorted(ref)
    for k in ("name", "nodes", "time-limit", "concurrency"):
        assert got[k] == ref[k]
    for k in ("db", "client", "nemesis", "checker"):
        assert type(got[k]).__name__ == type(ref[k]).__name__
    assert (got["db"].chronos_version, got["db"].mesos.version) == \
        (ref["db"].chronos_version, ref["db"].mesos.version)
    assert suites.SUITES["chronos"] == ("chronos", "chronos_test")


# ---------------------------------------------------------------------------
# the command logs
# ---------------------------------------------------------------------------

def _on_all(db_fn):
    def call(t):
        for node in NODES:
            db_fn(t, node)
    return call


LIFECYCLES = {
    "setup": lambda m: _on_all(lambda t, n: m.ChronosDB().setup(t, n)),
    "teardown": lambda m: _on_all(
        lambda t, n: m.ChronosDB().teardown(t, n)),
    "chronos down": lambda m: _on_all(m.start_chronos),
}


@pytest.mark.parametrize("name", sorted(LIFECYCLES))
def test_each_lifecycle_logs_the_reference_commands(name):
    # "service chronos status" fails in the last case: chronos starts
    responses = ({"service chronos status": (3, "", "stopped")}
                 if name == "chronos down" else {})
    logs = both_logs(LIFECYCLES[name](j_chronos), LIFECYCLES[name](chronos),
                     responses)
    if name == "setup":
        # mesos masters on the first three nodes, slaves on the rest
        for node, cmds in logs.items():
            text = "\n".join(cmds)
            master = node in ("n1", "n2", "n3")
            assert ("/usr/sbin/mesos-master" in text) == master, node
            assert ("/usr/sbin/mesos-slave" in text) == (not master), node


def test_the_log_files_are_the_references():
    from jepsen_tpu import control as j_control
    for ctl, mod in ((j_control, j_chronos), (control, chronos)):
        t = {"nodes": NODES, "ssh": {"mode": "dummy", "dummy-responses": {
            "ls -A": "master.INFO\nslave.INFO"}}}
        with ctl.session_pool(t):
            out = mod.ChronosDB().log_files(t, "n4")
        if mod is j_chronos:
            ref = out
    assert out == ref and "/var/log/messages" in out


def test_the_resurrection_hub_logs_the_reference_commands():
    def run(mod, op_cls):
        def call(t):
            hub = mod.ResurrectionHub(_Recorder()).setup(t)
            out = hub.invoke(t, op_cls(type="info", f="resurrect",
                                       process="nemesis"))
            assert out.value == "resurrection-complete"
            assert hub.invoke(t, op_cls(type="info", f="start",
                                        process="nemesis")).value == "start"
            assert hub.nemesis.seen == ["start"]
        return call
    logs = both_logs(run(j_chronos, JOp), run(chronos, Op))
    for node, cmds in logs.items():
        assert any("chronos" in c for c in cmds), node


class _Recorder:
    """A nemesis that records the ops delegated to it."""

    def __init__(self):
        self.seen = []

    def setup(self, test):
        return self

    def invoke(self, test, op):
        self.seen.append(op.f)
        return op.replace(value=op.f)

    def teardown(self, test):
        pass


# ---------------------------------------------------------------------------
# whole runs against the fake
# ---------------------------------------------------------------------------

#: the fake's clock runs this many times the wall clock's pace: slow
#: enough that a run due 8 clock seconds before the read (the least slack
#: of a constrained target) is on its node when the read lists the runs
PACE = 10.0
#: the runs' time limit, wall seconds: 60 of the fake's clock, past the
#: first job's first deadline (at most 48 s after it is added)
RUN_S = 6


@pytest.fixture
def fast_clock(monkeypatch):
    """The suite's clock at PACE times the wall clock, the job stagger at
    0.1 s and the nemesis sleeps at 0.5 s; returns the clock."""
    t0 = time.time()

    def clock():
        return t0 + (time.time() - t0) * PACE
    monkeypatch.setattr(chronos, "clock", clock)
    monkeypatch.setattr(chronos, "JOB_STAGGER_S", 0.1)
    monkeypatch.setattr(chronos, "NEMESIS_SLEEP_S", 0.5)
    return clock


def chronos_run(tmp_path, monkeypatch, clock, fault=None):
    """``run --suite chronos --ssh-mode dummy`` for RUN_S s against a
    fake on ``clock``: the exit code, the results and the fake."""
    fake = fakes.ChronosFake(5, clock=clock, fault=fault, seed=1)
    nodes = fake.start()
    try:
        sessions = fakes.CliFake(nodes, chronos=fake).sessions()
        monkeypatch.setattr(control, "make_session",
                            lambda node, opts: sessions[str(node)])
        args = ["run", "--suite", "chronos", "--ssh-mode", "dummy",
                "--time-limit", str(RUN_S), "--store-root", str(tmp_path)]
        for n in nodes:
            args += ["-n", n]
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = main(args)
    finally:
        fake.stop()
    runs = [d for d in os.listdir(tmp_path / "chronos") if d != "latest"]
    with open(tmp_path / "chronos" / runs[0] / "results.json") as f:
        results = json.load(f)
    return rc, results, fake


def test_a_chronos_run_against_the_fake_is_valid(tmp_path, monkeypatch,
                                                 fast_clock):
    rc, res, fake = chronos_run(tmp_path, monkeypatch, fast_clock)
    assert rc == 0 and res["valid"] is True, res
    assert fake.stats["jobs"] >= 3
    solved = [j for j in res["jobs"].values() if j["solution"]]
    assert solved, "no job had a run due by the read"
    assert all(j["valid"] for j in res["jobs"].values())


@pytest.mark.parametrize("fault", ["drop", "delay"])
def test_a_dropped_or_delayed_run_is_refuted_on_its_job(tmp_path,
                                                        monkeypatch,
                                                        fast_clock, fault):
    rc, res, fake = chronos_run(tmp_path, monkeypatch, fast_clock, fault)
    assert rc == 1 and res["valid"] is False, res
    first = str(next(iter(fake.jobs)))
    assert res["jobs"][first]["valid"] is False
    assert res["jobs"][first]["solution"] is None
    others = [j for n, j in res["jobs"].items() if n != first]
    assert others and all(j["valid"] for j in others)
    assert any(j["solution"] for j in others)
