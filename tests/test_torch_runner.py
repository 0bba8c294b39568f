"""The port's test runner against the JAX package's, on the CPU.

``core.run`` of the atom test (500 ops, the checker's kernels on their
plain versions with ``device="cpu"``) is valid, and its history, checked
by the reference's ``check_history_tpu`` on JAX's CPU, gives the same
verdict, levels and max-linearized-prefix, as does a copy with one read
corrupted. The recorded history is in time order with its WAL's ops, its
artifacts are the reference's set, and a client crash reincarnates its
process. ``Compose``, ``perf`` (``latency.json``, ``rate.json`` and the
SVGs, byte for byte) and ``check_safe`` give the reference's results on
the same histories. ``analyze`` and ``recover`` (``python -m
jepsen_tpu_torch`` with ``--device cpu``) give the reference command
line's exit codes and verdicts (``--backend tpu`` on JAX's CPU) on valid,
invalid, missing, done and dead stores.
"""

import json
import os
import random
import subprocess
import sys

import pytest
import torch

from jepsen_tpu import cli as jcli
from jepsen_tpu import store as js
from jepsen_tpu.checker import check_safe as j_check_safe
from jepsen_tpu.checker import compose as j_compose
from jepsen_tpu.checker import FnChecker as JFn
from jepsen_tpu.checker import noop_checker as j_noop
from jepsen_tpu.checker.perf import perf as j_perf
from jepsen_tpu.checker.tpu import check_history_tpu
from jepsen_tpu.checker.wgl import linearizable as j_linearizable
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.models import CASRegister as JCASRegister

from jepsen_tpu_torch import core, journal, store
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.__main__ import main as port_main
from jepsen_tpu_torch.checker import (FnChecker, check_safe, compose,
                                      linearizable, noop_checker, perf)
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.testing import (AtomClient, SharedRegister, atom_test,
                                      corrupt_one_read,
                                      simulate_register_history)

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("valid", "levels", "max-linearized-prefix")


def _jax(h) -> JHistory:
    return JHistory.of(o.to_dict() for o in h)


def _corrupt(h, seed0=0) -> History:
    for seed in range(seed0, seed0 + 100):
        bad = corrupt_one_read(h, random.Random(seed))
        if [o.value for o in bad] != [o.value for o in h]:
            return bad
    raise AssertionError("no read to corrupt")


@pytest.fixture(scope="module")
def atom_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("store")
    return core.run(atom_test(
        checker=linearizable(CASRegister(), device="cpu"),
        generator=gen.clients(gen.limit(500, gen.cas_gen())),
        **{"store-root": str(root)}))


def test_atom_run_is_valid_and_matches_the_reference(atom_run):
    res = atom_run["results"]
    assert res["valid"] is True and res["backend"] == "gpu"
    assert "fallback-from" not in res and "error" not in res
    h = atom_run["history"]
    assert len(h) == 1000 and [o.index for o in h] == list(range(1000))
    for hh in (h, _corrupt(h)):
        ours = linearizable(CASRegister(), device="cpu").check({}, hh)
        ref = check_history_tpu(_jax(hh), JCASRegister())
        assert {k: ours.get(k) for k in KEYS} == \
            {k: ref.get(k) for k in KEYS}
    assert ours["valid"] is False


def test_atom_run_artifacts_and_time_order(atom_run):
    d = atom_run["store-dir"]
    for name in ("history.jsonl", "history.txt", "history.wal",
                 "results.json", "run.state", "test.json", "jepsen.log",
                 "trace.jsonl", "metrics.json", "searchstats.json",
                 "progress.json"):
        assert os.path.exists(os.path.join(d, name)), name
    assert store.read_state(d)["state"] == "done"
    h = atom_run["history"]
    times = [o.time for o in h]
    assert times == sorted(times)
    wal, stats = journal.read_wal(os.path.join(d, journal.WAL_NAME))
    assert stats == {"records": 1000, "torn": 0, "corrupt": 0}
    # the WAL holds the same ops, in the order they were appended
    key = (lambda o: (o.time, o.process, o.type))
    assert sorted(map(key, wal)) == sorted(map(key, h))
    # each process: invoke, completion, invoke, ... in time order
    for p in h.processes():
        types = [o.type for o in h if o.process == p]
        assert types[0::2] == ["invoke"] * (len(types) // 2)
    loaded = js.load(d)
    assert [o.to_dict() for o in loaded["history"]] == \
        json.loads(json.dumps([o.to_dict() for o in h]))
    assert loaded["results"]["valid"] is True


class _CrashingClient(AtomClient):
    """Every seventh write raises after it applied: an indeterminate op."""

    def __init__(self, register, counter=None):
        super().__init__(register)
        self.counter = counter if counter is not None else [0]

    def open(self, test, node):
        return _CrashingClient(self.register, self.counter)

    def invoke(self, test, op):
        out = super().invoke(test, op)
        if op.f == "write":
            self.counter[0] += 1
            if self.counter[0] % 7 == 0:
                raise ConnectionError("lost the reply")
        return out


def test_a_crashed_op_reincarnates_its_process(tmp_path):
    reg = SharedRegister()
    t = core.run(atom_test(
        reg, client=_CrashingClient(reg), concurrency=3,
        checker=linearizable(CASRegister(), device="cpu"),
        generator=gen.clients(gen.limit(200, gen.cas_gen())),
        **{"store-dir": str(tmp_path / "run")}))
    h = t["history"]
    infos = [o for o in h if o.type == "info"]
    assert infos and all("ConnectionError" in o.error for o in infos)
    assert max(o.process for o in h) >= 3   # p + concurrency
    assert t["results"]["valid"] is True
    ref = check_history_tpu(_jax(h), JCASRegister())
    assert {k: t["results"].get(k) for k in KEYS} == \
        {k: ref.get(k) for k in KEYS}


# -- Compose, perf and check_safe -----------------------------------------


def perf_history() -> History:
    """A register history over 45 s with crashed ops and two nemesis
    windows: several latency and rate buckets."""
    h = simulate_register_history(300, n_procs=4, n_vals=5, seed=9,
                                  crash_p=0.05)
    out = History()
    for i, o in enumerate(h):
        out.append(o.replace(time=i * 75_000_000))
    for t, f in ((5e9, "start"), (5.1e9, "start"), (20e9, "stop"),
                 (20.2e9, "stop"), (30e9, "start"), (30.1e9, "start")):
        out.append(Op(type="info", f=f, value=None, process="nemesis",
                      time=int(t)))
    out.sort(key=lambda o: o.time)
    return out.index()


def test_perf_artifacts_are_the_references(tmp_path):
    h = perf_history()
    mine, theirs = tmp_path / "port", tmp_path / "ref"
    got = perf().check({"store-dir": str(mine)}, h)
    want = j_perf().check({"store-dir": str(theirs)}, _jax(h))
    assert got == want
    for name in ("latency.json", "rate.json", "latency-quantiles.svg",
                 "rate.svg"):
        assert (mine / name).read_bytes() == (theirs / name).read_bytes()
    lat = json.loads((mine / "latency.json").read_text())
    assert len(lat["nemesis"]) == 2 and lat["points"]


def test_compose_is_the_references(tmp_path):
    h = perf_history()
    bad = _corrupt(h)

    def count(test, history, opts):
        return {"valid": len(history) > 0, "n": len(history)}

    for hh in (h, bad):
        got = compose({"linear": linearizable(CASRegister(), backend="cpu"),
                       "perf": perf(), "noop": noop_checker(),
                       "n": FnChecker(count)}).check({}, hh)
        want = j_compose({"linear": j_linearizable(JCASRegister(),
                                                   backend="cpu"),
                          "perf": j_perf(), "noop": j_noop(),
                          "n": JFn(count)}).check({}, _jax(hh))
        assert got == want
    assert got["valid"] is False and got["linear"]["valid"] is False


def test_check_safe_is_the_references():
    class Boom:
        def check(self, *a):
            raise ConnectionResetError("boom")
    got = check_safe(Boom(), {}, History())
    want = j_check_safe(Boom(), {}, JHistory())
    assert got.keys() == want.keys()
    assert got["valid"] == want["valid"] == "unknown"
    assert got["error-class"] == want["error-class"]
    assert "boom" in got["error"]
    # one failing part: the composition is unknown, the others still run
    got = compose({"boom": Boom(), "noop": noop_checker()}).check(
        {}, History())
    assert got["valid"] == "unknown" and got["noop"] == {"valid": True}


# -- analyze and recover against the reference command line -------------


def _store_run(root, name, history, state="done", pid=None):
    """A stored run of ``history`` (and its WAL); ``state`` and ``pid``
    set its run.state."""
    test = {"name": name, "store-root": str(root), "concurrency": 5,
            "history": History.of(o.to_dict() for o in history).index(),
            "results": {"valid": True}}
    store.save_1(test)
    store.save_2(test)
    d = test["store-dir"]
    with open(os.path.join(d, journal.WAL_NAME), "wb") as f:
        for o in history:
            f.write(journal.encode_record(o))
    store.write_state(d, state)
    if pid is not None:
        with open(os.path.join(d, store.RUN_STATE)) as f:
            doc = json.load(f)
        doc["pid"] = pid
        with open(os.path.join(d, store.RUN_STATE), "w") as f:
            json.dump(doc, f)
    return d


def _dead_pid() -> int:
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait(timeout=60)
    return p.pid


def _verdict(out: str):
    """The JSON result analyze prints last."""
    i = out.index("\n{") + 1 if not out.startswith("{") else 0
    return json.loads(out[i:])


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """valid, invalid and dead stored runs (the dead one with two dangling
    invokes in its WAL), each under its own root, for both packages."""
    base = tmp_path_factory.mktemp("cli")
    h = simulate_register_history(200, n_procs=5, n_vals=8, seed=21,
                                  crash_p=0.01)
    dead_h = History(list(h) + [
        Op(type="invoke", f="write", value=3, process=90, time=10**12),
        Op(type="invoke", f="read", value=None, process=91,
           time=10**12 + 1)])
    out = {}
    for pkg in ("port", "ref"):
        root = base / pkg
        out[pkg] = {
            "valid": _store_run(root / "v", "valid", h),
            "invalid": _store_run(root / "i", "invalid", _corrupt(h)),
            "dead-root": str(root / "d"),
            "dead": _store_run(root / "d", "dead", dead_h,
                               state="running", pid=_dead_pid()),
        }
    return out


def _port(capsys, *args):
    rc = port_main(list(args) + ["--device", "cpu"])
    return rc, capsys.readouterr().out


def _ref(capsys, cmd, *args):
    rc = jcli.run(cmd, list(args) + ["--backend", "tpu"])
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("which,rc", [("valid", 0), ("invalid", 1)])
def test_analyze_exit_codes_and_verdicts(stores, capsys, which, rc):
    prc, pout = _port(capsys, "analyze", "--store", stores["port"][which])
    rrc, rout = _ref(capsys, jcli.analyze_cmd(), "analyze", "--store",
                     stores["ref"][which])
    assert prc == rrc == rc
    got, want = _verdict(pout), _verdict(rout)
    assert {k: got.get(k) for k in KEYS} == {k: want.get(k) for k in KEYS}
    assert got["backend"] == "gpu" and "fallback-from" not in got
    head = [ln.split(":")[0] for ln in pout.splitlines()
            if ln.startswith("# ")]
    assert head[:2] == ["# lint", "# plan"]
    assert head[-2:] == ["# compile", "# search"]
    assert "# contention" in head
    # the lint and contention lines are the reference's
    for prefix in ("# lint", "# contention"):
        assert [ln for ln in pout.splitlines() if ln.startswith(prefix)] \
            == [ln for ln in rout.splitlines() if ln.startswith(prefix)]


def test_analyze_a_missing_store(stores, capsys, tmp_path):
    missing = str(tmp_path / "nope")
    assert _port(capsys, "analyze", "--store", missing)[0] == 254
    assert _ref(capsys, jcli.analyze_cmd(), "analyze", "--store",
                missing)[0] == 254


def test_recover_agrees_with_the_reference(stores, capsys, tmp_path):
    # a done run: nothing to recover, exit 0; a missing one: 254
    for pkg_args in (("--store", "valid"),):
        prc, pout = _port(capsys, "recover", "--store",
                          stores["port"]["valid"])
        rrc, rout = _ref(capsys, jcli.recover_cmd(), "recover", "--store",
                         stores["ref"]["valid"])
        assert prc == rrc == 0 and "nothing to recover" in pout
    missing = str(tmp_path / "nope")
    assert _port(capsys, "recover", "--store", missing)[0] == 254
    assert _ref(capsys, jcli.recover_cmd(), "recover", "--store",
                missing)[0] == 254
    # the dead run, found by a scan of its root
    prc, pout = _port(capsys, "recover", "--store-root",
                      stores["port"]["dead-root"])
    rrc, rout = _ref(capsys, jcli.recover_cmd(), "recover", "--store-root",
                     stores["ref"]["dead-root"])
    assert prc == rrc == 0, (pout, rout)
    assert "2 dangling invoke(s) -> info" in pout
    for pkg in ("port", "ref"):
        st = js.read_state(stores[pkg]["dead"])
        assert st["state"] == "done" and st["recovered"] is True
    got = js.load(stores["port"]["dead"])
    want = store.load(stores["ref"]["dead"])
    assert got["results"]["valid"] is want["results"]["valid"] is True
    assert got["results"]["levels"] == want["results"]["levels"]
    assert got["results"]["backend"] == "gpu"
    # nothing left to recover
    assert _port(capsys, "recover", "--store-root",
                 stores["port"]["dead-root"])[1].strip() == \
        "# recovery: no dead runs found"


def test_the_commands_run_as_a_module(tmp_path):
    """``python -m jepsen_tpu_torch run`` in its own process refuses
    ``--fleet`` (254, naming the roadmap item) before any work."""
    p = subprocess.run([sys.executable, "-m", "jepsen_tpu_torch", "run",
                        "--suite", "local-kv", "--fleet", "2"],
                       cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 254 and "A7" in p.stderr
    assert not os.path.exists(tmp_path / "store")
    assert port_main(["run", "--suite", "local-kv", "--watch"]) == 254
    assert port_main(["run", "--suite", "nope"]) == 254
