"""The sqlite suites of the port against the real engine, on the CPU.

Each suite runs the whole ``core.run`` lifecycle with its check on the
kernels' plain versions (``device="cpu"``), at the reference's
end-to-end tests' time limits: the schema set up, workers on real
connections, the lock-hammer nemesis, the store, the check. The register
run is valid under real busy failures; the bank's totals hold; the
toctou schedule's two cas's of the same old value both succeed and are
refuted, with ``linear.svg`` byte for byte the reference's rendering.
Each register history also goes through the reference's
``linearizable(CASRegister())`` and its device search on JAX's CPU, to
the same verdict (and levels and prefix). Every test constructor has a
database file of its own under the temporary directory.
"""

import json
import os
import tempfile

import pytest
import torch

from jepsen_tpu import store as js
from jepsen_tpu.checker.tpu import check_history_tpu
from jepsen_tpu.checker.wgl import linearizable as j_linearizable
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.models import CASRegister as JCASRegister

from jepsen_tpu_torch import core, suites
from jepsen_tpu_torch.suites import sqlitedb
from jepsen_tpu_torch.suites.sqlitedb import (sqlite_bank_test,
                                              sqlite_register_test,
                                              sqlite_register_toctou_test)

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

KEYS = ("valid", "levels", "max-linearized-prefix")


@pytest.fixture
def opts(tmp_path):
    return {"store-root": str(tmp_path / "store"), "device": "cpu",
            "sqlite-path": str(tmp_path / "db" / "test.db")}


def reference_verdicts(out, lin):
    """The reference's facade and its device search on the stored
    history give the port's verdict (and levels and prefix)."""
    jh = js.load(out["store-dir"])["history"]
    ref = j_linearizable(JCASRegister()).check({}, jh)
    assert ref["valid"] == lin["valid"], (ref, lin)
    dev = check_history_tpu(jh, JCASRegister())
    assert {k: dev.get(k) for k in KEYS} == {k: lin.get(k) for k in KEYS}


def on_device_route(lin):
    assert lin["backend"] == "gpu" and "fallback-from" not in lin, lin


def test_register_is_linearizable_under_the_lock_hammer(opts):
    out = core.run(sqlite_register_test(
        {**opts, "time-limit": 6, "nemesis-period": 1.5}))
    lin = out["results"]["linear"]
    assert out["results"]["valid"] is True and lin["valid"] is True
    on_device_route(lin)
    history = out["history"]
    ops = [o for o in history if o.process != "nemesis"]
    assert len(ops) > 100, "the workload should run"
    nem = [o for o in history if o.process == "nemesis"]
    assert any("lock held" in str(o.value) for o in nem), nem
    locked = [o for o in ops if o.type == "fail" and o.error
              and "locked" in str(o.error)]
    assert locked, "the lock hammer produced no busy failures"
    times = [o.time for o in history]
    assert times == sorted(times)      # op-time order
    reference_verdicts(out, lin)


def test_register_store_artifacts(opts):
    out = core.run(sqlite_register_test({**opts, "time-limit": 3}))
    d = out["store-dir"]
    for f in ("history.jsonl", "results.json", "test.json",
              "latency-quantiles.svg", "history.wal", "run.state",
              "trace.jsonl"):
        assert os.path.exists(os.path.join(d, f)), f
    with open(os.path.join(d, "results.json")) as fh:
        results = json.load(fh)
    assert results["valid"] is True
    reference_verdicts(out, results["linear"])


def test_bank_totals_hold(opts):
    out = core.run(sqlite_bank_test(
        {**opts, "time-limit": 6, "nemesis-period": 1.5}))
    assert out["results"]["valid"] is True, out["results"]
    reads = [o for o in out["history"]
             if o.is_ok and o.f == "read" and o.process != "nemesis"]
    assert reads and all(sum(r.value) == 50 for r in reads)
    assert any(o.f == "transfer" and o.is_ok for o in out["history"])


def test_toctou_lost_update_is_refuted(opts, tmp_path):
    out = core.run(sqlite_register_toctou_test(opts))
    assert out["results"]["valid"] is False
    lin = out["results"]["linear"]
    assert lin["valid"] is False and lin["counterexample"] == "linear.svg"
    on_device_route(lin)
    oks = [o for o in out["history"] if o.is_ok and o.f == "cas"]
    assert len(oks) == 2, oks
    assert sorted(o.value for o in oks) == [(0, 1), (0, 2)]
    reference_verdicts(out, lin)
    # the reference renders from the same in-memory history (cas values
    # are tuples there; the stored history's are lists)
    jh = JHistory([JOp(type=o.type, f=o.f, value=o.value, process=o.process,
                       time=o.time, index=o.index, error=o.error)
                   for o in out["history"]])
    theirs = tmp_path / "ref"
    want = j_linearizable(JCASRegister(), backend="tpu").check(
        {"store-dir": str(theirs)}, jh)
    assert want["valid"] is False
    with open(os.path.join(out["store-dir"], "linear.svg"), "rb") as fh:
        assert fh.read() == (theirs / "linear.svg").read_bytes()


def test_database_files_are_per_constructor():
    a = sqlite_register_test({})
    b = sqlite_register_test({})
    c = sqlite_bank_test({})
    paths = {t["sqlite-path"] for t in (a, b, c)}
    assert len(paths) == 3
    root = os.path.join(tempfile.gettempdir(), "jepsen-sqlite")
    assert sqlitedb.RUN_DIR == root
    assert all(p.startswith(root + os.sep) for p in paths)
    assert sqlite_register_toctou_test({"concurrency": 1})["concurrency"] == 3


@pytest.mark.parametrize("opts,backend,device", [
    ({}, "gpu", None), ({"device": "cpu"}, "gpu", "cpu"),
    ({"backend": "cpu"}, "cpu", None)])
def test_the_suites_check_where_asked(opts, backend, device):
    for ctor in (sqlite_register_test, sqlite_register_toctou_test):
        linear = ctor(opts)["checker"].checkers["linear"]
        assert (linear.backend, linear.device) == (backend, device)


def test_the_registry_offers_the_sqlite_suites():
    reg = suites.registry()
    assert reg["sqlite-register"] is sqlite_register_test
    assert reg["sqlite-bank"] is sqlite_bank_test
    assert reg["sqlite-register-toctou"] is sqlite_register_toctou_test
