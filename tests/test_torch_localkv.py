"""The local-kv suites through the port's command line, on the CPU.

``python -m jepsen_tpu_torch run --suite local-kv --device cpu
--time-limit 5`` boots three real ``examples/localkv/kvnode.py`` daemons
through the local control plane, drives them under hammer-time, and
stores a complete run: it exits 0, each node's log snarfed into the store
holds the daemon's real pid, the nemesis paused a node, and the check
(the kernels' plain versions) is valid, as the reference's
``check_history_tpu`` finds the same history, with the same levels.
``--suite local-kv-unsafe`` exits 1: its stale read is refuted, and its
``linear.svg`` is byte for byte the reference's rendering of the same
history. The daemons' ports come from the pid-derived range and each
port has its own run directory, so the reference's end-to-end tests and
these never collide.
"""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from jepsen_tpu import store as js
from jepsen_tpu.checker.tpu import check_history_tpu
from jepsen_tpu.checker.wgl import linearizable as j_linearizable
from jepsen_tpu.models import CASRegister as JCASRegister

from jepsen_tpu_torch import store
from jepsen_tpu_torch.suites import localkv

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("valid", "levels", "max-linearized-prefix")


def run_suite(tmp_path, *args):
    p = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch", "run", "--device", "cpu",
         "--store-root", str(tmp_path / "store"), *args],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    return p


def test_local_kv_run_is_valid_with_real_processes(tmp_path):
    p = run_suite(tmp_path, "--suite", "local-kv", "--time-limit", "5")
    assert p.returncode == 0, p.stderr[-3000:]
    d = os.path.realpath(str(tmp_path / "store" / "local-kv" / "latest"))
    files = set(os.listdir(d))
    for name in ("history.jsonl", "history.wal", "results.json",
                 "run.state", "test.json", "jepsen.log", "trace.jsonl",
                 "metrics.json", "latency.json", "rate.json"):
        assert name in files, (name, files)
    assert store.read_state(d)["state"] == "done"
    results = json.loads(open(os.path.join(d, "results.json")).read())
    lin = results["linear"]
    assert results["valid"] is True and lin["valid"] is True
    assert lin["backend"] == "gpu" and "fallback-from" not in lin
    test = json.loads(open(os.path.join(d, "test.json")).read())
    assert test["nodes"] == ["kv1", "kv2", "kv3"]
    pids = set()
    for node in test["nodes"]:
        body = open(os.path.join(d, node, "kv.log")).read()
        assert "listening on" in body
        pids.update(int(m) for m in re.findall(r"kvnode\[(\d+)\]", body))
    assert len(pids) >= 3 and os.getpid() not in pids
    loaded = store.load(d)
    h = loaded["history"]
    assert len(h) > 50
    assert any(o.process == "nemesis" and "paused" in str(o.value)
               for o in h)
    # the reference checks the same stored history to the same verdict
    jh = js.load(d)["history"]
    ref = check_history_tpu(jh, JCASRegister())
    assert {k: lin.get(k) for k in KEYS} == {k: ref.get(k) for k in KEYS}


def test_local_kv_unsafe_is_refuted_with_the_references_svg(tmp_path):
    p = run_suite(tmp_path, "--suite", "local-kv-unsafe")
    assert p.returncode == 1, p.stderr[-3000:]
    d = os.path.realpath(str(tmp_path / "store" / "local-kv-unsafe" /
                             "latest"))
    results = json.loads(open(os.path.join(d, "results.json")).read())
    lin = results["linear"]
    assert results["valid"] is False and lin["valid"] is False
    assert lin["backend"] == "gpu" and "fallback-from" not in lin
    assert lin["counterexample"] == "linear.svg"
    reads = [o for o in store.load(d)["history"]
             if o.f == "read" and o.type == "ok"]
    assert reads and reads[0].value == 1      # the stale value, on cue
    theirs = tmp_path / "ref"
    want = j_linearizable(JCASRegister(), backend="tpu").check(
        {"store-dir": str(theirs)}, js.load(d)["history"])
    assert want["valid"] is False
    assert (theirs / "linear.svg").read_bytes() == \
        open(os.path.join(d, "linear.svg"), "rb").read()


def test_ports_and_run_directories_are_per_process():
    """The pid-derived port range, a fresh port each call, a run
    directory per port under the temporary directory."""
    a, b = localkv.free_ports(3), localkv.free_ports(3)
    assert len(set(a + b)) == 6
    test = localkv.localkv_test({})
    ports = test["localkv-ports"]
    assert not set(ports) & set(a + b)
    db = test["db"]
    dirs = {db._dir(test, n) for n in test["nodes"]}
    assert len(dirs) == 3
    import tempfile
    assert all(d.startswith(os.path.join(tempfile.gettempdir(),
                                         "jepsen-localkv"))
               for d in dirs)


@pytest.mark.parametrize("opts,backend,device", [
    ({}, "gpu", None), ({"device": "cpu"}, "gpu", "cpu"),
    ({"backend": "cpu"}, "cpu", None)])
def test_the_suites_check_where_asked(opts, backend, device):
    for ctor in (localkv.localkv_test, localkv.localkv_unsafe_test):
        linear = ctor(opts)["checker"].checkers["linear"]
        assert (linear.backend, linear.device) == (backend, device)
