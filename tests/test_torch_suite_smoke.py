"""The wire-protocol suites' registry and command line in the port, and a
dry run of ``chip_smoke.py``'s ``suites`` phase on the CPU.

``SUITES`` has the reference's rows for the ported suites, name for name
and constructor for constructor; every suite module's ``main`` is the
command line's ``run --suite NAME`` with its arguments after it. The
dry run drives the phase's three runs through ``python -m
jepsen_tpu_torch run`` (in this process) against the fakes of
``tools/torch_suite_fakes.py`` in subprocesses, with the
kernels' plain versions (``device="cpu"``) and 3 s runs: etcd valid and
held key by key against the plain route, the native engine and
``analyze``, etcd against lagging replicas refuted on the same keys by
both, the hazelcast lock valid.
"""

import importlib
import os
import sys

import pytest
import torch

from jepsen_tpu import suites as j_suites

from jepsen_tpu_torch import suites

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED = ("etcd", "zookeeper", "consul", "disque", "raftis", "rabbitmq",
          "rabbitmq-mutex", "hazelcast")
#: suite module -> the suite its main runs
MODULES = {"etcd": "etcd", "zookeeper": "zookeeper", "consul": "consul",
           "disque": "disque", "raftis": "raftis", "rabbitmq": "rabbitmq",
           "hazelcast": "hazelcast", "sqlitedb": "sqlite-register"}


def test_the_registry_has_the_reference_rows():
    for name in PORTED:
        assert suites.SUITES[name] == j_suites.SUITES[name], name
    assert set(suites.SUITES) <= set(j_suites.SUITES)
    reg = suites.registry()
    for name in PORTED:
        mod, attr = suites.SUITES[name]
        t = reg[name]({})
        ref = getattr(importlib.import_module(f"jepsen_tpu.suites.{mod}"),
                      attr)({})
        assert set(t) == set(ref) and t["name"] == ref["name"], name


@pytest.mark.parametrize("mod", sorted(MODULES))
def test_each_suite_main_is_the_run_command(mod, monkeypatch):
    import jepsen_tpu_torch.__main__ as cli
    seen = []
    monkeypatch.setattr(cli, "main", lambda argv: seen.append(argv) or 7)
    monkeypatch.setattr(sys, "argv", ["x", "--concurrency", "2"])
    m = importlib.import_module(f"jepsen_tpu_torch.suites.{mod}")
    assert m.main(["--time-limit", "3"]) == 7 and m.main() == 7
    assert seen == [["run", "--suite", MODULES[mod], "--time-limit", "3"],
                    ["run", "--suite", MODULES[mod], "--concurrency", "2"]]


def test_the_smoke_suites_phase_runs_on_the_cpu():
    sys.path.insert(0, ROOT)
    import chip_smoke
    seconds = {}
    line, launches, grid, segs = chip_smoke.suites_phase(
        torch.device("cpu"), seconds, "cpu",
        dict(chip_smoke.SUITES_RUN, etcd_seconds=3, stale_seconds=3,
             lock_seconds=3))
    assert set(line) == {"card", "etcd", "etcd stale", "hazelcast lock"}
    assert line["etcd"]["valid"] is True and line["etcd"]["keys"] >= 2
    assert line["etcd stale"]["valid"] is False
    assert line["etcd stale"]["failures"]
    assert line["hazelcast lock"]["valid"] is True
    assert any(ln.startswith("# plan:") for ln in line["etcd"]["analyze"])
    # the plain versions launch no kernel
    assert set(launches.values()) == {0} and segs["launches"] == 0
    assert seconds["suites"] > 0
