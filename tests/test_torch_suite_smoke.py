"""The wire-protocol suites' registry and command line in the port, and a
dry run of ``chip_smoke.py``'s ``suites`` phase on the CPU.

``SUITES`` has the reference's rows for the ported suites, name for name
and constructor for constructor; every suite module's ``main`` is the
reference's command line (``test`` and ``serve``), its ``test`` building
the reference's test. The
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

from test_torch_cli_lib import SUITE_MAINS

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED = ("etcd", "zookeeper", "consul", "disque", "raftis", "rabbitmq",
          "rabbitmq-mutex", "hazelcast")


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


def built_tests(mod, monkeypatch, argvs):
    """The test maps each package's ``mod`` main builds for each argv of
    ``argvs`` (None: the process's arguments), its ``core.run`` replaced;
    the port's take ``--device cpu`` too. {package: ([exit code], [test
    map])}."""
    out = {}
    for pkg, extra in (("jepsen_tpu_torch", ["--device", "cpu"]),
                       ("jepsen_tpu", [])):
        cli_mod = importlib.import_module(f"{pkg}.cli")
        core_mod = importlib.import_module(f"{pkg}.core")
        rcs, built = [], []
        monkeypatch.setattr(core_mod, "run", lambda t, b=built: b.append(
            t) or dict(t, results={"valid": True}))
        monkeypatch.setattr(
            cli_mod, "main", lambda cmds, argv=None, c=cli_mod, r=rcs:
            r.append(c.run(cmds, sys.argv[1:] + extra if argv is None
                           else argv)))
        main = getattr(importlib.import_module(f"{pkg}.suites.{mod}"),
                       SUITE_MAINS[mod])
        for argv in argvs:
            main(None if argv is None else argv + extra)
        out[pkg] = (rcs, built)
    return out


@pytest.mark.parametrize("mod", sorted(SUITE_MAINS))
def test_each_suite_main_is_the_run_command(mod, monkeypatch):
    """Each suite module's main is the reference's command line: with no
    argv it reads the process's arguments, and its ``test`` command builds
    the reference's test for the options given."""
    monkeypatch.setattr(sys, "argv", ["x", "test", "--concurrency", "2"])
    got = built_tests(mod, monkeypatch, [None, ["test", "--time-limit",
                                                "3"]])
    (rcs, ours), (jrcs, theirs) = got["jepsen_tpu_torch"], got["jepsen_tpu"]
    assert rcs == jrcs == [0, 0]
    for t, r in zip(ours, theirs):
        for k in ("name", "nodes", "concurrency", "time-limit"):
            assert t.get(k) == r.get(k), (mod, k)
    assert ours[1]["time-limit"] == 3


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
