"""The port's chaos matrix (``tools/torch_chaos_matrix.py``): its
in-process scenarios pass on the CPU, and where the reference's own
scenario (``tools/chaos_matrix.py``, loaded by path: its import only
defines things) runs the same injected faults on the same seed, the
verdicts, levels, pool rungs, fault counts and rule ids are the
reference's. The local-kv runs whose histories the scenarios check are
2 s long here (6 s in the tools).
"""

import importlib.util
import os
import re
import sys

import pytest
import torch

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_chaos_matrix as chaos  # noqa: E402

SEED = 7
IN_PROCESS = ("oom", "wedge", "kill-mid-segment", "transient",
              "hung-client", "malformed-history", "plan-rejects",
              "serve-batch-poison", "stream-dup", "lint-seeded-race")
#: the scenarios whose detail is the same words in both tools: the
#: verdict, the pool rung and the faults (oom), the segment resumed and
#: the levels (kill-mid-segment), the retries (transient)
SAME_DETAIL = ("oom", "kill-mid-segment", "transient")


def _reference():
    spec = importlib.util.spec_from_file_location(
        "reference_chaos_matrix", os.path.join(ROOT, "tools",
                                               "chaos_matrix.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the seconds of the local-kv runs that malformed-history and
#: plan-rejects check on the CPU (the tools' own run is 6 s)
LOCALKV_S = 2


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    import jepsen_tpu.suites.localkv as ref_localkv
    real = ref_localkv.localkv_test

    def short(opts):
        # the reference's scenario asks for its 6 s run by literal
        return real(dict(opts, **{"time-limit": LOCALKV_S}))
    monkeypatch.setattr(chaos, "LOCALKV_S", LOCALKV_S)
    monkeypatch.setattr(ref_localkv, "localkv_test", short)
    monkeypatch.setenv("JEPSEN_RETRY_BASE", "0.001")
    monkeypatch.delenv("JTPU_SEGMENT_DEADLINE_S", raising=False)
    monkeypatch.delenv("JTPU_PLAN_BYTES_LIMIT", raising=False)
    yield
    from jepsen_tpu import accel as jaccel
    chaos.accel._reset_for_tests()
    jaccel._reset_for_tests()


def _run(name):
    lines = []
    rc, rows = chaos.run_matrix([name], SEED, "cpu", out=lines.append)
    [(got_name, ok, _, detail)] = rows
    assert got_name == name and lines[-1] == "\n1/1 scenarios passed", lines
    assert rc == 0 and ok, detail
    return detail


@pytest.mark.parametrize("name", IN_PROCESS)
def test_the_in_process_scenarios_pass_on_the_cpu(name):
    detail = _run(name)
    ref = _reference()
    fn = dict(ref.SCENARIOS).get(name)
    if name in SAME_DETAIL:
        ok, want = fn(SEED)
        assert ok and detail == want, (detail, want)
    elif name == "plan-rejects":
        # the rule ids, in order; each tool's local-kv history is its
        # own run's
        ok, want = fn(SEED)
        assert ok
        assert detail.split("; ")[:2] == want.split("; ")[:2] == [
            "capacity-16384->PLAN-OOM", "mesh-3->PLAN-SHARD-INDIVISIBLE"]
    elif name == "wedge":
        # the reference finishes on its CPU fallback; the port resumes
        # the wedged check's checkpoint on the CPU: the same verdict and
        # levels as the reference's uninterrupted (and fallback) check
        ok, _ = fn(SEED)
        assert ok
        p, kernel = ref._packed(SEED)
        base = ref.supervised_check_packed(p, kernel, capacity=128,
                                           expand=8, segment_iters=8)
        m = re.search(r"resumed on cpu: verdict (\w+) levels (\d+) "
                      r"\(uninterrupted (\d+)\)", detail)
        assert m, detail
        assert m.group(1) == str(base["valid"])
        assert int(m.group(2)) == int(m.group(3)) == base["levels"]


def test_every_reference_scenario_has_a_port():
    ref = _reference()
    assert [n for n, _ in chaos.SCENARIOS] == [n for n, _ in ref.SCENARIOS]
    assert len(chaos.SCENARIOS) == 22
