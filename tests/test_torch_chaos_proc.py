"""The port's chaos matrix's scenarios that kill processes, on the CPU:
``kill9-recover``, ``serve-kill`` and ``fleet-host-kill``, each in a
``tools/torch_chaos_matrix.py`` process of its own under a timeout (its
process group killed past it), and ``main``'s exit code when a selected
scenario fails.
"""

import os
import signal
import subprocess
import sys

import pytest
import torch

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_chaos_matrix as chaos  # noqa: E402

TIMEOUT_S = 150


@pytest.mark.parametrize("name", ("kill9-recover", "serve-kill",
                                  "fleet-host-kill"))
def test_the_killing_scenarios_pass_on_the_cpu(name):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "torch_chaos_matrix.py"),
         "--device", "cpu", "--only", name],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    rows = [ln for ln in out.splitlines() if ln.startswith(name + " ")]
    assert proc.returncode == 0, (out, err[-3000:])
    assert len(rows) == 1 and rows[0].split()[1] == "PASS", out
    assert out.strip().endswith("1/1 scenarios passed")


def test_main_fails_when_a_selected_scenario_fails(monkeypatch, capsys):
    def broken(seed, device="cuda"):
        return False, "broken on purpose"

    def crashed(seed, device="cuda"):
        raise RuntimeError("crashed on purpose")

    scenarios = dict(chaos.SCENARIOS)
    scenarios["hung-client"] = broken
    scenarios["oom"] = crashed
    monkeypatch.setattr(chaos, "SCENARIOS", tuple(scenarios.items()))
    assert chaos.main(["--device", "cpu", "--only", "hung-client"]) == 1
    assert chaos.main(["--device", "cpu", "--only", "oom"]) == 1
    assert chaos.main(["--device", "cpu", "--only", "lint-seeded-race"]) == 0
    out = capsys.readouterr().out
    assert "hung-client  FAIL" in out and "broken on purpose" in out
    assert "crashed: RuntimeError: crashed on purpose" in out
    assert out.count("0/1 scenarios passed") == 2
    assert "1/1 scenarios passed" in out
